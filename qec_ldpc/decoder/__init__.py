from qec_ldpc.decoder.decode import (
    CONVERGENCE_FAIL_X,
    CONVERGENCE_FAIL_Z,
    SUCCESS,
    SYNDROME_FAIL_X,
    SYNDROME_FAIL_Z,
    CodeGraphs,
    DecodeResult,
    decode_batch,
    syndromes_from_errors,
)
from qec_ldpc.decoder.layered import layered_min_sum_run
from qec_ldpc.decoder.layout import CirculantGraph
from qec_ldpc.decoder.lifted import LiftedGraph
from qec_ldpc.decoder.min_sum import min_sum_run
from qec_ldpc.decoder.osd import CSSPostprocessor, OSDecoder
from qec_ldpc.decoder.relay import relay_decode_batch
from qec_ldpc.decoder.sum_product import BPConfig, bp_run, cn_update, vn_update
from qec_ldpc.decoder.validate import (
    checked_decode_batch,
    validate_decode_result,
)

__all__ = [
    "BPConfig",
    "OSDecoder",
    "CSSPostprocessor",
    "relay_decode_batch",
    "checked_decode_batch",
    "validate_decode_result",
    "min_sum_run",
    "layered_min_sum_run",
    "CirculantGraph",
    "LiftedGraph",
    "CodeGraphs",
    "DecodeResult",
    "decode_batch",
    "bp_run",
    "cn_update",
    "vn_update",
    "syndromes_from_errors",
    "SUCCESS",
    "SYNDROME_FAIL_X",
    "SYNDROME_FAIL_Z",
    "CONVERGENCE_FAIL_X",
    "CONVERGENCE_FAIL_Z",
]
