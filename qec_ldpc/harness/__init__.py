from qec_ldpc.harness import debug
from qec_ldpc.harness.config import (
    RunConfig,
    format_result_filename,
    load_init_file,
)
from qec_ldpc.harness.journal import Journal
from qec_ldpc.harness.stats import (
    CodeStatistics,
    parse_code_params,
    parse_reference_text,
)

__all__ = [
    "debug",
    "RunConfig",
    "load_init_file",
    "format_result_filename",
    "CodeStatistics",
    "parse_code_params",
    "parse_reference_text",
    "Journal",
]
