"""Run configuration: dataclasses + reference init-file compatibility.

The reference drives experiments from a 6-line positional init file
(``main.cu:74-89``; example ``QEC_LDPC/init.txt``):
    codeFile / w / W / COUNT / MAX_ITERATIONS / p
The hard-coded constants of the reference decode loop are surfaced here as
defaulted fields (SURVEY §5 config inventory).
"""

from __future__ import annotations

import dataclasses
import os

from qec_ldpc.decoder.sum_product import BPConfig

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def apply_option(cfg: "RunConfig", key: str, value: str) -> None:
    """Set one RunConfig field from its string form, with strict coercion.

    Booleans accept only explicit true/false literals — a typo ('ture')
    must raise, not silently become False (advisor finding r3)."""
    if not hasattr(cfg, key):
        raise ValueError(f"unknown option {key!r}")
    cur = getattr(cfg, key)
    if isinstance(cur, bool):
        v = value.lower()
        if v in _TRUE:
            value = True
        elif v in _FALSE:
            value = False
        else:
            raise ValueError(
                f"option {key!r}: expected one of {_TRUE + _FALSE}, "
                f"got {value!r}")
    elif isinstance(cur, int) or (cur is None and key == "seed"):
        value = int(value)
    elif isinstance(cur, float):
        value = float(value)
    setattr(cfg, key, value)


@dataclasses.dataclass
class RunConfig:
    code_file: str
    weight_start: int
    weight_end: int
    count: int
    max_iterations: int
    error_probability: float
    #: framework extensions
    seed: int | None = None
    batch_size: int = 1024
    results_dir: str = "results"
    log_file: str = "output_log.txt"
    algorithm: str = "sum-product"   # or "min-sum" / "layered-min-sum"
    error_model: str = "weight"      # or "depolarizing"
    use_mesh: bool = True            # shard over all local devices
    #: graph-axis size of the device mesh (BASELINE config 5): > 1 shards the
    #: Tanner graphs themselves across chips (block-columns for circulant QC
    #: codes, lift-lane bands for BB/HGP codes — parallel/mc_graph.py) and
    #: the Monte-Carlo batch over the remaining devices.  Constraints:
    #: num_graph must divide L (circulant) / the lift height l (lifted), and
    #: relay/osd quality modes are data-parallel-only.
    num_graph: int = 1
    #: comma-separated physical error rates: sweep p (logical-error-rate
    #: curve, BASELINE config 4) instead of the reference's weight sweep
    p_values: str = ""
    #: write a jax.profiler trace (TensorBoard/Perfetto) under this directory
    profile_dir: str = ""
    #: Monte-Carlo chunks scanned on device per dispatch (amortizes the
    #: per-dispatch host overhead and counter read-back; journal/resume
    #: granularity is one dispatch group of steps_per_call x batch samples)
    steps_per_call: int = 32
    #: OSD post-processing of BP failures (decoder/osd.py): -1 = off,
    #: 0 = OSD-0, >0 = combination sweep over that many non-pivot columns.
    #: Quality mode — runs chunk-at-a-time with host round-trips.  Pairs
    #: best with an LLR-domain algorithm (min-sum / layered-min-sum).
    osd: int = -1
    #: logical-error test convention: "reference" reproduces the shipped
    #: iMinusP semantics (residual harmless iff in the rowspace of the
    #: DETECTING matrix — required for golden-corpus parity); "physical"
    #: uses the CSS-correct convention (rowspace of the same-Pauli-type
    #: stabilizers, codes/css.py i_minus_p_physical).  The reference
    #: convention overcounts logical errors (it counts genuine stabilizers).
    logical_test: str = "reference"
    #: on-device ensemble relay repairs of BP failures (decoder/relay.py):
    #: number of randomized damped min-sum retries (0 = off).  Composable
    #: with osd (relay first, OSD mops up).
    relay: int = 0

    def sweep_points(self) -> list[tuple[int, float]]:
        """The (weight, p) grid this run covers: the reference's w..W sweep at
        fixed p, or a p sweep at fixed weight when ``p_values`` is set."""
        if self.p_values:
            ps = [float(x) for x in self.p_values.replace(",", " ").split()]
            return [(self.weight_start, p) for p in ps]
        return [(w, self.error_probability)
                for w in range(self.weight_start, self.weight_end + 1)]

    def bp_config(self) -> BPConfig:
        return BPConfig(max_iters=self.max_iterations,
                        algorithm=self.algorithm)


def load_init_file(path: str) -> RunConfig:
    """Parse the reference init format: 6 whitespace-separated tokens
    (``main.cu:74-89``).  Extra ``key=value`` tokens extend the format."""
    tokens: list[str] = []
    extras: dict[str, str] = {}
    with open(path) as f:
        for raw in f.read().split():
            if "=" in raw:
                k, v = raw.split("=", 1)
                extras[k] = v
            else:
                tokens.append(raw)
    if len(tokens) < 6:
        raise ValueError(
            f"init file {path!r}: expected 6 positional values "
            f"(codeFile w W COUNT MAX_ITERATIONS p), got {len(tokens)}")
    code_file = tokens[0]
    if (not os.path.isabs(code_file) and not os.path.exists(code_file)
            and ":" not in code_file):
        # the reference resolves codeFile against its own directory
        # (init.txt says just "code610.txt", main.cu:74-78); mirror that so
        # its LITERAL init file runs from anywhere
        beside = os.path.join(os.path.dirname(os.path.abspath(path)),
                              code_file)
        if os.path.exists(beside):
            code_file = beside
    cfg = RunConfig(
        code_file=code_file,
        weight_start=int(tokens[1]),
        weight_end=int(tokens[2]),
        count=int(tokens[3]),
        max_iterations=int(tokens[4]),
        error_probability=float(tokens[5]),
    )
    for k, v in extras.items():
        try:
            apply_option(cfg, k, v)
        except ValueError as e:
            raise ValueError(f"init file {path!r}: {e}") from e
    return cfg


def format_result_filename(code_str: str, weight: int, max_iterations: int,
                           error_probability: float) -> str:
    """Result-file naming of the reference harness (``main.cu:93-97``):
    ``<code>_W_<w>_MAX_<M>_p_<p>.txt`` with spaces stripped and the float
    printed like C++ default ostream (up to 6 significant digits)."""
    p_str = f"{error_probability:g}"
    name = f"{code_str}_W_{weight}_MAX_{max_iterations}_p_{p_str}.txt"
    return name.replace(" ", "")
