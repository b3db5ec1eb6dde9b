"""qec_ldpc — a JAX quantum-LDPC decoding framework.

A from-scratch JAX/XLA re-design of the capabilities of the reference
CUDA/C++ code ``cantwellc/QEC_LDPC``: quasi-cyclic CSS quantum-LDPC code
construction (Hagiwara–Imai, arXiv:quant-ph/0701020), random Pauli error
generation, syndrome extraction, sum-product / min-sum belief propagation over
the Tanner graph, and Monte-Carlo logical-error-rate estimation — batched,
vmapped, sharded over device meshes.

Layers (see SURVEY.md §7):
  codes/     code construction + file IO        (ref: Quantum_LDPC_Code.h, QEC_LDPC_CSS.cu)
  decoder/   batched BP decode engines          (ref: DecoderCPU.h, kernels.cu)
  sampling/  error generation + outcome classification (ref: RandomErrorGenerator.h, DecoderCPU.h:392-530)
  parallel/  mesh / shard_map Monte-Carlo scale-out     (no reference analog; new capability)
  harness/   experiment driver, stats records, CLI      (ref: main.cu, CodeStatistics.h)
  native/    C++ runtime pieces (fast IO, GF(2) linalg) with pure-NumPy fallbacks
"""

__version__ = "0.1.0"

from qec_ldpc.codes import QuantumLDPCCode, construct_code, load_code_file
