"""Circulant edge-tensor layout for Tanner-graph message passing.

The reference walks the graph with per-edge gather lists
(``DecoderCPU.h:41-133`` index/pointer arrays; one CUDA thread per edge in
``kernels.cu:95-250``).  Here we exploit the quasi-cyclic structure instead:

Every parity-check matrix is a B x L grid of P x P circulant permutation
blocks with exponents C[b, l].  Edge (b, l, r), r in [0, P):
    check index = b*P + r
    var   index = l*P + (C[b,l] + r) % P

Messages live in a flat rank-2 tensor of shape ``(B*L*P, batch)`` — edge rows
major-ordered by (b, l, lane), batch on the trailing (lane/128) axis — with
two equivalent lane orderings per (b, l) block:

  * check-indexed: lane r of block (b, l) belongs to check (b, r)
  * var-indexed:   lane q of block (b, l) belongs to var   (l, q)

Translating between the two is a per-(b, l) cyclic roll of the block's P rows.
Because the exponents are static, each roll is TWO static row slices + one
concatenate: XLA sees only static slices, so the routing needs no index
arrays in memory and fuses into the neighbouring elementwise work.  Rank-2
keeps every message tensor a plain ``(edges, batch)`` matrix.

No sparse formats, no per-edge index arrays, no gathers — the exponent table
IS the routing program.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
from jax import lax


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash, usable as a jit static arg
class CirculantGraph:
    """Static message-routing data for one PCM of a QC code.

    Replaces the reference's InitIndexArrays/InitNodePtrs adjacency machinery
    (``DecoderCPU.h:41-133``) with static cyclic-shift schedules.
    """

    B: int  # number of block rows (J for X graph, K for Z graph)
    L: int  # number of block cols (= vars per check, the check degree)
    P: int  # circulant size
    #: exponent table (B, L), entries in [0, P)
    table: np.ndarray

    @staticmethod
    def from_table(table: np.ndarray, P: int) -> "CirculantGraph":
        table = np.asarray(table, dtype=np.int64) % P
        B, L = table.shape
        return CirculantGraph(B=B, L=L, P=P, table=table)

    @property
    def check_degree(self) -> int:
        """Edges per check = block columns (generic-layout name; the lifted
        generalization in decoder/lifted.py shares this interface)."""
        return self.L

    @property
    def var_degree(self) -> int:
        """Edges per variable = block rows."""
        return self.B

    @property
    def num_checks(self) -> int:
        return self.B * self.P

    @property
    def num_vars(self) -> int:
        return self.L * self.P

    @property
    def num_edges(self) -> int:
        return self.B * self.L * self.P

    # -- static-roll primitives ------------------------------------------------

    def _roll_blocks(self, x: jnp.ndarray, shifts: np.ndarray) -> jnp.ndarray:
        """Per-block cyclic roll of (B*L*P, batch) rows: block i's P rows are
        rotated so out[q] = in[(q + s_i) % P].  Unrolled static slices+concat."""
        chunks = []
        P = self.P
        for i, s in enumerate(shifts.ravel()):
            base = i * P
            s = int(s) % P
            if s == 0:
                chunks.append(lax.slice_in_dim(x, base, base + P, axis=0))
            else:
                chunks.append(lax.slice_in_dim(x, base + s, base + P, axis=0))
                chunks.append(lax.slice_in_dim(x, base, base + s, axis=0))
        return jnp.concatenate(chunks, axis=0)

    def to_var(self, x: jnp.ndarray) -> jnp.ndarray:
        """Check-indexed -> var-indexed: out[q] = in[(q - C) % P] per block."""
        return self._roll_blocks(x, (-self.table) % self.P)

    def to_check(self, x: jnp.ndarray) -> jnp.ndarray:
        """Var-indexed -> check-indexed: out[r] = in[(r + C) % P] per block."""
        return self._roll_blocks(x, self.table)

    # -- graph-structured linear ops ------------------------------------------

    def syndrome(self, errors: jnp.ndarray) -> jnp.ndarray:
        """Mod-2 syndrome from errors (num_vars, batch) -> (num_checks, batch).

        S[b*P + r] = XOR_l errors[l*P + (C[b,l] + r) % P]: per block-row, sum
        the error blocks rolled to check order (dense-matvec reference:
        ``Quantum_LDPC_Code.h:94-124``) — pure slices, adds and a parity.
        """
        P, L = self.P, self.L
        rows = []
        for b in range(self.B):
            acc = None
            for l in range(self.L):
                base = l * P
                s = int(self.table[b, l])
                if s == 0:
                    blk = lax.slice_in_dim(errors, base, base + P, axis=0)
                else:
                    blk = jnp.concatenate([
                        lax.slice_in_dim(errors, base + s, base + P, axis=0),
                        lax.slice_in_dim(errors, base, base + s, axis=0),
                    ], axis=0)
                acc = blk if acc is None else acc + blk
            rows.append(acc)
        return jnp.concatenate(rows, axis=0) % 2

    # -- flat <-> block views (free reshapes: memory is contiguous) ------------

    def cn_view(self, x: jnp.ndarray) -> jnp.ndarray:
        """(B*L*P, batch) -> (B, L, P*batch) for leave-one-out over L."""
        return x.reshape(self.B, self.L, -1)

    def vn_view(self, x: jnp.ndarray) -> jnp.ndarray:
        """(B*L*P, batch) -> (B, L*P, batch) for leave-one-out over B."""
        return x.reshape(self.B, self.L * self.P, -1)

    def expand_checks(self, s: jnp.ndarray) -> jnp.ndarray:
        """Per-check values (B*P, batch) -> per-edge rows (B*L*P, batch),
        replicating each block-row's P lanes across its L blocks."""
        b_p = s.reshape(self.B, 1, self.P, -1)
        full = jnp.broadcast_to(b_p, (self.B, self.L, self.P, s.shape[-1]))
        return full.reshape(self.num_edges, -1)

    def expand_vars(self, g: jnp.ndarray) -> jnp.ndarray:
        """Per-variable values (L*P, batch) -> CHECK-indexed per-edge rows
        (B*L*P, batch): replicate across the B incident checks (var-indexed
        order), then roll to check order."""
        full = jnp.broadcast_to(g[None], (self.B, *g.shape))
        return self.to_check(full.reshape(self.num_edges, -1))
