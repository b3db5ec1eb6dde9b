"""Hypergraph-product (HGP) quantum codes of circulant classical codes.

A third CSS model family beyond the reference's Hagiwara–Imai construction
(``QEC_LDPC_CSS.cu:26-131``) and the bivariate bicycle family
(codes/bicycle.py): the Tillich–Zémor hypergraph product (arXiv:0903.0566)
of two *circulant* classical LDPC codes.  For square circulant parity-check
matrices ``h1(x)`` over Z_{n1} and ``h2(y)`` over Z_{n2}:

    H_X = [ h1(x) ⊗ I  |  I ⊗ h2(y)^T ]      (n1·n2 x 2·n1·n2)
    H_Z = [ I ⊗ h2(y)  |  h1(x)^T ⊗ I ]      (n1·n2 x 2·n1·n2)

CSS orthogonality ``H_X H_Z^T = h1 ⊗ h2^T + h1 ⊗ h2^T = 0`` holds
automatically over GF(2).  Every block is a sum of monomial permutations
over the product group Z_{n1} x Z_{n2}, so the family maps directly onto the
framework's lifted-graph layout (:class:`qec_ldpc.decoder.lifted
.LiftedGraph`) — one check block, two var blocks, one edge block per
monomial — and the whole decode stack (flooding sum-product/min-sum,
ensemble relay, OSD post-processing, sharded
Monte-Carlo) runs on it unchanged.

The **toric code** is the d x d special case ``h1 = 1 + x``, ``h2 = 1 + y``
(HGP of two cyclic repetition codes): ``toric_code(d)`` yields the
[[2d², 2, d]] surface code on a torus, so the framework decodes the most
widely studied topological code on the same kernels as the LDPC families.
Degenerate errors are classified correctly because the logical test uses the
physical convention (residual harmless iff in the rowspace of the SAME-type
stabilizers), exactly as for BB codes.

Constraint inherited from the lifted layout: ``LiftedGraph`` requires
uniform variable degrees across var blocks, which for HGP means
``weight(h1) == weight(h2)`` (true for the toric code and the standard
equal-row-weight LDPC products).  k is computed by GF(2) rank; for square
circulants it equals ``2·k1·k2`` with ``k_i = n_i - rank(h_i)``.

Convention note (physical, same as codes/bicycle.py): X errors are detected
by the Z-type stabilizers (``pcm_x = H_Z``) and a residual X error is
harmless iff it lies in the rowspace of the X-type stabilizers (``H_X``).
"""

from __future__ import annotations

import dataclasses
from functools import cached_property

import numpy as np

from qec_ldpc.codes import construction


@dataclasses.dataclass(frozen=True)
class HypergraphProductCode:
    """HGP(h1 over Z_{n1}, h2 over Z_{n2}) with weight(h1) == weight(h2)."""

    n1: int
    n2: int
    h1_terms: tuple[int, ...]  # exponents of h1(x), distinct mod n1
    h2_terms: tuple[int, ...]  # exponents of h2(y), distinct mod n2

    def __post_init__(self):
        object.__setattr__(
            self, "h1_terms", tuple(int(a) % self.n1 for a in self.h1_terms))
        object.__setattr__(
            self, "h2_terms", tuple(int(b) % self.n2 for b in self.h2_terms))
        if len(set(self.h1_terms)) != len(self.h1_terms):
            raise ValueError("duplicate exponents in h1")
        if len(set(self.h2_terms)) != len(self.h2_terms):
            raise ValueError("duplicate exponents in h2")
        if len(self.h1_terms) != len(self.h2_terms):
            raise ValueError(
                "lifted layout needs uniform var degrees: "
                f"weight(h1)={len(self.h1_terms)} != "
                f"weight(h2)={len(self.h2_terms)}")

    # -- sizes ---------------------------------------------------------------

    @property
    def group(self) -> tuple[int, int]:
        return (self.n1, self.n2)

    @property
    def P(self) -> int:
        return self.n1 * self.n2

    @property
    def n(self) -> int:
        return 2 * self.P

    @property
    def num_eqs_x(self) -> int:
        return self.P

    @property
    def num_eqs_z(self) -> int:
        return self.P

    @cached_property
    def k_logical(self) -> int:
        """n - rank(H_X) - rank(H_Z) over GF(2) (= 2·k1·k2 for square
        circulant factors; asserted against the factor ranks in tests)."""
        rx = len(construction.gf2_rref(self.hx_stab)[1])
        rz = len(construction.gf2_rref(self.hz_stab)[1])
        return self.n - rx - rz

    # -- edge-block structure -------------------------------------------------

    def _edges_hx(self) -> list[tuple[int, int, tuple[int, int]]]:
        """H_X = [h1 ⊗ I | I ⊗ h2^T]: shifts (a, 0) and (0, -b)."""
        return ([(0, 0, (a, 0)) for a in self.h1_terms]
                + [(0, 1, (0, -b)) for b in self.h2_terms])

    def _edges_hz(self) -> list[tuple[int, int, tuple[int, int]]]:
        """H_Z = [I ⊗ h2 | h1^T ⊗ I]: shifts (0, b) and (-a, 0)."""
        return ([(0, 0, (0, b)) for b in self.h2_terms]
                + [(0, 1, (-a, 0)) for a in self.h1_terms])

    def _graph(self, edges):
        from qec_ldpc.decoder.lifted import LiftedGraph

        return LiftedGraph.build(1, 2, self.group, edges)

    # -- dense stabilizer matrices (tests, OSD, logical algebra) --------------

    @cached_property
    def hx_stab(self) -> np.ndarray:
        """X-type stabilizer matrix (n1·n2 x 2·n1·n2)."""
        return self._graph(self._edges_hx()).dense_pcm()

    @cached_property
    def hz_stab(self) -> np.ndarray:
        """Z-type stabilizer matrix (n1·n2 x 2·n1·n2)."""
        return self._graph(self._edges_hz()).dense_pcm()

    # framework naming: pcm_x is the matrix whose syndrome DETECTS x errors
    # (Quantum_LDPC_Code.h:94-124 semantics) = the Z-type stabilizers
    @property
    def pcm_x(self) -> np.ndarray:
        return self.hz_stab

    @property
    def pcm_z(self) -> np.ndarray:
        return self.hx_stab

    @cached_property
    def i_minus_p(self) -> np.ndarray:
        """Logical-test matrix diag(ann(H_X), ann(H_Z)) over the doubled
        [x; z] space (physical convention)."""
        return construction.build_i_minus_p(self.hx_stab, self.hz_stab)

    def check_logical_error(self, errors_2n: np.ndarray) -> np.ndarray:
        """True where the doubled residual [ex; ez] has a logical component
        (same contract as QuantumLDPCCode.check_logical_error)."""
        prod = np.asarray(errors_2n) @ self.i_minus_p.T.astype(np.int64) % 2
        return prod.any(axis=-1)

    # -- graphs ---------------------------------------------------------------

    def build_graphs(self):
        """CodeGraphs with lifted X/Z Tanner graphs: graphs.x decodes the
        x-error syndrome (H_Z graph), graphs.z the z-error syndrome (H_X)."""
        from qec_ldpc.decoder.decode import CodeGraphs

        return CodeGraphs(code=self,
                          x=self._graph(self._edges_hz()),
                          z=self._graph(self._edges_hx()))

    def __str__(self) -> str:
        h1 = "+".join("1" if a == 0 else f"x{a}" for a in self.h1_terms)
        h2 = "+".join("1" if b == 0 else f"y{b}" for b in self.h2_terms)
        return (f"[HGP,n1={self.n1},n2={self.n2},h1={h1},h2={h2}]"
                f"[[n={self.n},k={self.k_logical}]]")


def _poly(spec: str, var: str, modulus: int) -> tuple[int, ...]:
    """Parse '1 + x3 + x5' -> (0, 3, 5).  Strict: only '1' or '<var><int>'
    terms are accepted so a typo fails loudly (same policy as
    codes/bicycle._mono)."""
    out = []
    for term in spec.split("+"):
        term = term.strip()
        if term == "1":
            out.append(0)
        elif term == var:
            out.append(1)
        elif term.startswith(var) and term[1:].isdigit():
            out.append(int(term[1:]))
        else:
            raise ValueError(
                f"bad term {term!r} in {spec!r}: expected '1', "
                f"'{var}' or '{var}<int>'")
    return tuple(e % modulus for e in out)


def hgp_code(n1: int, n2: int, h1: str, h2: str) -> HypergraphProductCode:
    """Construct HGP from polynomial strings, e.g.
    ``hgp_code(7, 7, "1 + x + x3", "1 + y + y3")``."""
    return HypergraphProductCode(
        n1=n1, n2=n2,
        h1_terms=_poly(h1, "x", n1),
        h2_terms=_poly(h2, "y", n2))


def toric_code(d: int) -> HypergraphProductCode:
    """The [[2d², 2, d]] toric code: HGP of two length-d cyclic repetition
    codes (h1 = 1 + x, h2 = 1 + y)."""
    if d < 2:
        raise ValueError(f"toric code needs d >= 2, got {d}")
    return HypergraphProductCode(n1=d, n2=d, h1_terms=(0, 1), h2_terms=(0, 1))
