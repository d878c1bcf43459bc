"""Problem-shape specification and closed-form KKT layout.

JAX replacement for the reference's ``ProblemSize`` plus the whole
"stamp" indexing machinery (reference: ``src/struct/problem_size.jl:5-44``,
``src/core/stamp.jl``, ``src/core/newton_core.jl:40-89``).  Where the
reference builds dictionaries of index vectors and SubArray views at problem
construction time, here every offset is a *pure closed-form function* of the
static shape, evaluated at trace time, so assembly compiles to static-shape
gather/scatter with no host data structures.

Layout conventions (0-based, horizon T = N-1):

Flat primal-dual vector ("horizontal" / column order,
reference ``src/core/newton_core.jl:65-89``)::

    for k in 0..T-1:  [ x_{k+1} (n) | u_k (m) | lam_{0,k} (n) ... lam_{p-1,k} (n) ]

Residual rows ("vertical" order, reference ``src/core/newton_core.jl:40-63``)::

    for i in 0..p-1:
        for k in 0..T-1:  [ stat_x(i, k+1) (n) | stat_u(i, k) (mi) ]
    for k in 0..T-1:      [ dyn(k) (n) ]

``S = n*p*T + m*T + n*T`` in both orders.

The per-knot KKT block width is ``W = n + m + p*n``; the KKT Jacobian in the
knot-blocked symmetric-ish ordering is block tridiagonal in k (see
``problem/residual.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """Static problem shape. Hashable; safe to close over under ``jax.jit``.

    Mirrors the reference ``ProblemSize`` fields
    (``src/struct/problem_size.jl:5-17``) with 0-based index tuples.
    """

    N: int                      # number of knot points
    n: int                      # full state dimension
    m: int                      # full control dimension
    p: int                      # number of players
    ni: Tuple[int, ...]         # per-player state dims
    mi: Tuple[int, ...]         # per-player control dims
    pu: Tuple[Tuple[int, ...], ...]  # per-player control indices into 0..m-1
    px: Tuple[Tuple[int, ...], ...]  # per-player x/y(/z) position indices into 0..n-1
    pz: Tuple[Tuple[int, ...], ...]  # per-player state indices into 0..n-1
    dt: float                   # time step (uniform, as in all reference usage)

    # ------------------------------------------------------------------ sizes
    @property
    def T(self) -> int:
        """Horizon: number of dynamics intervals (N-1)."""
        return self.N - 1

    @property
    def S(self) -> int:
        """Primal-dual vector size (``src/struct/problem_size.jl:22``)."""
        return self.n * self.p * self.T + self.m * self.T + self.n * self.T

    @property
    def W(self) -> int:
        """Per-knot KKT block width: [x_{k+1}; u_k; lam_{0..p-1,k}]."""
        return self.n + self.m + self.p * self.n

    @property
    def homogeneous(self) -> bool:
        return len(set(self.ni)) == 1 and len(set(self.mi)) == 1

    # ----------------------------------------------------- horizontal offsets
    # Column order within knot block k: x_{k+1} at 0, u_k at n (player slices
    # via pu), lam_{i,k} at n+m+i*n.
    def col_x(self, k: int) -> int:
        """Flat column offset of x_{k+1}, for k in 0..T-1."""
        assert 0 <= k < self.T
        return k * self.W

    def col_u(self, k: int) -> int:
        """Flat column offset of u_k (full m-vector), for k in 0..T-1."""
        assert 0 <= k < self.T
        return k * self.W + self.n

    def col_lam(self, i: int, k: int) -> int:
        """Flat column offset of lam_{i,k}, for k in 0..T-1."""
        assert 0 <= k < self.T and 0 <= i < self.p
        return k * self.W + self.n + self.m + i * self.n

    # ------------------------------------------------------- vertical offsets
    # Row order (reference vertical_indices): player-major, then dynamics.
    def _player_row_base(self, i: int) -> int:
        return i * (self.n + self.mi[i]) * self.T if self.homogeneous else sum(
            (self.n + self.mi[j]) * self.T for j in range(i))

    def row_stat_x(self, i: int, k: int) -> int:
        """Flat row offset of stationarity wrt x_{k+1} for player i."""
        assert 0 <= k < self.T and 0 <= i < self.p
        return self._player_row_base(i) + k * (self.n + self.mi[i])

    def row_stat_u(self, i: int, k: int) -> int:
        """Flat row offset of stationarity wrt u_{i,k} (mi rows)."""
        assert 0 <= k < self.T and 0 <= i < self.p
        return self._player_row_base(i) + k * (self.n + self.mi[i]) + self.n

    def row_dyn(self, k: int) -> int:
        """Flat row offset of the dynamics residual at interval k."""
        assert 0 <= k < self.T
        return sum((self.n + self.mi[j]) * self.T
                   for j in range(self.p)) + k * self.n

    # ------------------------------------------------------------- masks (IBR)
    def vertical_mask(self, i: int) -> np.ndarray:
        """Row indices of player i's sub-KKT system plus dynamics rows.

        Reference ``src/core/newton_core.jl:205-250`` (splitted_state=False:
        full n state rows).
        """
        idx = []
        for k in range(self.T):
            r = self.row_stat_x(i, k)
            idx.extend(range(r, r + self.n))
            r = self.row_stat_u(i, k)
            idx.extend(range(r, r + self.mi[i]))
        for k in range(self.T):
            r = self.row_dyn(k)
            idx.extend(range(r, r + self.n))
        return np.asarray(idx, dtype=np.int32)

    def horizontal_mask(self, i: int) -> np.ndarray:
        """Column indices of [all x; u_i; lam_i] variables.

        Reference ``src/core/newton_core.jl:253-294``.  Order: states, then
        player i's controls, then player i's multipliers.
        """
        idx = []
        for k in range(self.T):
            c = self.col_x(k)
            idx.extend(range(c, c + self.n))
        for k in range(self.T):
            c = self.col_u(k)
            idx.extend(c + j for j in self.pu[i])
        for k in range(self.T):
            c = self.col_lam(i, k)
            idx.extend(range(c, c + self.n))
        return np.asarray(idx, dtype=np.int32)

    # ------------------------------------------------------------ validation
    def __post_init__(self):
        assert self.N >= 2, "need at least one dynamics interval"
        assert self.p == len(self.ni) == len(self.mi) == len(self.pu) \
            == len(self.px) == len(self.pz)
        assert sum(self.mi) == self.m
        # Heterogeneous per-player control dims are supported end-to-end via
        # the mi-agnostic dense/tridiag/cr paths (the reference's NewtonCore
        # handles per-player mi throughout, src/core/newton_core.jl:40-89);
        # the player-stacked schur/pallas fast paths require homogeneity and
        # raise a clear error otherwise.


def spec_from_model(model, N: int, dt: float) -> ProblemSpec:
    """Build a ProblemSpec from a game model (reference ``ProblemSize(N, model)``)."""
    return ProblemSpec(
        N=N, n=model.n, m=model.m, p=model.p,
        ni=tuple(model.ni), mi=tuple(model.mi),
        pu=tuple(tuple(ix) for ix in model.pu),
        px=tuple(tuple(ix) for ix in model.px),
        pz=tuple(tuple(ix) for ix in model.pz),
        dt=float(dt),
    )
