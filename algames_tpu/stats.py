"""On-device solver statistics.

JAX equivalent of the reference ``Statistics`` and the violation
records (``src/struct/statistics.jl:5-72``, ``src/struct/violations.jl``).
The reference pushes per-iteration records onto host vectors; here the
record is a fixed-capacity stack of device arrays (capacity = the static
iteration budget), scatter-written at the current iteration index so the
whole solve stays jittable and vmappable.  ``iter`` counts valid rows.

All float columns live in ONE ``[M, 7]`` array so a record costs one fused
scatter inside the solver's while loop (dispatch overhead matters there);
the per-field accessors (`res`, `dyn_vio`, ...) expose column views.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .utils import pytree_dataclass

_COLS = ("res", "delta", "alpha", "dyn_vio", "con_vio", "sta_vio", "opt_vio")


@pytree_dataclass
class Statistics:
    iter: jnp.ndarray       # scalar int32: number of valid records
    outer: jnp.ndarray      # [M] outer-iteration index of each record
    data: jnp.ndarray       # [M, 7] float columns, see _COLS

    @property
    def res(self):
        """[M] mean-|.|_1 residual norm."""
        return self.data[..., :, 0]

    @property
    def delta(self):
        """[M] step-size metric (reference Δ_traj)."""
        return self.data[..., :, 1]

    @property
    def alpha(self):
        """[M] accepted line-search step."""
        return self.data[..., :, 2]

    @property
    def dyn_vio(self):
        """[M] max dynamics violation."""
        return self.data[..., :, 3]

    @property
    def con_vio(self):
        """[M] max control-constraint violation."""
        return self.data[..., :, 4]

    @property
    def sta_vio(self):
        """[M] max state-constraint violation."""
        return self.data[..., :, 5]

    @property
    def opt_vio(self):
        """[M] max stationarity violation."""
        return self.data[..., :, 6]


def init_stats(capacity: int, dtype=jnp.float64) -> Statistics:
    return Statistics(
        iter=jnp.zeros((), jnp.int32),
        outer=jnp.zeros((capacity,), jnp.int32),
        data=jnp.zeros((capacity, len(_COLS)), dtype),
    )


def print_stats(stats: Statistics, header: bool = True) -> None:
    """Host-side console table of the recorded iterations (reference
    ``display_solver_header/data``, ``src/utils.jl:37-61``)."""
    from .utils import scn

    it = int(np.asarray(stats.iter)) if hasattr(stats.iter, "shape") else int(stats.iter)
    if header:
        print(f"{'out':<4} {'res':<9} {'Δ':<9} {'dyn':<9} {'con':<9} "
              f"{'sta':<9} {'opt':<9}")
    for i in range(it):
        print(f"{int(stats.outer[i]):<4} {scn(float(stats.res[i])):<9} "
              f"{scn(float(stats.delta[i])):<9} "
              f"{scn(float(stats.dyn_vio[i])):<9} "
              f"{scn(float(stats.con_vio[i])):<9} "
              f"{scn(float(stats.sta_vio[i])):<9} "
              f"{scn(float(stats.opt_vio[i])):<9}")


def record(stats: Statistics, active, outer, res, delta, alpha,
           dyn_vio, con_vio, sta_vio, opt_vio) -> Statistics:
    """Append one record when ``active`` (mask for batched/while-loop use).

    One fused row scatter — the solver calls this inside its hot loop.

    At capacity the LAST row keeps being overwritten and ``iter`` saturates
    at capacity: out-of-bounds scatters would silently drop writes while
    clamped gathers re-read a stale row, so long runs (IBR with ibr_iter=100)
    would report a final record that was never the latest iteration.
    """
    cap = stats.data.shape[-2]
    i = jnp.minimum(stats.iter, cap - 1)
    row = jnp.stack([jnp.asarray(v, stats.data.dtype) for v in
                     (res, delta, alpha, dyn_vio, con_vio, sta_vio, opt_vio)])
    # One-hot row blend instead of .at[i].set: the [cap, 7] dense select
    # fuses into the surrounding elementwise ops.
    hit = (jnp.arange(cap) == i) & active
    return Statistics(
        iter=jnp.where(active, jnp.minimum(stats.iter + 1, cap), stats.iter),
        outer=jnp.where(hit, outer, stats.outer),
        data=jnp.where(hit[:, None], row[None, :], stats.data),
    )
