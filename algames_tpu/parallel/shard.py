"""Multi-device scaling: shard the scenario batch over a device mesh.

The distributed layer the reference does not have (SURVEY.md §2.3 / §5): the
Monte-Carlo scenario axis is sharded over a ``jax.sharding.Mesh`` with
``shard_map``; each device runs its shard of full game solves locally (zero
inter-device traffic in the hot loop — game solves are embarrassingly
parallel) and only the reduction of summary statistics (convergence counts,
violation maxima) crosses devices via ``psum``/``pmax``, which XLA hands to
NCCL over NVLink.

Mesh axes (a logical ``dp x mc`` factorisation; the GPUs of a host are
joined all to all, so the mesh follows the algorithm alone):
  dp — scenario data parallelism (the throughput axis)
  mc — a second scenario axis kept separate for schedulers that sweep two
       things at once (e.g. penalty schedules x initial conditions);
       logically both are batch.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..problem.problem import GameProblem
from ..problem.solver import newton_solve


def make_mesh(n_devices: int | None = None,
              axes: Tuple[str, str] = ("dp", "mc")) -> Mesh:
    """Build a 2D mesh over the available devices (dp-major)."""
    devs = jax.devices()[:n_devices] if n_devices else jax.devices()
    nd = len(devs)
    # factor nd = dp * mc with dp as large as possible
    mc = 1
    for cand in range(int(np.sqrt(nd)), 0, -1):
        if nd % cand == 0:
            mc = cand
            break
    dp = nd // mc
    return Mesh(np.asarray(devs).reshape(dp, mc), axes)


def sharded_monte_carlo(prob: GameProblem, mesh: Mesh, x0s: jnp.ndarray,
                        method: str = "schur", chunk: int = 128):
    """Solve a sharded batch of scenarios and psum summary stats.

    ``x0s`` [B, n] with B divisible by mesh size; rows are sharded over
    ('dp', 'mc').  Returns (trajs [B, N, n] sharded, summary dict of
    replicated scalars).

    ``chunk``: each device's shard is solved in sequential vmapped chunks of
    this many lanes (``lax.map``) instead of one giant vmap — a vmapped
    while_loop runs max-over-lanes iterations, so smaller chunks pay only
    their own stragglers.  Shards not divisible by
    ``chunk`` fall back to a single vmap.
    """
    opts = prob.opts

    def local_solve(x0_shard):
        # x0_shard: [B_local, n] on this device.
        def one(x0):
            p = GameProblem(spec=prob.spec, model=prob.model, opts=prob.opts,
                            x0=x0, obj=prob.obj, gc=prob.gc)
            return newton_solve(p, method=method)

        B_local = x0_shard.shape[0]
        if chunk and B_local > chunk and B_local % chunk == 0:
            xc = x0_shard.reshape(-1, chunk, x0_shard.shape[-1])
            res = jax.lax.map(jax.vmap(one), xc)
            res = jax.tree_util.tree_map(
                lambda a: a.reshape((B_local,) + a.shape[2:]), res)
        else:
            res = jax.vmap(one)(x0_shard)
        it = jnp.maximum(res.stats.iter - 1, 0)
        take = jax.vmap(lambda a, i: a[i])
        ok = ((take(res.stats.dyn_vio, it) < opts.eps_dyn)
              & (take(res.stats.con_vio, it) < opts.eps_con)
              & (take(res.stats.sta_vio, it) < opts.eps_sta)
              & (take(res.stats.opt_vio, it) < opts.eps_opt))
        # Failure detection (SURVEY.md §5): NaN/exploded lanes are masked,
        # counted, and never fatal.
        bad = (~jnp.isfinite(take(res.stats.res, it))
               | ~jnp.all(jnp.isfinite(
                   res.traj.x.reshape(res.traj.x.shape[0], -1)), axis=1))
        # Cross-device reductions (NCCL collectives).
        n_ok = jax.lax.psum(jnp.sum(ok.astype(jnp.float32)), ("dp", "mc"))
        n_tot = jax.lax.psum(jnp.asarray(ok.shape[0], jnp.float32), ("dp", "mc"))
        n_bad = jax.lax.psum(jnp.sum(bad.astype(jnp.float32)), ("dp", "mc"))
        worst_dyn = jax.lax.pmax(jnp.max(take(res.stats.dyn_vio, it)),
                                 ("dp", "mc"))
        mean_iters = jax.lax.psum(jnp.sum(res.stats.iter.astype(jnp.float32)),
                                  ("dp", "mc")) / n_tot
        summary = {"converged_frac": n_ok / n_tot, "worst_dyn_vio": worst_dyn,
                   "divergence_frac": n_bad / n_tot,
                   "mean_iters": mean_iters}
        return res.traj.x, summary

    shard_fn = jax.shard_map(
        local_solve, mesh=mesh,
        in_specs=P(("dp", "mc")),
        out_specs=(P(("dp", "mc")), P()),
        check_vma=False,
    )
    return shard_fn(x0s)


def sharded_monte_carlo_jit(prob, mesh, x0s, method="schur"):
    fn = jax.jit(functools.partial(sharded_monte_carlo, prob, mesh,
                                   method=method))
    return fn(x0s)
