"""Scenario-batch solving: vmap over initial conditions / targets / penalties.

This is the capability layer the reference lacks entirely (SURVEY.md §2.3):
the whole solver is a pure function, so a Monte-Carlo sweep over thousands of
scenarios is a single ``vmap`` — one compiled program, with the batch as the
parallel axis of every block solve.
"""
from __future__ import annotations



import jax
import jax.numpy as jnp

from ..problem.problem import GameProblem
from ..problem.solver import newton_solve


def solve_batch(prob: GameProblem, x0s: jnp.ndarray, method: str = "schur",
                keys=None):
    """Solve one game per row of ``x0s`` [B, n]; returns stacked SolveResult."""
    def one(x0, key):
        p = GameProblem(spec=prob.spec, model=prob.model, opts=prob.opts,
                        x0=x0, obj=prob.obj, gc=prob.gc)
        return newton_solve(p, key=key, method=method)

    if keys is None:
        return jax.vmap(lambda x: one(x, None))(x0s)
    return jax.vmap(one)(x0s, keys)


solve_batch_jit = jax.jit(solve_batch, static_argnames=("method",))


def solve_many(prob: GameProblem, x0s: jnp.ndarray, method: str = "schur",
               keys=None, chunk: int | None = None, unroll: int = 1,
               reduce=None):
    """Memory-bounded scenario sweep with the chunk loop ON DEVICE.

    ``solve_batch`` over N scenarios at once holds every lane's solver state
    live simultaneously and runs each ``while_loop`` trip over all N lanes
    (max-over-lanes straggler semantics).  ``solve_many`` splits the sweep
    into ``ceil(N / chunk)`` chunks of ``chunk`` lanes and runs them
    sequentially *inside* the jitted computation via ``lax.scan`` (with a
    ``None`` carry; ``unroll`` bodies per scan step) — ONE device dispatch
    for the whole sweep.  A host-side chunk loop pays a dispatch per chunk
    and leaves the device idle between dispatches; the on-device loop runs
    the chunks back to back.

    Per-chunk results are bitwise identical to ``solve_batch`` on the same
    chunk (same vmapped program, scanned).  N is padded to a multiple of
    ``chunk`` with copies of row 0 and trimmed from the result, so any N
    works.  ``chunk=None`` (or >= N) degenerates to one ``solve_batch``.
    ``unroll``: chunk solves per scan step (``lax.scan`` unrolling) —
    amortizes the scan-step boundary.  Chunks stay independent, so any
    value is exact.

    Returns a stacked :class:`~..problem.solver.SolveResult` with leading
    axis N — all chunks' results live in device memory at once (a few KB per lane).
    For sweeps too large to keep every result, pass ``reduce``: a function
    applied to each chunk's SolveResult on device; only its outputs are
    materialized, stacked with the CHUNK index as the leading axis
    (``[ceil(N/chunk), ...]`` — in the degenerate single-``solve_batch``
    case the leading axis is 1).  There is no tail trimming: when
    ``chunk`` does not divide N, the final chunk is ceil-padded with
    copies of row 0, and those padded lanes ARE included in that chunk's
    reduction — lane-aggregating reductions (means, convergence
    fractions) must account for this, e.g. by reducing with sums/counts
    and subtracting the known pad contribution, or by choosing
    ``chunk | N``.  E.g.
    ``reduce=lambda r: (r.traj.x, r.stats.iter)`` keeps trajectories and
    iteration counts but drops duals/stats — a million-scenario sweep then
    needs MBs, not GBs, and stays one dispatch.
    """
    N = x0s.shape[0]
    if chunk is None or chunk >= N:
        out = solve_batch(prob, x0s, method=method, keys=keys)
        if reduce is not None:
            # Leading chunk axis of 1, matching the chunked path's [C, ...].
            return jax.tree_util.tree_map(lambda a: a[None], reduce(out))
        return out
    C = -(-N // chunk)                       # ceil
    pad = C * chunk - N

    def _chunked(a):
        if pad:
            a = jnp.concatenate([a, jnp.broadcast_to(a[:1],
                                                     (pad,) + a.shape[1:])])
        return a.reshape((C, chunk) + a.shape[1:])

    def _scan(f, xs):
        g = f if reduce is None else (lambda x: reduce(f(x)))
        return jax.lax.scan(lambda c, x: (c, g(x)), None, xs,
                            unroll=unroll)[1]

    xs = _chunked(x0s)
    if keys is None:
        out = _scan(lambda x: solve_batch(prob, x, method=method), xs)
    else:
        out = _scan(
            lambda xk: solve_batch(prob, xk[0], method=method, keys=xk[1]),
            (xs, _chunked(keys)))
    if reduce is not None:
        return out                     # [C, ...] per-chunk reductions
    return jax.tree_util.tree_map(
        lambda a: a.reshape((C * chunk,) + a.shape[2:])[:N], out)


solve_many_jit = jax.jit(
    solve_many, static_argnames=("method", "chunk", "unroll", "reduce"))


def divergence_mask(result) -> jnp.ndarray:
    """Per-lane divergence flags for a batched SolveResult (SURVEY.md §5:
    the batched analogue of failure detection — NaN/exploding lanes are
    masked, not fatal).  True where the final residual is non-finite or the
    trajectory contains non-finite values."""
    it = jnp.maximum(result.stats.iter - 1, 0)
    final_res = jax.vmap(lambda a, i: a[i])(result.stats.res, it)
    bad_res = ~jnp.isfinite(final_res)
    bad_traj = ~jnp.all(jnp.isfinite(
        result.traj.x.reshape(result.traj.x.shape[0], -1)), axis=1)
    return bad_res | bad_traj


def convergence_fraction(result, opts) -> jnp.ndarray:
    """Fraction of lanes whose final violations meet the tolerances."""
    it = result.stats.iter
    idx = jnp.maximum(it - 1, 0)
    take = jax.vmap(lambda a, i: a[i])
    ok = ((take(result.stats.dyn_vio, idx) < opts.eps_dyn)
          & (take(result.stats.con_vio, idx) < opts.eps_con)
          & (take(result.stats.sta_vio, idx) < opts.eps_sta)
          & (take(result.stats.opt_vio, idx) < opts.eps_opt))
    return jnp.mean(ok.astype(jnp.float32))
