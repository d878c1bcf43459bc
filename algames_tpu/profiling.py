"""Device profiling helpers.

JAX upgrade of the reference's per-iteration ``@elapsed`` timing
(``src/problem/solver_methods.jl:40-41``): host-side wall timers around
blocked device computations, plus a ``jax.profiler`` trace context for
kernel-level inspection in TensorBoard/XProf.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict

import jax


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a jax.profiler device trace into ``logdir``."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def time_blocked(fn: Callable, *args, reps: int = 10, warmup: int = 1,
                 **kwargs) -> float:
    """Median wall seconds of ``fn(*args)`` with ``block_until_ready``."""
    for _ in range(warmup):
        out = fn(*args, **kwargs)
    jax.block_until_ready(out)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        jax.block_until_ready(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]


def phase_profile(phases: Dict[str, Callable], reps: int = 10) -> Dict[str, float]:
    """Time a dict of thunks; returns {name: median_seconds}."""
    return {name: time_blocked(fn, reps=reps) for name, fn in phases.items()}


def timed_solve(prob, method: str = "schur", key=None):
    """Per-iteration wall-timed solve — the reference's ``Statistics.t_elap``
    (``src/problem/solver_methods.jl:40-41``, ``src/struct/statistics.jl:8``)
    as a diagnostic mode.

    Runs the SAME flat (k, l) iteration state machine as ``newton_solve``
    with the default ``opts.flat_loop=True`` (identical per-iteration math —
    the bitwise-equality claim in ``tests/test_aux.py`` is against that
    path; with ``flat_loop=False`` ``newton_solve`` takes the nested
    outer/inner loops instead, whose per-lane iterate sequence is the same
    but whose loop-carried structure is not what this driver replays), but
    drives the loop from the host with one jitted iteration per step so each
    inner iteration's wall time can be recorded.  One dispatch + one host
    sync per iteration: use for diagnostics, not throughput.

    Returns ``(SolveResult, t_elap)`` with ``t_elap`` a list of seconds, one
    entry per executed inner iteration (first entry includes nothing of the
    compile — the step function is compiled before timing starts).
    """
    import functools

    import jax.numpy as jnp

    from .constraints import sets as gcm
    from .core.traj import PrimalDual, init_traj
    from .models.integration import rollout_rk3
    from .problem import solver as S
    from .problem import residual as R
    from .stats import init_stats, record

    spec, model, opts = prob.spec, prob.model, prob.opts
    dtype = prob.x0.dtype
    inf = jnp.asarray(jnp.inf, dtype)

    traj0 = init_traj(spec, prob.x0, key=key, amplitude=opts.amplitude_init,
                      shift=opts.shift, prev=None)
    traj0 = PrimalDual(x=rollout_rk3(model, prob.x0, traj0.u, spec.dt),
                       u=traj0.u, lam=traj0.lam)
    gc0 = gcm.reset_constraints(prob.gc) if opts.dual_reset else prob.gc
    stats0 = init_stats(opts.outer_iter * opts.inner_iter + 1, dtype)
    pd0 = R.point_data(model, spec, prob.obj, gc0, traj0)

    @functools.partial(jax.jit, static_argnames=())
    def step(carry):
        (k, l, done, traj, pd, gc, rho, stats, last_vio, delta_prev,
         alpha_prev, prev_cvio, delta_fin) = carry
        (traj, pd, stats, last_vio, delta_rec, alpha_rec,
         stop_inner) = S._iteration(
            model, spec, obj=prob.obj, opts=opts, method=method, gc=gc,
            traj=traj, pd=pd, stats=stats, outer_k=k, l=l,
            delta_prev=delta_prev, alpha_prev=alpha_prev)
        delta_fin = delta_rec
        advance = stop_inner | (l + 1 >= opts.inner_iter)
        converged, gc_o, rho_o, prev_cvio_o = S._outer_update(
            opts, traj, gc, rho, last_vio, prev_cvio,
            active=advance & (k < opts.outer_iter - 1))
        done = done | (advance & converged)
        gc = S._where_tree(advance, gc_o, gc)
        rho = jnp.where(advance, rho_o, rho)
        prev_cvio = jnp.where(advance, prev_cvio_o, prev_cvio)
        k = jnp.where(advance, k + 1, k)
        l = jnp.where(advance, 0, l + 1)
        delta_prev = jnp.where(advance, jnp.zeros((), dtype), delta_rec)
        alpha_prev = jnp.where(advance, jnp.asarray(1.0, dtype), alpha_rec)
        return (k, l, done, traj, pd, gc, rho, stats, last_vio, delta_prev,
                alpha_prev, prev_cvio, delta_fin)

    carry = (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(False), traj0, pd0, gc0,
             jnp.asarray(opts.rho_0, dtype), stats0, jnp.full((4,), inf),
             jnp.zeros((), dtype), jnp.asarray(1.0, dtype), inf,
             jnp.zeros((), dtype))
    _ = jax.block_until_ready(step(carry))     # compile outside the timers

    t_elap = []
    while (int(carry[0]) < opts.outer_iter) and not bool(carry[2]):
        t0 = time.perf_counter()
        carry = step(carry)
        jax.block_until_ready(carry[3].x)
        t_elap.append(time.perf_counter() - t0)

    (k, _, done, traj, pd, gc, rho, stats, last_vio, _, _, _, delta) = carry
    res = R.residual_from_point(spec, gc, pd)
    res_norm = R.residual_norm(spec, res)
    sta_v, con_v = R.point_violations(gc, pd)
    stats = record(stats, True, k, res_norm, delta, jnp.asarray(1.0, dtype),
                   R.dynamics_violation(res), con_v, sta_v,
                   R.optimality_violation(res))
    return S.SolveResult(traj=traj, gc=gc, stats=stats, rho=rho), t_elap
