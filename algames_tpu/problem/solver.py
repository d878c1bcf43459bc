"""ALGAMES Newton / augmented-Lagrangian solver — fully on-device.

JAX equivalent of the reference solver driver
(``src/problem/solver_methods.jl:5-125``): the AL outer loop, the inner
quasi-Newton iteration, and the backtracking line search.  The host-side
``for``/``break`` control flow of the reference becomes ``lax.while_loop``
with predicated (masked) updates, so that

* the entire solve is one jitted computation (zero host round-trips in the
  hot loop — the device analogue of the reference's zero-allocation
  kernels),
* ``vmap`` over scenario batches is exact: each lane carries its own
  ``active`` mask and converged lanes become no-ops, reproducing the
  sequential early-``break`` semantics per scenario.

Iterate-level control flow matches the reference:

  outer k = 1..outer_iter  (``solver_methods.jl:30-62``)
    inner l = 1..inner_iter with reg = reg_0 * l^4 (``:39``)
      residual -> record stats -> early exit on opt_vio < eps_opt (``:80``)
      Jacobian + regularization -> structured solve (``:84-88``)
      backtracking line search (``:105-125``) -> update -> exit on failed LS
      or step < delta_min (``:92-98``)
    convergence gate on 4 violations (``:49-54``)
    dual ascent + penalty schedule (``:57-61``)
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constraints import sets as gcm
from ..core.traj import (PrimalDual, delta_step, init_traj, unpack_step,
                         update_traj)
from ..models.integration import rollout_rk3
from ..stats import Statistics, init_stats, record
from ..utils import pytree_dataclass
from . import residual as R
from .linear_solver import (newton_step, solve_cyclic_reduction,
                            solve_tridiagonal_schur)
from .problem import GameProblem


def _where_tree(mask, new, old):
    return jax.tree_util.tree_map(lambda a, b: jnp.where(mask, a, b), new, old)


@pytree_dataclass
class SolveResult:
    traj: PrimalDual
    gc: gcm.GameConstraints     # final AL state (duals/penalties) — warm starts
    stats: Statistics
    rho: jnp.ndarray            # final penalty schedule value


def line_search(model, spec, obj, gc, opts, traj, dtraj, res_norm, reg,
                norm_fn=None):
    """Backtracking line search (reference ``line_search``,
    ``solver_methods.jl:105-125``).  Accept alpha iff the trial mean residual
    (with Tikhonov pull toward the current iterate) improves by (1-alpha*beta).
    Returns (alpha, j, found, pd); failed iff j == ls_iter.

    With ``opts.ls_parallel = K > 0`` the first K backtracking trials are
    evaluated in ONE vectorized residual pass and the first passing trial is
    accepted — the same accept decision as the sequential loop (identical
    alpha/depth sequences; the carried trial values differ by ~1 ULP across
    K because XLA fuses the K-lane trial window differently — pinned by
    ``tests/test_ls_parallel.py``), but a vmapped batch no longer serializes
    on its deepest lane.  Trials beyond K (rare: the depth histogram of the
    flagship bench puts p99 at 2) run in the reference's sequential loop.

    ``pd`` is the :class:`~..problem.residual.PointLite` evaluated at the
    accepted trial point — the next iteration rebuilds its residual/Jacobian
    from it instead of re-evaluating (the reference recomputes,
    ``solver_methods.jl:73``); the caller completes it with the dense step
    Jacobians via :func:`~..problem.residual.point_from_lite` (trials skip
    them).  On a FAILED line search the reference steps with a final alpha
    that was never evaluated (alpha_0 * decrease^ls_iter, ~3e-8 of the
    step); the returned pd is then from the last *tested* alpha
    (alpha_0 * decrease^(ls_iter-1)), while the caller completes it with
    dense Jacobians evaluated at the final-alpha point — the rebuilt
    PointData mixes two points 3e-8*|step| apart.  Both deltas are
    O(1e-8 * |step|), affect only lanes that immediately stop (failed LS
    breaks the inner loop), and are below every convergence tolerance.
    """
    dtype = res_norm.dtype
    reg_eff = reg if opts.regularize else 0.0
    if norm_fn is None:
        norm_fn = R.residual_norm     # IBR passes the player-rows norm

    @jax.named_scope("ls_trial")
    def trial_point(alpha):
        trial = update_traj(traj, alpha, dtraj)
        pd, res_t = R.point_lite_res(model, spec, obj, gc, trial)
        # Tikhonov pull toward the current iterate (residual's reg term),
        # applied in the same op order as R.residual(reg, traj_ref).
        rx = res_t.rx + reg_eff * (trial.x[1:] - traj.x[1:])[:, None, :]
        ru = res_t.ru + reg_eff * (trial.u - traj.u)
        tn = norm_fn(spec, R.Residual(rx=rx, ru=ru, rd=res_t.rd))
        return tn, pd

    # At least one vectorized trial so the carried pd always starts defined.
    K = max(1, min(int(opts.ls_parallel), opts.ls_iter - 1))
    alphas = (opts.alpha_0
              * opts.alpha_decrease ** jnp.arange(K, dtype=dtype))
    tns, pds = jax.vmap(trial_point)(alphas)
    ok = tns <= (1.0 - alphas * opts.beta) * res_norm
    any_ok = jnp.any(ok)
    first = jnp.argmax(ok)                    # index of first passing trial
    alpha_par = alphas[first]
    j_par = (first + 1).astype(jnp.int32)
    pd_par = jax.tree_util.tree_map(lambda s: s[first], pds)
    # Sequential continuation for lanes whose first K trials all failed:
    # identical carry to the reference loop after K rejected trials.
    pd_last = jax.tree_util.tree_map(lambda s: s[K - 1], pds)
    init = (jnp.asarray(K + 1, jnp.int32),
            jnp.asarray(opts.alpha_0 * opts.alpha_decrease ** K, dtype),
            any_ok, pd_last)

    def cond(c):
        j, alpha, found, _ = c
        return (j < opts.ls_iter) & ~found

    def body(c):
        j, alpha, found, _ = c
        tn, pd_t = trial_point(alpha)
        ok = tn <= (1.0 - alpha * opts.beta) * res_norm
        return (jnp.where(ok, j, j + 1),
                jnp.where(ok, alpha, alpha * opts.alpha_decrease),
                ok, pd_t)

    j, alpha, found, pd_seq = jax.lax.while_loop(cond, body, init)
    alpha = jnp.where(any_ok, alpha_par, alpha)
    j = jnp.where(any_ok, j_par, j)
    found = found | any_ok
    pd = _where_tree(any_ok, pd_par, pd_seq)
    return alpha, j, found, pd


def _kkt_step(spec, jb, b, method):
    """Structured Newton step ``J d = -b`` (``solver_methods.jl:84-88``) by
    the named KKT method (or a callable ``(spec, JacBlocks, -b) -> [S]``)."""
    if callable(method):
        # Custom KKT solver, e.g. parallel.horizon.spike_kkt_method(mesh):
        # (spec, JacBlocks, -b [T, W]) -> flat step [S].
        dflat = method(spec, jb, -b)
    elif method == "schur":
        dflat = solve_tridiagonal_schur(spec, jb, -b)
    elif method in ("pallas", "pallas_interpret"):
        from ..ops.thomas_pallas import thomas_pallas_for_spec
        dflat = thomas_pallas_for_spec(
            spec, interpret=(method == "pallas_interpret"))(jb, -b)
    elif method == "cr":
        D, U, L = R.build_tridiagonal(spec, jb)
        dflat = solve_cyclic_reduction(spec, D, U, L, -b)
    elif method in ("tridiag", "dense"):
        D, U, L = R.build_tridiagonal(spec, jb)
        dflat = newton_step(spec, D, U, L, b, method=method)
    else:
        raise ValueError(
            f"unknown linear-solver method {method!r}; expected one of "
            "'schur', 'pallas', 'pallas_interpret', 'cr', 'tridiag', "
            "'dense'")
    return dflat


def _iteration(model, spec, obj, opts, method, gc, traj, pd, stats, outer_k,
               l, delta_prev, alpha_prev):
    """One inner quasi-Newton iteration (``solver_methods.jl:67-103``):
    fused assembly, structured KKT step, line search, masked update.

    ``pd`` is the PointData at ``traj`` (carried from the accepted
    line-search trial); residual and Jacobian are REBUILT from it under the
    current AL state — bitwise the same values as a fresh evaluation, at a
    fraction of the FLOPs.

    Returns ``(traj, pd, stats, last_vio, delta_rec, alpha_rec, stop_inner)``
    where ``stop_inner`` reproduces the reference's ``:break`` conditions.
    """
    dtype = traj.x.dtype
    reg = opts.reg_0 * ((l + 1).astype(dtype)) ** 4   # reference l^4 schedule

    # Rebuild residual + Jacobian + violations from the carried point data
    # (one constraint expansion and one dynamics-Jacobian pass TOTAL per
    # accepted point, shared with the line search that produced it).
    reg_eff = reg if opts.regularize else 0.0
    with jax.named_scope("assemble"):
        res, jb, sta_v, con_v = R.assemble_from_point(spec, obj, gc, traj,
                                                      pd, reg=reg_eff)
    res_norm = R.residual_norm(spec, res)
    dyn_v = R.dynamics_violation(res)
    opt_v = R.optimality_violation(res)
    stats = record(stats, True, outer_k + 1, res_norm, delta_prev,
                   alpha_prev, dyn_v, con_v, sta_v, opt_v)
    last_vio = jnp.stack([dyn_v, con_v, sta_v, opt_v])

    stop_opt = opt_v < opts.eps_opt

    # Structured Newton step (solver_methods.jl:84-88).
    b = R.residual_knot_blocks(spec, res)
    with jax.named_scope("kkt"):
        dflat = _kkt_step(spec, jb, b, method)
    dtraj = unpack_step(spec, dflat)

    alpha, j, found, lite = line_search(model, spec, obj, gc, opts, traj,
                                        dtraj, res_norm, reg)
    failed_ls = j >= opts.ls_iter
    traj_new = update_traj(traj, alpha, dtraj)
    delta = delta_step(dtraj, alpha)

    take_step = ~stop_opt
    traj = _where_tree(take_step, traj_new, traj)
    # Select the (small) carried lite first, then evaluate the dense step /
    # constraint Jacobians ONCE at the SELECTED point: bitwise the values a
    # select between per-branch evaluations would produce (the old pd's
    # Jacobians were themselves computed at the old traj by this same
    # function), without lane-masked selects over the [B, T, n, n]-scale
    # A/B/state_J tensors.
    lite_old = R.PointLite(rx0=pd.rx0, ru0=pd.ru0, rd=pd.rd,
                           state_c=pd.state_c, control_c=pd.control_c)
    lite_sel = _where_tree(take_step, lite, lite_old)
    pd = R.point_from_lite(model, spec, gc, lite_sel, traj)
    delta_rec = jnp.where(take_step, delta, jnp.zeros((), dtype))
    alpha_rec = jnp.where(take_step, alpha, jnp.zeros((), dtype))
    stop = stop_opt | failed_ls | (delta < opts.delta_min)
    return traj, pd, stats, last_vio, delta_rec, alpha_rec, stop


def _inner_loop(model, spec, obj, opts, method, gc, traj, pd, stats, outer_k,
                active):
    """Inner quasi-Newton loop (``solver_methods.jl:38-44, 67-103``).

    Runs while l < inner_iter and no break condition fired; all updates are
    masked so inactive (converged / failed) lanes are no-ops under vmap.
    Returns (traj, pd, stats, last_vio[4], delta_last).
    """
    dtype = traj.x.dtype
    inf = jnp.asarray(jnp.inf, dtype)

    def cond(c):
        l, stop, *_ = c
        return (l < opts.inner_iter) & ~stop

    def body(c):
        l, stop, traj, pd, stats, last_vio, delta_prev, alpha_prev = c
        traj, pd, stats, last_vio, delta_rec, alpha_rec, stop = _iteration(
            model, spec, obj, opts, method, gc, traj, pd, stats, outer_k, l,
            delta_prev, alpha_prev)
        return (l + 1, stop, traj, pd, stats, last_vio, delta_rec, alpha_rec)

    init = (jnp.asarray(0, jnp.int32), ~active, traj, pd, stats,
            jnp.full((4,), inf), jnp.zeros((), dtype),
            jnp.asarray(1.0, dtype))
    _, _, traj, pd, stats, last_vio, delta_last, _ = jax.lax.while_loop(
        cond, body, init)
    return traj, pd, stats, last_vio, delta_last


def _outer_update(opts, traj, gc, rho, last_vio, prev_cvio, active):
    """AL convergence gate + dual ascent + penalty schedule
    (``solver_methods.jl:49-61``), applied when an outer iteration completes.

    ``active`` masks lanes still inside the outer loop at a non-final outer
    index; returns ``(converged, gc, rho, prev_cvio)``.
    """
    converged = ((last_vio[0] < opts.eps_dyn) & (last_vio[1] < opts.eps_con)
                 & (last_vio[2] < opts.eps_sta) & (last_vio[3] < opts.eps_opt))
    do_update = active & ~converged
    cvio = jnp.maximum(last_vio[1], last_vio[2])
    if opts.adaptive_penalty:
        # LANCELOT-style safeguard: duals when feasibility improved enough,
        # penalties otherwise (never both).
        improved = cvio <= opts.adaptive_ratio * prev_cvio
        gc_dual = gcm.dual_update(gc, traj)
        gc_pen = gcm.penalty_update(gc)
        gc = _where_tree(do_update & improved, gc_dual, gc)
        gc = _where_tree(do_update & ~improved, gc_pen, gc)
        rho = jnp.where(do_update & ~improved,
                        jnp.minimum(rho * opts.rho_increase, opts.rho_max),
                        rho)
    else:
        gc_new = gcm.penalty_update(gcm.dual_update(gc, traj))
        gc = _where_tree(do_update, gc_new, gc)
        rho = jnp.where(do_update,
                        jnp.minimum(rho * opts.rho_increase, opts.rho_max),
                        rho)
    prev_cvio = jnp.where(do_update, cvio, prev_cvio)
    return converged, gc, rho, prev_cvio


def flat_machine(prob: GameProblem, method):
    """The flat (k, l) AL×Newton state machine as ``(cond, body, init)``.

    ``cond``/``body`` operate on ONE lane's carry (a flat tuple) and vmap
    cleanly; :func:`_solve_flat` drives them with a ``lax.while_loop``.
    ``init(traj0, pd0, gc0, stats0, rho0)`` builds the initial carry.
    Exposed as a seam for alternative batch schedulers (e.g. a
    lane-compacted FIFO pool that refills converged lanes).
    """
    spec, model, opts = prob.spec, prob.model, prob.opts
    dtype = prob.x0.dtype
    inf = jnp.asarray(jnp.inf, dtype)

    def cond(c):
        k, l, done, *_ = c
        return (k < opts.outer_iter) & ~done

    def body(c):
        (k, l, done, traj, pd, gc, rho, stats, last_vio, delta_prev,
         alpha_prev, prev_cvio, delta_fin) = c

        (traj, pd, stats, last_vio, delta_rec, alpha_rec,
         stop_inner) = _iteration(
            model, spec, obj=prob.obj, opts=opts, method=method, gc=gc,
            traj=traj, pd=pd, stats=stats, outer_k=k, l=l,
            delta_prev=delta_prev, alpha_prev=alpha_prev)
        delta_fin = delta_rec

        advance = stop_inner | (l + 1 >= opts.inner_iter)

        # Outer-iteration bookkeeping, applied only on advance.
        converged, gc_o, rho_o, prev_cvio_o = _outer_update(
            opts, traj, gc, rho, last_vio, prev_cvio,
            active=advance & (k < opts.outer_iter - 1))
        done = done | (advance & converged)
        gc = _where_tree(advance, gc_o, gc)
        rho = jnp.where(advance, rho_o, rho)
        prev_cvio = jnp.where(advance, prev_cvio_o, prev_cvio)

        k = jnp.where(advance, k + 1, k)
        l = jnp.where(advance, 0, l + 1)
        delta_prev = jnp.where(advance, jnp.zeros((), dtype), delta_rec)
        alpha_prev = jnp.where(advance, jnp.asarray(1.0, dtype), alpha_rec)
        return (k, l, done, traj, pd, gc, rho, stats, last_vio, delta_prev,
                alpha_prev, prev_cvio, delta_fin)

    def init(traj0, pd0, gc0, stats0, rho0):
        return (jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
                jnp.asarray(False), traj0, pd0, gc0, rho0, stats0,
                jnp.full((4,), inf), jnp.zeros((), dtype),
                jnp.asarray(1.0, dtype), inf, jnp.zeros((), dtype))

    return cond, body, init


def _solve_flat(prob: GameProblem, traj0, pd0, gc0, stats0, rho0, method):
    """Flattened AL×Newton loop: ONE ``lax.while_loop`` over a (k, l) state
    machine instead of nested outer/inner loops.

    Per-lane semantics are identical to the nested path (same iteration
    sequence, same floating-point ops).  The payoff is batched: JAX's
    ``while_loop`` batching rule runs every lane until the slowest lane's
    cond clears, so nested loops cost ``sum_k max_lanes(inner_trips_k)``
    body executions while the flat machine costs
    ``max_lanes(sum_k inner_trips_k)`` — strictly fewer whenever lanes hit
    their expensive Newton rounds at different outer iterations (straggler
    mitigation for the Monte-Carlo/bench batches).
    """
    opts = prob.opts
    cond, body, init = flat_machine(prob, method)

    if opts.loop_unroll > 1:
        # Run `loop_unroll` iterations per while trip.  Sub-iterations past
        # the first are guarded by a per-lane select on this lane's own
        # cond — the identical masking the while batching rule applies
        # between trips — so the per-lane state sequence is bitwise the
        # same; only the number of cond evaluations (scalar-core syncs per
        # trip under vmap) shrinks.
        body_1 = body

        def body(c):
            c = body_1(c)
            for _ in range(opts.loop_unroll - 1):
                k, l, done, *_ = c
                live = (k < opts.outer_iter) & ~done
                c = _where_tree(live, body_1(c), c)
            return c

    (k, _, done, traj, pd, gc, rho, stats, last_vio, _, _, _,
     delta_fin) = jax.lax.while_loop(
        cond, body, init(traj0, pd0, gc0, stats0, rho0))
    return k, traj, pd, gc, rho, stats, delta_fin


def newton_solve(prob: GameProblem, key=None, method: str = "schur",
                 warm: PrimalDual | None = None):
    """Full ALGAMES solve (reference ``newton_solve!``,
    ``solver_methods.jl:5-65``).  Pure function of the problem pytree;
    jit/vmap/shard_map-ready.  Returns a :class:`SolveResult`.

    ``warm`` enables the MPC warm start: the previous solution is shifted by
    ``opts.shift`` knots (``init_traj!`` s-shift semantics,
    ``src/struct/primal_dual_traj.jl:29-44``) before the RK3 rollout.
    """
    spec, model, opts = prob.spec, prob.model, prob.opts
    dtype = prob.x0.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    traj0, pd0, gc0, stats0, rho0 = solve_init(prob, key=key, warm=warm)

    if opts.flat_loop:
        k, traj, pd, gc, rho, stats, delta = _solve_flat(
            prob, traj0, pd0, gc0, stats0, rho0, method)
    else:
        def cond(c):
            k, done, *_ = c
            return (k < opts.outer_iter) & ~done

        def body(c):
            k, done, traj, pd, gc, rho, stats, _, delta, prev_cvio = c
            active = ~done
            traj, pd, stats, last_vio, delta = _inner_loop(
                model, spec, obj=prob.obj, opts=opts, method=method, gc=gc,
                traj=traj, pd=pd, stats=stats, outer_k=k, active=active)

            # Convergence gate; dual ascent + penalty schedule — skipped once
            # converged and on the final outer iteration
            # (solver_methods.jl:49-61).
            converged, gc, rho, prev_cvio = _outer_update(
                opts, traj, gc, rho, last_vio, prev_cvio,
                active=active & (k < opts.outer_iter - 1))
            done = done | converged
            return (k + 1, done, traj, pd, gc, rho, stats, last_vio, delta,
                    prev_cvio)

        init = (jnp.asarray(0, jnp.int32), jnp.asarray(False), traj0, pd0,
                gc0, rho0, stats0, jnp.full((4,), inf), jnp.zeros((), dtype),
                inf)
        k, done, traj, pd, gc, rho, stats, last_vio, delta, _ = (
            jax.lax.while_loop(cond, body, init))

    return solve_finalize(prob, k, traj, pd, gc, rho, stats, delta)


def solve_init(prob: GameProblem, key=None, warm: PrimalDual | None = None):
    """Per-lane solve setup (reference ``solver_methods.jl:12-18``): random
    small-amplitude primal-dual init + RK3 rollout, AL state reset, stats
    buffer, penalty schedule, and the PointData at the initial iterate (the
    only fresh full point evaluation outside the line search — each accepted
    line-search step hands the next iteration its PointData)."""
    spec, model, opts = prob.spec, prob.model, prob.opts
    dtype = prob.x0.dtype
    traj0 = init_traj(spec, prob.x0, key=key, amplitude=opts.amplitude_init,
                      shift=opts.shift, prev=warm)
    traj0 = PrimalDual(x=rollout_rk3(model, prob.x0, traj0.u, spec.dt),
                       u=traj0.u, lam=traj0.lam)
    gc0 = gcm.reset_constraints(prob.gc) if opts.dual_reset else prob.gc
    stats0 = init_stats(opts.outer_iter * opts.inner_iter + 1, dtype)
    rho0 = jnp.asarray(opts.rho_0, dtype)
    pd0 = R.point_data(model, spec, prob.obj, gc0, traj0)
    return traj0, pd0, gc0, stats0, rho0


def solve_finalize(prob: GameProblem, k, traj, pd, gc, rho, stats, delta):
    """Final record at the solution (``solver_methods.jl:64``) — rebuilt
    from the carried point data (bitwise what a fresh evaluation would
    produce); wraps everything into a :class:`SolveResult`."""
    spec = prob.spec
    dtype = prob.x0.dtype
    res = R.residual_from_point(spec, gc, pd)
    res_norm = R.residual_norm(spec, res)
    dyn_v = R.dynamics_violation(res)
    opt_v = R.optimality_violation(res)
    sta_v, con_v = R.point_violations(gc, pd)
    stats = record(stats, True, k, res_norm, delta,
                   jnp.asarray(1.0, dtype), dyn_v, con_v, sta_v, opt_v)
    return SolveResult(traj=traj, gc=gc, stats=stats, rho=rho)


@functools.partial(jax.jit, static_argnames=("method",))
def newton_solve_jit(prob: GameProblem, key=None, method: str = "schur"):
    return newton_solve(prob, key=key, method=method)
