"""Iterative best response (IBR) solver.

JAX equivalent of the reference IBR path
(``src/problem/solver_methods.jl:133-289``, ``ibr_*`` assembly at
``global_quantities.jl:199-365``): Gauss-Seidel over players, each player
solving his own optimal-control problem with the other players' strategies
frozen.  The reference selects the sub-KKT system with row/column masks and
runs a sub-LU (``solver_methods.jl:249-250``); here the per-player subproblem
is a p=1 instance of the SAME structure the main solver factors

  v_t = [x_{t+1} (n) | u_{i,t} (mi) | lam_{i,t} (n)],  W_i = 2n + mi

so the per-player solve reuses the main solver's machinery wholesale:
the Schur-condensed block-Thomas sweep (`-I` multiplier pivots,
an (n+mi)-size reduced solve per knot), the PointData carry (one constraint/
dynamics-Jacobian evaluation per accepted point), and the K-parallel line
search restricted to the player's residual rows — no dynamic-size masking,
just static slices of the full Jacobian ingredients.

Deviation from the reference noted for the record: the reference's stopping
flag ``Δ_change[i] = !(Δ_min > maximum(stats.Δ_traj))`` maxes over the whole
accumulated history (``solver_methods.jl:155``), which can never re-arm once
any past step was large; we use the documented intent — the max step of the
player's *latest* solve — which is what the surrounding comment describes.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constraints import sets as gcm
from ..core.spec import ProblemSpec
from ..core.traj import PrimalDual, delta_step, init_traj, update_traj
from ..models.integration import rollout_rk3
from ..stats import init_stats, record
from ..utils import pytree_dataclass
from . import residual as R
from .linear_solver import solve_tridiagonal_schur
from .options import IBROptions
from .problem import GameProblem
from .solver import SolveResult, _where_tree, line_search


def player_block_width(spec: ProblemSpec, i: int) -> int:
    return 2 * spec.n + spec.mi[i]


def player_residual_blocks(spec: ProblemSpec, res: R.Residual, i: int):
    """Player i's rows of the residual in per-knot order [T, W_i]
    (the ``res[vmask]`` selection, reference ``newton_core.jl:205-250``)."""
    pu = np.asarray(spec.pu[i])
    return jnp.concatenate([res.rx[:, i], res.ru[:, pu], res.rd], axis=1)


def player_residual_norm(spec: ProblemSpec, res: R.Residual, i: int):
    """Mean 1-norm over player i's rows (ibr res_norm,
    ``solver_methods.jl:233``)."""
    b = player_residual_blocks(spec, res, i)
    return jnp.sum(jnp.abs(b)) / b.size


def unpack_player_step(spec: ProblemSpec, i: int, flat: jnp.ndarray,
                       dtype) -> PrimalDual:
    """Scatter the per-player flat step into a full PrimalDual (zeros for the
    other players' controls and multipliers)."""
    T, n, m, p = spec.T, spec.n, spec.m, spec.p
    mi = spec.mi[i]
    Wi = player_block_width(spec, i)
    pu = np.asarray(spec.pu[i])
    blocks = flat.reshape(T, Wi)
    dx = jnp.concatenate([jnp.zeros((1, n), dtype), blocks[:, :n]], axis=0)
    du = jnp.zeros((T, m), dtype).at[:, pu].set(blocks[:, n:n + mi])
    dlam = jnp.zeros((p, T, n), dtype).at[i].set(blocks[:, n + mi:])
    return PrimalDual(x=dx, u=du, lam=dlam)


def player_violations(spec, gc, pd: R.PointData, res, i):
    """Per-player violation maxima (reference per-i violation variants,
    ``src/struct/violations.jl:27-37, 69-80, 123-138, 170-183``), from the
    CARRIED constraint values — no fresh kernel evaluations."""
    pz = np.asarray(spec.pz[i])
    pu = np.asarray(spec.pu[i])
    dyn_v = jnp.max(jnp.abs(res.rd[:, pz]))
    opt_v = jnp.maximum(jnp.max(jnp.abs(res.rx[:, i])),
                        jnp.max(jnp.abs(res.ru[:, pu])))
    dtype = res.rd.dtype
    sta_v = jnp.zeros((), dtype)
    for b, c in zip(gc.state_blocks, pd.state_c):
        if b.owner == i:
            sta_v = jnp.maximum(sta_v, jnp.maximum(jnp.max(c), 0.0))
    con_v = jnp.zeros((), dtype)
    for b, c in zip(gc.control_blocks, pd.control_c):
        con_v = jnp.maximum(con_v, jnp.maximum(jnp.max(c), 0.0))
    return dyn_v, con_v, sta_v, opt_v


class _PlayerSpec:
    """Per-player sub-spec shim: the player sub-KKT is a p=1 game with
    control width mi, so ``solve_tridiagonal_schur`` — or the fused sweep
    kernel via ``thomas_pallas_for_spec`` — factors it with the same -I
    multiplier pivots as the main path.
    Hashable by value so the per-spec kernel cache
    (``thomas_pallas_for_spec``'s lru_cache) is shared across traces."""

    def __init__(self, spec: ProblemSpec, i: int):
        self.T, self.n, self.p = spec.T, spec.n, 1
        self.m = spec.mi[i]
        self.mi = (spec.mi[i],)
        self.pu = (tuple(range(spec.mi[i])),)
        self.W = 2 * spec.n + spec.mi[i]
        self.homogeneous = True

    def _key(self):
        return (self.T, self.n, self.m)

    def __eq__(self, other):
        return (isinstance(other, _PlayerSpec)
                and self._key() == other._key())

    def __hash__(self):
        return hash(("_PlayerSpec",) + self._key())


def player_jac_blocks(spec: ProblemSpec, jb: R.JacBlocks, i: int):
    """Player i's slice of the Jacobian ingredients as a p=1 JacBlocks."""
    pu = np.asarray(spec.pu[i])
    return R.JacBlocks(
        Qblk=jb.Qblk[:, i:i + 1],
        Ublk=jb.Ublk[:, pu[:, None], pu[None, :]],
        A=jb.A, B=jb.B[:, :, pu])


def _ibr_player_solve(prob: GameProblem, traj, gc, stats, i: int, active,
                      method: str = "schur"):
    """Per-player AL solve with others frozen — same skeleton AND machinery
    as ``newton_solve`` (reference ``ibr_newton_solve!(prob, i)``,
    ``solver_methods.jl:168-225``): PointData carried across iterations (one
    constraint/dynamics-Jacobian evaluation per accepted point), the K-parallel first trials of the main line search restricted to
    player i's residual rows, and the player-Schur elimination on the p=1
    sub-KKT.  ``method='pallas'`` routes the KKT step through the fused
    sweep kernel: under ``vmap`` over scenarios the batch becomes the
    kernel's grid, exactly like the main path.  Stats rows record
    the player's true AL epoch in the ``outer`` column (reference
    ``solver_methods.jl:218``).
    Returns (traj, gc, stats, max_delta)."""
    spec, model, opts, obj = prob.spec, prob.model, prob.opts, prob.obj
    dtype = traj.x.dtype
    inf = jnp.asarray(jnp.inf, dtype)
    spec_i = _PlayerSpec(spec, i)
    if method in ("pallas", "pallas_interpret"):
        from ..ops.thomas_pallas import thomas_pallas_for_spec
        kkt_solve = thomas_pallas_for_spec(
            spec_i, interpret=(method == "pallas_interpret"))
    else:
        kkt_solve = functools.partial(solve_tridiagonal_schur, spec_i)

    if opts.dual_reset:
        gc = gcm.reset_constraints(gc)
        traj = PrimalDual(x=traj.x, u=traj.u, lam=jnp.zeros_like(traj.lam))
    # One fresh full evaluation per player solve; every inner iteration and
    # line-search trial reuses/extends it.
    pd = R.point_data(model, spec, obj, gc, traj)

    def norm_i(spec_, res_):
        return player_residual_norm(spec_, res_, i)

    def inner_cond(c):
        l, stop, *_ = c
        return (l < opts.inner_iter) & ~stop

    def make_inner(gc, k):
        def inner_body(c):
            l, stop, traj, pd, stats, last_vio, max_delta = c
            reg = opts.reg_0 * ((l + 1).astype(dtype)) ** 4
            reg_eff = reg if opts.regularize else 0.0
            res, jb, _, _ = R.assemble_from_point(spec, obj, gc, traj, pd,
                                                  reg=reg_eff)
            res_norm = player_residual_norm(spec, res, i)
            dyn_v, con_v, sta_v, opt_v = player_violations(spec, gc, pd,
                                                           res, i)
            stats = record(stats, True, k + 1, res_norm, max_delta,
                           jnp.asarray(1.0, dtype), dyn_v, con_v, sta_v,
                           opt_v)
            last_vio = jnp.stack([dyn_v, con_v, sta_v, opt_v])
            stop_opt = opt_v < opts.eps_opt

            b = player_residual_blocks(spec, res, i)
            dflat = kkt_solve(player_jac_blocks(spec, jb, i), -b)
            dtraj = unpack_player_step(spec, i, dflat, dtype)

            alpha, j, found, lite = line_search(
                model, spec, obj, gc, opts, traj, dtraj, res_norm, reg,
                norm_fn=norm_i)
            failed_ls = j >= opts.ls_iter
            traj_new = update_traj(traj, alpha, dtraj)
            delta = delta_step(dtraj, alpha)
            take = ~stop_opt
            traj = _where_tree(take, traj_new, traj)
            # Same select-lite-then-evaluate order as the main solver: no
            # lane-masked selects over the dense Jacobian tensors.
            lite_old = R.PointLite(rx0=pd.rx0, ru0=pd.ru0, rd=pd.rd,
                                   state_c=pd.state_c,
                                   control_c=pd.control_c)
            lite_sel = _where_tree(take, lite, lite_old)
            pd = R.point_from_lite(model, spec, gc, lite_sel, traj)
            max_delta = jnp.where(take, jnp.maximum(max_delta, delta),
                                  max_delta)
            stop = stop_opt | failed_ls | (delta < opts.delta_min)
            return (l + 1, stop, traj, pd, stats, last_vio, max_delta)
        return inner_body

    def outer_cond(c):
        k, done, *_ = c
        return (k < opts.outer_iter) & ~done

    def outer_body(c):
        k, done, traj, pd, gc, stats, max_delta = c
        l0 = (jnp.asarray(0, jnp.int32), ~(active & ~done), traj, pd, stats,
              jnp.full((4,), inf), max_delta)
        _, _, traj, pd, stats, last_vio, max_delta = jax.lax.while_loop(
            inner_cond, make_inner(gc, k), l0)
        converged = ((last_vio[0] < opts.eps_dyn)
                     & (last_vio[1] < opts.eps_con)
                     & (last_vio[2] < opts.eps_sta)
                     & (last_vio[3] < opts.eps_opt))
        done = done | converged
        do_update = active & ~converged & (k < opts.outer_iter - 1)
        gc_new = gcm.penalty_update(gcm.dual_update(gc, traj))
        gc = _where_tree(do_update, gc_new, gc)
        return (k + 1, done, traj, pd, gc, stats, max_delta)

    init = (jnp.asarray(0, jnp.int32), ~active, traj, pd, gc, stats,
            jnp.zeros((), dtype))
    _, _, traj, pd, gc, stats, max_delta = jax.lax.while_loop(
        outer_cond, outer_body, init)
    return traj, gc, stats, max_delta


def ibr_newton_solve_player(prob: GameProblem, i: int, key=None,
                            method: str = "schur") -> SolveResult:
    """Solve only player i's problem with the others frozen at the initial
    guess (reference ``ibr_newton_solve!(prob, i)``,
    ``solver_methods.jl:168-225``, as exercised by the p=1 IBR tests)."""
    spec, model, opts = prob.spec, prob.model, prob.opts
    dtype = prob.x0.dtype
    traj0 = init_traj(spec, prob.x0, key=key, amplitude=opts.amplitude_init,
                      shift=opts.shift)
    traj0 = PrimalDual(x=rollout_rk3(model, prob.x0, traj0.u, spec.dt),
                       u=traj0.u, lam=traj0.lam)
    gc0 = gcm.reset_constraints(prob.gc) if opts.dual_reset else prob.gc
    stats0 = init_stats(opts.outer_iter * opts.inner_iter + 1, dtype)
    traj, gc, stats, _ = _ibr_player_solve(prob, traj0, gc0, stats0, i,
                                           jnp.asarray(True), method=method)
    res = R.residual(model, spec, prob.obj, gc, traj)
    stats = record(stats, True, opts.outer_iter,
                   R.residual_norm(spec, res), jnp.zeros((), dtype),
                   jnp.asarray(1.0, dtype), R.dynamics_violation(res),
                   jnp.zeros((), dtype), jnp.zeros((), dtype),
                   R.optimality_violation(res))
    return SolveResult(traj=traj, gc=gc, stats=stats,
                       rho=jnp.asarray(opts.rho_0, dtype))


def ibr_newton_solve(prob: GameProblem, ibr_opts: IBROptions = IBROptions(),
                     key=None, method: str = "schur") -> SolveResult:
    """Gauss-Seidel IBR driver (reference ``ibr_newton_solve!``,
    ``solver_methods.jl:133-166``): cycle players in ``ordering`` until no
    player's latest solve moved more than ``Δ_min``.  ``method`` selects the
    per-player KKT engine (``'schur'`` XLA scan, or ``'pallas'`` — the
    fused sweep kernel, the GPU path for vmapped batches)."""
    spec, model, opts = prob.spec, prob.model, prob.opts
    dtype = prob.x0.dtype
    p = spec.p
    ordering = [o for o in ibr_opts.ordering if o < p][:p]

    traj0 = init_traj(spec, prob.x0, key=key, amplitude=opts.amplitude_init,
                      shift=opts.shift)
    traj0 = PrimalDual(x=rollout_rk3(model, prob.x0, traj0.u, spec.dt),
                       u=traj0.u, lam=traj0.lam)
    gc0 = gcm.reset_constraints(prob.gc) if opts.dual_reset else prob.gc
    cap = ibr_opts.ibr_iter * p * opts.outer_iter * opts.inner_iter + 1
    # Cap stats capacity: one record per inner iteration is too large for
    # ibr_iter=100; keep the last solve per player recorded compactly.
    cap = min(cap, 4096)
    stats0 = init_stats(cap, dtype)

    def cond(c):
        q, done, *_ = c
        return (q < ibr_opts.ibr_iter) & ~done

    def body(c):
        q, done, traj, gc, stats, _ = c
        active = ~done
        changed = []
        for i in ordering:
            traj, gc, stats, max_delta = _ibr_player_solve(
                prob, traj, gc, stats, i, active, method=method)
            changed.append(max_delta >= ibr_opts.delta_min)
        moved = jnp.stack(changed).any()
        done = done | ~moved
        return (q + 1, done, traj, gc, stats, moved)

    init = (jnp.asarray(0, jnp.int32), jnp.asarray(False), traj0, gc0,
            stats0, jnp.asarray(True))
    q, done, traj, gc, stats, _ = jax.lax.while_loop(cond, body, init)

    res = R.residual(model, spec, prob.obj, gc, traj)
    res_norm = R.residual_norm(spec, res)
    stats = record(stats, True, q, res_norm, jnp.zeros((), dtype),
                   jnp.asarray(1.0, dtype),
                   R.dynamics_violation(res), jnp.zeros((), dtype),
                   jnp.zeros((), dtype), R.optimality_violation(res))
    return SolveResult(traj=traj, gc=gc, stats=stats,
                       rho=jnp.asarray(opts.rho_0, dtype))


ibr_newton_solve_jit = jax.jit(ibr_newton_solve,
                               static_argnames=("ibr_opts", "method"))
