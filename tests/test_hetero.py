"""Heterogeneous per-player dimensions (reference capability:
``src/core/newton_core.jl:40-89`` indexes per-player mi/ni throughout).

The synthetic HeteroDoubleIntegratorGame (player 0: mi=2, player 1: mi=1)
must lay out, assemble, and solve end-to-end through the mi-agnostic
dense/tridiag/cr paths; the player-stacked schur/pallas fast paths must
refuse with a clear error.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import algames_tpu as ag
from algames_tpu.core.traj import pack_traj, unpack_step
from algames_tpu.problem import residual as R


def _spec(mi=(2, 1), N=8):
    model = ag.hetero_double_integrator_game(mi=mi)
    return model, ag.spec_from_model(model, N, 0.1)


def _prob(mi=(2, 1), N=8):
    model, spec = _spec(mi, N)
    p = len(mi)
    obj = ag.game_objective(
        spec,
        Q=[jnp.ones(4)] * p,
        R=[0.1 * jnp.ones(spec.mi[i]) for i in range(p)],
        xf=[jnp.asarray([1.0, 0.4 * (p - 1 - i), 0.0, 0.0]) for i in range(p)],
        uf=[jnp.zeros(spec.mi[i]) for i in range(p)],
        dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, 0.15)
    gc = ag.add_control_bound(spec, gc, 2 * jnp.ones(spec.m),
                              -2 * jnp.ones(spec.m))
    # blocked layout: [x0 y0 vx0 vy0 | x1 y1 vx1 vy1]
    x0 = jnp.asarray([0.0, 0.0, 0.0, 0.0, 0.0, 0.4, 0.0, 0.0])
    opts = ag.Options(outer_iter=7, inner_iter=20)
    return ag.game_problem(N, 0.1, x0, model, opts, obj, gc), spec


def test_layout_partition_mixed_mi():
    """Row/column offset blocks exactly partition 0..S-1 at mixed mi
    (reference test/core/newton_core.jl:18-41 generalized)."""
    _, spec = _spec(mi=(2, 1), N=6)
    assert spec.S == spec.T * spec.W and spec.m == 3
    assert not spec.homogeneous
    covered = np.zeros(spec.S, dtype=int)
    for i in range(spec.p):
        for k in range(spec.T):
            r = spec.row_stat_x(i, k)
            covered[r:r + spec.n] += 1
            r = spec.row_stat_u(i, k)
            covered[r:r + spec.mi[i]] += 1
    for k in range(spec.T):
        r = spec.row_dyn(k)
        covered[r:r + spec.n] += 1
    assert np.all(covered == 1)


def test_jacobian_equals_autodiff_mixed_mi():
    """Linear dynamics + control bounds + zero duals: the assembled KKT
    Jacobian equals the exact autodiff Jacobian at mixed mi."""
    model, spec = _spec(mi=(2, 1), N=5)
    p = spec.p
    obj = ag.game_objective(
        spec, Q=[jnp.ones(4) + 0.3] * p,
        R=[0.5 * jnp.ones(spec.mi[i]) for i in range(p)],
        xf=[jnp.ones(4)] * p, uf=[jnp.zeros(spec.mi[i]) for i in range(p)],
        dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_control_bound(spec, gc, 0.2 * jnp.ones(spec.m),
                              -0.2 * jnp.ones(spec.m))
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    traj = ag.PrimalDual(
        x=jax.random.normal(ks[0], (spec.N, spec.n), jnp.float64),
        u=jax.random.normal(ks[1], (spec.T, spec.m), jnp.float64),
        lam=jax.random.normal(ks[2], (spec.p, spec.T, spec.n), jnp.float64))
    x0 = traj.x[0]

    def f(v):
        tr = unpack_step(spec, v)
        tr = ag.PrimalDual(x=tr.x.at[0].set(x0), u=tr.u, lam=tr.lam)
        return R.flatten_residual(spec, R.residual(model, spec, obj, gc, tr))

    J_ad = jax.jacfwd(f)(pack_traj(spec, traj))
    jb = R.jacobian_blocks(model, spec, obj, gc, traj)
    J_as = R.flatten_jacobian(spec, jb)
    np.testing.assert_allclose(np.asarray(J_as), np.asarray(J_ad),
                               rtol=1e-10, atol=1e-10)
    # the knot-blocked tridiagonal path assembles/solves the same operator
    from algames_tpu.problem.linear_solver import (solve_cyclic_reduction,
                                                   solve_dense,
                                                   solve_tridiagonal,
                                                   solve_tridiagonal_schur)
    D, U, L = R.build_tridiagonal(spec, jb)
    b = jax.random.normal(jax.random.PRNGKey(7), (spec.T, spec.W),
                          jnp.float64)
    y_d = solve_dense(spec, D, U, L, b)
    for solve in (solve_tridiagonal, solve_cyclic_reduction):
        y = solve(spec, D, U, L, b)
        np.testing.assert_allclose(np.asarray(y), np.asarray(y_d),
                                   rtol=1e-8, atol=1e-8)


def test_hetero_solve_matches_dense_oracle():
    """Full Newton/AL solve at mixed mi: every structured method — including
    the pad-and-mask schur/pallas fast paths — matches the
    dense oracle and converges to the reference tolerances."""
    prob, spec = _prob()
    ref = ag.newton_solve_jit(prob, method="dense")
    it = int(ref.stats.iter)
    vio = {k: float(getattr(ref.stats, k)[it - 1])
           for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")}
    assert all(v < 1e-3 for v in vio.values()), vio
    for method in ("tridiag", "cr", "schur", "pallas_interpret"):
        out = ag.newton_solve_jit(prob, method=method)
        np.testing.assert_allclose(np.asarray(out.traj.x),
                                   np.asarray(ref.traj.x),
                                   rtol=0, atol=1e-8)


def test_hetero_schur_pallas_kkt_oracle():
    """KKT-level: the padded schur sweep and Pallas kernel reproduce the
    dense-oracle step at a random iterate with ragged mi=(2, 1)."""
    from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
    from algames_tpu.problem.linear_solver import (solve_dense,
                                                   solve_tridiagonal_schur)

    prob, spec = _prob()
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 3)
    traj = ag.PrimalDual(
        x=0.3 * jax.random.normal(ks[0], (spec.N, spec.n), jnp.float64),
        u=0.3 * jax.random.normal(ks[1], (spec.T, spec.m), jnp.float64),
        lam=0.3 * jax.random.normal(ks[2], (spec.p, spec.T, spec.n),
                                    jnp.float64))
    res, jb, _, _ = R.assemble(prob.model, spec, prob.obj, prob.gc, traj,
                               reg=1e-3)
    b = R.residual_knot_blocks(spec, res)
    D, U, L = R.build_tridiagonal(spec, jb)
    y_or = np.asarray(solve_dense(spec, D, U, L, -b))
    scale = np.abs(y_or).max()
    y_s = np.asarray(solve_tridiagonal_schur(spec, jb, -b))
    np.testing.assert_allclose(y_s, y_or, rtol=0, atol=1e-10 * scale)
    jb1 = jax.tree_util.tree_map(lambda x: x[None], jb)
    y_p = np.asarray(solve_thomas_pallas(spec, jb1, -b[None],
                                         interpret=True))[0]
    np.testing.assert_allclose(y_p, y_or, rtol=0, atol=1e-10 * scale)
