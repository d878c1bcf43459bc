"""IBR solver oracles (mirrors reference test IBR section,
test/problem/solver_methods.jl:185-315)."""
import jax.numpy as jnp

import algames_tpu as ag
from algames_tpu.problem.ibr import ibr_newton_solve, ibr_newton_solve_player
from algames_tpu.problem.options import IBROptions


def _mk(model, p, **kw):
    N, dt = 20, 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec, [jnp.ones(model.ni[i]) for i in range(p)],
        [0.5 * jnp.ones(model.mi[i]) for i in range(p)],
        [jnp.zeros(model.ni[i]) for i in range(p)],
        [-jnp.ones(model.mi[i]) for i in range(p)], dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    opts = ag.Options(reg_0=1e-7, eps_dyn=1e-10, eps_opt=1e-10, **kw)
    return N, dt, obj, gc, opts


def _fin(out):
    i = int(out.stats.iter)
    return float(out.stats.res[i - 1]), float(out.stats.dyn_vio[i - 1])


def test_ibr_p1_linear_one_iteration():
    model = ag.double_integrator_game(p=1)
    N, dt, obj, gc, opts = _mk(model, 1, outer_iter=1, inner_iter=1)
    prob = ag.game_problem(N, dt, jnp.array([1.0, 1.0, 0.0, 0.9]), model,
                           opts, obj, gc)
    res, dyn = _fin(ibr_newton_solve_player(prob, 0))
    assert res < 1e-6 and dyn < 1e-6


def test_ibr_p1_nonlinear():
    model = ag.unicycle_game(p=1)
    N, dt, obj, gc, opts = _mk(model, 1, outer_iter=7, inner_iter=20)
    prob = ag.game_problem(N, dt, jnp.array([1.0, 1.0, 0.0, 0.9]), model,
                           opts, obj, gc)
    res, dyn = _fin(ibr_newton_solve_player(prob, 0))
    assert res < 1e-6 and dyn < 1e-6


def test_ibr_p2_linear():
    model = ag.double_integrator_game(p=2)
    N, dt, obj, gc, opts = _mk(model, 2, outer_iter=1, inner_iter=1)
    x0 = jnp.array([1.0, 2.0, 1.0, 2.0, 0.0, 0.0, 0.9, 0.9])
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    res, dyn = _fin(ibr_newton_solve(prob, IBROptions(ibr_iter=3)))
    assert res < 5e-2 and dyn < 1e-6    # IBR fixed point != Nash (ref :281)


def test_ibr_p2_nonlinear():
    model = ag.unicycle_game(p=2)
    N, dt, obj, gc, opts = _mk(model, 2, outer_iter=7, inner_iter=20)
    x0 = jnp.array([1.0, 2.0, 1.0, 2.0, 0.0, 0.0, 0.9, 0.9])
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    res, dyn = _fin(ibr_newton_solve(prob, IBROptions(ibr_iter=5)))
    assert res < 5e-2 and dyn < 1e-6    # (ref :312)


def test_ibr_pallas_matches_schur():
    """The fused player-KKT kernel tracks the schur path
    lane-for-lane through a full Gauss-Seidel IBR solve."""
    import jax
    import numpy as np
    model = ag.unicycle_game(p=2)
    N, dt, obj, gc, opts = _mk(model, 2, outer_iter=2, inner_iter=4)
    gc = ag.add_collision_avoidance(
        ag.spec_from_model(model, N, dt), gc, 0.2)
    x0 = jnp.array([0.0, 1.0, 0.0, 1.0, 0.0, jnp.pi, 0.4, 0.4])
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    x0s = x0[None] + 0.05 * jax.random.normal(jax.random.PRNGKey(0), (3, 8))

    def solve(method, x):
        import dataclasses
        return ibr_newton_solve(dataclasses.replace(prob, x0=x),
                                IBROptions(ibr_iter=3), method=method)

    out_s = jax.jit(jax.vmap(lambda x: solve("schur", x)))(x0s)
    out_p = jax.jit(jax.vmap(lambda x: solve("pallas_interpret", x)))(x0s)
    np.testing.assert_array_equal(np.asarray(out_s.stats.iter),
                                  np.asarray(out_p.stats.iter))
    np.testing.assert_allclose(np.asarray(out_s.traj.x),
                               np.asarray(out_p.traj.x), rtol=0, atol=1e-8)
    np.testing.assert_allclose(np.asarray(out_s.traj.u),
                               np.asarray(out_p.traj.u), rtol=0, atol=1e-8)
