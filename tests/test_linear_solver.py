"""Structured KKT solve: block-Thomas vs dense vs plain jnp.linalg.solve."""
import jax
import jax.numpy as jnp
import numpy as np

import algames_tpu as ag
from algames_tpu.problem import residual as R
from algames_tpu.problem.linear_solver import (newton_step,
                                               solve_cyclic_reduction,
                                               solve_dense, solve_tridiagonal,
                                               solve_tridiagonal_schur)


def _kkt_system(p=2, N=6, seed=0):
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, 0.1)
    obj = ag.game_objective(spec, [jnp.ones(4)] * p, [0.5 * jnp.ones(2)] * p,
                            [jnp.zeros(4)] * p, [jnp.zeros(2)] * p,
                            dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_control_bound(spec, gc, jnp.ones(spec.m), -jnp.ones(spec.m))
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    traj = ag.PrimalDual(
        x=jax.random.normal(k1, (spec.N, spec.n), jnp.float64),
        u=jax.random.normal(k2, (spec.T, spec.m), jnp.float64),
        lam=jax.random.normal(k3, (spec.p, spec.T, spec.n), jnp.float64))
    jb = R.jacobian_blocks(model, spec, obj, gc, traj, reg_x=1e-3, reg_u=1e-3)
    D, U, L = R.build_tridiagonal(spec, jb)
    res = R.residual(model, spec, obj, gc, traj)
    b = R.residual_knot_blocks(spec, res)
    return spec, D, U, L, b


def test_tridiag_matches_dense():
    spec, D, U, L, b = _kkt_system()
    y_dense = solve_dense(spec, D, U, L, b)
    y_tri = solve_tridiagonal(spec, D, U, L, b)
    np.testing.assert_allclose(np.asarray(y_tri), np.asarray(y_dense),
                               rtol=1e-8, atol=1e-8)


def test_solution_satisfies_system():
    spec, D, U, L, b = _kkt_system(seed=3)
    T, W = spec.T, spec.W
    y = solve_tridiagonal(spec, D, U, L, b).reshape(T, W)
    # Verify block rows: L y_{t-1} + D y_t + U y_{t+1} = b_t
    for t in range(T):
        lhs = D[t] @ y[t]
        if t >= 1:
            lhs = lhs + L[t - 1] @ y[t - 1]
        if t + 1 < T:
            lhs = lhs + U[t] @ y[t + 1]
        np.testing.assert_allclose(np.asarray(lhs), np.asarray(b[t]),
                                   rtol=1e-8, atol=1e-8)


def test_newton_step_sign():
    spec, D, U, L, b = _kkt_system(seed=5)
    y = newton_step(spec, D, U, L, b, method="tridiag")
    y2 = solve_tridiagonal(spec, D, U, L, -b)
    np.testing.assert_allclose(np.asarray(y), np.asarray(y2))


def test_schur_condensed_matches_thomas():
    """The structure-condensed fast path produces the same step."""
    for N, p, seed in ((6, 2, 0), (9, 3, 1), (20, 3, 2)):
        model = ag.unicycle_game(p=p)
        spec = ag.spec_from_model(model, N, 0.1)
        obj = ag.game_objective(spec, [jnp.ones(4)] * p, [0.5 * jnp.ones(2)] * p,
                                [jnp.zeros(4)] * p, [jnp.zeros(2)] * p,
                                dtype=jnp.float64)
        gc = ag.game_constraints(spec)
        gc = ag.add_control_bound(spec, gc, jnp.ones(spec.m), -jnp.ones(spec.m))
        ks = jax.random.split(jax.random.PRNGKey(seed), 3)
        traj = ag.PrimalDual(
            x=jax.random.normal(ks[0], (spec.N, spec.n), jnp.float64),
            u=jax.random.normal(ks[1], (spec.T, spec.m), jnp.float64),
            lam=jax.random.normal(ks[2], (spec.p, spec.T, spec.n), jnp.float64))
        jb = R.jacobian_blocks(model, spec, obj, gc, traj, 1e-3, 1e-3)
        D, U, L = R.build_tridiagonal(spec, jb)
        res = R.residual(model, spec, obj, gc, traj)
        b = R.residual_knot_blocks(spec, res)
        y_ref = solve_tridiagonal(spec, D, U, L, b)
        y_schur = solve_tridiagonal_schur(spec, jb, b)
        np.testing.assert_allclose(np.asarray(y_schur), np.asarray(y_ref),
                                   rtol=1e-8, atol=1e-10)
        y_cr = solve_cyclic_reduction(spec, D, U, L, b)
        np.testing.assert_allclose(np.asarray(y_cr), np.asarray(y_ref),
                                   rtol=1e-8, atol=1e-10)


def test_solver_methods_agree_end_to_end():
    """Full solves with every linear-solver method give the same trajectory."""
    p = 2
    model = ag.unicycle_game(p=p)
    N, dt = 10, 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(spec, [jnp.ones(4)] * p, [0.5 * jnp.ones(2)] * p,
                            [jnp.zeros(4)] * p, [-jnp.ones(2)] * p,
                            dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_control_bound(spec, gc, jnp.ones(spec.m), -jnp.ones(spec.m))
    opts = ag.Options(outer_iter=2, inner_iter=4, reg_0=1e-7)
    x0 = jnp.array([1.0, 2.0, 1.0, 2.0, 0.0, 0.0, 0.9, 0.9])
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    ref = ag.newton_solve(prob, method="dense")
    for method in ("tridiag", "schur", "cr"):
        out = ag.newton_solve(prob, method=method)
        np.testing.assert_allclose(np.asarray(out.traj.x),
                                   np.asarray(ref.traj.x),
                                   rtol=1e-8, atol=1e-10)


def test_pallas_thomas_interpret():
    """Fused sweep kernel (interpret mode) matches the pivoted Schur path,
    including with large AL penalties on the Q blocks (SURVEY.md §7 hard
    part 1)."""
    from algames_tpu.ops.thomas_pallas import solve_thomas_pallas

    p = 3
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, 8, 0.1)
    obj = ag.game_objective(spec, [jnp.ones(4)] * p, [0.5 * jnp.ones(2)] * p,
                            [jnp.zeros(4)] * p, [jnp.zeros(2)] * p,
                            dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_control_bound(spec, gc, jnp.ones(spec.m), -jnp.ones(spec.m))
    B = 4
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    trajs = ag.PrimalDual(
        x=0.3 * jax.random.normal(ks[0], (B, spec.N, spec.n), jnp.float64),
        u=0.3 * jax.random.normal(ks[1], (B, spec.T, spec.m), jnp.float64),
        lam=0.3 * jax.random.normal(ks[2], (B, p, spec.T, spec.n), jnp.float64))
    res, jbs, _, _ = jax.vmap(lambda tr: R.assemble(model, spec, obj, gc, tr, 1e-3))(trajs)
    b = jax.vmap(lambda r: R.residual_knot_blocks(spec, r))(res)
    for penalty in (1.0, 1e7):
        jbs_s = jbs
        if penalty != 1.0:
            # emulate a late-AL-schedule Hessian: huge penalty curvature
            diag = np.arange(spec.n)
            jbs_s = R.JacBlocks(
                Qblk=jbs.Qblk.at[:, :, :, diag, diag].add(penalty),
                Ublk=jbs.Ublk, A=jbs.A, B=jbs.B)
        y_ref = jax.vmap(lambda jb, bb: solve_tridiagonal_schur(spec, jb, bb))(jbs_s, b)
        y_pal = solve_thomas_pallas(spec, jbs_s, b, interpret=True)
        scale = float(jnp.max(jnp.abs(y_ref)))
        np.testing.assert_allclose(np.asarray(y_pal), np.asarray(y_ref),
                                   atol=1e-7 * max(scale, 1.0), rtol=1e-6)


def test_pallas_method_end_to_end_interpret():
    """Full solver with method=pallas_interpret matches schur lane-for-lane."""
    prob_dtype = jnp.float32
    p = 2
    model = ag.unicycle_game(p=p)
    N, dt = 6, 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(spec, [jnp.ones(4, prob_dtype)] * p,
                            [0.5 * jnp.ones(2, prob_dtype)] * p,
                            [jnp.zeros(4, prob_dtype)] * p,
                            [jnp.zeros(2, prob_dtype)] * p, dtype=prob_dtype)
    gc = ag.game_constraints(spec, dtype=prob_dtype)
    opts = ag.Options(outer_iter=1, inner_iter=2, reg_0=1e-5)
    x0 = jnp.asarray([1.0, 2.0, 1.0, 2.0, 0.0, 0.0, 0.5, 0.5], prob_dtype)
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    x0s = jnp.stack([prob.x0, prob.x0 * 1.05, prob.x0 * 0.9, prob.x0 * 1.1])
    from algames_tpu.parallel import solve_batch
    q_p = solve_batch(prob, x0s, method="pallas_interpret")
    q_s = solve_batch(prob, x0s, method="schur")
    np.testing.assert_allclose(np.asarray(q_p.traj.x), np.asarray(q_s.traj.x),
                               atol=5e-5)


def test_batched_vmap_solve():
    spec, D, U, L, b = _kkt_system()
    batch = 4
    Db = jnp.stack([D * (1 + 0.01 * i) for i in range(batch)])
    bb = jnp.stack([b * (1 + i) for i in range(batch)])
    ys = jax.vmap(lambda d, r: solve_tridiagonal(spec, d, U, L, r))(Db, bb)
    for i in range(batch):
        yi = solve_tridiagonal(spec, Db[i], U, L, bb[i])
        np.testing.assert_allclose(np.asarray(ys[i]), np.asarray(yi), rtol=1e-10)


def test_pallas_thomas_interpret_quadrotor_shapes():
    """Kernel generality at the quadrotor block sizes (n=24, mi=4, W=80 for
    p=2): the fused sweep kernel must match the pivoted Schur path at shapes
    far from the 3-player-unicycle flagship."""
    from algames_tpu.ops.thomas_pallas import solve_thomas_pallas

    p = 2
    model = ag.quadrotor_game(p=p)
    spec = ag.spec_from_model(model, 5, 0.05)
    ni = spec.n // p
    mi = spec.m // p
    obj = ag.game_objective(spec, [jnp.ones(ni)] * p,
                            [0.5 * jnp.ones(mi)] * p,
                            [jnp.zeros(ni)] * p, [jnp.zeros(mi)] * p,
                            dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    B = 2
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    trajs = ag.PrimalDual(
        x=0.1 * jax.random.normal(ks[0], (B, spec.N, spec.n), jnp.float64),
        u=0.1 * jax.random.normal(ks[1], (B, spec.T, spec.m), jnp.float64),
        lam=0.1 * jax.random.normal(ks[2], (B, p, spec.T, spec.n),
                                    jnp.float64))
    res, jbs, _, _ = jax.vmap(
        lambda tr: R.assemble(model, spec, obj, gc, tr, 1e-3))(trajs)
    b = jax.vmap(lambda r: R.residual_knot_blocks(spec, r))(res)
    y_ref = jax.vmap(lambda jb, bb: solve_tridiagonal_schur(spec, jb, bb))(
        jbs, b)
    y_pal = solve_thomas_pallas(spec, jbs, b, interpret=True)
    scale = float(jnp.max(jnp.abs(y_ref)))
    np.testing.assert_allclose(np.asarray(y_pal), np.asarray(y_ref),
                               atol=1e-7 * max(scale, 1.0), rtol=1e-6)


def test_structured_q_assembly_and_kernel():
    """At the flagship and quadrotor shapes, the fused sweep kernel solves
    the assembled KKT system (diagonal cost plus rank-1 collision AL terms
    in Q, formed densely) to the dense oracle's answer."""
    from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
    from algames_tpu.presets import flagship_unicycle, quadrotor3d
    from algames_tpu.problem.linear_solver import solve_dense

    for prob, spec in (flagship_unicycle(outer=2, inner=2),
                       quadrotor3d(outer=2, inner=2)):
        y_sq, y_or = _kernel_vs_dense(prob, spec, solve_thomas_pallas,
                                      solve_dense)
        scale = np.abs(y_or).max()
        np.testing.assert_allclose(y_sq, y_or, rtol=0, atol=1e-10 * scale)


def _kernel_vs_dense(prob, spec, kernel, dense):
    ks = jax.random.split(jax.random.PRNGKey(3), 3)
    traj = ag.PrimalDual(
        x=0.2 * jax.random.normal(ks[0], (spec.N, spec.n), jnp.float64),
        u=0.2 * jax.random.normal(ks[1], (spec.T, spec.m), jnp.float64),
        lam=0.2 * jax.random.normal(ks[2], (spec.p, spec.T, spec.n),
                                    jnp.float64))
    pd = R.point_data(prob.model, spec, prob.obj, prob.gc, traj)
    res, jb, _, _ = R.assemble_from_point(spec, prob.obj, prob.gc, traj, pd,
                                          reg=1e-3)
    b = R.residual_knot_blocks(spec, res)
    D, U, L = R.build_tridiagonal(spec, jb)
    y_or = np.asarray(dense(spec, D, U, L, -b))
    jb1 = jax.tree_util.tree_map(lambda x: x[None], jb)
    y_k = np.asarray(kernel(spec, jb1, -b[None], interpret=True))[0]
    return y_k, y_or


def test_structured_q_rank_k_circle_blocks():
    """Multi-row (C > 1) constraint blocks: the flagship plus three circle
    obstacles per player; the kernel matches the dense oracle."""
    import dataclasses

    from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
    from algames_tpu.presets import flagship_unicycle
    from algames_tpu.problem.linear_solver import solve_dense

    prob, spec = flagship_unicycle(outer=2, inner=2)
    gc = ag.add_circle_constraint(spec, prob.gc, [0.3, 0.8, 1.2],
                                  [0.1, -0.1, 0.2], [0.15, 0.2, 0.1])
    prob = dataclasses.replace(prob, gc=gc)
    y_k, y_or = _kernel_vs_dense(prob, spec, solve_thomas_pallas,
                                 solve_dense)
    np.testing.assert_allclose(y_k, y_or, rtol=0,
                               atol=1e-10 * np.abs(y_or).max())


def test_structured_q_fallback_collision_cost():
    """A CollisionCost objective (dense cross-player Hessian blocks):
    method='pallas_interpret' solves it and matches the dense method."""
    from algames_tpu.objective.objective import add_collision_cost
    from algames_tpu.presets import intro_di

    prob, spec = intro_di(outer=3, inner=4)
    obj = add_collision_cost(spec, prob.obj, 0.3 * jnp.ones(spec.p),
                             2.0 * jnp.ones(spec.p))
    import dataclasses
    prob = dataclasses.replace(prob, obj=obj)
    ref = ag.newton_solve(prob, method="dense")
    out = ag.newton_solve(prob, method="pallas_interpret")
    np.testing.assert_allclose(np.asarray(out.traj.x),
                               np.asarray(ref.traj.x), rtol=0, atol=1e-9)
