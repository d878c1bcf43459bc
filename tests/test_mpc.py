"""MPC receding-horizon loop with warm starts."""
import jax.numpy as jnp
import numpy as np

import algames_tpu as ag
from algames_tpu.mpc import mpc_solve


def test_mpc_tracks_target():
    p = 2
    model = ag.double_integrator_game(p=p)
    N, dt = 10, 0.1
    spec = ag.spec_from_model(model, N, dt)
    xf = [jnp.array([1.0, 1.0, 0.0, 0.0]), jnp.array([-1.0, -1.0, 0.0, 0.0])]
    obj = ag.game_objective(spec, [10.0 * jnp.ones(4)] * p,
                            [0.1 * jnp.ones(2)] * p,
                            xf, [jnp.zeros(2)] * p, dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    opts = ag.Options(outer_iter=1, inner_iter=3, reg_0=1e-7, shift=1,
                      mpc_horizon=12, upsampling=2)
    x0 = jnp.zeros(8)
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    out = mpc_solve(prob, horizon=12)
    assert out.states.shape == (13, 8)
    assert out.controls.shape == (12, 4)
    # Players converge toward their targets under closed-loop MPC.
    xT = np.asarray(out.states[-1])
    tgt = np.zeros(8)
    for i in range(p):
        tgt[np.asarray(spec.pz[i])] = np.asarray(xf[i])
    start_err = np.linalg.norm(np.asarray(x0) - tgt)
    end_err = np.linalg.norm(xT - tgt)
    assert end_err < 0.5 * start_err
    assert np.all(np.isfinite(np.asarray(out.dyn_vio)))


def test_mpc_warm_start_helps():
    """Warm-started replans need no more iterations than the cold solve."""
    p = 2
    model = ag.unicycle_game(p=p)
    N, dt = 10, 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(spec, [jnp.ones(4)] * p, [0.5 * jnp.ones(2)] * p,
                            [jnp.zeros(4)] * p, [jnp.zeros(2)] * p,
                            dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    opts = ag.Options(outer_iter=2, inner_iter=8, reg_0=1e-7, shift=1)
    x0 = jnp.array([1.0, 2.0, 1.0, 2.0, 0.0, 0.0, 0.5, 0.5])
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    out = mpc_solve(prob, horizon=5)
    iters = np.asarray(out.iters)
    assert np.all(iters[1:] <= iters[0] + 1)


def test_mpc_closedloop_collision_free_batched():
    """Closed-loop smoke test: a batched closed loop must keep the EXECUTED
    trajectories outside the pairwise collision gate and converge each
    warm-started replan."""
    import jax
    p = 2
    model = ag.unicycle_game(p=p)
    N, dt = 10, 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec,
        Q=[jnp.asarray([0.0, 5.0, 1.0, 2.0])] * p,
        R=[0.1 * jnp.ones(2)] * p,
        xf=[jnp.asarray([4.0, 0.4 * i, 0.0, 0.8]) for i in range(p)],
        uf=[jnp.zeros(2)] * p)
    gc = ag.game_constraints(spec)
    r_coll = 0.1
    gc = ag.add_collision_avoidance(spec, gc, r_coll)
    gc = ag.add_control_bound(spec, gc, u_min=-3.0, u_max=3.0)
    opts = ag.Options(outer_iter=3, inner_iter=8, shift=1, dual_reset=False)
    x0 = jnp.asarray([0.0, -0.3, 0.0, 0.4, 0.0, 0.0, 0.8, 0.8])
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)

    import dataclasses
    import jax.numpy as jnp_
    B, H = 4, 6
    x0s = x0[None] + 0.03 * jax.random.normal(jax.random.PRNGKey(0),
                                              (B, spec.n))
    out = jax.jit(jax.vmap(lambda x: mpc_solve(
        dataclasses.replace(prob, x0=x), horizon=H)))(x0s)
    X = np.asarray(out.states)                       # [B, H+1, n]
    assert np.all(np.isfinite(X))
    # Executed pairwise distance stays outside the summed-radius gate 2r.
    px0, px1 = np.asarray(spec.px[0]), np.asarray(spec.px[1])
    dmin = float(np.min(np.linalg.norm(X[:, :, px0] - X[:, :, px1],
                                       axis=-1)))
    assert dmin >= 2 * r_coll, f"closed loop collided: {dmin} < {2*r_coll}"
    # Each replan's final dynamics violation meets the gate.
    assert np.asarray(out.dyn_vio).max() < opts.eps_dyn
    # Applied controls respect the bound.
    assert np.abs(np.asarray(out.controls)).max() <= 3.0 + 1e-9
