"""Model layout + dynamics oracles (mirrors reference test/dynamics/*)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import algames_tpu as ag
from algames_tpu.models.integration import rk2_step, rk3_step, rollout_rk3, step_jacobians


def test_double_integrator_layout():
    # reference test/dynamics/double_integrator.jl:1-27
    model = ag.double_integrator_game(p=3, d=2)
    assert (model.n, model.m, model.p) == (12, 6, 3)
    assert model.ni == (4, 4, 4) and model.mi == (2, 2, 2)
    # interleaved: player i owns i, i+p, i+2p, ... (0-based)
    assert model.pu[0] == (0, 3) and model.pu[2] == (2, 5)
    assert model.px[1] == (1, 4)
    assert model.pz[0] == (0, 3, 6, 9)
    assert model.dim == 2


def test_double_integrator_dynamics():
    model = ag.double_integrator_game(p=2, d=2)
    x = jnp.arange(8.0)
    u = jnp.array([10.0, 11.0, 12.0, 13.0])
    xdot = model.dynamics(x, u)
    np.testing.assert_allclose(xdot, jnp.concatenate([x[4:], u]))


def test_unicycle_layout_and_dynamics():
    model = ag.unicycle_game(p=2)
    assert (model.n, model.m) == (8, 4)
    assert model.dim == 2
    x = jnp.array([0.0, 1.0, 0.0, 1.0, 0.3, 0.4, 2.0, 3.0])
    u = jnp.array([0.1, 0.2, 0.3, 0.4])
    xdot = model.dynamics(x, u)
    # xd_i = cos(theta_i) v_i with theta = x[4:6], v = x[6:8]
    np.testing.assert_allclose(xdot[0], jnp.cos(0.3) * 2.0)
    np.testing.assert_allclose(xdot[3], jnp.sin(0.4) * 3.0)
    np.testing.assert_allclose(xdot[4:], u)


def test_bicycle_dynamics():
    model = ag.bicycle_game(p=1, lf=0.05, lr=0.05)
    x = jnp.array([0.0, 0.0, 1.5, 0.2])   # [x, y, v, psi]
    u = jnp.array([0.7, 0.1])             # [a, delta]
    beta = np.arctan2(0.05 * np.tan(0.1), 0.1)
    xdot = model.dynamics(x, u)
    np.testing.assert_allclose(xdot[0], 1.5 * np.cos(beta + 0.2), rtol=1e-12)
    np.testing.assert_allclose(xdot[1], 1.5 * np.sin(beta + 0.2), rtol=1e-12)
    np.testing.assert_allclose(xdot[2], 0.7)
    np.testing.assert_allclose(xdot[3], 1.5 * np.sin(beta) / 0.05, rtol=1e-12)


def test_quadrotor_layout_and_hover():
    model = ag.quadrotor_game(p=2)
    assert (model.n, model.m) == (24, 8)
    assert model.dim == 3
    # Hover: thrust per rotor = m*g/4/kf; zero attitude/velocity.
    w = 0.5 * 9.81 / 4.0 / model.kf
    x = jnp.zeros(24)
    u = jnp.full((8,), w)
    xdot = model.dynamics(x, u)
    np.testing.assert_allclose(np.asarray(xdot)[:18], 0.0, atol=1e-12)
    # Moments: M1 - M2 + M3 - M4 = 0; omega-dot nonzero only if asymmetry.
    np.testing.assert_allclose(np.asarray(xdot)[18:], 0.0, atol=1e-9)


def test_quadrotor_thrust_clamp():
    model = ag.quadrotor_game(p=1)
    x = jnp.zeros(12)
    u_neg = -jnp.ones(4)
    xdot = model.dynamics(x, u_neg)
    # Negative rotor speeds produce zero thrust: free fall.
    np.testing.assert_allclose(float(xdot[8]), -9.81, rtol=1e-12)


@pytest.mark.parametrize("make,p", [
    (ag.double_integrator_game, 2), (ag.unicycle_game, 2),
    (ag.bicycle_game, 2), (ag.quadrotor_game, 2)])
def test_step_jacobians_match_fd(make, p):
    model = make(p=p)
    key = jax.random.PRNGKey(0)
    x = 0.1 * jax.random.normal(key, (model.n,), jnp.float64)
    u = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (model.m,), jnp.float64)
    dt = 0.1
    A, B = step_jacobians(model, x, u, dt)
    eps = 1e-6
    for j in range(model.n):
        dx = jnp.zeros(model.n).at[j].set(eps)
        fd = (rk2_step(model, x + dx, u, dt) - rk2_step(model, x - dx, u, dt)) / (2 * eps)
        np.testing.assert_allclose(A[:, j], fd, atol=1e-6)
    for j in range(model.m):
        du = jnp.zeros(model.m).at[j].set(eps)
        fd = (rk2_step(model, x, u + du, dt) - rk2_step(model, x, u - du, dt)) / (2 * eps)
        np.testing.assert_allclose(B[:, j], fd, atol=1e-6)


def test_integrators_order():
    # Scalar exponential decay via a 1-player DI stand-in: use unicycle v-dot=u.
    model = ag.double_integrator_game(p=1, d=1)
    x = jnp.array([0.0, 1.0])
    u = jnp.array([0.5])
    dt = 0.1
    # Exact: pos' = vel, vel' = 0.5 -> pos(dt) = vel*dt + 0.25 dt^2
    x2 = rk2_step(model, x, u, dt)
    x3 = rk3_step(model, x, u, dt)
    np.testing.assert_allclose(float(x2[0]), 1.0 * dt + 0.25 * dt ** 2, rtol=1e-12)
    np.testing.assert_allclose(float(x3[1]), 1.0 + 0.5 * dt, rtol=1e-12)


def test_rollout_rk3():
    model = ag.double_integrator_game(p=1, d=1)
    x0 = jnp.array([0.0, 1.0])
    us = jnp.zeros((5, 1))
    xs = rollout_rk3(model, x0, us, 0.1)
    assert xs.shape == (6, 2)
    np.testing.assert_allclose(xs[-1, 0], 0.5, rtol=1e-12)  # const velocity


def test_quadrotor_smooth_clamp_converges():
    """The quadrotor stationarity floor, resolved.

    With the reference's exact thrust clamp ``max(0, kf*w)``
    (``src/dynamics/quadrotor.jl:58-63``), the quad2_N15 config plateaus at
    opt_vio ~2.7e-2 no matter the budget: two rotors converge onto the clamp
    boundary (u ~ -2e-10), the quasi-Newton Jacobian is one-sided across the
    kink, and the iterates oscillate (measured 2.7e-2 <-> 3.8e-2 over 126
    iterations at outer=10 x inner=20) — a structural property of the
    non-smooth model shared with the reference, not a solver defect; the
    golden gate pins that plateau at 5e-2 (tests/test_golden.py).

    The opt-in softplus clamp (``thrust_smoothing=beta``, deviation
    <= ln2/beta) removes the kink: the SAME config converges past the 1e-3
    reference stationarity gate (measured 6e-4 at beta=100, and for every
    beta in [50, 300])."""
    import dataclasses

    from algames_tpu.presets import quadrotor3d

    prob, spec = quadrotor3d(outer=10, inner=20)
    model_s = ag.quadrotor_game(p=2, thrust_smoothing=100.0)
    prob = dataclasses.replace(prob, model=model_s)
    out = ag.newton_solve_jit(prob, method="tridiag")
    it = int(out.stats.iter)
    vio = {k: float(getattr(out.stats, k)[it - 1])
           for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")}
    assert all(v < 1e-3 for v in vio.values()), vio
