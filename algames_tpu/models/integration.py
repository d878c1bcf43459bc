"""Explicit integrators and discrete dynamics Jacobians.

JAX replacement for the RobotDynamics subset the reference relies on
(``src/problem/local_quantities.jl:5-27``, ``src/problem/solver_methods.jl:17``):

* ``rk2_step``  — explicit midpoint; used inside the Newton residual
  (``discrete_dynamics(RK2, ...)``).
* ``rk3_step``  — Kutta third-order; used only for the initial rollout guess
  (``rollout!(RK3, ...)``).
* ``step_jacobians`` — (A, B) of the RK2 step via ``jax.jacfwd`` (replacing
  ForwardDiff), vmapped over knots by callers.
* ``rollout_rk3`` — forward simulation as a ``lax.scan``.

All functions are pure and shape-static; Jacobians compile to closed-form XLA
because the models are simple compositions of elementwise ops.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp


def rk2_step(model, x, u, dt):
    """Explicit midpoint step (RobotDynamics RK2 semantics)."""
    k1 = model.dynamics(x, u) * dt
    k2 = model.dynamics(x + 0.5 * k1, u) * dt
    return x + k2


def rk3_step(model, x, u, dt):
    """Kutta third-order step (RobotDynamics RK3 semantics)."""
    k1 = model.dynamics(x, u) * dt
    k2 = model.dynamics(x + 0.5 * k1, u) * dt
    k3 = model.dynamics(x - k1 + 2.0 * k2, u) * dt
    return x + (k1 + 4.0 * k2 + k3) / 6.0


def step_jacobians(model, x, u, dt):
    """(A, B) = d rk2_step / d(x, u) for a single knot.

    Replacement for ``RobotDynamics.discrete_jacobian!(RK2, ...)``
    (reference ``src/problem/local_quantities.jl:21-27``).
    """
    A = jax.jacfwd(lambda xx: rk2_step(model, xx, u, dt))(x)
    B = jax.jacfwd(lambda uu: rk2_step(model, x, uu, dt))(u)
    return A, B


def step_jacobians_traj(model, xs, us, dt):
    """Batched (A, B) over a trajectory: xs [T, n], us [T, m] -> [T, n, n], [T, n, m]."""
    return jax.vmap(lambda x, u: step_jacobians(model, x, u, dt))(xs, us)


def rollout_rk3(model, x0, us, dt):
    """Forward-simulate from x0 under controls us [T, m]; returns xs [T+1, n].

    Replacement for ``rollout!(RK3, model, traj)`` used for the initial guess
    (reference ``src/problem/solver_methods.jl:17-18``).
    """
    def body(x, u):
        xn = rk3_step(model, x, u, dt)
        return xn, xn

    _, xs = jax.lax.scan(body, x0, us)
    return jnp.concatenate([x0[None], xs], axis=0)
