"""Canonical BASELINE problem configurations.

One builder per BASELINE.md config row (driver targets, `BASELINE.json`):

* :func:`intro_di`          — 2-player double-integrator, N=10 (config 1)
* :func:`flagship_unicycle` — 3-player unicycle merge, N=20 (headline bench)
* :func:`intro_bicycle`     — 3-player bicycle with the full constraint stack
                              (reference ``examples/intro_example.jl:1-80``)
* :func:`highway_mpc`       — 3-player highway for warm-started replanning

Each returns ``(GameProblem, ProblemSpec)``.  These are the configurations
frozen as golden-trajectory fixtures (``tests/golden/``) and exercised by the
headline bench; keeping them in the package guarantees the bench, the
fixtures, and the examples all solve the *same* problems.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from .constraints.sets import (Wall, add_collision_avoidance,
                               add_circle_constraint, add_control_bound,
                               add_spherical_collision_avoidance,
                               add_state_bound, add_wall_constraint,
                               game_constraints)
from .core.spec import spec_from_model
from .models.bicycle import bicycle_game
from .models.double_integrator import double_integrator_game
from .models.unicycle import unicycle_game
from .objective.objective import add_collision_cost, game_objective
from .problem.options import Options
from .problem.problem import game_problem


def intro_di(dtype=jnp.float64, outer: int = 7, inner: int = 20,
             eps_opt: float | None = None):
    """2-player double-integrator game, N=10 — BASELINE config 1 and the
    reference's linear-dynamics solver oracle
    (``test/problem/solver_methods.jl:27-34`` scaled to p=2)."""
    p, N, dt = 2, 10, 0.1
    model = double_integrator_game(p=p, d=2)
    spec = spec_from_model(model, N, dt)
    # Lane-swap scenario: the collision-avoidance constraint is ACTIVE at the
    # equilibrium (players cross), so the fixture pins real AL behavior.
    obj = game_objective(
        spec,
        Q=[jnp.ones(4, dtype)] * p,
        R=[0.1 * jnp.ones(2, dtype)] * p,
        xf=[jnp.asarray([1.0, 0.4 * (p - 1 - i), 0.0, 0.0], dtype)
            for i in range(p)],
        uf=[jnp.zeros(2, dtype)] * p,
        dtype=dtype)
    gc = game_constraints(spec, dtype=dtype)
    gc = add_collision_avoidance(spec, gc, 0.2)
    gc = add_control_bound(spec, gc, 2 * jnp.ones(2 * p, dtype),
                           -2 * jnp.ones(2 * p, dtype))
    opts = Options(outer_iter=outer, inner_iter=inner,
                   eps_opt=_default_eps_opt(dtype, eps_opt))
    # Interleaved DI layout: [x (p) | y (p) | vx (p) | vy (p)].
    x0 = jnp.asarray(np.concatenate([np.zeros(p), 0.4 * np.arange(p),
                                     np.zeros(2 * p)]), dtype)
    return game_problem(N, dt, x0, model, opts, obj, gc), spec


def flagship_unicycle(dtype=jnp.float64, p: int = 3, N: int = 20,
                      outer: int = 7, inner: int = 20,
                      eps_opt: float | None = None):
    """3-player unicycle merge with collision avoidance + control bounds —
    the BASELINE.json headline throughput config (same problem as
    ``__graft_entry__._flagship_problem``)."""
    dt = 0.1
    model = unicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec,
        Q=[jnp.ones(4, dtype)] * p,
        R=[0.1 * jnp.ones(2, dtype)] * p,
        xf=[jnp.asarray([2.0, 0.4 * i, 0.0, 0.3], dtype) for i in range(p)],
        uf=[jnp.zeros(2, dtype)] * p,
        dtype=dtype)
    gc = game_constraints(spec, dtype=dtype)
    gc = add_collision_avoidance(spec, gc, 0.08)
    gc = add_control_bound(spec, gc, 2 * jnp.ones(2 * p, dtype),
                           -2 * jnp.ones(2 * p, dtype))
    opts = Options(outer_iter=outer, inner_iter=inner,
                   eps_opt=_default_eps_opt(dtype, eps_opt))
    x0 = jnp.asarray(
        np.concatenate([np.zeros(p), 0.4 * np.arange(p), np.zeros(p),
                        0.5 * np.ones(p)]), dtype)
    return game_problem(N, dt, x0, model, opts, obj, gc), spec


def intro_bicycle(dtype=jnp.float64, outer: int = 7, inner: int = 20,
                  eps_opt: float | None = None):
    """3-player bicycle game with the full constraint stack — collision cost,
    collision avoidance, control/state bounds, a wall, circle obstacles
    (reference ``examples/intro_example.jl:10-67``)."""
    p, N, dt = 3, 20, 0.1
    model = bicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec,
        Q=[10 * jnp.ones(model.ni[i], dtype) for i in range(p)],
        R=[0.1 * jnp.ones(model.mi[i], dtype) for i in range(p)],
        xf=[jnp.asarray(v, dtype) for v in
            ([2, +0.4, 0, 0], [2, 0.0, 0, 0], [3, -0.4, 0, 0])],
        uf=[jnp.zeros(model.mi[i], dtype) for i in range(p)],
        dtype=dtype)
    obj = add_collision_cost(spec, obj, radius=jnp.ones(p, dtype),
                             mu=5.0 * jnp.ones(p, dtype))
    gc = game_constraints(spec, dtype=dtype)
    gc = add_collision_avoidance(spec, gc, 0.08)
    gc = add_control_bound(spec, gc, 5 * jnp.ones(spec.m, dtype),
                           -5 * jnp.ones(spec.m, dtype))
    gc = add_state_bound(spec, gc, 0, 5 * np.ones(spec.n),
                         -5 * np.ones(spec.n))
    gc = add_wall_constraint(
        spec, gc, [Wall([0.0, -0.4], [1.0, -0.4], [0.0, -1.0])])
    gc = add_circle_constraint(spec, gc, jnp.asarray([1.0, 2.0, 3.0]),
                               jnp.asarray([1.0, 2.0, 3.0]),
                               jnp.asarray([0.1, 0.2, 0.3]))
    opts = Options(outer_iter=outer, inner_iter=inner,
                   eps_opt=_default_eps_opt(dtype, eps_opt))
    x0 = jnp.asarray([0.1, 0.0, 0.5, -0.4, 0.0, 0.7,
                      0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype)
    return game_problem(N, dt, x0, model, opts, obj, gc), spec


def roundabout(dtype=jnp.float64, outer: int = 10, inner: int = 16,
               eps_opt: float | None = None):
    """4-player unicycle roundabout, N=40 — BASELINE config 4
    (``examples/roundabout_example.py``): central island circle constraint,
    pairwise collision constraints + smooth collision cost, velocity and
    control bounds, staggered entry speeds."""
    from .constraints.sets import add_velocity_bound
    p, N, dt = 4, 40, 0.1
    model = unicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    starts = np.array([[-1.5, 0.0], [1.5, 0.0], [0.0, -1.5], [0.0, 1.5]])
    order = [3, 2, 0, 1]
    goals = np.array([-starts[order[i]] for i in range(p)])
    headings = np.arctan2(-starts[:, 1], -starts[:, 0])
    obj = game_objective(
        spec,
        Q=[jnp.asarray([5.0, 5.0, 0.2, 0.2], dtype)] * p,
        R=[0.1 * jnp.ones(2, dtype)] * p,
        xf=[jnp.asarray([goals[i, 0], goals[i, 1], headings[i], 0.3], dtype)
            for i in range(p)],
        uf=[jnp.zeros(2, dtype)] * p, dtype=dtype)
    obj = add_collision_cost(spec, obj, radius=0.4 * jnp.ones(p, dtype),
                             mu=5.0 * jnp.ones(p, dtype))
    gc = game_constraints(spec, dtype=dtype)
    gc = add_collision_avoidance(spec, gc, 0.08)
    gc = add_circle_constraint(spec, gc, jnp.asarray([0.0]),
                               jnp.asarray([0.0]), jnp.asarray([0.3]))
    gc = add_velocity_bound(spec, model, gc, 1.5 * np.ones(p),
                            -0.2 * np.ones(p))
    gc = add_control_bound(spec, gc, 3 * jnp.ones(spec.m, dtype),
                           -3 * jnp.ones(spec.m, dtype))
    x0 = np.zeros(spec.n)
    for i in range(p):
        x0[np.asarray(spec.px[i])] = starts[i]
        x0[spec.pz[i][2]] = headings[i]
        x0[spec.pz[i][3]] = 0.3 + 0.1 * i
    opts = Options(outer_iter=outer, inner_iter=inner,
                   eps_opt=_default_eps_opt(dtype, eps_opt))
    return game_problem(N, dt, jnp.asarray(x0, dtype), model, opts, obj,
                        gc), spec


def quadrotor3d(dtype=jnp.float64, outer: int = 6, inner: int = 12,
                eps_opt: float | None = None):
    """2-player 3D quadrotor game, N=15 — BASELINE 3D config
    (``examples/quadrotor_example.py``): spherical collision avoidance,
    floor Wall3D facet, cylinder obstacle, one-sided thrust bounds."""
    from .constraints.sets import CylinderWall, Wall3D
    from .models.quadrotor import quadrotor_game
    p, N, dt = 2, 15, 0.1
    model = quadrotor_game(p=p)
    spec = spec_from_model(model, N, dt)
    hover = 0.5 * 9.81 / 4.0 / model.kf
    obj = game_objective(
        spec,
        Q=[jnp.asarray([10, 10, 10, 1, 1, 1, 1, 1, 1, 1, 1, 1], dtype)] * p,
        R=[0.1 * jnp.ones(4, dtype)] * p,
        xf=[jnp.concatenate([jnp.asarray([1.5, 0.3 * i, 1.0], dtype),
                             jnp.zeros(9, dtype)]) for i in range(p)],
        uf=[jnp.full((4,), hover, dtype)] * p, dtype=dtype)
    gc = game_constraints(spec, dtype=dtype)
    gc = add_spherical_collision_avoidance(spec, gc, 0.1)
    gc = add_wall_constraint(spec, gc, [
        Wall3D([0.0, -1.0, 0.2], [2.0, -1.0, 0.2], [0.0, 1.0, 0.2],
               [0.0, 0.0, -1.0])])
    gc = add_wall_constraint(spec, gc, [
        CylinderWall([0.75, 0.15, 0.0], 'z', 2.0, 0.2)])
    gc = add_control_bound(spec, gc, 3 * jnp.ones(spec.m, dtype),
                           jnp.zeros(spec.m, dtype))
    x0 = jnp.zeros(spec.n, dtype)
    x0 = x0.at[np.asarray([spec.pz[i][2] for i in range(p)])].set(1.0)
    x0 = x0.at[spec.pz[1][1]].set(0.3)
    opts = Options(outer_iter=outer, inner_iter=inner,
                   eps_opt=_default_eps_opt(dtype, eps_opt))
    return game_problem(N, dt, x0, model, opts, obj, gc), spec


def highway_mpc(dtype=jnp.float32, outer: int = 3, inner: int = 8):
    """3-player highway for receding-horizon replanning: parallel lanes,
    lane-keeping targets, overtaking pressure from different target speeds.

    ``dual_reset=False`` warm-starts the AL multipliers across replans
    (penalties restart at mu0 each replan via ``reset_penalties``) and
    ``shift=1`` shifts the previous plan by one knot; the gates are the
    reference defaults (all 1e-3)."""
    p = 3
    model = unicycle_game(p=p)
    N, dt = 20, 0.1
    spec = spec_from_model(model, N, dt)
    obj = game_objective(
        spec,
        Q=[jnp.asarray([0.0, 5.0, 1.0, 2.0], dtype)] * p,  # lane y, heading, speed
        R=[0.1 * jnp.ones(2, dtype)] * p,
        xf=[jnp.asarray([10.0, 0.4 * i, 0.0, 0.8 + 0.3 * i], dtype)
            for i in range(p)],
        uf=[jnp.zeros(2, dtype)] * p, dtype=dtype)
    gc = game_constraints(spec, dtype=dtype)
    gc = add_collision_avoidance(spec, gc, 0.1)
    gc = add_control_bound(spec, gc, 3.0 * jnp.ones(2 * p, dtype),
                           -3.0 * jnp.ones(2 * p, dtype))
    opts = Options(outer_iter=outer, inner_iter=inner, shift=1,
                   dual_reset=False)
    x0 = jnp.asarray(np.concatenate([
        [0.0, -0.5, -1.0], 0.4 * np.arange(p), np.zeros(p),
        0.8 + 0.3 * np.arange(p)]), dtype)
    return game_problem(N, dt, x0, model, opts, obj, gc), spec


def _default_eps_opt(dtype, eps_opt):
    """f32 runs gate stationarity at 1e-2: the f32 floor of the AL terms with
    mu up to 1e7 is ~3e-3 (see ``__graft_entry__._flagship_problem``); f64
    keeps the reference default 1e-3."""
    if eps_opt is not None:
        return eps_opt
    return 1e-2 if dtype == jnp.float32 else 1e-3


PRESETS = {
    "di2_N10": intro_di,
    "uni3_N20": flagship_unicycle,
    "bike3_N20": intro_bicycle,
    "round4_N40": roundabout,
    "quad2_N15": quadrotor3d,
}
