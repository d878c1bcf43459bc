"""Intro example — 3-player bicycle game with the full constraint stack.

JAX mirror of the reference ``examples/intro_example.jl:1-80``:
build model -> objective (+collision cost) -> constraints (collision
avoidance, control/state bounds, wall, circles) -> GameProblem ->
newton_solve -> plots.

Run (f64, default device):   python examples/intro_example.py
Run in float32:              DTYPE=f32 python examples/intro_example.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import algames_tpu as ag

dtype = jnp.float32 if os.environ.get("DTYPE") == "f32" else jnp.float64

# Dynamics: 3-player bicycle game (intro_example.jl:10-14).
p = 3
model = ag.bicycle_game(p=p)
N, dt = 20, 0.1
spec = ag.spec_from_model(model, N, dt)

# Per-player LQR objective (intro_example.jl:21-33).
Q = [10 * jnp.ones(model.ni[i], dtype) for i in range(p)]
R = [0.1 * jnp.ones(model.mi[i], dtype) for i in range(p)]
xf = [jnp.asarray(v, dtype) for v in
      ([2, +0.4, 0, 0], [2, 0.0, 0, 0], [3, -0.4, 0, 0])]
uf = [jnp.zeros(model.mi[i], dtype) for i in range(p)]
obj = ag.game_objective(spec, Q, R, xf, uf, dtype=dtype)
obj = ag.add_collision_cost(spec, obj, radius=jnp.ones(p, dtype),
                            mu=5.0 * jnp.ones(p, dtype))

# Constraints (intro_example.jl:38-58).
gc = ag.game_constraints(spec, dtype=dtype)
gc = ag.add_collision_avoidance(spec, gc, 0.08)
gc = ag.add_control_bound(spec, gc, 5 * jnp.ones(spec.m), -5 * jnp.ones(spec.m))
gc = ag.add_state_bound(spec, gc, 0, 5 * np.ones(spec.n), -5 * np.ones(spec.n))
gc = ag.add_wall_constraint(
    spec, gc, [ag.Wall([0.0, -0.4], [1.0, -0.4], [0.0, -1.0])])
gc = ag.add_circle_constraint(spec, gc, jnp.asarray([1.0, 2.0, 3.0]),
                              jnp.asarray([1.0, 2.0, 3.0]),
                              jnp.asarray([0.1, 0.2, 0.3]))

# Initial state (intro_example.jl:61-67): [x (p); y (p); v (p); psi (p)].
x0 = jnp.asarray([0.1, 0.0, 0.5, -0.4, 0.0, 0.7,
                  0.0, 0.0, 0.0, 0.0, 0.0, 0.0], dtype)

opts = ag.Options()
if os.environ.get("SMOKE"):   # reduced budget for the test-suite smoke run
    opts = ag.Options(outer_iter=2, inner_iter=4)
prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)

t0 = time.time()
result = ag.newton_solve_jit(prob)
jax.block_until_ready(result.traj.x)
t_total = time.time() - t0
t0 = time.time()
result = ag.newton_solve_jit(prob)
jax.block_until_ready(result.traj.x)
t_solve = time.time() - t0

it = int(result.stats.iter)
print(f"solved in {it} Newton iterations "
      f"(compile+solve {t_total:.2f}s, cached solve {t_solve * 1e3:.1f}ms)")
print("violations:",
      {k: float(getattr(result.stats, k)[it - 1])
       for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")})

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from algames_tpu.plots import plot_trajectory, plot_violations

    ax = plot_trajectory(spec, result.traj)
    ax.figure.savefig("/tmp/intro_traj.png", dpi=120)
    ax2 = plot_violations(result.stats)
    ax2.figure.savefig("/tmp/intro_violations.png", dpi=120)
    print("plots saved to /tmp/intro_traj.png, /tmp/intro_violations.png")
except ImportError:
    pass
