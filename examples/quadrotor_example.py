"""3D example — 2-player quadrotor game with spherical collision avoidance,
a 3D wall facet, and a cylinder keep-out.

Exercises the 3D constraint families (reference ``Wall3DConstraint``,
``CylinderConstraint``, ``add_spherical_collision_avoidance!``) on the
12-state MRP quadrotor model.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import algames_tpu as ag

p = 2
model = ag.quadrotor_game(p=p)
N, dt = 15, 0.1
spec = ag.spec_from_model(model, N, dt)

hover = 0.5 * 9.81 / 4.0 / model.kf
Q = [jnp.asarray([10, 10, 10, 1, 1, 1, 1, 1, 1, 1, 1, 1], jnp.float64)] * p
R = [0.1 * jnp.ones(4)] * p
xf = [jnp.concatenate([jnp.asarray([1.5, 0.3 * i, 1.0]), jnp.zeros(9)])
      for i in range(p)]
uf = [jnp.full((4,), hover)] * p
obj = ag.game_objective(spec, Q, R, xf, uf, dtype=jnp.float64)

gc = ag.game_constraints(spec)
gc = ag.add_spherical_collision_avoidance(spec, gc, 0.1)
# floor facet at z=0.2 over the unit square, forbidden side below
gc = ag.add_wall_constraint(spec, gc, [
    ag.Wall3D([0.0, -1.0, 0.2], [2.0, -1.0, 0.2], [0.0, 1.0, 0.2],
              [0.0, 0.0, -1.0])])
# vertical cylinder obstacle
gc = ag.add_wall_constraint(spec, gc, [
    ag.CylinderWall([0.75, 0.15, 0.0], 'z', 2.0, 0.2)])
gc = ag.add_control_bound(spec, gc, 3 * jnp.ones(spec.m), jnp.zeros(spec.m))

x0 = jnp.zeros(spec.n)
x0 = x0.at[np.asarray([spec.pz[i][2] for i in range(p)])].set(1.0)  # z = 1
x0 = x0.at[spec.pz[1][1]].set(0.3)                                  # y offset
opts = ag.Options(outer_iter=6, inner_iter=12)
if os.environ.get("SMOKE"):   # reduced budget for the test-suite smoke run
    opts = ag.Options(outer_iter=2, inner_iter=4)
prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)

out = ag.newton_solve_jit(prob)
it = int(out.stats.iter)
print(f"quadrotor game: {it} iterations")
print("violations:", {k: float(getattr(out.stats, k)[it - 1])
                      for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")})
X = np.asarray(out.traj.x)
for i in range(p):
    pz = np.asarray(spec.pz[i])
    print(f"player {i}: start {X[0, pz[:3]]}, end {X[-1, pz[:3]]}")
