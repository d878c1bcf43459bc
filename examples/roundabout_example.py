"""4-player roundabout, N=40 — the BASELINE.json config-4 scenario.

Four unicycles enter from the four compass directions and exit to their
right, yielding around a central circular island (circle constraint) with
pairwise collision constraints, a smooth collision cost, speed limits
(velocity bounds) and control bounds.  Entry speeds are staggered so the
crossing order is well-defined — the fully symmetric head-on variant has a
degenerate (colliding) symmetric equilibrium that no local Nash solver
handles.
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

p = 4
model = ag.unicycle_game(p=p)
N, dt = 40, 0.1
spec = ag.spec_from_model(model, N, dt)

starts = np.array([[-1.5, 0.0], [1.5, 0.0], [0.0, -1.5], [0.0, 1.5]])
# exit arm to the player's right
order = [3, 2, 0, 1]
goals = np.array([-starts[order[i]] for i in range(p)])
headings = np.arctan2(-starts[:, 1], -starts[:, 0])

obj = ag.game_objective(
    spec,
    Q=[jnp.asarray([5.0, 5.0, 0.2, 0.2])] * p,
    R=[0.1 * jnp.ones(2)] * p,
    xf=[jnp.asarray([goals[i, 0], goals[i, 1], headings[i], 0.3])
        for i in range(p)],
    uf=[jnp.zeros(2)] * p, dtype=jnp.float64)
obj = ag.add_collision_cost(spec, obj, radius=0.4 * jnp.ones(p),
                            mu=5.0 * jnp.ones(p))

gc = ag.game_constraints(spec)
gc = ag.add_collision_avoidance(spec, gc, 0.08)
gc = ag.add_circle_constraint(spec, gc, jnp.asarray([0.0]),
                              jnp.asarray([0.0]), jnp.asarray([0.3]))
gc = ag.add_velocity_bound(spec, model, gc, 1.5 * np.ones(p), -0.2 * np.ones(p))
gc = ag.add_control_bound(spec, gc, 3 * jnp.ones(spec.m), -3 * jnp.ones(spec.m))

x0 = np.zeros(spec.n)
for i in range(p):
    x0[np.asarray(spec.px[i])] = starts[i]
    x0[spec.pz[i][2]] = headings[i]
    x0[spec.pz[i][3]] = 0.3 + 0.1 * i   # staggered entry speeds
opts = ag.Options(outer_iter=10, inner_iter=16)
if os.environ.get("SMOKE"):   # reduced budget for the test-suite smoke run
    opts = ag.Options(outer_iter=2, inner_iter=4)
prob = ag.game_problem(N, dt, jnp.asarray(x0), model, opts, obj, gc)

t0 = time.time()
out = ag.newton_solve_jit(prob)
jax.block_until_ready(out.traj.x)
it = int(out.stats.iter)
print(f"roundabout p=4 N=40: {it} iterations in {time.time() - t0:.1f}s (incl. compile)")
print("violations:", {k: float(getattr(out.stats, k)[it - 1])
                      for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")})
X = np.asarray(out.traj.x)
dmin = min(np.min(np.linalg.norm(
    X[:, np.asarray(spec.px[a])] - X[:, np.asarray(spec.px[b])], axis=1))
    for a in range(p) for b in range(a + 1, p))
print(f"min pairwise distance: {dmin:.3f} (constraint: 0.16)")
island = min(np.min(np.linalg.norm(X[:, np.asarray(spec.px[i])], axis=1))
             for i in range(p))
print(f"min distance to island center: {island:.3f} (constraint: 0.3)")

try:
    import matplotlib
    matplotlib.use("Agg")
    from algames_tpu.plots import plot_trajectory
    ax = plot_trajectory(spec, out.traj)
    circ = matplotlib.patches.Circle((0, 0), 0.3, fill=False, color="k")
    ax.add_patch(circ)
    ax.figure.savefig("/tmp/roundabout.png", dpi=120)
    print("plot saved to /tmp/roundabout.png")
except ImportError:
    pass
