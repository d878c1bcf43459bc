"""ALGAMES vs iterative best response — mirror of the reference
``examples/ibr_example.jl:1-155``.

Solves the same 3-player unicycle scenario with (a) the full Nash solver and
(b) Gauss-Seidel IBR, then compares residuals and trajectories.  As the
reference example documents (``ibr_example.jl:137-154``), the IBR fixed
point is generally NOT a Nash equilibrium: its full-game stationarity
residual stays large even when each player is unilaterally optimal against
the frozen others.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import algames_tpu as ag
from algames_tpu.problem.ibr import ibr_newton_solve
from algames_tpu.problem.options import IBROptions

p = 3
model = ag.unicycle_game(p=p)
N, dt = 20, 0.1
spec = ag.spec_from_model(model, N, dt)

obj = ag.game_objective(
    spec,
    Q=[10 * jnp.ones(4)] * p,
    R=[0.1 * jnp.ones(2)] * p,
    xf=[jnp.asarray([2.0, -0.4 * (i - 1), 0.0, 0.0]) for i in range(p)],
    uf=[jnp.zeros(2)] * p, dtype=jnp.float64)
gc = ag.game_constraints(spec)
gc = ag.add_collision_avoidance(spec, gc, 0.05)
x0 = jnp.asarray([0.0, 0.0, 0.0, -0.4, 0.0, 0.4, 0.0, 0.0, 0.0,
                  0.5, 0.5, 0.5])
opts = ag.Options(reg_0=1e-7)
ibr_iter = 10
if os.environ.get("SMOKE"):   # reduced budget for the test-suite smoke run
    opts = ag.Options(reg_0=1e-7, outer_iter=2, inner_iter=4)
    ibr_iter = 2
prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)

nash = ag.newton_solve_jit(prob)
ibr = ibr_newton_solve(prob, IBROptions(ibr_iter=ibr_iter))

i_n, i_b = int(nash.stats.iter), int(ibr.stats.iter)
print(f"Nash solver:  res = {float(nash.stats.res[i_n - 1]):.2e}")
print(f"IBR solver:   res = {float(ibr.stats.res[i_b - 1]):.2e} "
      "(full-game residual at the IBR fixed point)")
dx = float(jnp.max(jnp.abs(nash.traj.x - ibr.traj.x)))
print(f"max trajectory difference Nash vs IBR: {dx:.2e} "
      "(nonzero: different solution concepts)")
