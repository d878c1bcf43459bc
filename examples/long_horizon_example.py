"""Long-horizon game with the KKT solve sharded over the knot axis.

The reference solves every horizon sequentially (sparse LU over all knots,
``src/problem/solver_methods.jl:87``); its tests stop at N=20.  This example
solves a 2-player N=129 (T=128 intervals) unicycle overtaking game with the
Newton step's block-tridiagonal factorization DISTRIBUTED over the horizon
(``parallel.spike_kkt_method``): each device eliminates a slab of knots, the
devices exchange only slab-boundary blocks, and wall-clock for the dominant
sweep scales ~1/devices.

Runs over every device JAX finds: on the CPU, 8 virtual devices (the
``--xla_force_host_platform_device_count`` flag set below), on a host with
several GPUs, those GPUs.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

import algames_tpu as ag


def main():
    p, N, dt = 2, 129, 0.05
    if os.environ.get("SMOKE"):   # reduced budget for the test-suite smoke
        N = 33                    # T=32: still 4 knots/device on 8 devices
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec,
        Q=[jnp.ones(4)] * p,
        R=[0.1 * jnp.ones(2)] * p,
        xf=[jnp.asarray([6.0, 0.3 * i, 0.0, 0.5]) for i in range(p)],
        uf=[jnp.zeros(2)] * p)
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, 0.1)
    gc = ag.add_control_bound(spec, gc, 2 * jnp.ones(spec.m),
                              -2 * jnp.ones(spec.m))
    opts = ag.Options(outer_iter=4, inner_iter=10)
    if os.environ.get("SMOKE"):
        opts = ag.Options(outer_iter=2, inner_iter=4)
    x0 = jnp.asarray([0.0, -0.5, 0.0, 0.3, 0.0, 0.0, 0.6, 0.4])
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)

    nd = len(jax.devices())
    mesh = Mesh(np.asarray(jax.devices()), ("hz",))
    print(f"horizon T={spec.T} sharded over {nd} devices "
          f"({spec.T // nd} knots/device)")

    method = ag.parallel.spike_kkt_method(mesh)
    res = jax.jit(lambda pr: ag.newton_solve(pr, method=method))(prob)
    i = int(res.stats.iter)
    print(f"iters={i}  dyn_vio={float(res.stats.dyn_vio[i-1]):.2e}  "
          f"con_vio={float(res.stats.con_vio[i-1]):.2e}  "
          f"opt_vio={float(res.stats.opt_vio[i-1]):.2e}")

    # Cross-check against the sequential sweep.
    ref = ag.newton_solve_jit(prob, method="tridiag")
    err = float(jnp.max(jnp.abs(res.traj.x - ref.traj.x)))
    print(f"max |x_spike - x_sequential| = {err:.2e}")


if __name__ == "__main__":
    main()
