"""Weak-scaling benchmark: sharded Monte-Carlo throughput vs mesh size.

Solves ``LANES_PER_DEVICE`` scenarios PER DEVICE on 1, 2, 4, ... device
meshes and reports throughput plus parallel efficiency (the BASELINE.md
">=80% scaling" target).  On a host with several GPUs the mesh spans them;
under ``XLA_FLAGS=--xla_force_host_platform_device_count=8
JAX_PLATFORMS=cpu`` it validates the scaling *shape* on virtual devices
(real efficiency numbers need real devices).

Usage: [PLATFORM=cpu] [BENCH_LANES=128] python benchmarks/bench_scaling.py
(PLATFORM=cpu forces the virtual-device CPU path; pair with
XLA_FLAGS=--xla_force_host_platform_device_count=8.)
"""
import json
import os
import sys
import time

import jax

if os.environ.get("PLATFORM") == "cpu":
    jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import algames_tpu as ag
    from algames_tpu.parallel.shard import make_mesh, sharded_monte_carlo
    from __graft_entry__ import _flagship_problem

    dtype = jnp.float32
    prob, spec = _flagship_problem(dtype=dtype, outer=3, inner=8)
    lanes = int(os.environ.get("BENCH_LANES", "128"))
    nd_all = len(jax.devices())
    sizes = [d for d in (1, 2, 4, 8, 16) if d <= nd_all]

    base = None
    rows = []
    for nd in sizes:
        mesh = make_mesh(nd)
        B = lanes * nd
        key = jax.random.PRNGKey(0)
        x0s = jnp.tile(prob.x0[None], (B, 1))
        x0s = x0s + 0.05 * jax.random.normal(key, x0s.shape, dtype)
        fn = jax.jit(lambda x, m=mesh: sharded_monte_carlo(prob, m, x,
                                                           method="schur"))
        trajs, summary = fn(x0s)
        jax.block_until_ready(trajs)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            trajs, summary = fn(x0s)
            jax.block_until_ready(trajs)
            ts.append(time.perf_counter() - t0)
        t = min(ts)
        sps = B / t
        if base is None:
            base = sps
        eff = sps / (base * nd)
        rows.append({"devices": nd, "lanes_per_device": lanes, "total": B,
                     "solves_per_s": round(sps, 1),
                     "efficiency": round(eff, 4),
                     "converged_frac": float(summary["converged_frac"])})
        print(f"devices={nd:2d} lanes/device={lanes} total={B:5d}: "
              f"{sps:9.1f} solves/s  efficiency={100*eff:5.1f}%  "
              f"converged={float(summary['converged_frac']):.3f}")

    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results")
    os.makedirs(out_dir, exist_ok=True)
    platform = jax.devices()[0].platform
    with open(os.path.join(out_dir, f"scaling_{platform}.json"), "w") as f:
        json.dump({"platform": platform,
                   "note": ("virtual CPU devices validate the scaling SHAPE "
                            "(sharding compiles + lanes stay independent); "
                            "they SHARE the host's cores, so measured "
                            "'efficiency' is expected ~1/n_devices by "
                            "construction — real efficiency needs real "
                            "chips"),
                   "target_efficiency": 0.8, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
