"""Monte-Carlo benchmark — BASELINE config 5 (4096-scenario Monte-Carlo
over the device mesh).

4096 initial-condition scenarios of the flagship 3-player game, sharded over
the device mesh via the parallel.shard path.  Two measurement modes:

* default: every GPU of the host — the throughput artifact;
* ``PLATFORM=cpu MC_DEVICES=8``: an 8-device virtual CPU mesh — validates
  the sharded code path and records the per-mesh-shape rows (shape-only:
  virtual-device timings are not chip throughput).

Appends one row per run to ``benchmarks/results/montecarlo.json``.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("PLATFORM") == "cpu":
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count="
        + os.environ.get("MC_DEVICES", "8"))

import jax
import jax.numpy as jnp

if os.environ.get("PLATFORM") == "cpu":
    jax.config.update("jax_platforms", "cpu")
else:
    import algames_tpu
    algames_tpu.enable_compile_cache()

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "results", "montecarlo.json")


def main():
    dtype = jnp.float32
    import algames_tpu as ag
    from algames_tpu.parallel import make_mesh, sharded_monte_carlo
    from __graft_entry__ import _flagship_problem

    outer = int(os.environ.get("MC_OUTER", "3"))
    inner = int(os.environ.get("MC_INNER", "8"))
    prob, spec = _flagship_problem(dtype=dtype, outer=outer, inner=inner)
    batch = int(os.environ.get("MC_BATCH", "4096"))
    mesh = make_mesh()
    x0s = jnp.tile(prob.x0[None], (batch, 1))
    x0s = x0s + 0.05 * jax.random.normal(jax.random.PRNGKey(0), x0s.shape,
                                         dtype)

    import functools
    fn = jax.jit(functools.partial(sharded_monte_carlo, prob, mesh,
                                   method=os.environ.get("MC_METHOD",
                                                         ag.kkt_method())))
    trajs, summary = fn(x0s)
    jax.block_until_ready(trajs)
    t0 = time.perf_counter()
    trajs, summary = fn(x0s)
    jax.block_until_ready(trajs)
    t = time.perf_counter() - t0

    platform = jax.devices()[0].platform
    row = {
        **ag.device_info(),
        "mesh_shape": list(mesh.devices.shape),
        "devices": int(mesh.devices.size),
        "batch": batch,
        "budget": f"outer={outer} x inner={inner}, f32 gates",
        # Convergence gates the run was measured at.
        "eps_dyn": prob.opts.eps_dyn, "eps_con": prob.opts.eps_con,
        "eps_sta": prob.opts.eps_sta, "eps_opt": prob.opts.eps_opt,
        "outer_iter": outer, "inner_iter": inner,
        "solves_per_s": round(batch / t, 2),
        "sec_per_batch": round(t, 4),
        "converged_frac": round(float(summary["converged_frac"]), 4),
        "divergence_frac": round(float(summary.get("divergence_frac", 0.0)),
                                 4),
        "mean_iters": round(float(summary["mean_iters"]), 2),
        "timing_meaningful": platform != "cpu",
        "note": ("device throughput" if platform != "cpu" else
                 "virtual CPU mesh: validates sharded path + convergence "
                 "only; timing is not device throughput"),
    }
    rows = []
    if os.path.exists(OUT):
        with open(OUT) as f:
            rows = json.load(f)
        rows = [r for r in rows
                if not (r["platform"] == row["platform"]
                        and r["devices"] == row["devices"]
                        and r["batch"] == row["batch"]
                        and r.get("budget", row["budget"]) == row["budget"])]
    rows.append(row)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(rows, f, indent=1)
    print(json.dumps(row))


if __name__ == "__main__":
    main()
