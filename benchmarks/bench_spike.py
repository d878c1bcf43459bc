"""Long-horizon SPIKE performance artifact.

Sweeps horizon N in {65, 257, 1025} (T = 64 / 256 / 1024 intervals) on a
2-player unicycle overtaking game and times the Newton-step KKT solve
end-to-end through a FULL solve:

* single-device sequential sweeps (``schur``; plus ``pallas`` on a GPU) —
  device numbers when run with the default platform;
* 8-virtual-device SPIKE (``parallel.spike_kkt_method``) on the CPU mesh —
  SHAPE-ONLY rows (virtual devices share the same cores, so efficiency is
  ~1/D by construction; the row validates the sharded program at scale and
  records the reduced-system overhead, not chip speedup — the same label
  as scaling_cpu.json).

Appends rows to ``benchmarks/results/spike_bench.json``.  Run:

  python benchmarks/bench_spike.py                 # single-GPU rows
  PLATFORM=cpu python benchmarks/bench_spike.py    # CPU + SPIKE rows
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

if os.environ.get("PLATFORM") == "cpu":
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count="
                               + os.environ.get("SPIKE_DEVICES", "8"))

import jax
import jax.numpy as jnp
import numpy as np

if os.environ.get("PLATFORM") == "cpu":
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
else:
    import algames_tpu
    algames_tpu.enable_compile_cache()

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "results", "spike_bench.json")

HORIZONS = [int(s) for s in os.environ.get("SPIKE_NS", "65,257,1025").split(",")]


def make_problem(ag, N, dtype):
    p, dt = 2, 0.05
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec,
        Q=[jnp.ones(4, dtype)] * p,
        R=[0.1 * jnp.ones(2, dtype)] * p,
        xf=[jnp.asarray([6.0, 0.3 * i, 0.0, 0.5], dtype) for i in range(p)],
        uf=[jnp.zeros(2, dtype)] * p, dtype=dtype)
    gc = ag.game_constraints(spec, dtype=dtype)
    gc = ag.add_collision_avoidance(spec, gc, 0.1)
    gc = ag.add_control_bound(spec, gc, 2 * jnp.ones(spec.m, dtype),
                              -2 * jnp.ones(spec.m, dtype))
    eps_opt = 1e-2 if dtype == jnp.float32 else 1e-3
    opts = ag.Options(outer_iter=2, inner_iter=6, eps_opt=eps_opt)
    x0 = jnp.asarray([0.0, -0.5, 0.0, 0.3, 0.0, 0.0, 0.6, 0.4], dtype)
    return ag.game_problem(N, dt, x0, model, opts, obj, gc), spec


def timed(fn, arg, reps=3):
    out = fn(arg)
    jax.block_until_ready(out.traj.x)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(arg)
        jax.block_until_ready(out.traj.x)
        times.append(time.perf_counter() - t0)
    return min(times), out


def main():
    import algames_tpu as ag

    platform = jax.devices()[0].platform
    on_cpu = platform == "cpu"
    dtype = jnp.float64 if on_cpu else jnp.float32
    nd = len(jax.devices())
    rows = []

    for N in HORIZONS:
        prob, spec = make_problem(ag, N, dtype)
        for method_name in (["schur", "spike"] if on_cpu
                            else ["schur", "pallas"]):
            if method_name == "spike":
                from jax.sharding import Mesh
                mesh = Mesh(np.asarray(jax.devices()), ("hz",))
                method = ag.parallel.spike_kkt_method(mesh)
            else:
                method = method_name
            fn = jax.jit(lambda pr, m=method: ag.newton_solve(pr, method=m))
            t, out = timed(fn, prob)
            i = int(out.stats.iter)
            row = {
                "platform": platform,
                "devices": nd if method_name == "spike" else 1,
                "N": N,
                "T": spec.T,
                "method": method_name,
                "dtype": "f64" if on_cpu else "f32",
                "solve_ms": round(t * 1e3, 2),
                "iters": i,
                "dyn_vio": float(out.stats.dyn_vio[i - 1]),
                "eps_dyn": prob.opts.eps_dyn, "eps_con": prob.opts.eps_con,
                "eps_sta": prob.opts.eps_sta, "eps_opt": prob.opts.eps_opt,
                "outer_iter": prob.opts.outer_iter,
                "inner_iter": prob.opts.inner_iter,
                "timing_meaningful": not on_cpu or method_name == "schur",
                "note": ("chip wall-clock" if not on_cpu else
                         ("CPU f64 single-stream reference" if method_name
                          == "schur" else
                          "virtual CPU mesh: shape-only — devices share "
                          "cores, records program validity + reduced-system "
                          "overhead, not chip speedup")),
            }
            rows.append(row)
            print(json.dumps(row))

    existing = []
    if os.path.exists(OUT):
        with open(OUT) as f:
            existing = json.load(f)
        keys = {(r["platform"], r["N"], r["method"]) for r in rows}
        existing = [r for r in existing
                    if (r["platform"], r["N"], r["method"]) not in keys]
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(existing + rows, f, indent=1)


if __name__ == "__main__":
    main()
