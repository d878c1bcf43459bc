"""IBR throughput benchmark.

Batched Gauss-Seidel IBR solves of the flagship 3-player unicycle config
(PointData carry, player-Schur sub-solves, K-parallel line search).  Writes
``benchmarks/results/ibr_bench.json``.

Run on the GPU:  python benchmarks/bench_ibr.py
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


HERE = os.path.dirname(os.path.abspath(__file__))


def main():
    import algames_tpu as ag
    from algames_tpu.presets import flagship_unicycle
    from algames_tpu.problem.ibr import ibr_newton_solve
    from algames_tpu.problem.options import IBROptions

    ag.enable_compile_cache()
    dtype = jnp.float32
    prob, spec = flagship_unicycle(dtype=dtype, outer=3, inner=8)
    ibr_opts = IBROptions(ibr_iter=10)
    method = os.environ.get("IBR_METHOD", ag.kkt_method())
    # Chunked sweep like parallel.solve_many: chunks of IBR_BATCH lanes
    # back-to-back ON DEVICE (lax.scan) — one dispatch for the whole sweep.
    B = int(os.environ.get("IBR_BATCH", "128"))
    C = int(os.environ.get("IBR_CHUNKS", "4"))
    key = jax.random.PRNGKey(0)
    x0s = jnp.tile(prob.x0[None], (C * B, 1))
    x0s = x0s + 0.05 * jax.random.normal(key, x0s.shape, dtype)

    import dataclasses

    def one(x0):
        return ibr_newton_solve(dataclasses.replace(prob, x0=x0),
                                ibr_opts=ibr_opts, method=method)

    def sweep(xs):
        chunks = xs.reshape(C, B, -1)
        return jax.lax.scan(
            lambda c, x: (c, jax.vmap(one)(x)), None, chunks)[1]

    fn = jax.jit(sweep)
    t0 = time.time()
    out = fn(x0s)
    jax.block_until_ready(out.traj.x)
    compile_s = time.time() - t0

    reps = 3
    t0 = time.time()
    for _ in range(reps):
        out = fn(x0s)
    jax.block_until_ready(out.traj.x)
    per = (time.time() - t0) / reps
    sps = C * B / per

    # Solution quality: full-game residual at the IBR fixed point (large by
    # design — IBR != Nash, reference ibr_example.jl:137-154); mean final
    # per-player residual row norm must be small.
    it = out.stats.iter.reshape(-1)
    res_norm = out.stats.res.reshape(C * B, -1)[jnp.arange(C * B), it - 1]
    result = {
        **ag.device_info(),
        "batch": B,
        "chunks": C,
        "method": method,
        "ibr_iter": ibr_opts.ibr_iter,
        "budget": "outer=3 x inner=8 per player solve",
        "eps_dyn": prob.opts.eps_dyn, "eps_con": prob.opts.eps_con,
        "eps_sta": prob.opts.eps_sta, "eps_opt": prob.opts.eps_opt,
        "outer_iter": prob.opts.outer_iter,
        "inner_iter": prob.opts.inner_iter,
        "solves_per_s": float(sps),
        "sec_per_batch": float(per),
        "compile_s": float(compile_s),
        "mean_final_res": float(jnp.mean(res_norm)),
    }
    os.makedirs(os.path.join(HERE, "results"), exist_ok=True)
    with open(os.path.join(HERE, "results", "ibr_bench.json"), "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
