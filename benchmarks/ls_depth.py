"""Measure accepted line-search step sizes across the flagship batch.

alpha = alpha_0 * 0.5^(j-1) for the accepted trial j, so the alpha histogram
IS the line-search-depth histogram: it sizes how many trial residuals a
parallel-alpha line search would need per Newton iteration.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    dtype = jnp.float32
    import algames_tpu as ag
    from __graft_entry__ import _flagship_problem

    prob, spec = _flagship_problem(dtype=dtype, outer=3, inner=8)
    batch = int(os.environ.get("BENCH_BATCH", "512"))
    key = jax.random.PRNGKey(0)
    x0s = jnp.tile(prob.x0[None], (batch, 1))
    x0s = x0s + 0.05 * jax.random.normal(key, x0s.shape, dtype)

    ag.enable_compile_cache()
    fn = jax.jit(lambda x: ag.parallel.solve_batch(prob, x,
                                                   method=ag.kkt_method()))
    out = fn(x0s)
    jax.block_until_ready(out.traj.x)

    iters = np.asarray(out.stats.iter)             # [B]
    alphas = np.asarray(out.stats.alpha)           # [B, M] (shifted by one)
    # Row r of lane b is valid for r in [1, iters_b) — alpha of iteration r-1.
    M = alphas.shape[1]
    valid = (np.arange(M)[None, :] >= 1) & (np.arange(M)[None, :] < iters[:, None])
    vals = alphas[valid]
    vals = vals[vals > 0]                          # 0 = no step taken
    depth = np.round(1 - np.log2(np.maximum(vals, 1e-9))).astype(int)
    print(f"batch={batch} lanes, {vals.size} accepted steps")
    print(f"max inner-loop trips over batch: {iters.max()}  mean: {iters.mean():.1f}")
    for d in range(1, depth.max() + 1):
        frac = np.mean(depth == d)
        if frac > 0:
            print(f"  LS depth {d:2d} (alpha={2.0**(1-d):.4g}): {frac*100:5.1f}%")
    print(f"mean depth {depth.mean():.2f}, p99 {np.percentile(depth, 99):.0f}, "
          f"max {depth.max()}")


if __name__ == "__main__":
    main()
