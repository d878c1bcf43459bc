"""Headline benchmark: batched 3-player N=20 game solves/s per device.

Runs the BASELINE.json flagship config — 3-player unicycle merge with
collision-avoidance and control-bound constraints, N=20 knots — as a vmapped
batch of full ALGAMES solves (AL outer loop + Newton inner loop + line search
+ block-tridiagonal KKT factorizations, all on device) and reports throughput.

Run on the GPU: ``python bench.py``.  It fails when JAX finds no GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": ..., "unit": "solves/s", "vs_baseline": ...,
   "platform": ..., "device_kind": ..., "device_count": ...}
vs_baseline is against the target of 1000 solves/s per device
(BASELINE.md "Targets").
"""
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


def _measure(ag, prob, dtype, batch, chunks, reps):
    """Steady-state solves/s for one sweep shape.

    The whole ``batch * chunks`` sweep is ONE device dispatch:
    ``parallel.solve_many`` runs the chunk loop on device via ``lax.scan``
    (chunks of ``batch`` lanes back-to-back inside the jitted computation).
    Full SolveResults for every lane are materialized in device memory so
    the bench can report convergence over ALL lanes.
    """
    key = jax.random.PRNGKey(0)
    n_tot = batch * chunks
    x0s = jnp.tile(prob.x0[None], (n_tot, 1))
    x0s = x0s + 0.05 * jax.random.normal(key, x0s.shape, dtype)
    method = ag.kkt_method()
    fn = jax.jit(lambda x: ag.parallel.solve_many(prob, x, method=method,
                                                  chunk=batch, unroll=2))
    q = fn(x0s)
    jax.block_until_ready(q.traj.x)
    q = fn(x0s)
    jax.block_until_ready(q.traj.x)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        q = fn(x0s)
        jax.block_until_ready(q.traj.x)
        times.append(time.perf_counter() - t0)
    assert np.all(np.isfinite(np.asarray(q.traj.x))), "non-finite trajs"
    return n_tot / min(times), q


def _gates(opts):
    """Convergence-gate and budget fields for every emitted JSON line (the
    f32 paths run the documented eps_opt stationarity floor)."""
    return {
        "eps_dyn": opts.eps_dyn, "eps_con": opts.eps_con,
        "eps_sta": opts.eps_sta, "eps_opt": opts.eps_opt,
        "outer_iter": opts.outer_iter, "inner_iter": opts.inner_iter,
    }


def main():
    dtype = jnp.float32
    import algames_tpu as ag
    from __graft_entry__ import _flagship_problem

    ag.enable_compile_cache()
    dev = ag.device_info()
    if dev["platform"] != "gpu":
        sys.exit(f"bench.py measures the GPU; JAX found {dev['platform']}")

    # Full default solve budget semantics, f32 tolerances: the solver stops
    # per-lane once the 1e-3 violation gates pass (same gates as reference).
    prob, spec = _flagship_problem(dtype=dtype, outer=3, inner=8)
    reps = int(os.environ.get("BENCH_REPS", "3"))

    # Sweep shape: chunks of 128 lanes, 256 chunks.  Env overrides remain
    # for sweeps.
    batch = int(os.environ.get("BENCH_BATCH", "128"))
    chunks = int(os.environ.get("BENCH_CHUNKS", "256"))

    solves_per_s, q = _measure(ag, prob, dtype, batch, chunks, reps)
    print(f"[bench] {batch}x{chunks}: {solves_per_s:.0f} solves/s",
          file=sys.stderr)

    # Solution quality at the winning shape (per-lane convergence gates).
    frac = float(ag.parallel.convergence_fraction(q, prob.opts))
    div = float(jnp.mean(ag.parallel.divergence_mask(q).astype(jnp.float32)))
    it = jnp.maximum(q.stats.iter - 1, 0)
    dyn = jax.vmap(lambda a, i: a[i])(q.stats.dyn_vio, it)
    print(f"[bench] converged_frac={frac:.3f} diverged_frac={div:.3f} "
          f"median_dyn_vio={float(jnp.median(dyn)):.2e} "
          f"mean_iters={float(jnp.mean(q.stats.iter)):.1f}", file=sys.stderr)

    # Iteration histogram: prove the short-budget caps (outer=3 x inner=8,
    # 24 iters) never truncate a lane.
    iters = np.asarray(q.stats.iter).ravel()
    cap = prob.opts.outer_iter * prob.opts.inner_iter
    hist = np.bincount(iters.astype(int), minlength=cap + 1)
    at_cap = float((iters >= cap).mean())
    print(f"[bench] iter histogram (cap={cap}): "
          + " ".join(f"{i}:{c}" for i, c in enumerate(hist) if c)
          + f"  frac_at_cap={at_cap:.4f}", file=sys.stderr)

    # Second metric: the REFERENCE DEFAULT budget (outer=7 x inner=20,
    # options.jl:73-91; f32-floor eps_opt documented in presets.py).  Same
    # per-lane convergence gates — the caps are just higher, so lanes that
    # converge at iteration ~8 cost the same work; this line makes the
    # headline comparable to the reference's own defaults.  Goes to stderr:
    # stdout carries ONE JSON line.
    prob_d, _ = _flagship_problem(dtype=dtype, outer=7, inner=20)
    sps_d, qd = _measure(ag, prob_d, dtype, batch, chunks, reps)
    print(f"[bench-default-budget] {batch}x{chunks}: {sps_d:.0f} solves/s",
          file=sys.stderr)
    frac_d = float(ag.parallel.convergence_fraction(qd, prob_d.opts))
    print("[bench-default-budget] " + json.dumps({
        "metric": "3p_unicycle_N20_solves_per_s_per_chip_outer7_inner20",
        "value": round(sps_d, 2),
        "unit": "solves/s",
        "vs_baseline": round(sps_d / 1000.0, 4),
        "converged_frac": round(frac_d, 4),
        **_gates(prob_d.opts), **dev,
    }), file=sys.stderr)

    print(json.dumps({
        "metric": "3p_unicycle_N20_solves_per_s_per_chip",
        "value": round(solves_per_s, 2),
        "unit": "solves/s",
        "vs_baseline": round(solves_per_s / 1000.0, 4),
        "converged_frac": round(frac, 4),
        **_gates(prob.opts), **dev,
    }))


if __name__ == "__main__":
    main()
