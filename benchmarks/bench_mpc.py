"""Receding-horizon replanning on the highway (``presets.highway_mpc``).

Three measurements, each at the reference-default 1e-3 gates:

* ``single``: one scene, a host loop of warm-started replans (one jitted
  replan per control step, the plant stepped on the host between them) —
  per-replan latency p50/p99 against the 100 ms budget of a 10 Hz planner;
* ``device_loop``: the same closed loop as ONE on-device ``lax.scan``
  (``mpc.mpc_solve``), wall time / H per replan;
* ``batched``: B scenes replanning together (vmapped closed loop), with the
  closed-loop correctness summary (pairwise distance, per-replan
  convergence, applied-control bounds).

    python benchmarks/bench_mpc.py        # MPC_BATCH=32 MPC_STEPS=30

Prints one JSON line per measurement, each with the device it ran on.
"""
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BUDGET_MS = 100.0   # RSS-2020 real-time replan budget (10 Hz)


def main():
    import algames_tpu as ag
    from algames_tpu.models.integration import rk3_step
    from algames_tpu.presets import highway_mpc

    ag.enable_compile_cache()
    dev = ag.device_info()
    method = ag.kkt_method()
    prob, spec = highway_mpc(dtype=jnp.float32)
    opts, model = prob.opts, prob.model
    steps = int(os.environ.get("MPC_STEPS", "30"))
    gates = {k: getattr(opts, k) for k in ("eps_dyn", "eps_con", "eps_sta",
                                           "eps_opt", "outer_iter",
                                           "inner_iter")}

    def replan(x, warm, gc):
        pb = dataclasses.replace(prob, x0=x, gc=gc)
        out = ag.newton_solve(pb, warm=warm, method=method)
        it = jnp.maximum(out.stats.iter - 1, 0)
        vio = jnp.stack([out.stats.dyn_vio[it], out.stats.con_vio[it],
                         out.stats.sta_vio[it], out.stats.opt_vio[it]])
        return out.traj, ag.reset_penalties(out.gc), vio

    def plant(x, u):
        return rk3_step(model, rk3_step(model, x, u, spec.dt / 2), u,
                        spec.dt / 2)

    # ---- one scene, host loop ---------------------------------------------
    replan_jit = jax.jit(replan)
    cold = jax.jit(lambda pr: ag.newton_solve(pr, method=method))(prob)
    warm, gc, x = cold.traj, ag.reset_penalties(cold.gc), prob.x0
    lat = []
    for _ in range(steps):
        t0 = time.perf_counter()
        warm, gc, _ = replan_jit(x, warm, gc)
        jax.block_until_ready(warm.x)
        lat.append(time.perf_counter() - t0)
        x = plant(x, warm.u[0])
    lat = np.asarray(lat[2:]) * 1e3          # first replans compile
    print(json.dumps({
        "metric": "mpc_replan_latency_ms", "method": method,
        "p50": float(np.percentile(lat, 50)),
        "p99": float(np.percentile(lat, 99)), "budget_ms": BUDGET_MS,
        **gates, **dev}))

    # ---- one scene, on-device loop ----------------------------------------
    loop = jax.jit(lambda pr: ag.mpc_solve(pr, horizon=steps, method=method))
    jax.block_until_ready(loop(prob).states)
    t0 = time.perf_counter()
    r = loop(prob)
    jax.block_until_ready(r.states)
    print(json.dumps({
        "metric": "mpc_device_loop_ms_per_replan", "method": method,
        "value": (time.perf_counter() - t0) / steps * 1e3,
        "replans_converged": bool(np.all(np.asarray(r.dyn_vio) < opts.eps_dyn)
                                  & np.all(np.asarray(r.opt_vio)
                                           < opts.eps_opt)),
        **gates, **dev}))

    # ---- B scenes together ------------------------------------------------
    B = int(os.environ.get("MPC_BATCH", "32"))
    x0s = prob.x0[None] + 0.05 * jax.random.normal(
        jax.random.PRNGKey(0), (B, spec.n), jnp.float32)
    loop_b = jax.jit(jax.vmap(lambda x: ag.mpc_solve(
        dataclasses.replace(prob, x0=x), horizon=steps, method=method)))
    jax.block_until_ready(loop_b(x0s).states)
    t0 = time.perf_counter()
    rb = loop_b(x0s)
    jax.block_until_ready(rb.states)
    per_step = (time.perf_counter() - t0) / steps
    X = np.asarray(rb.states)                    # [B, H+1, n]
    px = [np.asarray(spec.px[i]) for i in range(spec.p)]
    dmin = min(float(np.min(np.linalg.norm(X[..., px[a]] - X[..., px[b]],
                                           axis=-1)))
               for a in range(spec.p) for b in range(a + 1, spec.p))
    conv = ((np.asarray(rb.dyn_vio) < opts.eps_dyn)
            & (np.asarray(rb.opt_vio) < opts.eps_opt))
    print(json.dumps({
        "metric": "mpc_batched_ms_per_step", "method": method, "batch": B,
        "value": per_step * 1e3,
        "scenario_replans_per_s": B / per_step,
        "min_pairwise_distance": dmin,
        "replan_converged_frac": float(conv.mean()),
        "max_abs_control": float(np.max(np.abs(np.asarray(rb.controls)))),
        **gates, **dev}))


if __name__ == "__main__":
    main()
