"""Smoke test of the batched game solver on the GPU.

    python chip_smoke.py              # phases 1-5 on one GPU
    python chip_smoke.py --four       # phase 6 only: the sharded path, 4 GPUs
    python chip_smoke.py --out F.json # also write every phase's numbers to F

Phases (one process; each prints its numbers on its own line):

1. device   — JAX must find a GPU; there is no CPU fallback.
2. sweep    — ``parallel.solve_many`` over 128 x 256 flagship scenarios
              (3-player unicycle merge, N = 20, float32) with the GPU's KKT
              method; converged fraction >= 0.999, every trajectory finite,
              and on 64 lanes, solved in float32 at the reference gates,
              within 2e-3 of the float64 ``schur`` solve.
3. kkt      — the sweep kernel on flagship KKT systems across the AL
              penalty mu in {1, 1e2, 1e4, 1e7}, against the dense float64
              solve and beside the float32 ``schur`` scan.
4. golden   — the ``tests/golden`` fixtures in float64 through ``schur`` and
              the kernel.
5. mpc_ibr  — warm-started highway replans (``mpc.mpc_solve``) at the 1e-3
              gates, and batched IBR solves, each converged.
6. four     — ``parallel.sharded_monte_carlo`` over four GPUs on 4,096
              flagship scenarios, lane for lane against one GPU.

The last line of stdout is ``{"ok": true, "device": {...}}`` only when every
phase passed; otherwise the script exits non-zero without it.
"""
import argparse
import functools
import json
import subprocess
import sys
import time
import traceback


def _card():
    """``name, power.limit`` of the first GPU as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"
    return out.strip().splitlines()[0] if out.strip() else "nvidia-smi: none"


def _line(phase, **kv):
    print(f"[{phase}] " + json.dumps(kv), flush=True)


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _flagship_x0s(prob, n, seed=0):
    import jax
    import jax.numpy as jnp
    x0s = jnp.tile(prob.x0[None], (n, 1))
    return x0s + 0.05 * jax.random.normal(jax.random.PRNGKey(seed),
                                          x0s.shape, prob.x0.dtype)


def _final(res, name):
    """Per-lane value of stats field ``name`` at the last recorded row."""
    import jax
    import jax.numpy as jnp
    it = jnp.maximum(res.stats.iter - 1, 0)
    return jax.vmap(lambda a, i: a[i])(getattr(res.stats, name), it)


def phase_sweep(ag, out):
    """Flagship sweep at the bench shape, float32, the GPU's method."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from __graft_entry__ import _flagship_problem

    method = ag.kkt_method()
    prob, _ = _flagship_problem(dtype=jnp.float32, outer=3, inner=8)
    chunk, chunks = 128, 256
    x0s = _flagship_x0s(prob, chunk * chunks)
    fn = jax.jit(lambda x: ag.parallel.solve_many(
        prob, x, method=method, chunk=chunk, unroll=2))
    t0 = time.perf_counter()
    q = fn(x0s)
    jax.block_until_ready(q.traj.x)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    q = fn(x0s)
    jax.block_until_ready(q.traj.x)
    sweep_s = time.perf_counter() - t0
    frac = float(ag.parallel.convergence_fraction(q, prob.opts))
    finite = bool(np.all(np.isfinite(np.asarray(q.traj.x))))

    # 64 of these scenarios against the float64 schur solve at the
    # reference gates (all 1e-3) and budget (outer 7 x inner 20).  The
    # sweep's own lanes stop at eps_opt = 1e-2, up to ~1e-2 away from the
    # float64 equilibrium on any backend, so they are compared (and
    # reported) at the gate they ran to; the 2e-3 criterion of
    # __graft_entry__._flagship_problem is held by the float32 solve
    # through the same method at the reference gates.
    lanes = 64
    ref_opts = dict(outer=7, inner=20)
    p32, _ = _flagship_problem(dtype=jnp.float32, **ref_opts)
    p32 = dataclasses.replace(p32, opts=dataclasses.replace(p32.opts,
                                                            eps_opt=1e-3))
    y32 = jax.jit(lambda x: ag.parallel.solve_batch(p32, x, method=method))(
        x0s[:lanes])
    jax.config.update("jax_enable_x64", True)
    p64, _ = _flagship_problem(dtype=jnp.float64, **ref_opts)
    ref = np.asarray(jax.jit(lambda x: ag.parallel.solve_batch(
        p64, x, method="schur"))(x0s[:lanes].astype(jnp.float64)).traj.x)

    def dev(x):
        return float(np.max(np.abs(np.asarray(x, np.float64) - ref)))
    dev_ref, dev_sweep = dev(y32.traj.x), dev(q.traj.x[:lanes])
    frac_ref = float(ag.parallel.convergence_fraction(y32, p32.opts))
    out.update(sweep_method=method, sweep_scenarios=chunk * chunks,
               sweep_converged_frac=frac, sweep_first_call_s=first_s,
               sweep_s=sweep_s, sweep_dev_f32_at_ref_gates=dev_ref,
               sweep_dev_f32_at_bench_gates=dev_sweep)
    _line("sweep", method=method, scenarios=chunk * chunks,
          converged_frac=frac, finite=finite, first_call_s=first_s,
          sweep_s=sweep_s, max_dev_vs_f64_64_lanes_at_ref_gates=dev_ref,
          ref_gates_converged_frac=frac_ref,
          max_dev_vs_f64_64_lanes_at_bench_gates=dev_sweep)
    _check(frac >= 0.999, f"converged fraction {frac} < 0.999")
    _check(finite, "non-finite trajectories")
    _check(frac_ref == 1.0, f"reference-gate solves converged {frac_ref}")
    _check(dev_ref <= 2e-3, f"deviation from float64 schur {dev_ref} > 2e-3")
    # A lane accepted at eps_opt = 1e-2 lies within that gate's reach.
    _check(dev_sweep <= 2e-2, f"sweep lanes {dev_sweep} from float64")


def phase_kkt(ag, out):
    """KKT-level accuracy across the AL penalty schedule.

    Tolerance: the float32 error of any solver of these systems grows with
    cond(K) ~ mu, so the float32 kernel is held to the pivoted float32 XLA
    scan (within 4x of its error, or 1e-4 relative, whichever is larger)
    against the float64 dense solve; the float64 kernel is held to 1e-9."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
    from algames_tpu.problem import residual as R
    from algames_tpu.problem.linear_solver import (solve_dense,
                                                   solve_tridiagonal_schur)
    from __graft_entry__ import _flagship_problem

    jax.config.update("jax_enable_x64", True)
    prob, spec = _flagship_problem(dtype=jnp.float64)
    model, obj, gc = prob.model, prob.obj, prob.gc
    B, n_dense = 128, 16
    ks = jax.random.split(jax.random.PRNGKey(0), 3)
    trajs = ag.PrimalDual(
        x=0.3 * jax.random.normal(ks[0], (B, spec.N, spec.n)),
        u=0.3 * jax.random.normal(ks[1], (B, spec.T, spec.m)),
        lam=0.3 * jax.random.normal(ks[2], (B, spec.p, spec.T, spec.n)))
    res, jbs, _, _ = jax.jit(jax.vmap(
        lambda tr: R.assemble(model, spec, obj, gc, tr, 1e-3)))(trajs)
    b = jax.vmap(lambda r: R.residual_knot_blocks(spec, r))(res)
    f32 = functools.partial(jax.tree_util.tree_map,
                            lambda x: x.astype(jnp.float32))
    kern = jax.jit(lambda j, bb: solve_thomas_pallas(spec, j, bb))
    schur = jax.jit(jax.vmap(
        lambda j, bb: solve_tridiagonal_schur(spec, j, bb)))

    def dense_one(jb, bb):
        D, U, L = R.build_tridiagonal(spec, jb)
        return solve_dense(spec, D, U, L, bb)
    dense = jax.jit(jax.vmap(dense_one))
    diag = np.arange(spec.n)
    rows = []
    for mu in (1.0, 1e2, 1e4, 1e7):
        jb_mu = R.JacBlocks(Qblk=jbs.Qblk.at[:, :, :, diag, diag].add(mu),
                            Ublk=jbs.Ublk, A=jbs.A, B=jbs.B)
        # The float64 oracle solves the float32-rounded system.
        jb32, b32 = f32(jb_mu), f32(b)
        jb_r = jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), jb32)
        b_r = b32.astype(jnp.float64)
        y64 = np.asarray(dense(jax.tree_util.tree_map(
            lambda x: x[:n_dense], jb_r), b_r[:n_dense]))
        scale = np.max(np.abs(y64))

        def rel(y):
            return float(np.max(np.abs(np.asarray(y, np.float64)[:n_dense]
                                       - y64)) / scale)
        row = {"mu": mu,
               "rel_err_kernel_f32": rel(kern(jb32, b32)),
               "rel_err_schur_f32": rel(schur(jb32, b32)),
               "rel_err_kernel_f64": rel(kern(jb_r, b_r)),
               "rel_err_schur_f64": rel(schur(jb_r, b_r))}
        rows.append(row)
        _line("kkt", **row)
    out["kkt"] = rows
    for r in rows:
        _check(r["rel_err_kernel_f32"]
               <= max(1e-4, 4 * r["rel_err_schur_f32"]),
               f"float32 kernel error at mu={r['mu']}: {r}")
        _check(r["rel_err_kernel_f64"] <= 1e-9,
               f"float64 kernel error at mu={r['mu']}: {r}")


def phase_golden(ag, out):
    """Golden fixtures in float64 on the card.  Gate 1e-6 (the CPU suite
    holds 1e-9): reductions run in another order on the GPU.  bike3_N20
    converges only to opt_vio ~7e-4, so its fixture is pinned to the
    suite's own 5e-3 there as well."""
    import os

    import jax
    import numpy as np
    from algames_tpu.presets import PRESETS

    jax.config.update("jax_enable_x64", True)
    here = os.path.dirname(os.path.abspath(__file__))
    gates = {"bike3_N20": 5e-3}
    rows = []
    for name in sorted(PRESETS):
        gold = np.load(os.path.join(here, "tests", "golden", f"{name}.npz"))
        prob, _ = PRESETS[name]()
        for method in sorted({"schur", ag.kkt_method()}):
            res = jax.jit(functools.partial(ag.newton_solve,
                                            method=method))(prob)
            dev = float(np.max(np.abs(np.asarray(res.traj.x) - gold["x"])))
            row = {"fixture": name, "method": method, "max_dev_x": dev,
                   "iter": int(res.stats.iter), "gold_iter": int(gold["iter"])}
            rows.append(row)
            _line("golden", **row)
    out["golden"] = rows
    for r in rows:
        _check(r["max_dev_x"] <= gates.get(r["fixture"], 1e-6),
               f"golden deviation {r}")


def phase_mpc_ibr(ag, out):
    """Warm-started replans at the 1e-3 gates; batched IBR solves."""
    import dataclasses

    import jax
    import jax.numpy as jnp
    import numpy as np
    from algames_tpu.presets import highway_mpc
    from algames_tpu.problem.ibr import ibr_newton_solve
    from algames_tpu.problem.options import IBROptions

    jax.config.update("jax_enable_x64", True)
    method = ag.kkt_method()
    prob, _ = highway_mpc(dtype=jnp.float32)
    H = 10
    r = jax.jit(functools.partial(ag.mpc_solve, horizon=H,
                                  method=method))(prob)
    dyn = np.asarray(r.dyn_vio)
    opt = np.asarray(r.opt_vio)
    o = prob.opts
    _line("mpc", replans=H, method=method, max_dyn_vio=float(dyn.max()),
          max_opt_vio=float(opt.max()),
          iters=np.asarray(r.iters).tolist())
    out.update(mpc_max_dyn_vio=float(dyn.max()),
               mpc_max_opt_vio=float(opt.max()))
    _check(bool(np.all(dyn < o.eps_dyn) & np.all(opt < o.eps_opt)),
           "an MPC replan missed the 1e-3 gates")

    # IBR: 2-player unicycle crossing, float64, a batch of perturbed starts
    # through the kernel and through schur (reference fixed-point gates:
    # dynamics < 1e-6, residual < 5e-2 — IBR's fixed point is not Nash).
    model = ag.unicycle_game(p=2)
    N, dt = 20, 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec, [jnp.ones(4)] * 2, [0.5 * jnp.ones(2)] * 2,
        [jnp.zeros(4)] * 2, [-jnp.ones(2)] * 2, dtype=jnp.float64)
    gc = ag.add_collision_avoidance(spec, ag.game_constraints(spec), 0.2)
    opts = ag.Options(reg_0=1e-7, eps_dyn=1e-10, eps_opt=1e-10,
                      outer_iter=7, inner_iter=20)
    x0 = jnp.array([0.0, 1.0, 0.0, 1.0, 0.0, jnp.pi, 0.4, 0.4])
    ibr_prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)
    x0s = x0[None] + 0.05 * jax.random.normal(jax.random.PRNGKey(1), (8, 8))
    res_by = {}
    for m in sorted({"schur", method}):
        q = jax.jit(jax.vmap(lambda x, m=m: ibr_newton_solve(
            dataclasses.replace(ibr_prob, x0=x), IBROptions(ibr_iter=5),
            method=m)))(x0s)
        res_by[m] = q
        fres = np.asarray(_final(q, "res"))
        fdyn = np.asarray(_final(q, "dyn_vio"))
        _line("ibr", method=m, lanes=int(x0s.shape[0]),
              max_final_res=float(fres.max()),
              max_final_dyn_vio=float(fdyn.max()))
        out[f"ibr_{m}_max_final_res"] = float(fres.max())
        _check(bool(np.all(fres < 5e-2) & np.all(fdyn < 1e-6)),
               f"IBR ({m}) did not converge")
    if len(res_by) == 2:
        dev = float(np.max(np.abs(np.asarray(res_by["schur"].traj.x)
                                  - np.asarray(res_by[method].traj.x))))
        _line("ibr", max_dev_kernel_vs_schur=dev)
        _check(dev <= 1e-6, f"IBR kernel vs schur deviation {dev}")


def phase_four(ag, out):
    """Sharded Monte-Carlo over four GPUs vs the one-GPU solve."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from algames_tpu.parallel.shard import make_mesh, sharded_monte_carlo
    from __graft_entry__ import _flagship_problem

    n_dev = len(jax.devices())
    _check(n_dev == 4, f"--four needs 4 GPUs, JAX found {n_dev}")
    method = ag.kkt_method()
    prob, _ = _flagship_problem(dtype=jnp.float32, outer=3, inner=8)
    B, chunk = 4096, 128
    x0s = _flagship_x0s(prob, B)
    mesh = make_mesh(4)
    fn = jax.jit(functools.partial(sharded_monte_carlo, prob, mesh,
                                   method=method, chunk=chunk))
    trajs, summary = fn(x0s)
    jax.block_until_ready(trajs)
    t0 = time.perf_counter()
    trajs, summary = fn(x0s)
    jax.block_until_ready(trajs)
    four_s = time.perf_counter() - t0

    dev0 = jax.devices()[0]
    x0_one = jax.device_put(x0s, dev0)
    one = jax.jit(lambda x: ag.parallel.solve_many(
        prob, x, method=method, chunk=chunk))
    ref = one(x0_one)
    jax.block_until_ready(ref.traj.x)
    t0 = time.perf_counter()
    ref = one(x0_one)
    jax.block_until_ready(ref.traj.x)
    one_s = time.perf_counter() - t0
    dev = float(np.max(np.abs(np.asarray(trajs) - np.asarray(ref.traj.x))))
    frac = float(summary["converged_frac"])
    row = {"scenarios": B, "method": method, "converged_frac": frac,
           "max_lane_dev_vs_one_gpu": dev, "four_gpu_s": four_s,
           "one_gpu_s": one_s, "mean_iters": float(summary["mean_iters"])}
    out["four"] = row
    _line("four", **row)
    _check(frac >= 0.999, f"converged fraction {frac} < 0.999")
    _check(dev <= 1e-5, f"sharded vs one-GPU deviation {dev} > 1e-5")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-GPU sharded phase")
    ap.add_argument("--out", help="write every phase's numbers to this JSON")
    args = ap.parse_args(argv)

    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"[device] JAX found {devs[0].platform}, not a GPU",
              file=sys.stderr)
        return 1
    card = _card()
    print(f"[card] {card}", flush=True)
    import algames_tpu as ag
    ag.enable_compile_cache()
    _line("device", platform=devs[0].platform, kind=devs[0].device_kind,
          count=len(devs), kkt_method=ag.kkt_method())

    out = {"card": card, "device_kind": devs[0].device_kind,
           "device_count": len(devs)}
    phases = ([phase_four] if args.four else
              [phase_sweep, phase_kkt, phase_golden, phase_mpc_ibr])
    failed = []
    for ph in phases:
        name = ph.__name__[len("phase_"):]
        t0 = time.perf_counter()
        try:
            ph(ag, out)
        except Exception:                 # recorded, and fails the run
            traceback.print_exc()
            failed.append(name)
            print(f"[{name}] FAILED", flush=True)
        print(f"[{name}] {time.perf_counter() - t0:.1f} s", flush=True)
    out["failed"] = failed
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if failed:
        print(f"[smoke] failed phases: {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
