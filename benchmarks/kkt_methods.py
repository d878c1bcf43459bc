"""End-to-end flagship throughput by KKT method: the fused sweep kernel
(``pallas``) against the XLA scan (``schur``).

Runs ``parallel.solve_many`` on 32,768 flagship scenarios (3-player unicycle,
N = 20, float32, outer 3 x inner 8) at two chunk shapes — 128 lanes x 256
chunks (the ``bench.py`` shape) and 4,096 lanes x 8 chunks — and times each
method in the order kernel, schur, schur, kernel after one warm call; the
best of each method's two runs is kept.  GPU only.

    python benchmarks/kkt_methods.py [--out FILE.json]

Prints one JSON line per shape and, with ``--out``, writes them together
with the card's name and power limit.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((128, 256), (4096, 8))
METHODS = ("pallas", "schur")


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out")
    args = ap.parse_args()

    import algames_tpu as ag
    from __graft_entry__ import _flagship_problem

    dev = ag.device_info()
    if dev["platform"] != "gpu":
        sys.exit(f"kkt_methods.py measures the GPU; JAX found {dev['platform']}")
    ag.enable_compile_cache()
    card = _card()
    print(f"[card] {card}", flush=True)
    prob, _ = _flagship_problem(dtype=jnp.float32, outer=3, inner=8)
    rows = []
    for chunk, chunks in SHAPES:
        n = chunk * chunks
        x0s = jnp.tile(prob.x0[None], (n, 1)) + 0.05 * jax.random.normal(
            jax.random.PRNGKey(0), (n, prob.x0.shape[0]), jnp.float32)
        fns = {m: jax.jit(lambda x, m=m: ag.parallel.solve_many(
            prob, x, method=m, chunk=chunk, unroll=2)) for m in METHODS}
        best = {}
        for m in METHODS:
            fns[m](x0s).traj.x.block_until_ready()
        for m in METHODS + METHODS[::-1]:
            t0 = time.perf_counter()
            fns[m](x0s).traj.x.block_until_ready()
            best[m] = min(best.get(m, float("inf")), time.perf_counter() - t0)
        row = {"chunk": chunk, "chunks": chunks, "scenarios": n,
               **{f"{m}_s": best[m] for m in METHODS},
               **{f"{m}_solves_per_s": n / best[m] for m in METHODS},
               **dev}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
