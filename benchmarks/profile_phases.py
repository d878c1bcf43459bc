"""Device-time breakdown of the flagship sweep from a profiler trace.

Traces one steady-state ``parallel.solve_many`` sweep of the flagship
(3-player unicycle, N = 20, float32) with the platform's KKT method and
reduces the device trace to

* the busy and idle share of the traced window on the device,
* device time per solver phase, by the ``jax.named_scope`` the solver puts
  around each: ``assemble`` (residual + Jacobian rebuild), ``kkt`` (the KKT
  sweep), ``ls_trial`` (line-search trial evaluation); the rest is loop
  control, the AL update and bookkeeping.

    python benchmarks/profile_phases.py [--chunk 128] [--chunks 32]
        [--method schur|pallas] [--trace-dir DIR]

Prints one JSON line; ``--trace-dir`` keeps the raw trace.

XLA on the GPU replays the loop bodies as CUDA graphs (command buffers),
and a kernel launched from a graph carries the graph's op name, not its
own: per-phase times need ``XLA_FLAGS=--xla_gpu_enable_command_buffer=``,
which also changes the busy and idle shares it reports.
"""
import argparse
import glob
import json
import os
import re
import sys
import tempfile
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PHASES = ("assemble", "kkt", "ls_trial")
# A scope appears in an op's name as ``.../kkt/...`` or, under a transform,
# as ``.../vmap(ls_trial)/...``.
_SCOPE = {p: re.compile(rf"[/(]{p}[)/]") for p in PHASES}


def _event_text(ev):
    parts = [ev.name]
    for k, v in ev.stats:
        parts.append(f"{k}={v}")
    return " ".join(parts)


def _union(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path):
    """Busy/idle share and per-phase device time from one ``.xplane.pb``.

    Device planes are the ``/device:GPU:*`` planes; their kernel events are
    attributed to a phase when the phase's scope name appears in the
    event's name or stats (XLA carries the op's name scope there)."""
    from jax.profiler import ProfileData
    pd = ProfileData.from_file(path)
    out = {}
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        # Kernel events: the per-stream lines, else the derived "XLA Ops"
        # line (never both: they describe the same kernels).
        lines = ([ln for ln in plane.lines if ln.name.startswith("Stream")]
                 or [ln for ln in plane.lines if ln.name == "XLA Ops"])
        evs = [e for ln in lines for e in ln.events]
        if not evs:
            continue
        t0 = min(e.start_ns for e in evs)
        t1 = max(e.end_ns for e in evs)
        busy = _union([(e.start_ns, e.end_ns) for e in evs])
        by = {ph: 0.0 for ph in PHASES}
        by["other"] = 0.0
        for e in evs:
            txt = _event_text(e)
            ph = next((p for p in PHASES if _SCOPE[p].search(txt)), "other")
            by[ph] += e.duration_ns
        tot = sum(by.values())
        out[plane.name] = {
            "window_ms": (t1 - t0) / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / max(t1 - t0, 1),
            "kernel_ms": {k: v / 1e6 for k, v in by.items()},
            "kernel_share": {k: v / max(tot, 1) for k, v in by.items()},
            "n_kernels": len(evs)}
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chunk", type=int, default=128)
    ap.add_argument("--chunks", type=int, default=32)
    ap.add_argument("--method", default=None)
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()

    import algames_tpu as ag
    from __graft_entry__ import _flagship_problem

    ag.enable_compile_cache()
    method = args.method or ag.kkt_method()
    prob, _ = _flagship_problem(dtype=jnp.float32, outer=3, inner=8)
    n = args.chunk * args.chunks
    x0s = jnp.tile(prob.x0[None], (n, 1))
    x0s = x0s + 0.05 * jax.random.normal(jax.random.PRNGKey(0), x0s.shape,
                                         jnp.float32)
    fn = jax.jit(lambda x: ag.parallel.solve_many(
        prob, x, method=method, chunk=args.chunk,
        unroll=2 if args.chunks > 1 else 1).traj.x)
    fn(x0s).block_until_ready()
    t0 = time.perf_counter()
    fn(x0s).block_until_ready()
    wall = time.perf_counter() - t0

    tdir = args.trace_dir or tempfile.mkdtemp(prefix="algames_trace_")
    with jax.profiler.trace(tdir):
        fn(x0s).block_until_ready()
    paths = sorted(glob.glob(os.path.join(tdir, "**", "*.xplane.pb"),
                             recursive=True))
    red = reduce_trace(paths[-1]) if paths else {}
    print(json.dumps({"metric": "flagship_phase_breakdown", "method": method,
                      "chunk": args.chunk, "chunks": args.chunks,
                      "untraced_wall_s": wall, "solves_per_s": n / wall,
                      "devices": red, **ag.device_info()}))


if __name__ == "__main__":
    main()
