"""Generate golden-trajectory fixtures for the BASELINE configs.

Solves each preset with the f64 DENSE-oracle linear solver at the reference
default budget (outer=7 x inner=20, eps all 1e-3 —
``/root/reference/src/struct/options.jl:73-91``) and freezes the converged
primal-dual trajectory plus its final violations as an ``.npz`` fixture.

``tests/test_golden.py`` regression-gates every structured linear-solver
method against these fixtures, and the f32 trajectory against the
f64 oracle at equal budget (the BASELINE "match reference open-loop
equilibrium trajectories within tolerance at equal iteration budget" anchor,
reference trajectories themselves being defined by the same algorithm at the
same budget: ``/root/reference/test/problem/solver_methods.jl:164-182``).

Run:  python tests/golden/generate.py
"""
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

import algames_tpu as ag
from algames_tpu.presets import PRESETS

HERE = os.path.dirname(os.path.abspath(__file__))


# Oracle method per config: dense LU for the small ones; block-Thomas for
# the big ones (S=3432 roundabout / S=1120 quadrotor make per-iteration
# dense LU prohibitive on CPU) — justified as an oracle by the
# dense==tridiag f64 agreement at ~1e-15 on the small configs
# (tests/test_golden.py, tests/test_linear_solver.py).
METHOD = {"round4_N40": "tridiag", "quad2_N15": "tridiag"}

# Per-config optimality gate: the quadrotor's max(0, kf*w) thrust clamp is
# non-smooth at the hover point, so absolute stationarity plateaus ~3e-2
# regardless of budget (verified at 6x12 / 8x20 / 12x20); dyn/con/sta still
# reach 1e-3.  The reference ships NO quadrotor solver test (dynamics only,
# test/dynamics/quadrotor.jl) — this fixture goes beyond it and records the
# plateau as the regression anchor.
OPT_GATE = {"quad2_N15": 5e-2}


def main():
    only = set(sys.argv[1:])
    for name, build in PRESETS.items():
        if only and name not in only:
            continue
        prob, spec = build()
        out = ag.newton_solve_jit(prob, method=METHOD.get(name, "dense"))
        it = int(out.stats.iter)
        vio = {k: float(getattr(out.stats, k)[it - 1])
               for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")}
        gate = OPT_GATE.get(name, 1e-3)
        assert vio["opt_vio"] < gate and all(
            vio[k] < 1e-3 for k in ("dyn_vio", "con_vio", "sta_vio")), \
            (name, vio)
        path = os.path.join(HERE, f"{name}.npz")
        np.savez(
            path,
            x=np.asarray(out.traj.x),
            u=np.asarray(out.traj.u),
            lam=np.asarray(out.traj.lam),
            iter=it,
            outer_iter=prob.opts.outer_iter,
            inner_iter=prob.opts.inner_iter,
            **vio,
        )
        print(f"{name}: iter={it} "
              + " ".join(f"{k}={v:.2e}" for k, v in vio.items())
              + f" -> {path}")


if __name__ == "__main__":
    main()
