"""Golden-trajectory regression gates (BASELINE correctness anchor).

``tests/golden/*.npz`` freeze the f64 dense-oracle equilibrium trajectories
of the BASELINE configs at the reference default budget (outer=7 x inner=20,
eps 1e-3 — ``/root/reference/src/struct/options.jl:73-91``), produced by
``tests/golden/generate.py``.  Every structured linear-solver method must
reproduce them, and the f32 trajectory must match the f64 oracle at
equal iteration caps (reference anchor for the converged-trajectory test:
``/root/reference/test/problem/solver_methods.jl:164-182``).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

import algames_tpu as ag
from algames_tpu.presets import PRESETS

HERE = os.path.dirname(os.path.abspath(__file__))


def _gold(name):
    return np.load(os.path.join(HERE, "golden", f"{name}.npz"))


def _solve(name, method, dtype=jnp.float64):
    prob, _ = PRESETS[name](dtype=dtype)
    out = ag.newton_solve_jit(prob, method=method)
    it = int(out.stats.iter)
    vio = {k: float(getattr(out.stats, k)[it - 1])
           for k in ("dyn_vio", "con_vio", "sta_vio", "opt_vio")}
    return out, it, vio


# Per-config trajectory tolerance for structured (non-dense) methods.  The
# bike3 config converges to opt_vio ~6.7e-4, so its equilibrium is only
# pinned to that level — different factorization roundoff walks within the
# near-converged plateau.
_ATOL = {"di2_N10": (1e-9, 1e-9), "uni3_N20": (1e-9, 1e-9),
         "bike3_N20": (5e-3, 5e-2),
         "round4_N40": (1e-9, 1e-9), "quad2_N15": (1e-9, 1e-9)}

# Per-config optimality gate: the quadrotor's max(0, kf*w) thrust clamp is
# non-smooth at hover, so absolute stationarity plateaus ~3e-2 regardless of
# budget (see tests/golden/generate.py); all other violations reach 1e-3.
_OPT_GATE = {"quad2_N15": 5e-2}

CASES = [
    ("uni3_N20", "dense"), ("uni3_N20", "tridiag"), ("uni3_N20", "schur"),
    ("uni3_N20", "cr"), ("uni3_N20", "pallas_interpret"),
    ("di2_N10", "dense"), ("di2_N10", "schur"),
    ("di2_N10", "pallas_interpret"),
    ("bike3_N20", "dense"), ("bike3_N20", "schur"),
    # big configs: tridiag generated the fixture; gate the structured
    # paths (schur + the fused sweep kernel at the W=88 / W=80 shapes)
    ("round4_N40", "schur"), ("round4_N40", "pallas_interpret"),
    ("quad2_N15", "schur"), ("quad2_N15", "pallas_interpret"),
]


@pytest.mark.parametrize("name,method", CASES)
def test_golden_trajectory(name, method):
    gold = _gold(name)
    out, it, vio = _solve(name, method)
    atol_x, atol_u = _ATOL[name]
    assert it == int(gold["iter"]), (it, int(gold["iter"]))
    np.testing.assert_allclose(np.asarray(out.traj.x), gold["x"],
                               atol=atol_x, rtol=0)
    np.testing.assert_allclose(np.asarray(out.traj.u), gold["u"],
                               atol=atol_u, rtol=0)
    assert vio["opt_vio"] < _OPT_GATE.get(name, 1e-3) and all(
        vio[k] < 1e-3 for k in ("dyn_vio", "con_vio", "sta_vio")), vio


def test_golden_spike_method():
    """The horizon-sharded SPIKE KKT method, driven end-to-end through the
    full Newton/AL solve, reproduces the flagship golden trajectory."""
    gold = _gold("uni3_N20")
    prob, _ = PRESETS["uni3_N20"]()
    mesh = Mesh(np.asarray(jax.devices()[:1]), ("hz",))
    out = ag.newton_solve_jit(prob,
                              method=ag.parallel.spike_kkt_method(mesh))
    assert int(out.stats.iter) == int(gold["iter"])
    np.testing.assert_allclose(np.asarray(out.traj.x), gold["x"],
                               atol=1e-9, rtol=0)


@pytest.mark.parametrize("name", ["di2_N10", "uni3_N20"])
@pytest.mark.parametrize("method", ["schur", "pallas_interpret"])
def test_f32_matches_f64_golden_equal_budget(name, method):
    """The f32 trajectory matches the f64 oracle at equal iteration
    caps (BASELINE "match reference trajectories at equal iteration budget";
    quantifies the ~2e-3 claim in ``__graft_entry__``)."""
    gold = _gold(name)
    out, it, vio = _solve(name, method, dtype=jnp.float32)
    assert out.traj.x.dtype == jnp.float32
    dx = float(np.max(np.abs(np.asarray(out.traj.x) - gold["x"])))
    assert dx < 1e-3, dx
    # f32 gates: dyn/con/sta at the reference 1e-3; opt at the f32 floor 1e-2
    # (see presets._default_eps_opt).
    assert vio["dyn_vio"] < 1e-3 and vio["con_vio"] < 1e-3 \
        and vio["sta_vio"] < 1e-3 and vio["opt_vio"] < 1e-2, vio
