"""The GPU path as far as the CPU can check it: the fused sweep kernel in
the Pallas interpreter against the XLA ``schur`` scan and the dense oracle,
its tiling and batching, the platform's method choice, the compile-cache
helper, the precision pins, and ``chip_smoke.py`` refusing a machine
without a GPU."""
import os
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import algames_tpu as ag
from algames_tpu import runtime
from algames_tpu.ops import thomas_pallas as TP
from algames_tpu.problem import residual as R
from algames_tpu.problem.linear_solver import (solve_dense,
                                               solve_tridiagonal_schur)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _systems(model, N, B=2, mu=0.0, seed=0):
    """B random mid-solve KKT systems; ``mu`` adds AL-penalty curvature to
    the Q diagonal (the late-schedule conditioning)."""
    spec = ag.spec_from_model(model, N, 0.1)
    p = spec.p
    obj = ag.game_objective(
        spec, [jnp.ones(spec.n // p)] * p,
        [0.5 * jnp.ones(len(spec.pu[i])) for i in range(p)],
        [jnp.zeros(spec.n // p)] * p,
        [jnp.zeros(len(spec.pu[i])) for i in range(p)], dtype=jnp.float64)
    gc = ag.add_control_bound(spec, ag.game_constraints(spec),
                              jnp.ones(spec.m), -jnp.ones(spec.m))
    ks = jax.random.split(jax.random.PRNGKey(seed), 3)
    trajs = ag.PrimalDual(
        x=0.3 * jax.random.normal(ks[0], (B, spec.N, spec.n)),
        u=0.3 * jax.random.normal(ks[1], (B, spec.T, spec.m)),
        lam=0.3 * jax.random.normal(ks[2], (B, p, spec.T, spec.n)))
    res, jbs, _, _ = jax.vmap(
        lambda tr: R.assemble(model, spec, obj, gc, tr, 1e-3))(trajs)
    b = jax.vmap(lambda r: R.residual_knot_blocks(spec, r))(res)
    if mu:
        d = np.arange(spec.n)
        jbs = R.JacBlocks(Qblk=jbs.Qblk.at[:, :, :, d, d].add(mu),
                          Ublk=jbs.Ublk, A=jbs.A, B=jbs.B)
    return spec, jbs, b


def _dense(spec, jbs, b):
    def one(jb, bb):
        D, U, L = R.build_tridiagonal(spec, jb)
        return solve_dense(spec, D, U, L, bb)
    return np.asarray(jax.vmap(one)(jbs, b))


SHAPES = {
    "flagship": lambda: ag.unicycle_game(p=3),
    "hetero": lambda: ag.hetero_double_integrator_game(),
    "quadrotor": lambda: ag.quadrotor_game(p=2),
}


@pytest.mark.parametrize("mu", [0.0, 1e7])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_kernel_matches_schur_and_dense(shape, mu):
    spec, jbs, b = _systems(SHAPES[shape](), 6, mu=mu)
    y_k = np.asarray(TP.solve_thomas_pallas(spec, jbs, b, interpret=True))
    y_s = np.asarray(jax.vmap(
        lambda j, bb: solve_tridiagonal_schur(spec, j, bb))(jbs, b))
    y_d = _dense(spec, jbs, b)
    scale = np.abs(y_d).max()
    np.testing.assert_allclose(y_k, y_s, rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(y_k, y_d, rtol=0, atol=1e-9 * scale)


def test_kernel_float32_accuracy_at_mu_1e7():
    """Row partial pivoting holds the float32 kernel to the float32 XLA
    scan's accuracy at the top of the AL penalty schedule."""
    spec, jbs, b = _systems(ag.unicycle_game(p=3), 8, B=3, mu=1e7)
    f32 = lambda t: jax.tree_util.tree_map(lambda x: x.astype(jnp.float32), t)
    jb32, b32 = f32(jbs), f32(b)
    up = lambda t: jax.tree_util.tree_map(lambda x: x.astype(jnp.float64), t)
    y64 = _dense(spec, up(jb32), up(b32))
    y_k = np.asarray(TP.solve_thomas_pallas(spec, jb32, b32, interpret=True))
    y_s = np.asarray(jax.vmap(
        lambda j, bb: solve_tridiagonal_schur(spec, j, bb))(jb32, b32))
    assert y_k.dtype == np.float32
    err_k = np.abs(y_k - y64).max() / np.abs(y64).max()
    err_s = np.abs(y_s - y64).max() / np.abs(y64).max()
    assert err_k <= max(1e-4, 4 * err_s), (err_k, err_s)


@pytest.mark.parametrize("n,ms,p,expect", [
    (12, 6, 3, dict(NP=16, PP=4, DP=32, CP=64)),     # flagship
    (24, 8, 2, dict(NP=32, PP=2, DP=32, CP=128)),    # quadrotor
    (16, 8, 4, dict(NP=16, PP=4, DP=32, CP=128)),    # roundabout
    (4, 2, 1, dict(NP=4, PP=1, DP=8, CP=16)),        # IBR player sub-KKT
])
def test_tile_dims(n, ms, p, expect):
    dims = TP.tile_dims(n, ms, p)
    assert dims == expect
    assert all(v & (v - 1) == 0 for v in dims.values())
    assert dims["CP"] >= n + ms + p * n + 1 and dims["DP"] >= n + ms


def test_warps_for_batch():
    """Two warps for the shortest single-program sweep; one warp per
    program once the grid fills the card."""
    assert TP.warps_for_batch(1) == 2
    assert TP.warps_for_batch(128) == 2
    assert TP.warps_for_batch(4096) == 1


def test_batching_rule_broadcasts_unbatched_leaves():
    """The per-scenario solve under vmap with a shared (unbatched) B block
    equals solving each scenario alone."""
    spec, jbs, b = _systems(ag.unicycle_game(p=2), 5, B=3)
    solve = TP.thomas_pallas_for_spec(spec, interpret=True)
    jb_shared = R.JacBlocks(Qblk=jbs.Qblk, Ublk=jbs.Ublk, A=jbs.A,
                            B=jbs.B[0])
    ys = jax.vmap(solve, in_axes=(R.JacBlocks(Qblk=0, Ublk=0, A=0, B=None),
                                  0))(jb_shared, b)
    for i in range(3):
        jb_i = R.JacBlocks(Qblk=jbs.Qblk[i], Ublk=jbs.Ublk[i], A=jbs.A[i],
                           B=jbs.B[0])
        np.testing.assert_allclose(
            np.asarray(ys[i]),
            np.asarray(solve_tridiagonal_schur(spec, jb_i, b[i])),
            rtol=0, atol=1e-10)


@pytest.mark.parametrize("platform,method", [
    ("gpu", "pallas"), ("cpu", "schur"), ("rocm", "schur")])
def test_kkt_method_per_platform(platform, method):
    assert ag.kkt_method(platform) == method


def test_kkt_method_default_backend():
    assert ag.kkt_method() == ag.kkt_method(jax.default_backend())


def test_compile_cache_honours_env(monkeypatch):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert runtime.compile_cache_dir() is None
    before = jax.config.jax_compilation_cache_dir
    runtime.enable_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a, b = runtime.compile_cache_dir(), runtime.compile_cache_dir()
    assert a == b == os.path.join(ROOT, ".jax_cache")


def test_device_info_fields():
    info = ag.device_info()
    assert set(info) == {"platform", "device_kind", "device_count"}
    assert info["platform"] == "cpu" and info["device_count"] >= 1


def _hlo_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                if hasattr(v, "jaxpr") and hasattr(v.jaxpr, "eqns"):
                    walk(v.jaxpr)
                elif hasattr(v, "eqns"):
                    walk(v)
    walk(jaxpr.jaxpr)
    return found


def test_schur_scan_contractions_are_highest():
    spec, jbs, b = _systems(ag.unicycle_game(p=3), 4, B=1)
    f32 = lambda t: jax.tree_util.tree_map(
        lambda x: x[0].astype(jnp.float32), t)
    precs = _hlo_precisions(
        lambda j, bb: solve_tridiagonal_schur(spec, j, bb), f32(jbs), f32(b))
    assert precs, "no contractions found in the Schur scan"
    hi = jax.lax.Precision.HIGHEST
    assert all(p == (hi, hi) for p in precs), precs


def test_residual_contractions_are_highest():
    """The multi-row AL gradient/Hessian contractions (circle obstacles)."""
    from algames_tpu.presets import flagship_unicycle
    prob, spec = flagship_unicycle(outer=1, inner=1)
    gc = ag.add_circle_constraint(spec, prob.gc, [0.3, 0.8], [0.1, -0.1],
                                  [0.15, 0.2])
    traj = ag.zero_traj(spec, jnp.float64)
    pd = R.point_data(prob.model, spec, prob.obj, gc, traj)
    precs = _hlo_precisions(
        lambda t, p_: R.assemble_from_point(spec, prob.obj, gc, t, p_,
                                            reg=1e-3), traj, pd)
    hi = jax.lax.Precision.HIGHEST
    assert precs and all(p == (hi, hi) for p in precs), precs


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_chip_smoke_fails_outside_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path))
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
