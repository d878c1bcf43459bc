"""Auxiliary subsystems: checkpointing, stats printer, scn formatting,
profiling helpers, divergence masks."""
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np

import algames_tpu as ag
from algames_tpu import checkpoint as ckpt
from algames_tpu.parallel import divergence_mask, solve_batch
from algames_tpu.profiling import phase_profile
from algames_tpu.stats import init_stats, print_stats, record
from algames_tpu.utils import scn


def test_scn_formatting():
    # reference scn semantics (src/utils.jl:63-85)
    assert scn(0.0) == " 0.0e+0"
    assert scn(123.4) == " 1.2e+2"
    assert scn(-0.00123) == "-1.2e-3"
    assert scn(1.0) == " 1.0e+0"
    # exponent is floored, so 9.99e-7 keeps e-7 (reference scn behavior)
    assert scn(9.99e-7, digits=2) == " 9.99e-7"


def test_stats_record_and_print(capsys):
    stats = init_stats(4, jnp.float64)
    one = jnp.asarray(1.0)
    stats = record(stats, True, 1, one * 0.5, one * 0.1, one,
                   one * 1e-3, one * 0.0, one * 0.0, one * 2e-2)
    stats = record(stats, False, 2, one, one, one, one, one, one, one)
    assert int(stats.iter) == 1            # masked record is a no-op
    np.testing.assert_allclose(float(stats.res[0]), 0.5)
    print_stats(stats)
    out = capsys.readouterr().out
    assert "5.0e-1" in out and "2.0e-2" in out


def test_stats_record_saturates_at_capacity():
    """Past capacity the LAST row keeps the latest record and ``iter``
    saturates — long IBR runs must not read a stale final row
    (problem/ibr.py capacity 4096 vs ibr_iter=100 worth of records)."""
    cap = 4
    stats = init_stats(cap, jnp.float64)
    one = jnp.asarray(1.0)
    for t in range(7):
        stats = record(stats, True, t, one * (t + 1), one, one,
                       one, one, one, one)
    assert int(stats.iter) == cap
    # final-row gather (what divergence_mask / convergence_fraction read)
    np.testing.assert_allclose(float(stats.res[int(stats.iter) - 1]), 7.0)
    np.testing.assert_allclose(np.asarray(stats.res), [1.0, 2.0, 3.0, 7.0])
    assert int(stats.outer[cap - 1]) == 6


def test_ibr_stats_overflow_final_record_truthful():
    """End-to-end: an IBR run whose record count exceeds the stats capacity
    still reports the true final residual (reference keeps unbounded host
    vectors, src/struct/statistics.jl:5-72)."""
    from algames_tpu.problem.ibr import ibr_newton_solve
    from algames_tpu.problem import ibr as ibr_mod
    from algames_tpu import IBROptions

    p = 1
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, 5, 0.1)
    obj = ag.game_objective(spec, [jnp.ones(4)], [0.1 * jnp.ones(2)],
                            [jnp.asarray([1.0, 0.1, 0.0, 0.0])],
                            [jnp.zeros(2)])
    gc = ag.game_constraints(spec)
    x0 = jnp.asarray([0.0, 0.0, 0.0, 0.3])
    opts = ag.Options(outer_iter=3, inner_iter=4)
    prob = ag.game_problem(5, 0.1, x0, model, opts, obj, gc)
    # Shrink the capacity cap so this small run overflows it.
    orig = ibr_mod.init_stats
    try:
        ibr_mod.init_stats = lambda cap, dtype: orig(min(cap, 3), dtype)
        out = ibr_newton_solve(prob, IBROptions(ibr_iter=4))
    finally:
        ibr_mod.init_stats = orig
    it = int(out.stats.iter)
    assert it == 3  # saturated
    # The final record is the explicit end-of-solve record: its residual
    # must match a fresh residual evaluation at the returned trajectory.
    from algames_tpu.problem import residual as R
    res = R.residual(model, spec, prob.obj, out.gc, out.traj)
    np.testing.assert_allclose(float(out.stats.res[it - 1]),
                               float(R.residual_norm(spec, res)), rtol=1e-12)


def test_checkpoint_traj_roundtrip():
    spec = ag.spec_from_model(ag.unicycle_game(p=2), 6, 0.1)
    traj = ag.PrimalDual(
        x=jnp.arange(spec.N * spec.n, dtype=jnp.float64).reshape(spec.N, spec.n),
        u=jnp.ones((spec.T, spec.m)), lam=2 * jnp.ones((2, spec.T, spec.n)))
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "t.npz")
        ckpt.save_traj(path, traj)
        back = ckpt.load_traj(path)
        np.testing.assert_allclose(np.asarray(back.x), np.asarray(traj.x))
        np.testing.assert_allclose(np.asarray(back.lam), np.asarray(traj.lam))
        back32 = ckpt.load_traj(path, dtype=np.float32)
        assert back32.x.dtype == jnp.float32


def test_divergence_mask_flags_nan_lane():
    p = 2
    model = ag.double_integrator_game(p=p)
    spec = ag.spec_from_model(model, 5, 0.1)
    obj = ag.game_objective(spec, [jnp.ones(4)] * p, [jnp.ones(2)] * p,
                            [jnp.zeros(4)] * p, [jnp.zeros(2)] * p,
                            dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    prob = ag.game_problem(5, 0.1, jnp.ones(8), model,
                           ag.Options(outer_iter=1, inner_iter=2), obj, gc)
    x0s = jnp.stack([prob.x0, prob.x0.at[0].set(jnp.nan)])
    out = solve_batch(prob, x0s)
    mask = np.asarray(divergence_mask(out))
    assert mask.tolist() == [False, True]


def test_phase_profile_runs():
    f = jax.jit(lambda: jnp.sum(jnp.ones((64, 64))))
    res = phase_profile({"sum": f}, reps=3)
    assert res["sum"] >= 0.0


def test_quadrotor_mesh_obj(tmp_path):
    """Procedural quadrotor mesh: watertight indices, valid OBJ output
    (replaces the reference's static src/mesh/quadrotor assets)."""
    import numpy as np
    from algames_tpu.plots.mesh import quadrotor_mesh, write_obj

    v, f = quadrotor_mesh()
    assert v.ndim == 2 and v.shape[1] == 3
    assert f.min() == 0 and f.max() == len(v) - 1
    path = write_obj(str(tmp_path / "quad.obj"))
    lines = open(path).read().splitlines()
    nv = sum(1 for l in lines if l.startswith("v "))
    nf = sum(1 for l in lines if l.startswith("f "))
    assert nv == len(v) and nf == len(f)
    # OBJ faces are 1-based
    first_face = next(l for l in lines if l.startswith("f "))
    assert min(int(t) for t in first_face.split()[1:]) >= 1


def test_regularizer_penalty_shims():
    import algames_tpu as ag

    r = ag.Regularizer().set(2.0)
    assert r.x == r.u == r.lam == 2.0
    r = r.mult(3.0)
    assert r.x == 6.0
    pen = ag.Penalty(rho=5.0)
    assert pen.rho == 5.0 and pen.rho_trial == 1.0


def test_timed_solve_matches_and_times():
    """``profiling.timed_solve`` (the reference ``Statistics.t_elap``
    diagnostic, ``solver_methods.jl:40-41``) runs the identical iteration
    state machine: bitwise-equal trajectories, one wall-time entry per
    executed inner iteration."""
    import numpy as np
    import jax.numpy as jnp

    import algames_tpu as ag
    from algames_tpu.presets import PRESETS

    prob, _ = PRESETS["di2_N10"](dtype=jnp.float64)
    ref = ag.newton_solve_jit(prob, method="schur")
    out, t_elap = ag.profiling.timed_solve(prob, method="schur")
    assert int(out.stats.iter) == int(ref.stats.iter)
    np.testing.assert_array_equal(np.asarray(out.traj.x),
                                  np.asarray(ref.traj.x))
    # one entry per inner iteration (the final stats row is the closing
    # record, not an iteration), all positive
    assert len(t_elap) == int(ref.stats.iter) - 1
    assert all(t > 0 for t in t_elap)


def test_dynamics_violation_vector():
    """Per-knot dynamics-defect vector (reference ``DynamicsViolation.vio``,
    ``src/struct/violations.jl:16-24``): zero along an exact RK2 rollout
    except where the trajectory is perturbed."""
    import jax
    import jax.numpy as jnp

    import algames_tpu as ag
    from algames_tpu.core.traj import PrimalDual, init_traj
    from algames_tpu.models.integration import rk2_step

    model = ag.unicycle_game(p=2)
    spec = ag.spec_from_model(model, 10, 0.1)
    key = jax.random.PRNGKey(3)
    traj = init_traj(spec, jnp.zeros(spec.n, jnp.float64), key=key,
                     amplitude=0.1)
    # RK2-consistent rollout -> zero defects
    xs = [traj.x[0]]
    for t in range(spec.T):
        xs.append(rk2_step(model, xs[-1], traj.u[t], spec.dt))
    traj = PrimalDual(x=jnp.stack(xs), u=traj.u, lam=traj.lam)
    v = ag.dynamics_violation_vector(model, spec, traj)
    assert v.shape == (spec.T,)
    assert float(jnp.max(v)) < 1e-12
    # perturb knot 4 -> only defects at intervals 3 (misses it as target)
    # and 4 (starts from it) light up
    traj2 = PrimalDual(x=traj.x.at[4].add(0.5), u=traj.u, lam=traj.lam)
    v2 = ag.dynamics_violation_vector(model, spec, traj2)
    assert float(v2[3]) > 0.1 and float(v2[4]) > 0.01
    mask = jnp.ones(spec.T, bool).at[3].set(False).at[4].set(False)
    assert float(jnp.max(jnp.where(mask, v2, 0.0))) < 1e-12
