"""Adversarial line-search / penalty-schedule stress fuzz.

Full solves engineered for the solver's worst paths: random INFEASIBLE
starts (players spawned inside each other's collision radius), tight control
bounds, a demanding Armijo parameter (deep line-search histograms), and both
penalty schedules (``adaptive_penalty`` off and on — the LANCELOT-style
safeguard, ``problem/solver.py:_outer_update``).  The contract under test is
convergence-or-masked-divergence: every lane either produces an all-finite
result, or is flagged by ``parallel.divergence_mask`` — NaNs never escape
unflagged (SURVEY.md §5 failure detection).

24 cases = 4 shapes x 2 penalty modes x 3 random starts, solved with the
pivoted-XLA ``schur`` path; the Pallas kernel path (``pallas_interpret``)
runs on a 12-case subset (interpret mode is ~10x slower to execute).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import algames_tpu as ag

SHAPES = [
    # (family, p, N, collision_radius, control_limit)
    ("unicycle", 2, 10, 0.5, 0.4),
    ("unicycle", 3, 8, 0.4, 0.3),
    ("bicycle", 2, 12, 0.45, 0.5),
    ("di", 3, 9, 0.35, 0.25),
]


def _make(family, p):
    if family == "di":
        return ag.double_integrator_game(p=p, d=2)
    if family == "unicycle":
        return ag.unicycle_game(p=p)
    return ag.bicycle_game(p=p)


def _stress_problem(family, p, N, radius, ulim, adaptive):
    model = _make(family, p)
    dt = 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec,
        Q=[5 * jnp.ones(model.ni[i]) for i in range(p)],
        R=[0.1 * jnp.ones(model.mi[i]) for i in range(p)],
        # Crossing targets keep the collision constraint under pressure.
        xf=[jnp.zeros(model.ni[i]).at[0].set(1.5)
            .at[1].set(0.5 * (p - 1 - 2 * i)) for i in range(p)],
        uf=[jnp.zeros(model.mi[i]) for i in range(p)],
        dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, radius)
    gc = ag.add_control_bound(spec, gc, ulim * jnp.ones(spec.m),
                              -ulim * jnp.ones(spec.m))
    gc = ag.add_state_bound(spec, gc, 0, 4.0 * np.ones(spec.n),
                            -4.0 * np.ones(spec.n))
    opts = ag.Options(outer_iter=5, inner_iter=10, beta=0.8, ls_iter=25,
                      adaptive_penalty=adaptive)
    x0 = jnp.zeros(spec.n)   # placeholder; starts are randomized per lane
    return ag.game_problem(N, dt, x0, model, opts, obj, gc), spec


def _infeasible_starts(rng, spec, p, radius, n_lanes):
    """Random starts with every player pair INSIDE the collision radius."""
    x0s = np.zeros((n_lanes, spec.n))
    for b in range(n_lanes):
        center = rng.uniform(-0.3, 0.3, 2)
        for i in range(p):
            # Positions clustered within ~radius/2 of a common center.
            pos = center + rng.uniform(-0.25, 0.25, 2) * radius
            x0s[b, np.asarray(spec.px[i])] = pos
            # Remaining per-player states: small random values.
            rest = np.asarray(spec.pz[i])[2:]
            x0s[b, rest] = rng.uniform(-0.3, 0.3, rest.size)
    return jnp.asarray(x0s)


def _check_no_nan_escape(out, opts):
    """Every lane: all-finite result, or flagged by divergence_mask."""
    diverged = np.asarray(ag.parallel.divergence_mask(out))
    finite_traj = np.all(np.isfinite(np.asarray(out.traj.x).reshape(
        out.traj.x.shape[0], -1)), axis=1)
    finite_u = np.all(np.isfinite(np.asarray(out.traj.u).reshape(
        out.traj.u.shape[0], -1)), axis=1)
    ok = diverged | (finite_traj & finite_u)
    assert ok.all(), (
        f"NaN escaped unflagged: diverged={diverged}, "
        f"finite_traj={finite_traj}, finite_u={finite_u}")
    # Recorded stats rows up to iter must be finite on unflagged lanes.
    it = np.asarray(out.stats.iter)
    res = np.asarray(out.stats.res)
    for b in range(res.shape[0]):
        if not diverged[b]:
            assert np.all(np.isfinite(res[b, :it[b]])), (
                f"non-finite residual recorded on unflagged lane {b}")
    return diverged


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("shape_i", range(len(SHAPES)))
def test_stress_schur(shape_i, adaptive):
    family, p, N, radius, ulim = SHAPES[shape_i]
    prob, spec = _stress_problem(family, p, N, radius, ulim, adaptive)
    rng = np.random.default_rng(1000 + 10 * shape_i + adaptive)
    x0s = _infeasible_starts(rng, spec, p, radius, 3)
    out = jax.jit(lambda x: ag.parallel.solve_batch(
        prob, x, method="schur"))(x0s)
    diverged = _check_no_nan_escape(out, prob.opts)
    # The stress must not be SO hard that nothing ever solves: across the
    # suite most lanes converge (checked per-case loosely, <=1e-2 dyn).
    it = np.asarray(out.stats.iter)
    dyn = np.asarray(out.stats.dyn_vio)[np.arange(3), np.maximum(it - 1, 0)]
    assert (dyn[~diverged] < 1e-2).any(), (
        f"no lane made progress: dyn_vio={dyn}, diverged={diverged}")


@pytest.mark.parametrize("adaptive", [False, True])
@pytest.mark.parametrize("shape_i", [0, 3])
def test_stress_pallas_interpret(shape_i, adaptive):
    family, p, N, radius, ulim = SHAPES[shape_i]
    prob, spec = _stress_problem(family, p, N, radius, ulim, adaptive)
    rng = np.random.default_rng(1000 + 10 * shape_i + adaptive)
    x0s = _infeasible_starts(rng, spec, p, radius, 3)
    out = jax.jit(lambda x: ag.parallel.solve_batch(
        prob, x, method="pallas_interpret"))(x0s)
    _check_no_nan_escape(out, prob.opts)
    # Same accept decisions as schur would be too strong in general (the
    # kernel's op order differs); instead pin lane-for-lane iteration-count
    # agreement with schur on the same starts, which holds when both paths
    # track the same iterate sequence to solver tolerances.
    out_s = jax.jit(lambda x: ag.parallel.solve_batch(
        prob, x, method="schur"))(x0s)
    d = np.abs(np.asarray(out.traj.x) - np.asarray(out_s.traj.x))
    finite = np.isfinite(d)
    assert d[finite].max() < 1e-6, f"pallas vs schur drift {d[finite].max()}"
