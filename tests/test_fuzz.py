"""Adversarial solver fuzzing.

The golden fixtures (``tests/golden/``) pin five BASELINE configurations;
this suite pins the space between them: seeded random small problems —
random model family, player count, horizon, diagonal costs, targets, and
constraint placements — checked at the KKT level against the f64 dense
oracle for EVERY structured linear-solver method, plus the f32 fast paths at
adversarial AL penalties (log-uniform mu up to the reference's
``rho_max = 1e7``, ``src/struct/options.jl:56``) and full-solve f32-vs-f64
drift at equal iteration budget on a subset.

f32 accuracy gating: random per-entry penalties up to 1e7 produce KKT
systems whose conditioning exceeds what ANY f32 factorization can track
(kappa * eps_f32 >~ 1), so the f32 gates are RELATIVE — the Pallas kernel
must track the pivoted XLA ``schur`` path
— with an absolute bound whenever the pivoted path itself is accurate.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import algames_tpu as ag
from algames_tpu.constraints import sets as gcm
from algames_tpu.core.spec import spec_from_model
from algames_tpu.models.bicycle import bicycle_game
from algames_tpu.models.double_integrator import double_integrator_game
from algames_tpu.models.unicycle import unicycle_game
from algames_tpu.objective.objective import game_objective
from algames_tpu.ops.thomas_pallas import solve_thomas_pallas
from algames_tpu.problem import residual as R
from algames_tpu.problem.linear_solver import (solve_cyclic_reduction,
                                               solve_tridiagonal,
                                               solve_tridiagonal_schur)
from algames_tpu.problem.options import Options
from algames_tpu.problem.problem import game_problem
from algames_tpu.problem.solver import newton_solve

N_CASES = 50


def _random_problem(rng, dtype=jnp.float64):
    """One seeded random small game: model family, p, N, costs, constraints."""
    family = rng.choice(["di", "unicycle", "bicycle"])
    p = int(rng.integers(1, 5))
    N = int(rng.integers(4, 13))
    dt = float(rng.uniform(0.05, 0.2))
    if family == "di":
        model = double_integrator_game(p=p, d=2)
    elif family == "unicycle":
        model = unicycle_game(p=p)
    else:
        model = bicycle_game(p=p)
    spec = spec_from_model(model, N, dt)
    ni, mi = 4, 2

    Q = [jnp.asarray(rng.uniform(0.1, 3.0, ni), dtype) for _ in range(p)]
    Rw = [jnp.asarray(rng.uniform(0.01, 1.0, mi), dtype) for _ in range(p)]
    xf = [jnp.asarray(rng.uniform(-1.0, 1.0, ni), dtype) for _ in range(p)]
    uf = [jnp.zeros(mi, dtype)] * p
    obj = game_objective(spec, Q, Rw, xf, uf, dtype=dtype)

    gc = gcm.game_constraints(spec, dtype=dtype)
    if p > 1 and rng.random() < 0.8:
        gc = gcm.add_collision_avoidance(spec, gc, float(rng.uniform(0.05, 0.3)))
    if rng.random() < 0.7:
        lim = float(rng.uniform(0.5, 3.0))
        gc = gcm.add_control_bound(spec, gc, lim * jnp.ones(spec.m, dtype),
                                   -lim * jnp.ones(spec.m, dtype))
    if rng.random() < 0.5:
        k = int(rng.integers(1, 4))
        gc = gcm.add_circle_constraint(
            spec, gc, rng.uniform(-1, 1, k), rng.uniform(-1, 1, k),
            rng.uniform(0.05, 0.3, k))
    if rng.random() < 0.3:
        big = float(rng.uniform(2.0, 5.0))
        gc = gcm.add_state_bound(spec, gc, int(rng.integers(0, p)),
                                 big * jnp.ones(spec.n, dtype),
                                 -big * jnp.ones(spec.n, dtype))

    # Interleaved per-player start states: position spread, zero-ish rest.
    x0 = np.zeros(spec.n)
    for i in range(p):
        x0[np.asarray(spec.pz[i])] = rng.uniform(-0.5, 0.5, ni)
    x0 = jnp.asarray(x0, dtype)

    opts = Options(outer_iter=2, inner_iter=3)
    prob = game_problem(N, dt, x0, model, opts, obj, gc)
    return prob, spec


def _random_iterate(rng, spec, gc, dtype=jnp.float64, mu_max=1e7):
    """Random mid-solve iterate + adversarial AL state (lam >= 0 for ineq,
    mu log-uniform up to the reference's rho_max)."""
    traj = ag.PrimalDual(
        x=jnp.asarray(rng.normal(0, 0.4, (spec.N, spec.n)), dtype),
        u=jnp.asarray(rng.normal(0, 0.4, (spec.T, spec.m)), dtype),
        lam=jnp.asarray(rng.normal(0, 0.4, (spec.p, spec.T, spec.n)), dtype))

    def randomize(blk):
        lam = rng.uniform(0.0, 2.0, blk.lam.shape)
        log_mu = rng.uniform(0.0, np.log10(mu_max), blk.mu.shape)
        return dataclasses.replace(
            blk, lam=jnp.asarray(lam, dtype),
            mu=jnp.asarray(10.0 ** log_mu, dtype))

    gc = dataclasses.replace(
        gc, state_blocks=tuple(randomize(b) for b in gc.state_blocks),
        control_blocks=tuple(randomize(b) for b in gc.control_blocks))
    return traj, gc


def _dense_oracle(spec, D, U, L, b):
    """f64 host LAPACK solve of the densified block-tridiagonal system."""
    T, W = spec.T, spec.W
    D, U, L = (np.asarray(a, np.float64) for a in (D, U, L))
    J = np.zeros((T * W, T * W))
    for t in range(T):
        J[t*W:(t+1)*W, t*W:(t+1)*W] = D[t]
        if t + 1 < T:
            J[t*W:(t+1)*W, (t+1)*W:(t+2)*W] = U[t]
            J[(t+1)*W:(t+2)*W, t*W:(t+1)*W] = L[t]
    return np.linalg.solve(J, np.asarray(b, np.float64).reshape(-1))


def _case_system(case):
    rng = np.random.default_rng(1000 + case)
    prob, spec = _random_problem(rng)
    traj, gc = _random_iterate(rng, spec, prob.gc)
    res, jb, _, _ = jax.jit(
        lambda t, g: R.assemble(prob.model, spec, prob.obj, g, t, reg=1e-3)
    )(traj, gc)
    b = R.residual_knot_blocks(spec, res)
    return spec, jb, b


@pytest.mark.parametrize("case", range(N_CASES))
def test_fuzz_kkt_methods_vs_dense_oracle(case):
    """Every-case gate: tridiag + schur (f64) reproduce the dense-oracle
    Newton step; the f32 fast paths track it within the relative bound (see
    module docstring).  cr + pallas-interpret run on every 5th case."""
    spec, jb, b = _case_system(case)
    D, U, L = jax.jit(lambda j: R.build_tridiagonal(spec, j))(jb)
    y_or = _dense_oracle(spec, D, U, L, -b)
    scale = max(np.abs(y_or).max(), 1e-30)

    y_tri = np.asarray(jax.jit(
        lambda: solve_tridiagonal(spec, D, U, L, -b))())
    np.testing.assert_allclose(y_tri, y_or, atol=2e-6 * scale, rtol=0)

    deep = case % 5 == 0
    if deep:
        y_cr = np.asarray(jax.jit(
            lambda: solve_cyclic_reduction(spec, D, U, L, -b))())
        np.testing.assert_allclose(y_cr, y_or, atol=2e-6 * scale, rtol=0)

    if not spec.homogeneous:
        return
    y_sch = np.asarray(jax.jit(
        lambda: solve_tridiagonal_schur(spec, jb, -b))())
    np.testing.assert_allclose(y_sch, y_or, atol=2e-6 * scale, rtol=0)

    # f32 fast paths: pallas must track the pivoted schur path.
    f32 = jnp.float32
    jb32 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, f32), jb)
    b32 = jnp.asarray(b, f32)
    y_s32 = np.asarray(jax.jit(
        lambda: solve_tridiagonal_schur(spec, jb32, -b32))())
    err_s = np.abs(y_s32 - y_or).max() / scale
    if deep:
        jb321 = jax.tree_util.tree_map(lambda x: x[None], jb32)
        y_p32 = np.asarray(solve_thomas_pallas(
            spec, jb321, -b32[None], interpret=True))[0]
        err_p = np.abs(y_p32 - y_or).max() / scale
        assert err_p < max(3e-2, 2.0 * err_s), (err_p, err_s)
        jb1 = jax.tree_util.tree_map(lambda x: x[None], jb)
        y_pal = np.asarray(solve_thomas_pallas(
            spec, jb1, -b[None], interpret=True))[0]
        np.testing.assert_allclose(y_pal, y_or, atol=2e-6 * scale, rtol=0)


@pytest.mark.parametrize("case", range(0, N_CASES, 8))
def test_fuzz_f32_vs_f64_equal_budget(case):
    """Full solves, f32 vs f64, same problem and iteration budget: the f32
    trajectory tracks the f64 one (golden-fixture f32 gate, generalized)."""
    rng = np.random.default_rng(1000 + case)
    prob64, spec = _random_problem(rng)
    rng32 = np.random.default_rng(1000 + case)
    prob32, _ = _random_problem(rng32, dtype=jnp.float32)
    prob32 = dataclasses.replace(
        prob32, x0=jnp.asarray(prob64.x0, jnp.float32))

    out64 = newton_solve(prob64, method="tridiag")
    out32 = newton_solve(prob32, method="schur" if spec.homogeneous
                         else "tridiag")
    dev = np.abs(np.asarray(out64.traj.x, np.float32)
                 - np.asarray(out32.traj.x)).max()
    assert dev < 5e-2, f"f32 drift {dev:.3e} at equal budget"


@pytest.mark.parametrize("case", range(8))
def test_fuzz_hetero_fast_paths(case):
    """Random ragged-mi games: the pad-and-mask schur/pallas fast paths
    reproduce the f64 dense-oracle step (fuzz-pinned)."""
    from algames_tpu.models.hetero import hetero_double_integrator_game

    rng = np.random.default_rng(3000 + case)
    p = int(rng.integers(2, 4))
    mi = tuple(int(rng.integers(1, 3)) for _ in range(p))
    if len(set(mi)) == 1:
        mi = mi[:-1] + (3 - mi[-1],)          # force raggedness
    N = int(rng.integers(4, 10))
    dt = float(rng.uniform(0.05, 0.2))
    model = hetero_double_integrator_game(mi=mi, d=2)
    spec = spec_from_model(model, N, dt)
    dtype = jnp.float64
    obj = game_objective(
        spec,
        Q=[jnp.asarray(rng.uniform(0.1, 3.0, 4), dtype) for _ in range(p)],
        R=[jnp.asarray(rng.uniform(0.01, 1.0, mi[i]), dtype)
           for i in range(p)],
        xf=[jnp.asarray(rng.uniform(-1, 1, 4), dtype) for _ in range(p)],
        uf=[jnp.zeros(mi[i], dtype) for i in range(p)], dtype=dtype)
    gc = gcm.game_constraints(spec, dtype=dtype)
    if rng.random() < 0.7:
        lim = float(rng.uniform(0.5, 3.0))
        gc = gcm.add_control_bound(spec, gc, lim * jnp.ones(spec.m, dtype),
                                   -lim * jnp.ones(spec.m, dtype))
    prob = game_problem(N, dt, jnp.zeros(spec.n, dtype), model,
                        Options(), obj, gc)
    traj, gc_r = _random_iterate(rng, spec, gc)

    res, jb, _, _ = jax.jit(
        lambda t, g: R.assemble(model, spec, obj, g, t, reg=1e-3)
    )(traj, gc_r)
    b = R.residual_knot_blocks(spec, res)
    D, U, L = jax.jit(lambda j: R.build_tridiagonal(spec, j))(jb)
    y_or = _dense_oracle(spec, D, U, L, -b)
    scale = max(np.abs(y_or).max(), 1e-30)
    y_s = np.asarray(jax.jit(
        lambda: solve_tridiagonal_schur(spec, jb, -b))())
    np.testing.assert_allclose(y_s, y_or, atol=2e-6 * scale, rtol=0)
    jb1 = jax.tree_util.tree_map(lambda x: x[None], jb)
    y_p = np.asarray(solve_thomas_pallas(spec, jb1, -b[None],
                                         interpret=True))[0]
    np.testing.assert_allclose(y_p, y_or, atol=2e-6 * scale, rtol=0)
