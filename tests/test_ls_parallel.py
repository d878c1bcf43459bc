"""K-parallel line-search equivalence.

``Options.ls_parallel = K`` evaluates the first K backtracking trials in one
vectorized residual pass and accepts the first passing trial; trials past K
run in the reference's sequential loop (``solver.line_search``, reference
``line_search`` at ``src/problem/solver_methods.jl:105-125``).  The claim
under test: the accept DECISIONS (accepted alpha, accept depth, iteration
counts) are exactly identical for any K — including iterations whose accept
depth exceeds K, which exercise the sequential continuation — and the
iterates agree to f64 roundoff.  (They are not bitwise identical: XLA fuses
the K-lane vectorized trial window differently for different K, which
perturbs the carried trial values by ~1 ULP; the isolated trial pass IS
batch-size invariant.  Measured drift over a full solve: relative ~1e-16,
i.e. a few ULPs at every magnitude.)
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import algames_tpu as ag


def _deep_ls_problem():
    """2-player unicycle with a demanding Armijo parameter (beta=0.7) and an
    infeasible, tightly bounded start: the first trial(s) frequently fail,
    pushing accept depths past 4 so every K in {1, 2, 4} hits both its
    vectorized window and the sequential continuation."""
    model = ag.unicycle_game(p=2)
    N, dt = 12, 0.1
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec,
        Q=[10 * jnp.ones(model.ni[i]) for i in range(2)],
        R=[0.1 * jnp.ones(model.mi[i]) for i in range(2)],
        xf=[jnp.asarray([2.0, 0.0, 0.0, 0.0]),
            jnp.asarray([-2.0, 0.0, jnp.pi, 0.0])],
        uf=[jnp.zeros(model.mi[i]) for i in range(2)],
        dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, radius=0.5)
    gc = ag.add_control_bound(spec, gc, u_min=-1.0, u_max=1.0)
    opts = ag.Options(outer_iter=4, inner_iter=8, beta=0.9, ls_iter=25)
    # Head-on start well inside the collision radius.
    x0 = jnp.asarray([0.2, -0.2, 0.0, 0.0, 0.0, jnp.pi, 0.8, 0.8])
    return ag.game_problem(N, dt, x0, model, opts, obj, gc), spec


def _accept_depths(stats):
    """Accept depth j per recorded iteration: alpha = alpha_0 * 0.5^(j-1)."""
    it = np.asarray(stats.iter)
    alphas = np.asarray(stats.alpha)
    M = alphas.shape[-1]
    valid = (np.arange(M) >= 1) & (np.arange(M) < it.reshape(-1, 1))
    vals = alphas.reshape(-1, M)[valid]
    vals = vals[vals > 0]
    return np.round(1 - np.log2(np.maximum(vals, 1e-12))).astype(int)


@pytest.mark.parametrize("batched", [False, True])
def test_ls_parallel_bitwise_equivalence(batched):
    prob, spec = _deep_ls_problem()
    key = jax.random.PRNGKey(7)
    if batched:
        x0s = prob.x0[None] + 0.05 * jax.random.normal(key, (4, spec.n))
    else:
        x0s = prob.x0[None]

    def solve(opts, x0):
        p = dataclasses.replace(prob, opts=opts, x0=x0)
        return ag.newton_solve(p)

    results = {}
    for K in (1, 2, 4):
        opts = dataclasses.replace(prob.opts, ls_parallel=K)
        results[K] = jax.jit(jax.vmap(functools.partial(solve, opts)))(x0s)

    # The config must actually exercise the sequential continuation for the
    # deepest K under test: some accepted step needs depth > 4.
    depths = _accept_depths(results[4].stats)
    assert depths.max() > 4, (
        f"LS depth histogram too shallow (max {depths.max()}) — config no "
        "longer exercises the sequential continuation past K=4")
    assert (depths > 1).any() and (depths > 2).any()

    ref = results[1]
    for K in (2, 4):
        out = results[K]
        # Identical accept DECISIONS: the recorded alpha sequence (hence the
        # depth histogram) and the iteration counts match exactly.
        np.testing.assert_array_equal(np.asarray(ref.stats.alpha),
                                      np.asarray(out.stats.alpha))
        np.testing.assert_array_equal(np.asarray(ref.stats.iter),
                                      np.asarray(out.stats.iter))
        np.testing.assert_array_equal(_accept_depths(ref.stats),
                                      _accept_depths(out.stats))
        # Iterates agree to f64 roundoff (see module docstring for why not
        # bitwise): per-solve drift bounded well below any solver tolerance.
        for a, b in ((ref.traj.x, out.traj.x), (ref.traj.u, out.traj.u),
                     (ref.traj.lam, out.traj.lam),
                     (ref.stats.res, out.stats.res)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-12, atol=1e-13)
