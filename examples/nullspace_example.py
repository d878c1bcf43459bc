"""Equilibrium-subspace exploration with the active-set nullspace.

The reference's research purpose for the active-set machinery is exploring
the manifold of nearby generalized Nash equilibria
(``src/active_set/active_set_methods.jl:5-26`` + ``NullSpace``,
``active_set_core.jl:5-45``): at a converged equilibrium with active
collision constraints, the active-set extended KKT Jacobian has a nontrivial
nullspace, and stepping along a basis vector moves the trajectory O(eps)
while keeping the extended residual O(eps^2) — a first-order direction along
the equilibrium manifold.

This example solves a 3-player unicycle game whose collision constraint is
active at the equilibrium, computes the nullspace basis, and verifies the
first-order invariance numerically: a step eps*v along a basis vector vs a
random direction of the same norm.
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

import algames_tpu as ag
from algames_tpu import active_set as ascore
from algames_tpu.core.traj import unpack_step


def extended_residual_fn(prob, traj, lam_col):
    """Extended residual as a function of ALL Sh variables: base KKT residual
    plus the appended-dual stationarity terms grad(c)^T lam_col in player i's
    x rows, and the collision constraint values in the appended rows — the
    function whose Jacobian at lam_col = 0 is ``extended_jacobian``
    (reference ``residual!(ascore, ...)``, ``active_set_methods.jl:94-123``,
    with the dual columns of ``residual_jacobian!``, ``:148-156``)."""
    spec = prob.spec
    base = ag.problem.residual.residual(prob.model, spec, prob.obj, prob.gc,
                                        traj)
    opairs = ascore.ordered_pairs(spec.p)
    rx = base.rx
    for q, (i, j) in enumerate(opairs):
        blk = ascore.get_collision_block(prob.gc, spec, i, j)
        if blk is None:
            continue
        jac = ag.constraints.sets.block_jacobian(blk, traj)[:, 0, :]       # [T, n]
        rx = rx.at[:, i, :].add(jac * lam_col[:, q][:, None])
    cvals = []
    for (i, j) in ascore.unordered_pairs(spec.p):
        blk = ascore.get_collision_block(prob.gc, spec, i, j)
        cvals.append(ag.constraints.sets.block_values(blk, traj)[:, 0])
    flat = ag.problem.residual.flatten_residual(
        spec, ag.problem.residual.Residual(rx=rx, ru=base.ru, rd=base.rd))
    return jnp.concatenate([flat, jnp.stack(cvals, axis=1).reshape(-1)])


def main():
    p, N, dt = 3, 20, 0.1
    model = ag.unicycle_game(p=p)
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec,
        Q=[jnp.ones(4)] * p,
        R=[0.1 * jnp.ones(2)] * p,
        # Crossing targets force the collision constraint active.
        xf=[jnp.asarray([2.0, 0.4 * (p - 1 - i) - 0.4 * i, 0.0, 0.3])
            for i in range(p)],
        uf=[jnp.zeros(2)] * p, dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, 0.25)
    x0 = jnp.asarray(
        np.concatenate([np.zeros(p), 0.4 * np.arange(p), np.zeros(p),
                        0.3 * np.ones(p)]))
    opts = ag.Options()
    if os.environ.get("SMOKE"):   # reduced budget for the test-suite smoke
        opts = ag.Options(outer_iter=3, inner_iter=8)
    prob = ag.game_problem(N, dt, x0, model, opts, obj, gc)

    out = ag.newton_solve(prob, method="tridiag")
    prob = ag.GameProblem(spec=spec, model=model, opts=prob.opts, x0=prob.x0,
                          obj=obj, gc=out.gc)
    gc_a = ag.update_active_set(out.gc, out.traj)
    n_active = sum(
        int(np.asarray(b.active).sum()) for b in gc_a.state_blocks)
    print(f"converged; active collision entries: {n_active}")

    ns = ascore.update_nullspace(prob, out.traj)
    print(f"nullspace dimension: {ns.mat.shape[1]}")

    # First-order invariance: r(z + eps v) - r(z) is O(eps^2) along the
    # basis, O(eps) along a random direction of equal norm.
    nop = len(ascore.ordered_pairs(spec.p))
    v = ns.vec[0]
    dtraj = unpack_step(spec, v[:spec.S])
    dlam_col = v[spec.S:].reshape(spec.T, nop)
    lam0 = jnp.zeros((spec.T, nop))
    r0 = extended_residual_fn(prob, out.traj, lam0)

    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=v.shape))
    w = w * (jnp.linalg.norm(v) / jnp.linalg.norm(w))
    dtraj_w = unpack_step(spec, w[:spec.S])
    dlam_w = w[spec.S:].reshape(spec.T, nop)

    print(f"{'eps':>8} {'|dr| along basis':>18} {'|dr| random dir':>16}")
    for eps in (1e-2, 1e-3, 1e-4):
        t1 = ag.update_traj(out.traj, eps, dtraj)
        r1 = extended_residual_fn(prob, t1, eps * dlam_col)
        tw = ag.update_traj(out.traj, eps, dtraj_w)
        rw = extended_residual_fn(prob, tw, eps * dlam_w)
        dn = float(jnp.linalg.norm(r1 - r0))
        dw = float(jnp.linalg.norm(rw - r0))
        print(f"{eps:8.0e} {dn:18.3e} {dw:16.3e}")
        move = float(jnp.max(jnp.abs(t1.x - out.traj.x)))
        print(f"         trajectory moved {move:.3e} (O(eps))")


if __name__ == "__main__":
    main()
