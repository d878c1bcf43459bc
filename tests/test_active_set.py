"""Active-set / equilibrium-subspace oracles (mirrors reference
test/active_set/*: active flags, masks, extended system sizes, nullspace
dimension)."""
import jax
import jax.numpy as jnp
import numpy as np

import algames_tpu as ag
from algames_tpu import active_set as ascore
from algames_tpu.constraints import sets


def _prob(p=3, N=10, radius=1.0):
    model = ag.unicycle_game(p=p)
    dt = 0.1
    spec = ag.spec_from_model(model, N, dt)
    key = jax.random.PRNGKey(0)
    ks = jax.random.split(key, 2)
    obj = ag.game_objective(
        spec,
        Q=[jax.random.uniform(ks[0], (4,), jnp.float64) + 0.1] * p,
        R=[jax.random.uniform(ks[1], (2,), jnp.float64) + 0.1] * p,
        xf=[(i + 1.0) * jnp.ones(4) for i in range(p)],
        uf=[2.0 * (i + 1) * jnp.ones(2) for i in range(p)],
        dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = ag.add_collision_avoidance(spec, gc, radius)
    opts = ag.Options()
    x0 = jax.random.uniform(jax.random.PRNGKey(5), (spec.n,), jnp.float64)
    return ag.game_problem(N, dt, x0, model, opts, obj, gc), spec


def test_sizes():
    prob, spec = _prob()
    Sv, Sh = ascore.sizes(spec)
    p, T = spec.p, spec.T
    assert Sv == spec.S + T * p * (p - 1) // 2
    assert Sh == spec.S + T * p * (p - 1)


def test_active_flags():
    """Active = (c >= -tol) | (lam > 0) per (i,j,k) collision entry
    (reference test/active_set/active_set_methods.jl:3-34)."""
    prob, spec = _prob()
    gc = prob.gc
    # Players nearly coincident at ~0 with radius 2 -> everything active.
    traj = ag.zero_traj(spec, jnp.float64)
    gc_a = ag.update_active_set(gc, traj)
    assert ascore.active(gc_a, spec, 0, 1, 1)
    assert ascore.active(gc_a, spec, 0, 1, spec.T)
    # Far apart -> inactive.
    far = ag.PrimalDual(
        x=jnp.tile(1e3 * jnp.arange(spec.n, dtype=jnp.float64)[None],
                   (spec.N, 1)),
        u=jnp.zeros((spec.T, spec.m)),
        lam=jnp.zeros((spec.p, spec.T, spec.n)))
    gc_i = ag.update_active_set(gc, far)
    assert not ascore.active(gc_i, spec, 0, 1, 1)


def test_active_masks_all_or_none():
    """All-active masks cover the full extended system; all-inactive reduce
    to 1:S (reference active_set_methods.jl:36-84)."""
    prob, spec = _prob(radius=1e-8)
    Sv, Sh = ascore.sizes(spec)
    traj = ag.zero_traj(spec, jnp.float64)  # coincident: active (c=r^2>0>= -tol)
    gc_a = ag.update_active_set(prob.gc, traj)
    vmask, hmask = ascore.active_masks(prob, gc_a)
    assert len(vmask) == Sv and len(hmask) == Sh
    far = ag.PrimalDual(
        x=jnp.tile(1e3 * jnp.arange(spec.n, dtype=jnp.float64)[None],
                   (spec.N, 1)),
        u=jnp.zeros((spec.T, spec.m)),
        lam=jnp.zeros((spec.p, spec.T, spec.n)))
    gc_i = ag.update_active_set(prob.gc, far)
    vmask, hmask = ascore.active_masks(prob, gc_i)
    assert len(vmask) == spec.S and len(hmask) == spec.S


def test_extended_residual_and_jacobian():
    prob, spec = _prob()
    Sv, Sh = ascore.sizes(spec)
    traj = ag.zero_traj(spec, jnp.float64)
    r = ascore.extended_residual(prob, traj)
    assert r.shape == (Sv,)
    # appended rows hold the collision constraint values c = r^2 - 0 = 1
    np.testing.assert_allclose(np.asarray(r[spec.S:]), 4.0)  # (1+1)^2
    J = ascore.extended_jacobian(prob, traj)
    assert J.shape == (Sv, Sh)


def test_nullspace_dimension():
    """With all collision constraints active, the nullspace of the masked
    extended Jacobian has dimension (N-1)*p (reference
    active_set_methods.jl:113-116)."""
    prob, spec = _prob(p=3, N=10, radius=1.0)
    traj = ag.zero_traj(spec, jnp.float64)
    # small random positions: distinct, non-collinear (equally-spaced
    # collinear players make the per-knot pair gradients linearly dependent)
    x = 0.01 * jax.random.normal(jax.random.PRNGKey(9), (spec.N, spec.n),
                                 jnp.float64)
    traj = ag.PrimalDual(x=x, u=traj.u, lam=traj.lam)
    ns = ascore.update_nullspace(prob, traj)
    p, N = spec.p, spec.N
    Sh = ascore.sizes(spec)[1]
    assert ns.mat.shape == (Sh, (N - 1) * p)
    assert ns.vec.shape == ((N - 1) * p, Sh)
    # basis vectors actually lie in the kernel
    J = ascore.extended_jacobian(
        ag.GameProblem(spec=spec, model=prob.model, opts=prob.opts,
                       x0=prob.x0, obj=prob.obj,
                       gc=ag.update_active_set(prob.gc, traj)), traj)
    resid = np.asarray(J) @ np.asarray(ns.mat)
    assert np.max(np.abs(resid)) < 1e-8


def test_nullspace_masked_jit_matches_host():
    """The fixed-shape masked nullspace (under jax.jit) finds the same kernel
    dimension as the host-driven version, and its flagged vectors lie in the
    kernel of the active extended Jacobian."""
    prob, spec = _prob(p=3, N=10, radius=1.0)
    x = 0.01 * jax.random.normal(jax.random.PRNGKey(9), (spec.N, spec.n),
                                 jnp.float64)
    z = ag.zero_traj(spec, jnp.float64)
    traj = ag.PrimalDual(x=x, u=z.u, lam=z.lam)
    ns_host = ascore.update_nullspace(prob, traj)
    ns = jax.jit(ascore.update_nullspace_masked)(prob, traj)
    assert int(ns.dim) == ns_host.mat.shape[1] == (spec.N - 1) * spec.p
    # flagged vectors are in the kernel of the (all-active here) Jacobian
    gc_a = ag.update_active_set(prob.gc, traj)
    J = np.asarray(ascore.extended_jacobian(
        ag.GameProblem(spec=spec, model=prob.model, opts=prob.opts,
                       x0=prob.x0, obj=prob.obj, gc=gc_a), traj))
    vecs = np.asarray(ns.vec)[np.asarray(ns.mask)]
    assert np.max(np.abs(J @ vecs.T)) < 1e-7
    # vmap over a batch of trajectories works (fixed shapes throughout)
    xs = jnp.stack([x, x * 1.01])
    batch = ag.PrimalDual(x=xs, u=jnp.stack([z.u] * 2),
                          lam=jnp.stack([z.lam] * 2))
    ns_b = jax.vmap(lambda t: ascore.update_nullspace_masked(prob, t))(batch)
    assert ns_b.vec.shape[0] == 2
    assert int(ns_b.dim[0]) == (spec.N - 1) * spec.p


def test_nullspace_masked_partial_active():
    """With players far apart (nothing active) the kernel reduces to the
    appended-column pinning structure: dim = 0 extra beyond the base system's
    kernel plus the forced-zero duals — i.e. matches the host version."""
    prob, spec = _prob(p=3, N=6, radius=1e-6)
    far = ag.PrimalDual(
        x=jnp.tile(1e3 * jnp.arange(spec.n, dtype=jnp.float64)[None],
                   (spec.N, 1)),
        u=jnp.zeros((spec.T, spec.m)),
        lam=jnp.zeros((spec.p, spec.T, spec.n)))
    ns_host = ascore.update_nullspace(prob, far)
    ns = jax.jit(ascore.update_nullspace_masked)(prob, far)
    assert int(ns.dim) == ns_host.mat.shape[1]


def test_nullspace_dimension_3d_spherical():
    """Quadrotor (pz-based spherical collision) case: get_collision_block
    resolves spherical blocks and the all-active nullspace dimension is
    (N-1) * p(p-1)/2 — each knot appends p(p-1) dual columns and p(p-1)/2
    constraint rows to the (generically full-rank) square base system.  For
    the reference's p=3 planar oracle this equals (N-1)*p
    (active_set_methods.jl:113-116); here p=2 gives (N-1)*1."""
    p, N, dt = 2, 5, 0.1
    model = ag.quadrotor_game(p=p)
    spec = ag.spec_from_model(model, N, dt)
    obj = ag.game_objective(
        spec, Q=[jnp.ones(12)] * p, R=[0.1 * jnp.ones(4)] * p,
        xf=[jnp.zeros(12)] * p, uf=[jnp.zeros(4)] * p, dtype=jnp.float64)
    gc = ag.game_constraints(spec)
    gc = sets.add_spherical_collision_avoidance(spec, gc, 1.0)
    x0 = jnp.zeros(spec.n, jnp.float64)
    prob = ag.game_problem(N, dt, x0, model, ag.Options(), obj, gc)
    assert ascore.get_collision_block(gc, spec, 0, 1) is not None
    z = ag.zero_traj(spec, jnp.float64)
    x = 0.01 * jax.random.normal(jax.random.PRNGKey(3), (spec.N, spec.n),
                                 jnp.float64)
    traj = ag.PrimalDual(x=x, u=z.u, lam=z.lam)
    expect = (N - 1) * p * (p - 1) // 2
    ns_host = ascore.update_nullspace(prob, traj)
    assert ns_host.mat.shape[1] == expect
    ns = jax.jit(ascore.update_nullspace_masked)(prob, traj)
    assert int(ns.dim) == expect


def test_extended_jacobian_knotrows_is_row_permutation():
    """The block-native builder equals the reference-ordered
    oracle up to the static base-row permutation (knot-major equation order
    vs player-major vertical order); appended rows/columns are identical."""
    prob, spec = _prob(p=3, N=7, radius=1.0)
    x = 0.05 * jax.random.normal(jax.random.PRNGKey(11), (spec.N, spec.n),
                                 jnp.float64)
    z = ag.zero_traj(spec, jnp.float64)
    traj = ag.PrimalDual(x=x, u=0.1 * jnp.ones_like(z.u), lam=z.lam)
    J_ref = np.asarray(ascore.extended_jacobian(prob, traj))
    J_knot = np.asarray(ascore.extended_jacobian_knotrows(prob, traj))

    T, W, n, p, m, S = spec.T, spec.W, spec.n, spec.p, spec.m, spec.S
    Sv, _ = ascore.sizes(spec)
    perm = np.zeros(Sv, dtype=int)
    r = 0
    for t in range(T):
        for i in range(p):
            perm[r:r + n] = spec.row_stat_x(i, t) + np.arange(n)
            r += n
        for c in range(m):
            i = next(a for a in range(p) if c in list(spec.pu[a]))
            k = list(spec.pu[i]).index(c)
            perm[r] = spec.row_stat_u(i, t) + k
            r += 1
        perm[r:r + n] = spec.row_dyn(t) + np.arange(n)
        r += n
    perm[S:] = np.arange(S, Sv)
    np.testing.assert_allclose(J_knot, J_ref[perm], rtol=0, atol=0)


def test_nullspace_masked_round4_scale_compiles():
    """p=4, N=40 (the BASELINE roundabout scale): the block-native masked
    nullspace traces + compiles in seconds — the scatter-loop builder it
    replaced traced ~470 .at[].add calls here."""
    import time
    prob, spec = _prob(p=4, N=40, radius=0.5)
    z = ag.zero_traj(spec, jnp.float64)
    t0 = time.time()
    jax.jit(ascore.update_nullspace_masked).lower(prob, z).compile()
    elapsed = time.time() - t0
    assert elapsed < 120.0, f"compile took {elapsed:.1f}s"


def test_nullspace_first_order_invariance():
    """Stepping eps*v along a nullspace basis vector moves the trajectory
    O(eps) but changes the extended residual only O(eps^2); a random
    direction of equal norm changes it O(eps).  This is the equilibrium-
    manifold property the reference's active-set machinery exists for
    (``active_set_methods.jl:5-26``); see ``examples/nullspace_example.py``
    for the full demo at a converged equilibrium."""
    from algames_tpu.core.traj import unpack_step, update_traj
    from algames_tpu.presets import intro_di

    # A (near-)converged equilibrium is required: away from stationarity the
    # Gauss-Newton Jacobian's dropped curvature terms (rho * d2c * c and the
    # dynamics second derivatives) leak into dr at first order.
    prob0, spec = intro_di(outer=5, inner=10)
    out = ag.newton_solve(prob0, method="tridiag")
    prob = ag.GameProblem(spec=spec, model=prob0.model, opts=prob0.opts,
                          x0=prob0.x0, obj=prob0.obj, gc=out.gc)
    traj = out.traj

    ns = ascore.update_nullspace(prob, traj)
    assert ns.mat.shape[1] >= 1
    gc_a = ag.update_active_set(prob.gc, traj)
    prob_a = ag.GameProblem(spec=spec, model=prob.model, opts=prob.opts,
                            x0=prob.x0, obj=prob.obj, gc=gc_a)
    opairs = ascore.ordered_pairs(spec.p)
    upairs = ascore.unordered_pairs(spec.p)

    def r_ext(tr, lam_col):
        # base residual + grad(c)^T lam_col in owner x rows ++ c values —
        # the function whose Jacobian at lam_col=0 is extended_jacobian.
        base = ag.problem.residual.residual(prob_a.model, spec, prob_a.obj,
                                            prob_a.gc, tr)
        rx = base.rx
        for q, (i, j) in enumerate(opairs):
            blk = ascore.get_collision_block(prob_a.gc, spec, i, j)
            jac = sets.block_jacobian(blk, tr)[:, 0, :]
            rx = rx.at[:, i, :].add(jac * lam_col[:, q][:, None])
        cv = [sets.block_values(ascore.get_collision_block(prob_a.gc, spec,
                                                           i, j), tr)[:, 0]
              for (i, j) in upairs]
        flat = ag.problem.residual.flatten_residual(
            spec, ag.problem.residual.Residual(rx=rx, ru=base.ru,
                                               rd=base.rd))
        return jnp.concatenate([flat, jnp.stack(cv, axis=1).reshape(-1)])

    nop = len(opairs)
    v = ns.vec[0]
    w = jnp.asarray(np.random.default_rng(0).normal(size=v.shape))
    w = w * (jnp.linalg.norm(v) / jnp.linalg.norm(w))
    r0 = r_ext(traj, jnp.zeros((spec.T, nop)))

    def dr(direction, eps):
        t1 = update_traj(traj, eps, unpack_step(spec, direction[:spec.S]))
        return float(jnp.linalg.norm(
            r_ext(t1, eps * direction[spec.S:].reshape(spec.T, nop)) - r0))

    for eps in (1e-3, 1e-4):
        dn, dw = dr(v, eps), dr(w, eps)
        # random direction responds first-order, basis second-order
        assert dn < 1e-2 * dw, (eps, dn, dw)
    # scaling along the basis is quadratic OR BETTER, up to f64 noise (for
    # the linear-dynamics DI game the manifold is exactly flat and both
    # values sit at machine epsilon; the unicycle example shows the clean
    # x100-per-decade quadratic regime).
    assert dr(v, 1e-3) < 130.0 * dr(v, 1e-4) + 1e-9
    # and the trajectory genuinely moves O(eps)
    t1 = update_traj(traj, 1e-3, unpack_step(spec, v[:spec.S]))
    assert float(jnp.max(jnp.abs(t1.x - traj.x))) > 1e-5
