"""Horizon (sequence) parallelism: the KKT solve sharded over the knot axis.

The reference's "sequence length" is the horizon N; its solver is a
sequential sparse LU over all knots (``src/problem/solver_methods.jl:87``).
For LONG horizons this module shards the block-tridiagonal KKT system over a
mesh axis — the dynamic-games analogue of sequence parallelism (SURVEY.md §5
"long-context" row): each device eliminates its contiguous slab of knots
locally (block partitioned-Thomas, the SPIKE algorithm), devices exchange
only O(1) boundary blocks, and a small replicated reduced system couples the
slabs:

  1. local:   express the slab solution as  y = y0 + V·y_left + Z·y_right
              (one block-Thomas sweep with 1+2W right-hand sides)
  2. gather:  all_gather the slab boundary rows (2 blocks per device) — the
              ONLY inter-device traffic, O(D · W²) between devices
  3. reduced: every device redundantly solves the 2D·W coupled boundary
              system (tiny: D devices × W block size)
  4. local:   back-substitute the interior with the now-known neighbors

Communication volume is independent of the horizon length — halo exchange
only at slab boundaries — so wall-clock scales ~1/D for the dominant local
sweeps.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P


def _local_spike(Dl, Lh, Uh, bl, axis):
    """Per-device slab solve.  Dl/Lh/Uh [Tl, W, W], bl [Tl, W]; Lh[0] couples
    to the left neighbor's last unknown, Uh[-1] to the right neighbor's first
    unknown (zero blocks on the outer partitions).  Returns y_local [Tl, W]."""
    Tl, W, _ = Dl.shape
    dtype = Dl.dtype
    R = 1 + 2 * W

    # RHS columns: [b | -Lh0 (first row only) | -Uh_last (last row only)]
    RHS = jnp.zeros((Tl, W, R), dtype)
    RHS = RHS.at[:, :, 0].set(bl)
    RHS = RHS.at[0, :, 1:W + 1].set(-Lh[0])
    RHS = RHS.at[-1, :, W + 1:].set(-Uh[-1])

    # Interior couplings only: mask out the cross-slab blocks.
    Lh_in = Lh.at[0].set(jnp.zeros((W, W), dtype))
    Uh_in = Uh.at[-1].set(jnp.zeros((W, W), dtype))

    def fwd(carry, inp):
        G_prev, Y_prev = carry
        D_t, L_t, U_t, r_t = inp
        M = D_t - L_t @ G_prev
        sol = jnp.linalg.solve(
            M, jnp.concatenate([U_t, r_t - L_t @ Y_prev], axis=1))
        G_t, Y_t = sol[:, :W], sol[:, W:]
        return (G_t, Y_t), (G_t, Y_t)

    init = (jnp.zeros((W, W), dtype), jnp.zeros((W, R), dtype))
    _, (G, Yh) = jax.lax.scan(fwd, init, (Dl, Lh_in, Uh_in, RHS))

    def bwd(Y_next, inp):
        G_t, Yh_t = inp
        Y_t = Yh_t - G_t @ Y_next
        return Y_t, Y_t

    _, sol = jax.lax.scan(bwd, jnp.zeros((W, R), dtype), (G, Yh),
                          reverse=True)
    # sol[t] = [y0 | V | Z]: y_t = y0 + V @ y_left + Z @ y_right.

    # ---- reduced boundary system over all slabs (replicated) --------------
    nd = jax.lax.psum(1, axis)          # static mesh size
    idx = jax.lax.axis_index(axis)
    Sf = jax.lax.all_gather(sol[0], axis)     # [D, W, R]
    Sl = jax.lax.all_gather(sol[-1], axis)    # [D, W, R]

    DW = nd * 2 * W                     # unknowns: (y_first, y_last) per slab
    M = jnp.eye(DW, dtype=dtype)
    rhs = jnp.zeros((DW,), dtype)
    for d in range(nd):
        rf, rl = (2 * d) * W, (2 * d + 1) * W
        rhs = rhs.at[rf:rf + W].set(Sf[d, :, 0])
        rhs = rhs.at[rl:rl + W].set(Sl[d, :, 0])
        if d > 0:
            cl = (2 * (d - 1) + 1) * W          # left neighbor's y_last
            M = M.at[rf:rf + W, cl:cl + W].add(-Sf[d, :, 1:W + 1])
            M = M.at[rl:rl + W, cl:cl + W].add(-Sl[d, :, 1:W + 1])
        if d < nd - 1:
            cf = (2 * (d + 1)) * W              # right neighbor's y_first
            M = M.at[rf:rf + W, cf:cf + W].add(-Sf[d, :, W + 1:])
            M = M.at[rl:rl + W, cf:cf + W].add(-Sl[d, :, W + 1:])
    gsol = jnp.linalg.solve(M, rhs)             # [2 D W], replicated

    g2 = gsol.reshape(nd, 2, W)
    y_left = jnp.where(idx > 0,
                       jax.lax.dynamic_index_in_dim(
                           g2, jnp.maximum(idx - 1, 0), keepdims=False)[1],
                       jnp.zeros((W,), dtype))
    y_right = jnp.where(idx < nd - 1,
                        jax.lax.dynamic_index_in_dim(
                            g2, jnp.minimum(idx + 1, nd - 1),
                            keepdims=False)[0],
                        jnp.zeros((W,), dtype))

    y = (sol[:, :, 0] + sol[:, :, 1:W + 1] @ y_left
         + sol[:, :, W + 1:] @ y_right)
    return y


def solve_tridiagonal_sharded(spec, D, U, L, b_knots, mesh: Mesh,
                              axis: str = "hz"):
    """Distributed block-tridiagonal solve: knots sharded over ``mesh[axis]``.

    Same system convention as ``linear_solver.solve_tridiagonal``:
    D [T, W, W]; U, L [T-1, W, W] (L[t] is the sub-diagonal block of equation
    t+1); b_knots [T, W].  T must be divisible by the axis size.
    Returns the flat solution [S].
    """
    T, W = spec.T, spec.W
    nd = mesh.shape[axis]
    assert T % nd == 0, f"T={T} not divisible by mesh axis {axis}={nd}"
    dtype = D.dtype
    zero = jnp.zeros((1, W, W), dtype)
    Lhat = jnp.concatenate([zero, L], axis=0)
    Uhat = jnp.concatenate([U, zero], axis=0)

    fn = jax.shard_map(
        lambda d, lh, uh, b: _local_spike(d, lh, uh, b, axis),
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
        check_vma=False,
    )
    return fn(D, Lhat, Uhat, b_knots).reshape(-1)


def spike_kkt_method(mesh: Mesh, axis: str = "hz"):
    """A ``method=`` callable for ``newton_solve``: the Newton step's KKT
    factorization distributed over the horizon.  Use for long-horizon games
    (N in the hundreds) where one chip's sequential sweep dominates:

        mesh = Mesh(np.asarray(jax.devices()).reshape(-1), ("hz",))
        res = ag.newton_solve(prob, method=ag.parallel.spike_kkt_method(mesh))
    """
    from ..problem import residual as R

    def method(spec, jb, neg_b):
        D, U, L = R.build_tridiagonal(spec, jb)
        return solve_tridiagonal_sharded(spec, D, U, L, neg_b, mesh, axis)

    return method
