"""Equilibrium-subspace analysis: active-set extended KKT + nullspace.

JAX equivalent of the reference active-set machinery
(``src/active_set/active_set_core.jl``, ``active_set_methods.jl``,
``active_set_stamp.jl``): the KKT system is extended with one scalar row per
*unordered* colliding player pair per knot (the shared constraint value) and
one scalar column per *ordered* pair per knot (each player's own multiplier
on that constraint):

  Sv = S + (N-1) p(p-1)/2        rows     (CStamp :v, i<j, k=2..N)
  Sh = S + (N-1) p(p-1)          columns  (CStamp :h, i!=j, k=2..N)

``update_nullspace`` masks the extended Jacobian down to the active rows /
columns and takes an SVD nullspace — a basis for the manifold of nearby
generalized Nash equilibria (research feature; dense, host-driven, exactly
like the reference's ``nullspace(Matrix(jac[vmask, hmask]))`` at
``active_set_methods.jl:180-183``).

Index layout (0-based) mirrors ``complete_vertical/horizontal_indices``
(``active_set_core.jl:98-155``): appended entries are knot-major, pair-minor
in lexicographic order.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import jax.numpy as jnp
import numpy as np

from ..constraints import sets as gcm
from ..constraints.kernels import CollisionParams
from ..core.spec import ProblemSpec
from ..core.traj import PrimalDual
from ..problem import residual as R
from ..problem.problem import GameProblem
from ..utils import pytree_dataclass


def unordered_pairs(p: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(p) for j in range(i + 1, p)]


def ordered_pairs(p: int) -> List[Tuple[int, int]]:
    return [(i, j) for i in range(p) for j in range(p) if j != i]


def sizes(spec: ProblemSpec) -> Tuple[int, int]:
    """(Sv, Sh) of the extended system (``active_set_core.jl:61-63``)."""
    p, T = spec.p, spec.T
    return (spec.S + T * (p * (p - 1)) // 2, spec.S + T * p * (p - 1))


def vrow(spec: ProblemSpec, i: int, j: int, k: int) -> int:
    """Appended row of unordered pair (i<j) at knot k (0-based k=1..N-1,
    matching the reference's k=2..N applied knots)."""
    assert i < j and 1 <= k <= spec.T
    pairs = unordered_pairs(spec.p)
    return spec.S + (k - 1) * len(pairs) + pairs.index((i, j))


def hcol(spec: ProblemSpec, i: int, j: int, k: int) -> int:
    """Appended column of ordered pair (i, j) at knot k (0-based)."""
    assert i != j and 1 <= k <= spec.T
    pairs = ordered_pairs(spec.p)
    return spec.S + (k - 1) * len(pairs) + pairs.index((i, j))


def get_collision_block(gc: gcm.GameConstraints, spec: ProblemSpec,
                        i: int, j: int):
    """Find player i's collision conval against player j — planar
    (``add_collision_avoidance``, pxj = px[j]) or spherical
    (``add_spherical_collision_avoidance``, pxj = pz[j][:3]) (reference
    ``get_collision_conval``, ``active_set_methods.jl:76-90``)."""
    j_pos = {tuple(spec.px[j]), tuple(spec.pz[j][:3])}
    for blk in gc.state_blocks:
        if (isinstance(blk.params, CollisionParams) and blk.owner == i
                and tuple(blk.params.pxj) in j_pos):
            return blk
    return None


def active(gc: gcm.GameConstraints, spec: ProblemSpec, i: int, j: int,
           k: int) -> bool:
    """Active flag of the (i, j, k) collision constraint (reference
    ``active``, ``active_set_methods.jl:5-26``).  k is the 0-based knot
    (1..N-1); the block row for knot k is k-1."""
    blk = get_collision_block(gc, spec, i, j)
    if blk is None:
        return False
    return bool(np.asarray(blk.active)[k - 1, 0])


def extended_residual(prob: GameProblem, traj: PrimalDual) -> jnp.ndarray:
    """[Sv] = base flat residual ++ collision constraint values
    (reference ``residual!(ascore, ...)``, ``active_set_methods.jl:97-125``)."""
    spec = prob.spec
    Sv, _ = sizes(spec)
    base = R.residual(prob.model, spec, prob.obj, prob.gc, traj)
    out = jnp.zeros((Sv,), traj.x.dtype)
    out = out.at[:spec.S].set(R.flatten_residual(spec, base))
    for (i, j) in unordered_pairs(spec.p):
        blk = get_collision_block(prob.gc, spec, i, j)
        if blk is None:
            continue
        vals = gcm.block_values(blk, traj)        # [T, 1]
        for k in range(1, spec.T + 1):
            out = out.at[vrow(spec, i, j, k)].add(vals[k - 1, 0])
    return out


def extended_jacobian(prob: GameProblem, traj: PrimalDual) -> jnp.ndarray:
    """[Sv, Sh] dense extended Jacobian (reference
    ``residual_jacobian!(ascore, ...)``, ``active_set_methods.jl:132-170``)."""
    spec = prob.spec
    Sv, Sh = sizes(spec)
    jb = R.jacobian_blocks(prob.model, spec, prob.obj, prob.gc, traj)
    J = jnp.zeros((Sv, Sh), traj.x.dtype)
    J = J.at[:spec.S, :spec.S].set(R.flatten_jacobian(spec, jb))
    n = spec.n
    for (i, j) in ordered_pairs(spec.p):
        blk = get_collision_block(prob.gc, spec, i, j)
        if blk is None:
            continue
        jac = gcm.block_jacobian(blk, traj)       # [T, 1, n]
        for k in range(1, spec.T + 1):
            # opt-i x_k rows x new dual column: grad c^T
            r0 = spec.row_stat_x(i, k - 1)
            J = J.at[r0:r0 + n, hcol(spec, i, j, k)].add(jac[k - 1, 0])
            # new constraint row x x_k columns: grad c (only for i<j rows)
            if i < j:
                c0 = spec.col_x(k - 1)
                J = J.at[vrow(spec, i, j, k), c0:c0 + n].add(jac[k - 1, 0])
    return J


def _pair_jacobians(prob: GameProblem, traj: PrimalDual, pairs):
    """Collision-constraint position Jacobians [T, n] per pair (zero when the
    pair has no constraint), evaluated once from the existing kernels."""
    spec = prob.spec
    out = []
    for (i, j) in pairs:
        blk = get_collision_block(prob.gc, spec, i, j)
        if blk is None:
            out.append(jnp.zeros((spec.T, spec.n), traj.x.dtype))
        else:
            out.append(gcm.block_jacobian(blk, traj)[:, 0, :])
    return out


def extended_jacobian_knotrows(prob: GameProblem, traj: PrimalDual,
                               jb=None) -> jnp.ndarray:
    """[Sv, Sh] extended Jacobian, assembled block-natively.

    Identical column order to :func:`extended_jacobian` (spec per-knot
    columns ++ appended ordered-pair duals) but base rows in PER-KNOT
    equation order (statx | statu | dyn per knot) instead of the reference's
    player-major vertical order — a pure row permutation, so every
    row-order-invariant consumer (nullspace span/dimension, singular values,
    masked SVD) is unchanged while the assembly is scatter-free: the
    ~O(T·p^2) traced ``.at[].add`` updates of the reference-ordered builder
    become three einsum embeddings of the existing block-tridiagonal
    (D, U, L) blocks plus two static concats for the appended
    rows/columns.  Jits in seconds at the roundabout scale (p=4, N=40) and vmaps
    over trajectory batches.  Reference: ``active_set_methods.jl:130-170``.
    """
    spec = prob.spec
    T, W, n = spec.T, spec.W, spec.n
    dtype = traj.x.dtype
    if jb is None:
        jb = R.jacobian_blocks(prob.model, spec, prob.obj, prob.gc, traj)
    D, U, L = R.build_tridiagonal(spec, jb)
    eyeT = jnp.eye(T, dtype=dtype)
    sup = jnp.eye(T, k=1, dtype=dtype)
    sub = jnp.eye(T, k=-1, dtype=dtype)
    zW = jnp.zeros((1, W, W), dtype)
    Upad = jnp.concatenate([U, zW], axis=0)      # row t couples col t+1
    Lpad = jnp.concatenate([zW, L], axis=0)      # row t couples col t-1
    base = (jnp.einsum('ts,twv->twsv', eyeT, D)
            + jnp.einsum('ts,twv->twsv', sup, Upad)
            + jnp.einsum('ts,twv->twsv', sub, Lpad)).reshape(T * W, T * W)

    # Appended dual columns: ordered pair (i, j) at knot k couples the
    # statx rows of player i in the SAME knot block (variable x_k lives in
    # block k-1, and so does the appended column k) — block-diagonal embed.
    opairs = ordered_pairs(spec.p)
    nop = len(opairs)
    cols = []
    for (i, j), jac in zip(opairs, _pair_jacobians(prob, traj, opairs)):
        cols.append(jnp.concatenate(
            [jnp.zeros((T, i * n), dtype), jac,
             jnp.zeros((T, W - (i + 1) * n), dtype)], axis=1))
    Call = jnp.stack(cols, axis=2)               # [T, W, nop]
    right = jnp.einsum('ts,twq->twsq', eyeT, Call).reshape(T * W, T * nop)

    # Appended constraint rows: unordered pair at knot k reads the x columns
    # of block k-1 — block-diagonal embed again.
    upairs = unordered_pairs(spec.p)
    nup = len(upairs)
    rows = []
    for (i, j), jac in zip(upairs, _pair_jacobians(prob, traj, upairs)):
        rows.append(jnp.concatenate(
            [jac, jnp.zeros((T, W - n), dtype)], axis=1))
    Rall = jnp.stack(rows, axis=1)               # [T, nup, W]
    bottom = jnp.einsum('ts,tuw->tusw', eyeT, Rall).reshape(T * nup, T * W)

    zbr = jnp.zeros((T * nup, T * nop), dtype)
    return jnp.concatenate(
        [jnp.concatenate([base, right], axis=1),
         jnp.concatenate([bottom, zbr], axis=1)], axis=0)


def active_masks(prob: GameProblem, gc: gcm.GameConstraints):
    """(vmask, hmask): indices 0..S-1 plus the appended entries whose
    collision constraint is active (reference ``active_vertical_mask!`` /
    ``active_horizontal_mask!``, ``active_set_methods.jl:28-72``)."""
    spec = prob.spec
    vmask = list(range(spec.S))
    for k in range(1, spec.T + 1):
        for (i, j) in unordered_pairs(spec.p):
            if active(gc, spec, i, j, k):
                vmask.append(vrow(spec, i, j, k))
    hmask = list(range(spec.S))
    for k in range(1, spec.T + 1):
        for (i, j) in ordered_pairs(spec.p):
            if active(gc, spec, i, j, k):
                hmask.append(hcol(spec, i, j, k))
    return np.asarray(sorted(vmask)), np.asarray(sorted(hmask))


@pytree_dataclass
class NullSpace:
    """Nullspace basis of the active-set Jacobian (reference ``NullSpace``,
    ``active_set_core.jl:5-45``): columns of ``mat`` span the kernel; ``vec``
    are the full-Sh embeddings, split into trajectory and collision-dual
    parts, each normalized by its mean absolute value."""
    mat: jnp.ndarray      # [len(hmask), dim]
    vec: jnp.ndarray      # [dim, Sh]
    dtraj: jnp.ndarray    # [dim, S]
    dlam: jnp.ndarray     # [dim, Sh - S]


def nullspace_basis(M: jnp.ndarray, atol: float = 1e-10) -> jnp.ndarray:
    """Kernel basis via SVD (Julia ``nullspace`` semantics with explicit
    atol: rank = #{s > atol} over the computed singular values; columns of V
    beyond min(r, c) are always in the kernel)."""
    _, s, Vh = jnp.linalg.svd(M, full_matrices=True)
    rank = int(jnp.sum(s > atol))
    return Vh[rank:].T


def pair_active_flags(gc: gcm.GameConstraints, spec: ProblemSpec):
    """Traced active flags of the appended rows/columns, in ``vrow``/``hcol``
    order (knot-major, pair-minor).  Returns (v_flags [Sv-S], h_flags [Sh-S])
    as jnp bool arrays — the jit-compatible replacement for the host-driven
    ``active_masks``.  Pairs with no collision constraint read inactive."""
    dtype = jnp.bool_

    def flag(i, j):
        blk = get_collision_block(gc, spec, i, j)
        if blk is None:
            return jnp.zeros((spec.T,), dtype)
        return blk.active[:, 0].astype(dtype)          # [T], k=1..T

    v = jnp.stack([flag(i, j) for (i, j) in unordered_pairs(spec.p)],
                  axis=1).reshape(-1)
    h = jnp.stack([flag(i, j) for (i, j) in ordered_pairs(spec.p)],
                  axis=1).reshape(-1)
    return v, h


@pytree_dataclass
class NullSpaceMasked:
    """Fixed-shape, jit/vmap-compatible nullspace of the active-set extended
    Jacobian.  ``vec`` rows are ALL Sh right singular vectors (SVD order,
    kernel last); ``mask`` flags the rows spanning the kernel; ``dim`` is
    their count (traced scalar).  Rows flagged by ``mask`` are normalized by
    their mean absolute value, matching the reference's ``NullSpace``
    convention (``active_set_core.jl:5-45``)."""
    vec: jnp.ndarray      # [Sh, Sh]
    mask: jnp.ndarray     # [Sh] bool
    dim: jnp.ndarray      # scalar int
    svals: jnp.ndarray    # [Sh] singular values


def update_nullspace_masked(prob: GameProblem, traj: PrimalDual,
                            atol: float = 1e-10) -> NullSpaceMasked:
    """Device-resident ``update_nullspace``: jits, vmaps, no host sync.

    Instead of gathering the data-dependent active submatrix
    ``J[vmask, hmask]`` (dynamic shapes — untraceable), build a FIXED-shape
    system whose kernel is the active submatrix's kernel embedded in Sh:

      * inactive appended rows are zeroed (they impose no constraint);
      * one pinning row ``e_c`` is appended per appended column c, scaled by
        ``1 - active(c)`` — forcing inactive-column components to zero while
        active columns stay free.

    A single SVD then yields the kernel basis and its dimension as a masked
    fixed-shape result.  Matches the host-driven ``update_nullspace`` (same
    dimension, same span) — see ``tests/test_active_set.py``.
    Reference semantics: ``active_set_methods.jl:173-184``.
    """
    spec = prob.spec
    Sv, Sh = sizes(spec)
    gc = gcm.update_active_set(prob.gc, traj)
    prob2 = GameProblem(spec=spec, model=prob.model, opts=prob.opts,
                        x0=prob.x0, obj=prob.obj, gc=gc)
    J = extended_jacobian_knotrows(prob2, traj)
    v_flags, h_flags = pair_active_flags(gc, spec)
    dtype = J.dtype
    row_mask = jnp.concatenate(
        [jnp.ones((spec.S,), dtype), v_flags.astype(dtype)])
    top = J * row_mask[:, None]
    pin = jnp.zeros((Sh - spec.S, Sh), dtype).at[
        jnp.arange(Sh - spec.S), spec.S + jnp.arange(Sh - spec.S)
    ].set(1.0 - h_flags.astype(dtype))
    M = jnp.concatenate([top, pin], axis=0)       # [Sv + Sh - S, Sh]
    _, s, Vh = jnp.linalg.svd(M, full_matrices=False)   # Vh [Sh, Sh]
    mask = s <= atol
    norm = jnp.mean(jnp.abs(Vh), axis=1, keepdims=True)
    norm = jnp.where((norm > 0) & mask[:, None], norm, 1.0)
    return NullSpaceMasked(vec=Vh / norm, mask=mask,
                           dim=jnp.sum(mask.astype(jnp.int32)), svals=s)


def update_nullspace(prob: GameProblem, traj: PrimalDual,
                     atol: float = 1e-10) -> NullSpace:
    """Reference ``update_nullspace!`` (``active_set_methods.jl:173-184``):
    refresh active set -> masks -> extended Jacobian -> SVD nullspace."""
    spec = prob.spec
    Sv, Sh = sizes(spec)
    gc = gcm.update_active_set(prob.gc, traj)
    prob2 = GameProblem(spec=spec, model=prob.model, opts=prob.opts,
                        x0=prob.x0, obj=prob.obj, gc=gc)
    vmask, hmask = active_masks(prob2, gc)
    J = extended_jacobian(prob2, traj)
    M = J[np.ix_(vmask, hmask)]
    mat = nullspace_basis(M, atol)
    dim = mat.shape[1]
    vec = jnp.zeros((dim, Sh), traj.x.dtype)
    vec = vec.at[:, hmask].set(mat.T)
    norm = jnp.mean(jnp.abs(vec), axis=1, keepdims=True)
    norm = jnp.where(norm > 0, norm, 1.0)
    vec = vec / norm
    return NullSpace(mat=mat, vec=vec, dtraj=vec[:, :spec.S],
                     dlam=vec[:, spec.S:])
