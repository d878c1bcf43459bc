"""Structured KKT linear solve.

Replaces the reference's hot spot — sparse LU on the S×S KKT matrix
(``src/problem/solver_methods.jl:87``) — with a batched *block-tridiagonal*
factorization (block Thomas algorithm) over the horizon:

  eq t:  Lhat_t y_{t-1} + D_t y_t + U_t y_{t+1} = b_t      (W×W blocks)

Forward elimination and back substitution run as ``lax.scan`` over the T
knots; each step is a W×W pivoted solve (``jnp.linalg.solve``) that is
batched over scenarios by ``vmap`` — the batch dimension is what feeds the
tensor cores.  FLOPs: O(T · W³) versus O((T·W)³) for the dense LU, a ~T² reduction.

A dense fallback (``solve_dense``) materializes the block-tridiagonal system
into an S×S matrix and calls one pivoted solve — the correctness oracle and
the robust path for ill-conditioned corner cases.

Row order in both paths is the per-knot equation order of
``residual_knot_blocks``; the solution comes back in the per-knot column
order unpacked by ``core.traj.unpack_step``.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np


def solve_dense(spec, D, U, L, b_knots):
    """Dense S×S solve of the block-tridiagonal system. b_knots [T, W].

    Returns the flat step [S] (solution of J y = b; caller negates).
    """
    T, W = spec.T, spec.W
    S = T * W
    J = jnp.zeros((S, S), D.dtype)

    def place(J, t, mat, col_t):
        return jax.lax.dynamic_update_slice(J, mat, (t * W, col_t * W))

    for t in range(T):
        J = place(J, t, D[t], t)
        if t + 1 < T:
            J = place(J, t, U[t], t + 1)
            J = jax.lax.dynamic_update_slice(J, L[t], ((t + 1) * W, t * W))
    return jnp.linalg.solve(J, b_knots.reshape(-1))


def solve_tridiagonal(spec, D, U, L, b_knots):
    """Block-Thomas solve. D [T,W,W], U [T-1,W,W], L [T-1,W,W] (L[t] is the
    sub-diagonal block of equation t+1), b_knots [T,W]. Returns flat [S]."""
    T, W = spec.T, spec.W
    dtype = D.dtype
    zeros_W = jnp.zeros((W, W), dtype)

    # Pad: Lhat_t for t=0 is zero; Uhat_t for t=T-1 is zero.
    Lhat = jnp.concatenate([zeros_W[None], L], axis=0)          # [T, W, W]
    Uhat = jnp.concatenate([U, zeros_W[None]], axis=0)          # [T, W, W]

    def fwd(carry, inp):
        G_prev, y_prev = carry
        D_t, Lh_t, Uh_t, b_t = inp
        M = D_t - Lh_t @ G_prev
        rhs = jnp.concatenate([Uh_t, (b_t - Lh_t @ y_prev)[:, None]], axis=1)
        sol = jnp.linalg.solve(M, rhs)                          # [W, W+1]
        G_t = sol[:, :W]
        y_t = sol[:, W]
        return (G_t, y_t), (G_t, y_t)

    init = (zeros_W, jnp.zeros((W,), dtype))
    _, (G, yhat) = jax.lax.scan(fwd, init, (D, Lhat, Uhat, b_knots))

    def bwd(y_next, inp):
        G_t, yhat_t = inp
        y_t = yhat_t - G_t @ y_next
        return y_t, y_t

    _, ys = jax.lax.scan(bwd, jnp.zeros((W,), dtype), (G, yhat), reverse=True)
    return ys.reshape(-1)


def newton_step(spec, D, U, L, b_knots, method: str = "tridiag"):
    """Solve J y = -b for the Newton step. Returns flat [S] in column order."""
    if method == "dense":
        return solve_dense(spec, D, U, L, -b_knots)
    return solve_tridiagonal(spec, D, U, L, -b_knots)


def solve_cyclic_reduction(spec, D, U, L, b_knots):
    """Block cyclic reduction — the horizon-parallel KKT solve.

    Where block-Thomas is a T-step sequential scan of small ops (bound by
    per-step launch overhead, not FLOPs), cyclic reduction runs
    ceil(log2 T) *levels*, each eliminating every odd-indexed block
    simultaneously with a handful of LARGE batched ops:

      y_odd = D_odd^{-1} (b_odd - Lh_odd y_{odd-1} - Uh_odd y_{odd+1})
      D'_e  = D_e - Lh_e D_{e-1}^{-1} Uh_{e-1} - Uh_e D_{e+1}^{-1} Lh_{e+1}
      Lh'_e = -Lh_e D_{e-1}^{-1} Lh_{e-1};  Uh'_e = -Uh_e D_{e+1}^{-1} Uh_{e+1}
      b'_e  = b_e - Lh_e D_{e-1}^{-1} b_{e-1} - Uh_e D_{e+1}^{-1} b_{e+1}

    Each level's solves are pivoted LU batched over [B x T/2] matrices —
    few large batched calls instead of many small ones.  Stability rests on the diagonal
    blocks staying invertible at every level (the reference's pivoting-free
    concern, SURVEY.md §7 hard part 1); the Tikhonov-regularized KKT blocks
    satisfy this in practice and the result is validated against block-Thomas
    in tests.

    Args: D [T, W, W]; U, L [T-1, W, W] (L[t] = sub-diagonal block of
    equation t+1); b_knots [T, W].  Returns flat [S].
    """
    T, W = spec.T, spec.W
    dtype = D.dtype
    zero = jnp.zeros((1, W, W), dtype)
    Lh = jnp.concatenate([zero, L], axis=0)          # [T] sub-diag of eq t
    Uh = jnp.concatenate([U, zero], axis=0)          # [T] super-diag of eq t
    b = b_knots

    # Reduce: record per-level (D_odd, Lh_odd, Uh_odd, b_odd, had_pad).
    stack = []
    while D.shape[0] > 1:
        Tl = D.shape[0]
        if Tl % 2 == 1:  # pad with identity block / zero couplings
            eye = jnp.eye(W, dtype=dtype)[None]
            D = jnp.concatenate([D, eye], axis=0)
            Lh = jnp.concatenate([Lh, jnp.zeros((1, W, W), dtype)], axis=0)
            Uh = jnp.concatenate([Uh, jnp.zeros((1, W, W), dtype)], axis=0)
            b = jnp.concatenate([b, jnp.zeros((1, W), dtype)], axis=0)
            Tl += 1
        Do, De = D[1::2], D[0::2]
        Lo, Le = Lh[1::2], Lh[0::2]
        Uo, Ue = Uh[1::2], Uh[0::2]
        bo, be = b[1::2], b[0::2]
        # Solve against every odd diagonal block once: D_o^{-1} [L_o U_o b_o]
        rhs = jnp.concatenate([Lo, Uo, bo[..., None]], axis=-1)
        sol = jnp.linalg.solve(Do, rhs)
        DiL, DiU, Dib = sol[..., :W], sol[..., W:2 * W], sol[..., 2 * W]
        stack.append((DiL, DiU, Dib, Tl))

        ne = De.shape[0]
        # Even block t uses odd neighbors t-1 (odd index t//2 - 1... careful:
        # even positions 0,2,4..; left odd neighbor of even j is odd j-1 ->
        # odd array index (j-1)//2 = jj-1 for even index jj; right neighbor
        # odd j+1 -> index jj.
        Dn = De
        Ln = jnp.zeros_like(Le)
        Un = jnp.zeros_like(Ue)
        bn = be
        # right odd neighbor exists for even jj when jj < #odd
        no = DiL.shape[0]
        m_r = min(ne, no)
        Dn = Dn.at[:m_r].add(-Ue[:m_r] @ DiL[:m_r])
        Un = Un.at[:m_r].set(-Ue[:m_r] @ DiU[:m_r])
        bn = bn.at[:m_r].add(-jnp.einsum('tij,tj->ti', Ue[:m_r], Dib[:m_r]))
        # left odd neighbor exists for even jj >= 1 (odd index jj-1)
        if ne > 1:
            Dn = Dn.at[1:].add(-Le[1:] @ DiU[:ne - 1])
            Ln = Ln.at[1:].set(-Le[1:] @ DiL[:ne - 1])
            bn = bn.at[1:].add(-jnp.einsum('tij,tj->ti', Le[1:], Dib[:ne - 1]))
        D, Lh, Uh, b = Dn, Ln, Un, bn

    y = jnp.linalg.solve(D[0], b[0])
    ys = y[None]

    # Back-substitute up the levels.
    for (DiL, DiU, Dib, Tl) in reversed(stack):
        half = Tl // 2
        y_even = ys[:half]                           # trim any coarser pad
        # y_odd[j] = Dib[j] - DiL[j] y_even[j] - DiU[j] y_even[j+1]
        y_odd = Dib - jnp.einsum('tij,tj->ti', DiL, y_even)
        if half > 1:
            y_odd = y_odd.at[:half - 1].add(
                -jnp.einsum('tij,tj->ti', DiU[:half - 1], y_even[1:]))
        merged = jnp.zeros((Tl, W), dtype)
        merged = merged.at[0::2].set(y_even)
        merged = merged.at[1::2].set(y_odd)
        ys = merged
    return ys[:T].reshape(-1)


class SchurBlocks(NamedTuple):
    """Per-knot ingredients of the condensed (Schur) block-Thomas sweep,
    shared by :func:`solve_tridiagonal_schur` and the fused sweep kernel
    (``ops/thomas_pallas.py``).  ``ms`` is the (padded) control width."""
    Kbase: jnp.ndarray    # [T, d, d]   rows (statu | dyn), cols (x | u)
    RHS_top: jnp.ndarray  # [T, ms, pn+1]  statu rows of the RHS
    Q: jnp.ndarray        # [T, p, n, n]
    a: jnp.ndarray        # [T, p, n]   statx RHS blocks
    d0: jnp.ndarray       # [T, n]      dyn RHS
    Asub: jnp.ndarray     # [T, n, n]   A_t (0 at t=0)
    AsupT: jnp.ndarray    # [T, n, n]   A_{t+1}^T (0 at t=T-1)
    ms: int


def _hetero_padding(spec):
    """Player-major padded control layout for heterogeneous per-player mi:
    ``idx[r]`` is the natural control index of padded row r (``m`` = a
    virtual zero column for padding rows), ``pad_mask[r]`` marks padding."""
    p, m = spec.p, spec.m
    mmax = max(spec.mi)
    ms = p * mmax
    idx = np.full((ms,), m, np.int64)
    pad_mask = np.zeros((ms,), np.float64)
    for i in range(p):
        mi = spec.mi[i]
        idx[i * mmax:i * mmax + mi] = np.asarray(spec.pu[i])
        pad_mask[i * mmax + mi:(i + 1) * mmax] = 1.0
    return idx, pad_mask


def schur_blocks(spec, jb, b_knots) -> SchurBlocks:
    """Carry-independent part of the condensed sweep.

    Exploits the *interior* structure of each W×W KKT block:

    * statx rows are ``[Q_i | 0 | -I(own lam)]`` — the -I pivots eliminate all
      p·n multiplier unknowns exactly (no conditioning loss):
      ``lam_i = Q_i x - a_i``.
    * The Thomas fill-in ``Lhat_t G_{t-1}`` touches only [dyn rows x lam cols]
      because Lhat lives in dyn-rows/x-cols and G's nonzero columns are the
      lam block of U.

    Heterogeneous per-player mi is handled by padding every player's control
    block to mmax = max(mi) with identity rows / zero couplings, in
    PLAYER-MAJOR order: the padded unknowns satisfy ``1 * u_pad = 0`` and
    are exactly decoupled (the reference's sparse LU is shape-agnostic,
    ``src/core/newton_core.jl:40-89``).
    """
    T, n, m, p = spec.T, spec.n, spec.m, spec.p
    pn = p * n
    dtype = jb.A.dtype
    eye_n = jnp.eye(n, dtype=dtype)

    zero_n = jnp.zeros((1, n, n), dtype)
    Asub = jnp.concatenate([zero_n, jb.A[1:]], axis=0)   # sub-diag A_t (0 at t=0)
    Asup = jnp.concatenate([jb.A[1:], zero_n], axis=0)   # super-diag A_{t+1} (0 at T-1)
    AsupT = jnp.transpose(Asup, (0, 2, 1))               # At1^T per knot

    a_all = b_knots[:, :pn].reshape(T, p, n)             # statx RHS blocks
    c_all = b_knots[:, pn:pn + m]
    d_all = b_knots[:, pn + m:]
    Q_all = jb.Qblk                                      # [T, p, n, n]

    if spec.homogeneous:
        # Per-player control columns of B: [T, p, n, mi]; row embeddings by
        # static permutation gather, not scatter.
        pu = np.stack([np.asarray(spec.pu[i]) for i in range(p)])  # [p, mi]
        perm = pu.reshape(-1)
        inv = np.argsort(perm)
        Bp_all = (jb.B[:, :, perm].reshape(T, n, p, -1)
                  .transpose(0, 2, 1, 3))
        BtQ_p = jnp.sum(Bp_all[..., None] * Q_all[:, :, :, None, :],
                        axis=2)                          # [T, p, mi, n]
        BtQ = BtQ_p.reshape(T, m, n)[:, inv, :]
        Ub_s, B_s = jb.Ublk, jb.B
        ms = m
    else:
        mmax = max(spec.mi)
        idx, pad_mask = _hetero_padding(spec)
        ms = len(idx)
        pad_eye = jnp.asarray(np.diag(pad_mask), dtype)
        zcol = jnp.zeros((T, n, 1), dtype)
        B_s = jnp.concatenate([jb.B, zcol], axis=2)[:, :, idx]   # [T, n, ms]
        Bp_all = B_s.reshape(T, n, p, mmax).transpose(0, 2, 1, 3)
        BtQ_p = jnp.sum(Bp_all[..., None] * Q_all[:, :, :, None, :],
                        axis=2)                          # [T, p, mmax, n]
        BtQ = BtQ_p.reshape(T, ms, n)
        Ub_ext = jnp.pad(jb.Ublk, ((0, 0), (0, 1), (0, 1)))
        Ub_s = Ub_ext[:, idx][:, :, idx] + pad_eye[None]

    Kbase = jnp.concatenate([
        jnp.concatenate([BtQ, Ub_s], axis=2),
        jnp.concatenate([jnp.broadcast_to(-eye_n, (T, n, n)), B_s], axis=2),
    ], axis=1)                                           # [T, n+ms, n+ms]

    cG_p = jnp.sum(Bp_all[..., None] * AsupT[:, None, :, None, :],
                   axis=2)                             # [T, p, mi|mmax, n]
    eye_p = jnp.asarray(np.eye(p), dtype)
    cG_bd = (cG_p[:, :, :, None, :]
             * eye_p[None, :, None, :, None])            # [T, p, ., p, n]
    cG = cG_bd.reshape(T, ms, pn)
    cy_add = jnp.sum(Bp_all * a_all[..., None], axis=2)  # [T, p, mi|mmax]
    if spec.homogeneous:
        cG = cG[:, inv, :]
        cy = c_all + cy_add.reshape(T, m)[:, inv]
    else:
        cy = (jnp.pad(c_all, ((0, 0), (0, 1)))[:, idx]
              + cy_add.reshape(T, ms))
    RHS_top = jnp.concatenate([cG, cy[:, :, None]], axis=2)  # [T, ms, pn+1]
    return SchurBlocks(Kbase=Kbase, RHS_top=RHS_top, Q=Q_all, a=a_all,
                       d0=d_all, Asub=Asub, AsupT=AsupT, ms=ms)


def schur_unpad(spec, ys):
    """[T, n+ms+pn] sweep output (padded player-major controls) -> [T, W]
    in the natural per-knot column order."""
    if spec.homogeneous:
        return ys
    n, m, p = spec.n, spec.m, spec.p
    mmax = max(spec.mi)
    ms = p * mmax
    nat2pm = np.zeros((m,), np.int64)
    for i in range(p):
        nat2pm[np.asarray(spec.pu[i])] = i * mmax + np.arange(spec.mi[i])
    cols = np.concatenate([np.arange(n), n + nat2pm,
                           n + ms + np.arange(p * n)])
    return ys[:, cols]


def solve_tridiagonal_schur(spec, jb, b_knots):
    """Structure-exploiting block-Thomas solve (see :func:`schur_blocks`).

    Each scan step reduces to a handful of n×n / n×m matmuls plus ONE
    pivoted solve of size (n+m) with (p·n + 1) right-hand sides — versus a
    (W = n+m+p·n)-size pivoted solve in the generic path.  For the 3-player
    unicycle flagship: 18×18 instead of 54×54 (27x fewer LU FLOPs, 3x
    shorter sequential pivot chain).  Every contraction is pinned to
    ``HIGHEST`` precision: the float32 path must not drop to TF32.

    Args: ``jb``: JacBlocks; ``b_knots`` [T, W] (pass the NEGATED residual to
    get the Newton step).  Returns flat [S] in per-knot column order.
    """
    n, p = spec.n, spec.p
    pn = p * n
    sb = schur_blocks(spec, jb, b_knots)
    ms = sb.ms
    dtype = jb.A.dtype
    hi = jax.lax.Precision.HIGHEST

    def fwd(carry, inp):
        # Carry holds only the (x, u) rows [d = n+ms]: the recursion reads
        # just the x rows, and the multipliers are reconstructed during the
        # backward sweep from the statx relation (see ``bwd``).
        G_prev, y_prev = carry                       # [d, pn], [d]
        Q, Kb, Rt, a, d0, At, At1T = inp
        # Thomas fill-in: only dyn rows x lam cols.
        F = -jnp.matmul(At, G_prev[:n], precision=hi)          # [n, pn]
        F3 = F.reshape(n, p, n)
        FQ = jnp.einsum('aib,ibq->aq', F3, Q, precision=hi)    # [n, n]
        K = Kb.at[ms:, :n].add(FQ)

        dG = jnp.einsum('aib,bq->aiq', F3, At1T,
                        precision=hi).reshape(n, pn)
        dy = (d0 - jnp.matmul(At, y_prev[:n], precision=hi)
              + jnp.einsum('aib,ib->a', F3, a, precision=hi))
        RHS = jnp.concatenate(
            [Rt, jnp.concatenate([dG, dy[:, None]], axis=1)], axis=0)
        sol = jnp.linalg.solve(K, RHS)               # [(n+ms), pn+1]
        G_t = sol[:, :pn]                            # rows (x, u)
        y_t = sol[:, pn]
        return (G_t, y_t), (G_t, y_t)

    d_rows = n + ms
    init = (jnp.zeros((d_rows, pn), dtype), jnp.zeros((d_rows,), dtype))
    _, (G, yhat) = jax.lax.scan(
        fwd, init,
        (sb.Q, sb.Kbase, sb.RHS_top, sb.a, sb.d0, sb.Asub, sb.AsupT))

    def bwd(lam_next, inp):
        # lam_{i,t} = Q_i x_t + A_{t+1}^T lam_{i,t+1} - a_{i,t}  (statx row
        # solved for the eliminated multiplier; A_T^T = 0 at the last knot).
        G_t, yhat_t, Q, At1T, a = inp
        xu = yhat_t - jnp.matmul(G_t, lam_next, precision=hi)  # [d]
        x = xu[:n]
        lam = (jnp.einsum('pab,b->pa', Q, x, precision=hi)
               + jnp.einsum('ab,pb->pa', At1T, lam_next.reshape(p, n),
                            precision=hi)
               - a)                                  # [p, n]
        lam = lam.reshape(pn)
        return lam, jnp.concatenate([xu, lam])

    _, ys = jax.lax.scan(bwd, jnp.zeros((pn,), dtype),
                         (G, yhat, sb.Q, sb.AsupT, sb.a), reverse=True)
    return schur_unpad(spec, ys).reshape(-1)
