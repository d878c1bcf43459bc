"""Pallas kernel (Triton route): the fused block-tridiagonal KKT sweep.

The XLA Schur-condensed Thomas sweep (``linear_solver.solve_tridiagonal_schur``)
is launch-bound on a GPU: every knot of its two ``lax.scan``s issues several
small batched dots and a batched LU solve, a few hundred launches per Newton
iteration at T = 20.  This module runs the same recursion as two
``pallas_call``s — a forward elimination and a back substitution — with the
knot loop *inside* the program.

Layout: one program per scenario (the solver is written per scenario and
``vmap`` turns the batch into the kernel's grid).  Every operand keeps the
solver's natural ``[T, ...]`` layout; the kernel reads it with masked gather
loads into power-of-two padded tiles, so no relayout happens in XLA.  The
carry-independent per-knot blocks come from ``linear_solver.schur_blocks``,
shared with the XLA path.

Per knot the forward program

1. forms the fill-in ``F = -A_t G_{t-1}`` as rank-1 updates whose operands
   it reads back from the previous knot's output (``G`` never lives in
   registers across knots, so no tile has to be re-indexed in registers);
2. forms ``F Q``, ``F A_{t+1}^T`` and the RHS update from ``F`` staged in a
   per-program scratch buffer;
3. writes those into the dyn rows of a scratch copy of the augmented system
   ``[K | RHS]`` and adds the carry-independent part;
4. solves the (n+m)-square system by Gaussian elimination with row partial
   pivoting — the pivot row is selected per scenario by an argmax over the
   not-yet-used rows and swapped *virtually* (the rank-1 update is masked to
   unpivoted rows and the normalized pivot row is saved), which is what
   holds float32 accuracy at AL penalties up to 1e7 — followed by a
   backward elimination on the saved unit-upper rows.  Control columns
   are eliminated before state columns (see :func:`_pivoted_solve`).

Blocks of a GPU grid run in parallel and in no order, so nothing is carried
between programs; within a program, a ``debug_barrier`` orders every store
to a scratch or output buffer before the loads that read it back.  Loads of
buffers the kernel itself wrote are ``volatile`` (no stale L1 line).

Contractions are explicit multiply-adds in the operand dtype (no ``tl.dot``,
so no TF32 and float64 works as well as float32).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..problem.linear_solver import schur_blocks, schur_unpad

# Warps per program.  One program solves one scenario; its tiles are a few
# thousand elements, and most steps are reductions across one tile.  Two
# warps give the shortest sweep for one program; one warp per program packs
# more programs per SM, which wins once the grid fills the card.  Measured
# end to end on an H100 (flagship, float32): 2 warps best at 128 scenarios
# per call, 1 warp best at 4,096 (docs/PERF.md).
def warps_for_batch(batch: int) -> int:
    return 2 if batch <= 512 else 1


def _pow2(x: int) -> int:
    """Smallest power of two >= x (Triton tiles are powers of two)."""
    return 1 << max(0, int(x) - 1).bit_length()


def tile_dims(n: int, ms: int, p: int) -> dict:
    """Padded tile sizes of the sweep for state width n, (padded) control
    width ms and p players: ``NP`` pads n, ``PP`` pads p, ``DP`` pads the
    d = n + ms unknowns of one knot, ``CP`` pads the d + p*n + 1 columns of
    the augmented system ``[K | G | y]``."""
    d = n + ms
    return dict(NP=_pow2(n), PP=_pow2(p), DP=_pow2(d),
                CP=_pow2(d + p * n + 1))


def _iota(shape, dim):
    return lax.broadcasted_iota(jnp.int32, shape, dim)


def _oob(ref, idx, mask):
    """Send the indices of masked lanes one past their dimension: the GPU
    never touches them, the interpreter clamps loads and drops stores."""
    return tuple(i if jnp.ndim(i) == 0
                 else jnp.where(mask, i, jnp.int32(size))
                 for i, size in zip(idx, ref.shape))


def _load(ref, idx, mask, volatile=False):
    """Masked gather load; masked lanes read 0."""
    return plgpu.load(ref.at[_oob(ref, idx, mask)], mask=mask, other=0.0,
                      volatile=volatile)


def _store(ref, idx, val, mask):
    """Masked scatter store."""
    plgpu.store(ref.at[_oob(ref, idx, mask)], val, mask=mask)


def _barrier(interpret):
    if not interpret:
        plgpu.debug_barrier()


def _pivoted_solve(Aug, d, first, DP, CP):
    """Solve ``Aug[:d, :d] X = Aug[:d, d:]`` in place.  Returns the tile
    whose row j holds unknown j in the RHS columns (col >= d).

    Columns are eliminated in the order ``first, ..., d-1, 0, ..., first-1``
    (the control columns before the state columns: the state columns carry
    the AL-penalty curvature, and pivoting them first loses float32
    accuracy on ill-conditioned knots).  The pivot row for column c is
    saved in row c of the result."""
    dtype = Aug.dtype
    rid1 = _iota((DP,), 0)
    rid2 = _iota((DP, CP), 0)
    cid2 = _iota((DP, CP), 1)
    zero = jnp.zeros((), dtype)
    # Elimination step of column c (the inverse of the column order).
    step1 = jnp.where(rid1 >= first, rid1 - first, rid1 + (d - first))

    def column(k):
        return jnp.where(k < d - first, k + first, k - (d - first))

    def elim(k, c):
        A, U, used = c
        i = column(k)
        col = jnp.sum(jnp.where(cid2 == i, A, zero), axis=1)        # [DP]
        mag = jnp.where(used, -1.0, jnp.abs(col))
        sel = lax.argmax(mag, 0, jnp.int32)                         # first max
        onehot = rid1 == sel
        piv = jnp.sum(jnp.where(onehot, col, zero))
        row = jnp.sum(jnp.where(onehot[:, None], A, zero), axis=0) / piv
        # Pivot row keeps exactly the normalized row (multiplier piv - 1);
        # used rows are untouched; every other row is eliminated.
        colv = (jnp.where(used, zero, col)
                - jnp.where(onehot, 1.0, zero))
        A = A - colv[:, None] * row[None, :]
        U = jnp.where(rid2 == i, row[None, :], U)                   # slot i
        return A, U, used | onehot

    used0 = rid1 >= d                                # padding rows never pivot
    _, U, _ = lax.fori_loop(jnp.int32(0), jnp.int32(d), elim,
                            (Aug, jnp.zeros_like(Aug), used0))

    def back(k, U):
        j = d - 1 - k
        i = column(j)
        row = jnp.sum(jnp.where(rid2 == i, U, zero), axis=0)        # [CP]
        col = jnp.sum(jnp.where(cid2 == i, U, zero), axis=1)        # [DP]
        return U - jnp.where(step1 < j, col, zero)[:, None] * row[None, :]

    return lax.fori_loop(jnp.int32(0), jnp.int32(d), back, U)


def _fwd_kernel(T, n, ms, p, interpret,
                aug0_ref, a_ref, at1_ref, q_ref, b_ref,
                g_ref, y_ref, fs_ref, s_ref):
    """Forward elimination over the T knots of one scenario.

    Inputs: aug0 [T, d, C] carry-independent ``[K | RHS]``; a [T, n, n]
    (A_t); at1 [T, n, n] (A_{t+1}^T); q [T, p, n, n]; b [T, p, n] (statx
    RHS).  Outputs: g [T, d, pn], y [T, d]; fs [NP, PP, NP] and s [DP, CP]
    are per-program scratch."""
    pn, d = p * n, n + ms
    C = d + pn + 1
    dims = tile_dims(n, ms, p)
    NP, PP, DP, CP = dims["NP"], dims["PP"], dims["DP"], dims["CP"]
    dtype = aug0_ref.dtype
    zero = jnp.zeros((), dtype)

    # [NP, PP, NP] index tiles: (row a, player i, col q)
    a3, i3, q3 = _iota((NP, PP, NP), 0), _iota((NP, PP, NP), 1), \
        _iota((NP, PP, NP), 2)
    m3 = (a3 < n) & (i3 < p) & (q3 < n)
    i2, q2 = _iota((PP, NP), 0), _iota((PP, NP), 1)
    m2 = (i2 < p) & (q2 < n)
    a1 = _iota((NP,), 0)
    r1 = _iota((DP,), 0)
    r2, c2 = _iota((DP, CP), 0), _iota((DP, CP), 1)
    a_nn, b_nn = _iota((NP, NP), 0), _iota((NP, NP), 1)
    m_nn = (a_nn < n) & (b_nn < n)

    s_ref[...] = jnp.zeros((DP, CP), dtype)
    _barrier(interpret)

    def knot(t, carry):
        have = t > 0
        tp = jnp.maximum(t - 1, 0)

        # 1. F = -A_t G_{t-1}[x rows]; dy = -A_t y_{t-1}[x rows].  The
        # contraction loops are unrolled so that their loads, which do not
        # depend on one another, are all in flight together.
        F = jnp.zeros((NP, PP, NP), dtype)
        dy = jnp.zeros((NP,), dtype)
        for k in range(n):
            acol = _load(a_ref, (t, a1, jnp.full((NP,), k)), a1 < n)
            grow = _load(g_ref, (tp, jnp.full((PP, NP), k), i2 * n + q2),
                         m2 & have, volatile=True)
            yk = jnp.sum(_load(y_ref, (tp, jnp.full((NP,), k)),
                               (a1 == 0) & have, volatile=True))
            F = F - acol[:, None, None] * grow[None, :, :]
            dy = dy - acol * yk
        fs_ref[...] = F
        _barrier(interpret)

        # 2. FQ = sum_i F_i Q_i, dG_i = F_i A_{t+1}^T, dy += sum_i F_i a_i.
        FQ3 = jnp.zeros((NP, PP, NP), dtype)
        dG = jnp.zeros((NP, PP, NP), dtype)
        for bc in range(n):
            fb = plgpu.load(fs_ref.at[:, :, bc], volatile=True)    # [NP, PP]
            at1 = _load(at1_ref, (t, jnp.full((NP,), bc), a1), a1 < n)
            qb = _load(q_ref, (t, i2, jnp.full((PP, NP), bc), q2), m2)
            ab = jnp.sum(_load(b_ref, (t, i2, jnp.full((PP, NP), bc)),
                               m2 & (q2 == 0)), axis=1)            # [PP]
            FQ3 = FQ3 + fb[:, :, None] * qb[None, :, :]
            dG = dG + fb[:, :, None] * at1[None, None, :]
            dy = dy + jnp.sum(fb * ab[None, :], axis=1)
        FQ = jnp.sum(FQ3, axis=1)                                   # [NP, NP]

        # 3. Dyn rows (ms + a) of the augmented system: FQ in the x columns,
        # dG in the G columns, dy in the y column.
        _store(s_ref, (ms + a_nn, b_nn), FQ, m_nn)
        _store(s_ref, (ms + a3, d + i3 * n + q3), dG, m3)
        _store(s_ref, (ms + a1, jnp.full((NP,), d + pn)), dy, a1 < n)
        _barrier(interpret)
        aug = (_load(aug0_ref, (t, r2, c2), (r2 < d) & (c2 < C))
               + plgpu.load(s_ref.at[:, :], volatile=True))

        # 4. Pivoted solve; store G_t (cols d..d+pn) and y_t (col d+pn).
        sol = _pivoted_solve(aug, d, n, DP, CP)
        _store(g_ref, (t, r2, c2 - d), sol,
               (r2 < d) & (c2 >= d) & (c2 < d + pn))
        _store(y_ref, (t, r1), jnp.sum(
            jnp.where(c2 == d + pn, sol, zero), axis=1), r1 < d)
        _barrier(interpret)
        return carry

    lax.fori_loop(jnp.int32(0), jnp.int32(T), knot, jnp.int32(0))


def _bwd_kernel(T, n, ms, p, g_ref, yhat_ref, q_ref, at1_ref, b_ref, out_ref):
    """Back substitution: x/u rows from the forward carry, multipliers in
    closed form ``lam_{i,t} = Q_i x_t + A_{t+1}^T lam_{i,t+1} - a_{i,t}``.
    Output [T, d + pn] per knot: (x, u, lam)."""
    pn, d = p * n, n + ms
    dims = tile_dims(n, ms, p)
    NP, PP, DP = dims["NP"], dims["PP"], dims["DP"]
    dtype = g_ref.dtype
    zero = jnp.zeros((), dtype)

    r3, i3, q3 = _iota((DP, PP, NP), 0), _iota((DP, PP, NP), 1), \
        _iota((DP, PP, NP), 2)
    i2, q2 = _iota((PP, NP), 0), _iota((PP, NP), 1)
    m2 = (i2 < p) & (q2 < n)
    r1 = _iota((DP,), 0)
    ia, aa, ba = (_iota((PP, NP, NP), 0), _iota((PP, NP, NP), 1),
                  _iota((PP, NP, NP), 2))
    a_nn, b_nn = _iota((NP, NP), 0), _iota((NP, NP), 1)
    sel_b, sel_r = _iota((NP, DP), 0), _iota((NP, DP), 1)

    def knot(k, lam_next):
        t = T - 1 - k
        G = _load(g_ref, (t, r3, i3 * n + q3), (r3 < d) & (i3 < p) & (q3 < n))
        yhat = _load(yhat_ref, (t, r1), r1 < d)
        xu = yhat - jnp.sum(jnp.sum(G * lam_next[None, :, :], axis=2), axis=1)
        # x as a [NP] vector on the contraction axis (xu rows 0..n).
        x = jnp.sum(jnp.where(sel_b == sel_r, xu[None, :], zero), axis=1)
        Qt = _load(q_ref, (t, ia, aa, ba), (ia < p) & (aa < n) & (ba < n))
        at1 = _load(at1_ref, (t, a_nn, b_nn), (a_nn < n) & (b_nn < n))
        a = _load(b_ref, (t, i2, q2), m2)
        lam = (jnp.sum(Qt * x[None, None, :], axis=2)
               + jnp.sum(at1[None, :, :] * lam_next[:, None, :], axis=2)
               - a)                                                 # [PP, NP]
        _store(out_ref, (t, r1), xu, r1 < d)
        _store(out_ref, (t, d + i2 * n + q2), lam, m2)
        return lam

    lax.fori_loop(jnp.int32(0), jnp.int32(T), knot,
                  jnp.zeros((PP, NP), dtype))


def sweep(spec, jb, b_knots, interpret: bool = False, batch: int = 1):
    """Per-scenario drop-in for ``solve_tridiagonal_schur``: ``jb`` leaves
    [T, ...], ``b_knots`` [T, W] (the negated residual for a Newton step).
    Returns the flat step [S].  Batch it with ``jax.vmap``: the batch
    becomes the kernel grid, one program per scenario; ``batch`` is that
    grid's size, which sets the warps per program."""
    T, n, p = spec.T, spec.n, spec.p
    pn = p * n
    sb = schur_blocks(spec, jb, b_knots)
    ms = sb.ms
    d = n + ms
    dims = tile_dims(n, ms, p)
    dtype = jb.A.dtype
    aug0 = jnp.concatenate([
        jnp.concatenate([sb.Kbase[:, :ms], sb.RHS_top], axis=2),
        jnp.concatenate([sb.Kbase[:, ms:], jnp.zeros((T, n, pn), dtype),
                         sb.d0[:, :, None]], axis=2)], axis=1)      # [T, d, C]
    params = plgpu.CompilerParams(num_warps=warps_for_batch(batch),
                                  num_stages=1)
    G, yhat, _, _ = pl.pallas_call(
        functools.partial(_fwd_kernel, T, n, ms, p, interpret),
        out_shape=(
            jax.ShapeDtypeStruct((T, d, pn), dtype),
            jax.ShapeDtypeStruct((T, d), dtype),
            jax.ShapeDtypeStruct((dims["NP"], dims["PP"], dims["NP"]), dtype),
            jax.ShapeDtypeStruct((dims["DP"], dims["CP"]), dtype),
        ),
        compiler_params=params, interpret=interpret, name="kkt_sweep_fwd",
    )(aug0, sb.Asub, sb.AsupT, sb.Q, sb.a)
    ys = pl.pallas_call(
        functools.partial(_bwd_kernel, T, n, ms, p),
        out_shape=jax.ShapeDtypeStruct((T, d + pn), dtype),
        compiler_params=params, interpret=interpret, name="kkt_sweep_bwd",
    )(G, yhat, sb.Q, sb.AsupT, sb.a)
    return schur_unpad(spec, ys).reshape(-1)


def solve_thomas_pallas(spec, jb, b_knots, interpret: bool = False):
    """Batched form of :func:`sweep`: ``jb`` leaves and ``b_knots`` carry a
    leading batch axis [B, ...].  Returns [B, S]."""
    batch = b_knots.shape[0]
    return jax.vmap(lambda j, b: sweep(spec, j, b, interpret=interpret,
                                       batch=batch))(jb, b_knots)


@functools.lru_cache(maxsize=None)
def thomas_pallas_for_spec(spec, interpret: bool = False):
    """Per-scenario KKT solve ``(JacBlocks, b) -> [S]`` for ``spec`` whose
    batching rule sees the batch size and picks the warps per program from
    it (:func:`warps_for_batch`)."""

    @jax.custom_batching.custom_vmap
    def solve(jb, b):
        return sweep(spec, jb, b, interpret=interpret)

    @solve.def_vmap
    def _rule(axis_size, in_batched, jb, b):
        jb_flags, b_flag = in_batched

        def bcast(x, flag):
            return x if flag else jnp.broadcast_to(
                x[None], (axis_size,) + x.shape)

        jb = jax.tree_util.tree_map(bcast, jb, jb_flags)
        return solve_thomas_pallas(spec, jb, bcast(b, b_flag),
                                   interpret=interpret), True

    return solve
