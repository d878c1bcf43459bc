"""KKT residual and Jacobian-block assembly.

JAX equivalent of the reference's global residual/Jacobian assembly
(``src/problem/global_quantities.jl:4-193``) and the per-knot dynamics
quantities (``src/problem/local_quantities.jl:5-27``).

Where the reference scatters SubArray views into a sparse S×S matrix, this
module produces *dense per-knot blocks* in a ``[T, ...]`` leading-axis
layout — the KKT matrix is block tridiagonal in the knot index (SURVEY.md
§3.2) and is never materialized sparse:

  per-knot variable block  v_t = [x_{t+1} (n) | u_t (m) | lam_{0..p-1,t} (p n)]
  per-knot equation block  e_t = [statx(i,t) i=0..p-1 | statu(t) | dyn(t)]

  D[t] = de_t/dv_t,  U[t] = de_t/dv_{t+1},  L[t] = de_t/dv_{t-1}

with entries (0-based t; cf. ``global_quantities.jl:128-171``):

  statx(i,t) rows:  Qblk[t,i] at x-cols;  -I at lam_i-cols;  A_{t+1}^T in U[t]
  statu(t) rows:    Ublk[t] at u-cols;    B_t[:,pu_i]^T at lam_i-cols (rows pu_i)
  dyn(t) rows:      -I at x-cols;  B_t at u-cols;  A_t in L[t]

The Jacobian is quasi-Newton exactly as the reference: second derivatives of
the dynamics (d(A^T lam)/dx) are dropped.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..constraints import sets as gcm
from ..core.spec import ProblemSpec
from ..core.traj import PrimalDual
from ..models.integration import rk2_step, step_jacobians_traj
from ..objective.objective import cost_gradient, cost_hessian
from ..utils import pytree_dataclass

# float32 contractions are exact float32 on every backend (no TF32).
_HI = jax.lax.Precision.HIGHEST


@pytree_dataclass
class Residual:
    """Structured KKT residual.

    rx [T, p, n]: stationarity wrt x_{t+1} per player
    ru [T, m]:    stationarity wrt u_t (interleaved player ownership)
    rd [T, n]:    dynamics defects  f(x_t, u_t) - x_{t+1}
    """
    rx: jnp.ndarray
    ru: jnp.ndarray
    rd: jnp.ndarray


def owner_map_u(spec: ProblemSpec) -> np.ndarray:
    """owner_u[j] = player owning control index j."""
    owner = np.zeros((spec.m,), np.int32)
    for i in range(spec.p):
        owner[np.asarray(spec.pu[i])] = i
    return owner


def _same_owner_mask(spec: ProblemSpec) -> np.ndarray:
    """Static [m, m] 0/1 mask: 1 iff both control indices belong to the same
    player.  Embedding per-player control Hessian sub-blocks is a multiply by
    this mask, not a strided ``.at[pu, pu].add`` scatter."""
    owner = owner_map_u(spec)
    return (owner[:, None] == owner[None, :]).astype(np.float64)


def _owner_select(spec: ProblemSpec, per_player, T, width, dtype):
    """Stack per-player accumulations [T, width] (None = zero) into a
    [T, p, width] add-term.  Replaces per-block ``rx.at[:, owner].add``
    scatters with ONE stack + ONE add."""
    if all(g is None for g in per_player):
        return None
    z = None
    out = []
    for g in per_player:
        if g is None:
            if z is None:
                z = jnp.zeros((T,) + width, dtype)
            g = z
        out.append(g)
    return jnp.stack(out, axis=1)


def dynamics_residual(model, spec: ProblemSpec, traj: PrimalDual) -> jnp.ndarray:
    """RK2 defects [T, n] (reference ``dynamics_residual``,
    ``local_quantities.jl:13-15``)."""
    step = jax.vmap(lambda x, u: rk2_step(model, x, u, spec.dt))
    return step(traj.x[:-1], traj.u) - traj.x[1:]


def residual(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
             traj: PrimalDual, reg: jnp.ndarray | float = 0.0,
             traj_ref: PrimalDual | None = None) -> Residual:
    """Full KKT residual (reference ``residual!`` + ``regularize_residual!``,
    ``global_quantities.jl:9-97``).

    ``reg``/``traj_ref`` implement the Tikhonov pull toward a reference
    trajectory used during line search; at ``traj_ref = traj`` it vanishes.
    Implemented as ``point_data`` + ``residual_from_point`` so fresh and
    carried evaluations are the same code path.
    """
    pd = point_data(model, spec, obj, gc, traj)
    res = residual_from_point(spec, gc, pd)
    if traj_ref is not None:
        res = Residual(
            rx=res.rx + reg * (traj.x[1:] - traj_ref.x[1:])[:, None, :],
            ru=res.ru + reg * (traj.u - traj_ref.u),
            rd=res.rd)
    return res


def residual_norm(spec: ProblemSpec, res: Residual) -> jnp.ndarray:
    """Mean 1-norm over all S entries (reference ``residual_norm``,
    ``global_quantities.jl:88-96``)."""
    total = (jnp.sum(jnp.abs(res.rx)) + jnp.sum(jnp.abs(res.ru))
             + jnp.sum(jnp.abs(res.rd)))
    return total / spec.S


def optimality_violation(res: Residual) -> jnp.ndarray:
    """Max-abs over all stationarity rows (reference
    ``optimality_violation``, ``src/struct/violations.jl:152-168``)."""
    return jnp.maximum(jnp.max(jnp.abs(res.rx)), jnp.max(jnp.abs(res.ru)))


def dynamics_violation(res: Residual) -> jnp.ndarray:
    """Max-abs dynamics defect (reference ``dynamics_violation``,
    ``src/struct/violations.jl:16-24``)."""
    return jnp.max(jnp.abs(res.rd))


# --------------------------------------------------------------------------
# Jacobian ingredients and block-tridiagonal assembly
# --------------------------------------------------------------------------

@pytree_dataclass
class JacBlocks:
    """Dense per-knot ingredients of the KKT Jacobian."""
    Qblk: jnp.ndarray   # [T, p, n, n] stationarity-x Hessian blocks
    Ublk: jnp.ndarray   # [T, m, m]    stationarity-u Hessian blocks
    A: jnp.ndarray      # [T, n, n]    RK2 d/dx at every interval
    B: jnp.ndarray      # [T, n, m]    RK2 d/du


def jacobian_blocks(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
                    traj: PrimalDual, reg_x=0.0, reg_u=0.0) -> JacBlocks:
    """Assemble Jacobian ingredients (reference ``residual_jacobian!`` +
    ``regularize_residual_jacobian!``, ``global_quantities.jl:109-193``)."""
    T, p, n, m = spec.T, spec.p, spec.n, spec.m
    dtype = traj.x.dtype
    Qx, Ru = cost_hessian(spec, obj, traj)                  # [p,N,n,n],[p,T,m,m]

    Qblk = jnp.transpose(Qx[:, 1:], (1, 0, 2, 3))           # [T, p, n, n]
    # Control Hessian: owner-sliced sub-blocks [pu_i, pu_i] of player i's Ru,
    # embedded by static owner masks (no strided scatters).
    owner = owner_map_u(spec)
    same = jnp.asarray(_same_owner_mask(spec), dtype)
    Ublk = jnp.zeros((T, m, m), dtype)
    for i in range(p):
        mask_i = jnp.asarray(np.outer(owner == i, owner == i)
                             .astype(np.float64), dtype)
        Ublk = Ublk + Ru[i] * mask_i

    # Constraint AL Hessians.
    hess_per = [None] * p
    for blk in gc.state_blocks:
        _, hess = gcm.al_expansion(blk, traj)               # [T, n, n]
        i = blk.owner
        hess_per[i] = hess if hess_per[i] is None else hess_per[i] + hess
    hsum = _owner_select(spec, hess_per, T, (n, n), dtype)
    if hsum is not None:
        Qblk = Qblk + hsum
    for blk in gc.control_blocks:
        _, hess = gcm.al_expansion(blk, traj)               # [T, m, m]
        Ublk = Ublk + hess * same

    # Tikhonov regularization on primal diagonals.
    Qblk = Qblk + reg_x * jnp.eye(n, dtype=dtype)
    Ublk = Ublk + reg_u * jnp.eye(m, dtype=dtype)

    A, B = step_jacobians_traj(model, traj.x[:-1], traj.u, spec.dt)
    return JacBlocks(Qblk=Qblk, Ublk=Ublk, A=A, B=B)


def build_tridiagonal(spec: ProblemSpec, jb: JacBlocks):
    """Pack ingredients into block-tridiagonal (D, U, L) of W×W blocks.

    D [T, W, W]; U [T-1, W, W] couples e_t to v_{t+1}; L [T-1, W, W] couples
    e_{t+1} to v_t (stored shifted: L[t] multiplies v_t in equation e_{t+1}).
    """
    T, p, n, m, W = spec.T, spec.p, spec.n, spec.m, spec.W
    dtype = jb.A.dtype
    eye_n = jnp.eye(n, dtype=dtype)

    D = jnp.zeros((T, W, W), dtype)
    # statx rows & Q blocks + (-I) at own lam cols
    for i in range(p):
        r0 = i * n
        D = D.at[:, r0:r0 + n, 0:n].set(jb.Qblk[:, i])
        c0 = n + m + i * n
        D = D.at[:, r0:r0 + n, c0:c0 + n].add(-eye_n)
    # statu rows
    ru0 = p * n
    D = D.at[:, ru0:ru0 + m, n:n + m].set(jb.Ublk)
    # rows pu_i of statu, cols lam_i: B_t[:, pu_i]^T — one contiguous set of
    # the block-diagonal embed (static permutation, no strided scatter).
    # Ragged-safe over per-player mi: rows grouped player-major, each row's
    # owner selecting its lam block via a static [m, p] mask.
    perm = np.concatenate([np.asarray(spec.pu[i]) for i in range(p)])
    inv = np.argsort(perm)
    owner_rows = np.concatenate(
        [np.full(len(spec.pu[i]), i) for i in range(p)])
    BpT = jnp.transpose(jb.B[:, :, perm], (0, 2, 1))        # [T, m, n]
    sel = jnp.asarray(np.eye(p)[owner_rows], dtype)         # [m, p]
    bd = (BpT[:, :, None, :]
          * sel[None, :, :, None]).reshape(T, m, p * n)[:, inv]
    D = D.at[:, ru0:ru0 + m, n + m:].set(bd)
    # dyn rows
    rd0 = p * n + m
    D = D.at[:, rd0:rd0 + n, 0:n].add(-eye_n)
    D = D.at[:, rd0:rd0 + n, n:n + m].set(jb.B)

    U = jnp.zeros((T - 1, W, W), dtype)
    At1 = jnp.transpose(jb.A[1:], (0, 2, 1))                # [T-1, n, n]
    for i in range(p):
        r0 = i * n
        c0 = n + m + i * n
        U = U.at[:, r0:r0 + n, c0:c0 + n].set(At1)

    L = jnp.zeros((T - 1, W, W), dtype)
    L = L.at[:, rd0:rd0 + n, 0:n].set(jb.A[1:])
    return D, U, L


def residual_knot_blocks(spec: ProblemSpec, res: Residual) -> jnp.ndarray:
    """Residual in per-knot equation order [T, W] matching (D, U, L) rows."""
    T, p, n = spec.T, spec.p, spec.n
    return jnp.concatenate(
        [res.rx.reshape(T, p * n), res.ru, res.rd], axis=1)


def assemble(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
             traj: PrimalDual, reg: jnp.ndarray | float = 0.0):
    """Fused residual + Jacobian-ingredient assembly for the Newton loop.

    Computes everything :func:`residual` and :func:`jacobian_blocks` produce
    in ONE pass: the RK2 (A, B) Jacobians and each constraint block's AL
    expansion (values, jacobian, grad, hess) are evaluated once and shared —
    the reference evaluates them twice per inner iteration
    (``global_quantities.jl:9-66`` then ``:109-193``).
    Regularization ``reg`` is applied to the Jacobian diagonals only (the
    residual pull term vanishes at the reference point, which is how the
    solver calls it).
    Returns (Residual, JacBlocks, sta_vio_max, con_vio_max) — the
    constraint-violation maxima fall out of the same block evaluations.
    Implemented as ``point_data`` + ``assemble_from_point``, the same code
    path the solver's carried-point iterations use.
    """
    pd = point_data(model, spec, obj, gc, traj)
    return assemble_from_point(spec, obj, gc, traj, pd, reg=reg)


# --------------------------------------------------------------------------
# Point data: carry the line search's residual work into the next iteration
# --------------------------------------------------------------------------

@pytree_dataclass
class PointLite:
    """The gc-independent point quantities a LINE-SEARCH TRIAL needs to
    CARRY — everything in :class:`PointData` except the dense step Jacobians
    (A, B) and the per-block constraint Jacobians:

      rx0/ru0: cost gradients + dynamics-dual terms of the stationarity rows
               (the residual before constraint AL gradients)
      rd:      RK2 dynamics defects
      state_c/control_c: per-constraint-block values

    The dual terms A^T lam / B^T lam are computed as p VJP pulls through the
    RK2 step — NOT by materializing the [T, n, n+m] ``jacfwd`` Jacobian and
    contracting.  Constraint Jacobians are evaluated inside the trial for its
    own residual but NOT carried: both the dense and the constraint Jacobians
    are only needed for the KKT assembly of the ACCEPTED point, so they are
    re-evaluated there (:func:`point_from_lite`) instead of being carried
    as [B, trials, T, C, n] tensors per trial.
    """
    rx0: jnp.ndarray                 # [T, p, n]
    ru0: jnp.ndarray                 # [T, m]
    rd: jnp.ndarray                  # [T, n]
    state_c: tuple                   # per state block: [K, C]
    control_c: tuple


@pytree_dataclass
class PointData:
    """:class:`PointLite` plus the RK2 step Jacobians (A, B) — everything
    the Newton iteration needs that does NOT depend on the AL state
    (lam, mu) or the regularization.

    The accepted line-search trial evaluates the full residual at exactly the
    point the next iteration re-assembles at (the reference recomputes it,
    ``solver_methods.jl:73`` after ``:94``).  Carrying PointData lets the next
    iteration rebuild residual AND Jacobian with cheap contractions — and it
    stays exact across AL dual/penalty updates, because (c, J) are
    gc-independent and the AL terms are rebuilt from the *current* lam/mu.
    """
    rx0: jnp.ndarray                 # [T, p, n]
    ru0: jnp.ndarray                 # [T, m]
    rd: jnp.ndarray                  # [T, n]
    A: jnp.ndarray                   # [T, n, n]
    B: jnp.ndarray                   # [T, n, m]
    state_c: tuple                   # per state block: [K, C]
    state_J: tuple                   # per state block: [K, C, n]
    control_c: tuple
    control_J: tuple


def point_from_lite(model, spec: ProblemSpec, gc: gcm.GameConstraints,
                    lite: PointLite, traj: PrimalDual) -> PointData:
    """Complete a :class:`PointLite` into a :class:`PointData` by evaluating
    the dense RK2 step Jacobians and the per-block constraint Jacobians at
    ``traj`` (the accepted trial point — the values are identical to what
    the trial computed internally, at a fraction of the carried bytes)."""
    A, B = step_jacobians_traj(model, traj.x[:-1], traj.u, spec.dt)
    state_J = tuple(_blk_jacobian_for_carry(blk, traj)
                    for blk in gc.state_blocks)
    control_J = tuple(_blk_jacobian_for_carry(blk, traj)
                      for blk in gc.control_blocks)
    return PointData(rx0=lite.rx0, ru0=lite.ru0, rd=lite.rd, A=A, B=B,
                     state_c=lite.state_c, state_J=state_J,
                     control_c=lite.control_c, control_J=control_J)


def point_lite_res(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
                   traj: PrimalDual):
    """Evaluate a trial point: returns ``(PointLite, Residual)`` in one pass
    (same op order as :func:`residual` so rebuilds are bitwise-identical).
    Constraint Jacobians are used for the residual's AL gradients but not
    returned."""
    m = spec.m
    dt = spec.dt
    qx, ru_cost = cost_gradient(spec, obj, traj)

    rx = jnp.transpose(qx[:, 1:], (1, 0, 2))
    owner = owner_map_u(spec)
    ru = ru_cost[owner, :, np.arange(m)].T
    # Dynamics-dual terms A_k^T lam_k / B_k^T lam_k as one VJP per knot with
    # the p player cotangents pulled through a shared forward pass — p pulls
    # instead of n+m jacfwd tangents (the [T, n, n+m] Jacobian is deferred to
    # the accepted point, :func:`point_from_lite`).
    def _pull(xk, uk, lams_k):
        _, pull = jax.vjp(lambda x, u: rk2_step(model, x, u, dt), xk, uk)
        return jax.vmap(pull)(lams_k)            # ([p, n], [p, m])
    gx, gu = jax.vmap(_pull, in_axes=(0, 0, 1))(
        traj.x[:-1], traj.u, traj.lam)           # [T, p, n], [T, p, m]
    # Shifted add as concat-pad, not .at[:-1].add (a dynamic-update-slice).
    rx = rx + jnp.concatenate([gx[1:], jnp.zeros_like(gx[:1])], axis=0)
    rx = rx - jnp.transpose(traj.lam, (1, 0, 2))
    ru = ru + gu[:, owner, np.arange(m)]
    # (One-hot owner-pick forms of the two gathers above are needed for
    # the fused trial kernel but cost throughput on the XLA hot path —
    # see collision_jacobian's note in constraints/kernels.py.)

    rd = dynamics_residual(model, spec, traj)

    # Constraint values + AL gradients (Jacobians local, not carried).
    state_c, control_c = [], []
    rx_res, ru_res = rx, ru
    grad_per = [None] * spec.p
    for blk in gc.state_blocks:
        c = gcm.block_values(blk, traj)
        J = _blk_jacobian_for_carry(blk, traj)
        state_c.append(c)
        g = _al_grad(blk, J, blk.lam + _irho(blk, c) * c)
        grad_per[blk.owner] = (g if grad_per[blk.owner] is None
                               else grad_per[blk.owner] + g)
    gsum = _owner_select(spec, grad_per, rd.shape[0], (spec.n,), rx.dtype)
    if gsum is not None:
        rx_res = rx_res + gsum
    for blk in gc.control_blocks:
        c = gcm.block_values(blk, traj)
        J = _blk_jacobian_for_carry(blk, traj)
        control_c.append(c)
        ru_res = ru_res + _al_grad(blk, J, blk.lam + _irho(blk, c) * c)

    lite = PointLite(rx0=rx, ru0=ru, rd=rd,
                     state_c=tuple(state_c), control_c=tuple(control_c))
    return lite, Residual(rx=rx_res, ru=ru_res, rd=rd)


def point_data(model, spec: ProblemSpec, obj, gc: gcm.GameConstraints,
               traj: PrimalDual) -> PointData:
    """Evaluate all gc-independent point quantities at ``traj``
    (:func:`point_lite_res` + the dense/constraint Jacobians)."""
    lite, _ = point_lite_res(model, spec, obj, gc, traj)
    return point_from_lite(model, spec, gc, lite, traj)


def _irho(blk: gcm.ConBlock, c: jnp.ndarray) -> jnp.ndarray:
    if blk.sense == "eq":
        return blk.mu
    return jnp.where((c >= 0.0) | (blk.lam > 0.0), blk.mu, 0.0)


def _al_grad(blk, J, w):
    """J'w per knot, shaped to the block's structure:

    * bounds: J is the constant ``[+I; -I] * mask`` — closed form, no J
      needed (``w_up * m - w_lo * m``);
    * single-row constraints (collision/circle): elementwise product;
    * general: einsum at ``HIGHEST`` precision (float32 must not drop to
      TF32 on a GPU).
    """
    from ..constraints import kernels as _k
    if isinstance(blk.params, _k.BoundParams):
        dim = blk.params.z_max.shape[0]
        m = np.asarray(blk.params.mask, np.float64)
        mu_, ml_ = jnp.asarray(m[:dim], w.dtype), jnp.asarray(m[dim:], w.dtype)
        return w[:, :dim] * mu_ - w[:, dim:] * ml_
    if J.shape[1] == 1:
        # w is [K, 1]: broadcast directly.
        return J[:, 0, :] * w
    return jnp.einsum('kcd,kc->kd', J, w, precision=_HI)


def _al_hess(blk, J, irho):
    """J' diag(irho) J per knot (same structure dispatch as _al_grad)."""
    from ..constraints import kernels as _k
    if isinstance(blk.params, _k.BoundParams):
        dim = blk.params.z_max.shape[0]
        m = np.asarray(blk.params.mask, np.float64)
        mu_ = jnp.asarray(m[:dim], irho.dtype)
        ml_ = jnp.asarray(m[dim:], irho.dtype)
        d = irho[:, :dim] * mu_ + irho[:, dim:] * ml_       # [K, dim]
        return d[:, :, None] * jnp.eye(dim, dtype=irho.dtype)
    if J.shape[1] == 1:
        return (J[:, 0, :, None] * J[:, 0, None, :]) * irho[:, 0, None, None]
    return jnp.einsum('kcd,kc,kce->kde', J, irho, J, precision=_HI)


def _blk_jacobian_for_carry(blk, traj):
    """Constraint Jacobian to store in PointData — empty for bound blocks
    (their J is a static constant the closed forms never read)."""
    from ..constraints import kernels as _k
    if isinstance(blk.params, _k.BoundParams):
        return jnp.zeros((0,), traj.x.dtype)
    return gcm.block_jacobian(blk, traj)


def _state_grad_sum(spec: ProblemSpec, gc, pd, dtype):
    """Per-player sums of state-constraint AL gradients, stacked [T, p, n]
    (None if there are no state blocks)."""
    per = [None] * spec.p
    for blk, c, J in zip(gc.state_blocks, pd.state_c, pd.state_J):
        g = _al_grad(blk, J, blk.lam + _irho(blk, c) * c)
        per[blk.owner] = g if per[blk.owner] is None else per[blk.owner] + g
    return _owner_select(spec, per, pd.rd.shape[0], (spec.n,), dtype)


def residual_from_point(spec: ProblemSpec, gc: gcm.GameConstraints,
                        pd: PointData) -> Residual:
    """Rebuild the full residual from PointData under the CURRENT AL state
    (same math as :func:`residual`; per-player constraint gradients are
    summed then added in one op instead of per-block scatters)."""
    rx, ru = pd.rx0, pd.ru0
    gsum = _state_grad_sum(spec, gc, pd, rx.dtype)
    if gsum is not None:
        rx = rx + gsum
    for blk, c, J in zip(gc.control_blocks, pd.control_c, pd.control_J):
        ru = ru + _al_grad(blk, J, blk.lam + _irho(blk, c) * c)
    return Residual(rx=rx, ru=ru, rd=pd.rd)


def assemble_from_point(spec: ProblemSpec, obj, gc: gcm.GameConstraints,
                        traj: PrimalDual, pd: PointData,
                        reg: jnp.ndarray | float = 0.0):
    """Rebuild what :func:`assemble` produces — (Residual, JacBlocks,
    sta_vio_max, con_vio_max) — from carried PointData: only the cost
    Hessians and the AL contractions with the current (lam, mu) are
    recomputed.  All owner embeddings are mask-multiplies / stacked adds —
    no strided scatters (see ``_same_owner_mask``)."""
    T, p, n, m = spec.T, spec.p, spec.n, spec.m
    dtype = traj.x.dtype
    Qx, Ru = cost_hessian(spec, obj, traj)

    rx, ru = pd.rx0, pd.ru0
    Qblk = jnp.transpose(Qx[:, 1:], (1, 0, 2, 3))
    same = jnp.asarray(_same_owner_mask(spec), dtype)        # [m, m] 0/1
    owner = owner_map_u(spec)
    Ublk = jnp.zeros((T, m, m), dtype)
    for i in range(p):
        mask_i = jnp.asarray(np.outer(owner == i, owner == i)
                             .astype(np.float64), dtype)
        Ublk = Ublk + Ru[i] * mask_i

    sta_v = jnp.zeros((), dtype)
    con_v = jnp.zeros((), dtype)
    grad_per = [None] * p
    hess_per = [None] * p
    for blk, c, J in zip(gc.state_blocks, pd.state_c, pd.state_J):
        irho = _irho(blk, c)
        grad = _al_grad(blk, J, blk.lam + irho * c)
        hess = _al_hess(blk, J, irho)
        i = blk.owner
        grad_per[i] = grad if grad_per[i] is None else grad_per[i] + grad
        hess_per[i] = hess if hess_per[i] is None else hess_per[i] + hess
        sta_v = jnp.maximum(sta_v, gcm.block_violation_max(blk, c))
    gsum = _owner_select(spec, grad_per, T, (n,), dtype)
    if gsum is not None:
        rx = rx + gsum
    hsum = _owner_select(spec, hess_per, T, (n, n), dtype)
    if hsum is not None:
        Qblk = Qblk + hsum
    for blk, c, J in zip(gc.control_blocks, pd.control_c, pd.control_J):
        irho = _irho(blk, c)
        grad = _al_grad(blk, J, blk.lam + irho * c)
        hess = _al_hess(blk, J, irho)
        ru = ru + grad
        # Only same-owner entries couple (per-player pu slices in the
        # reference, constraint_derivatives.jl:60-69): one mask multiply.
        Ublk = Ublk + hess * same
        con_v = jnp.maximum(con_v, gcm.block_violation_max(blk, c))

    eye_n = jnp.eye(n, dtype=dtype)
    eye_m = jnp.eye(m, dtype=dtype)
    Qblk = Qblk + reg * eye_n
    Ublk = Ublk + reg * eye_m
    return (Residual(rx=rx, ru=ru, rd=pd.rd),
            JacBlocks(Qblk=Qblk, Ublk=Ublk, A=pd.A, B=pd.B), sta_v, con_v)


def point_violations(gc: gcm.GameConstraints, pd: PointData):
    """(sta_vio_max, con_vio_max) from carried constraint values."""
    dtype = pd.rd.dtype
    sta_v = jnp.zeros((), dtype)
    con_v = jnp.zeros((), dtype)
    for blk, c in zip(gc.state_blocks, pd.state_c):
        sta_v = jnp.maximum(sta_v, gcm.block_violation_max(blk, c))
    for blk, c in zip(gc.control_blocks, pd.control_c):
        con_v = jnp.maximum(con_v, gcm.block_violation_max(blk, c))
    return sta_v, con_v


# --------------------------------------------------------------------------
# Reference-order flattening (test oracles, IBR masks, active-set system)
# --------------------------------------------------------------------------

def flatten_residual(spec: ProblemSpec, res: Residual) -> jnp.ndarray:
    """Flatten to the reference's vertical row order
    (``src/core/newton_core.jl:40-63``): player-major [x-rows; u-rows] per
    knot, then dynamics rows."""
    parts = []
    for i in range(spec.p):
        pu = np.asarray(spec.pu[i])
        # per knot: n x-rows then mi u-rows
        xi = res.rx[:, i]                       # [T, n]
        ui = res.ru[:, pu]                      # [T, mi]
        parts.append(jnp.concatenate([xi, ui], axis=1).reshape(-1))
    parts.append(res.rd.reshape(-1))
    return jnp.concatenate(parts)


def flatten_jacobian(spec: ProblemSpec, jb: JacBlocks) -> jnp.ndarray:
    """Dense S×S Jacobian in reference (row, column) order — the oracle and
    dense-fallback path; columns follow ``core/spec.py`` horizontal order."""
    S, T, p, n, m = spec.S, spec.T, spec.p, spec.n, spec.m
    dtype = jb.A.dtype
    J = jnp.zeros((S, S), dtype)
    eye_n = jnp.eye(n, dtype=dtype)
    for t in range(T):
        cx, cu = spec.col_x(t), spec.col_u(t)
        for i in range(p):
            pu = np.asarray(spec.pu[i])
            cl = spec.col_lam(i, t)
            rx = spec.row_stat_x(i, t)
            ru = spec.row_stat_u(i, t)
            J = J.at[rx:rx + n, cx:cx + n].add(jb.Qblk[t, i])
            J = J.at[rx:rx + n, cl:cl + n].add(-eye_n)
            if t + 1 < T:
                cl1 = spec.col_lam(i, t + 1)
                J = J.at[rx:rx + n, cl1:cl1 + n].add(jb.A[t + 1].T)
            J = J.at[ru:ru + len(pu), cl:cl + n].add(jb.B[t][:, pu].T)
            J = J.at[ru:ru + len(pu), cu + pu].add(
                jb.Ublk[t][pu[:, None], pu[None, :]])
        rd = spec.row_dyn(t)
        J = J.at[rd:rd + n, cx:cx + n].add(-eye_n)
        J = J.at[rd:rd + n, cu:cu + m].add(jb.B[t])
        if t >= 1:
            cxm = spec.col_x(t - 1)
            J = J.at[rd:rd + n, cxm:cxm + n].add(jb.A[t])
    return J
