"""Per-player game objectives: embedded LQR costs + smooth collision repulsion.

JAX equivalent of the reference ``GameObjective`` / ``CollisionCost``
(``src/objective/objective.jl:6-192``).  Per-player diagonal LQR costs on the
player's own state/control slice are embedded into full-dimension diagonal
vectors (``expand_vector``, ``src/objective/objective.jl:37-41``); collision
costs are a batch of ordered player pairs with parameters ``(mu, r)``.

Cost-expansion semantics match the reference oracle
(``test/objective/objective.jl:50-63``): stage gradients/Hessians are scaled
by ``dt``, the terminal knot is not, and the terminal control cost is zero.

Gradients/Hessians are returned as stacked arrays over (player, knot) —
pure functions of the trajectory, fused by XLA, vmappable over scenarios.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..core.spec import ProblemSpec
from ..core.traj import PrimalDual
from ..utils import pytree_dataclass


def expand_vector(v, inds, size):
    """Embed per-player vector ``v`` at ``inds`` of a zero vector of ``size``.

    Reference ``expand_vector`` (``src/objective/objective.jl:37-41``).
    """
    v = jnp.asarray(v)
    out = jnp.zeros((size,), v.dtype)
    return out.at[jnp.asarray(inds)].set(v)


@pytree_dataclass(meta_fields=("pair_i", "pair_j", "pxi", "pxj"))
class GameObjective:
    """Stacked per-player quadratic costs + collision-cost pair batch.

    Traced fields:
      Qd  [p, n]  diagonal of the (embedded) state cost, per player
      Rd  [p, m]  diagonal of the (embedded) control cost
      xf  [p, n]  embedded state target
      uf  [p, m]  embedded control target
      mu  [n_pairs]  collision cost weights (player i's mu)
      r   [n_pairs]  collision radii
    Static fields:
      pair_i/pair_j: owner/other player index per pair
      pxi/pxj: position-index tuples per pair
    """
    Qd: jnp.ndarray
    Rd: jnp.ndarray
    xf: jnp.ndarray
    uf: jnp.ndarray
    mu: jnp.ndarray
    r: jnp.ndarray
    pair_i: Tuple[int, ...]
    pair_j: Tuple[int, ...]
    pxi: Tuple[Tuple[int, ...], ...]
    pxj: Tuple[Tuple[int, ...], ...]


def game_objective(spec: ProblemSpec, Q, R, xf, uf, dtype=None) -> GameObjective:
    """Build a GameObjective from per-player cost data.

    Mirrors ``GameObjective(Q, R, xf, uf, N, model)``
    (``src/objective/objective.jl:11-34``): ``Q[i]`` is a length-ni diagonal,
    ``R[i]`` a length-mi diagonal, ``xf[i]``/``uf[i]`` the player's targets on
    his own slices; each is embedded at ``pz[i]``/``pu[i]``.
    """
    p, n, m = spec.p, spec.n, spec.m
    dtype = dtype or jnp.asarray(Q[0]).dtype
    Qd = jnp.stack([expand_vector(jnp.asarray(Q[i], dtype), spec.pz[i], n)
                    for i in range(p)])
    Rd = jnp.stack([expand_vector(jnp.asarray(R[i], dtype), spec.pu[i], m)
                    for i in range(p)])
    xfe = jnp.stack([expand_vector(jnp.asarray(xf[i], dtype), spec.pz[i], n)
                     for i in range(p)])
    ufe = jnp.stack([expand_vector(jnp.asarray(uf[i], dtype), spec.pu[i], m)
                     for i in range(p)])
    return GameObjective(
        Qd=Qd, Rd=Rd, xf=xfe, uf=ufe,
        mu=jnp.zeros((0,), dtype), r=jnp.zeros((0,), dtype),
        pair_i=(), pair_j=(), pxi=(), pxj=(),
    )


def add_collision_cost(spec: ProblemSpec, obj: GameObjective, radius, mu) -> GameObjective:
    """Append one CollisionCost per ordered player pair (i, j != i).

    Mirrors ``add_collision_cost!`` (``src/objective/objective.jl:84-103``):
    pair (i, j) uses player i's weight ``mu[i]`` and radius ``radius[i]``.
    """
    p = spec.p
    radius = jnp.asarray(radius, obj.Qd.dtype)
    mu = jnp.asarray(mu, obj.Qd.dtype)
    assert radius.shape == (p,) and mu.shape == (p,)
    pair_i, pair_j, pxi, pxj, mus, rs = [], [], [], [], [], []
    for i in range(p):
        for j in range(p):
            if j == i:
                continue
            pair_i.append(i)
            pair_j.append(j)
            pxi.append(spec.px[i])
            pxj.append(spec.px[j])
            mus.append(mu[i])
            rs.append(radius[i])
    return GameObjective(
        Qd=obj.Qd, Rd=obj.Rd, xf=obj.xf, uf=obj.uf,
        mu=jnp.concatenate([obj.mu, jnp.stack(mus)]),
        r=jnp.concatenate([obj.r, jnp.stack(rs)]),
        pair_i=obj.pair_i + tuple(pair_i),
        pair_j=obj.pair_j + tuple(pair_j),
        pxi=obj.pxi + tuple(pxi),
        pxj=obj.pxj + tuple(pxj),
    )


# --------------------------------------------------------------------------
# Expansion
# --------------------------------------------------------------------------

def _dt_scale(spec: ProblemSpec, dtype):
    """Per-knot expansion scale: dt at stage knots, 1 at the terminal knot
    (``test/objective/objective.jl:50-63``)."""
    return jnp.concatenate([
        jnp.full((spec.N - 1,), spec.dt, dtype), jnp.ones((1,), dtype)])


def _pair_grad_hess(obj: GameObjective, x_knots: jnp.ndarray, n: int,
                    want_hess: bool):
    """Collision-pair gradients (and Hessians) at every knot.

    Implements the reference's hand-derived epsilon-regularized expressions
    (``src/objective/objective.jl:139-186``): active iff ``r - |Δ| > 0``;
      g = mu * (r (eps + Δ)/(eps_n + |Δ|) - Δ);  q[pxi] = -g, q[pxj] = +g
      H = mu * (I - r I/|Δ| + r Δ Δᵀ/|Δ|³); blocks [pxi,pxi]=[pxj,pxj]=+H,
      [pxi,pxj]=[pxj,pxi]=-H.
    Returns (grad [n_pairs, N, n], hess [n_pairs, N, n, n] or None).
    """
    N = x_knots.shape[0]
    dtype = x_knots.dtype
    n_pairs = len(obj.pair_i)
    grads = jnp.zeros((n_pairs, N, n), dtype)
    hesss = jnp.zeros((n_pairs, N, n, n), dtype) if want_hess else None
    eps = 1e-10
    eps_n = eps * np.sqrt(n)
    for idx in range(n_pairs):
        pxi = np.asarray(obj.pxi[idx])
        pxj = np.asarray(obj.pxj[idx])
        d = len(pxi)
        mu, r = obj.mu[idx], obj.r[idx]
        delta = x_knots[:, pxi] - x_knots[:, pxj]            # [N, d]
        dn = jnp.linalg.norm(delta, axis=-1)                 # [N]
        active = (r - dn > 0.0).astype(dtype)
        g = mu * (r * (eps + delta) / (eps_n + dn)[:, None] - delta)
        g = (g * active[:, None]).T                          # [d, N]
        grads = grads.at[idx, :, pxi].add(-g)
        grads = grads.at[idx, :, pxj].add(g)
        if want_hess:
            eye = jnp.eye(d, dtype=dtype)
            dn_safe = jnp.where(dn > 0, dn, 1.0)
            H = mu * (eye - r * eye / dn_safe[:, None, None]
                      + r * delta[:, :, None] * delta[:, None, :]
                      / (dn_safe ** 3)[:, None, None])
            H = H * active[:, None, None]                    # [N, d, d]
            for a in range(d):
                hesss = hesss.at[idx, :, pxi[a], pxi].add(H[:, a, :].T)
                hesss = hesss.at[idx, :, pxj[a], pxj].add(H[:, a, :].T)
                hesss = hesss.at[idx, :, pxi[a], pxj].add(-H[:, a, :].T)
                hesss = hesss.at[idx, :, pxj[a], pxi].add(-H[:, a, :].T)
    return grads, hesss


def cost_gradient(spec: ProblemSpec, obj: GameObjective, traj: PrimalDual):
    """Per-player cost gradients over all knots.

    Returns ``(qx [p, N, n], ru [p, T, m])`` — the reference's
    ``E[i][j].cost[k].q/r`` summed over objectives j with dt/terminal scaling
    (``src/objective/objective.jl:43-62``).
    """
    scale = _dt_scale(spec, traj.x.dtype)                    # [N]
    qx = obj.Qd[:, None, :] * (traj.x[None] - obj.xf[:, None, :])
    qx = qx * scale[None, :, None]
    ru = obj.Rd[:, None, :] * (traj.u[None] - obj.uf[:, None, :]) * spec.dt
    if obj.pair_i:
        cg, _ = _pair_grad_hess(obj, traj.x, spec.n, want_hess=False)
        cg = cg * scale[None, :, None]
        for idx, i in enumerate(obj.pair_i):
            qx = qx.at[i].add(cg[idx])
    return qx, ru


def cost_hessian(spec: ProblemSpec, obj: GameObjective, traj: PrimalDual):
    """Per-player cost Hessians over all knots.

    Returns ``(Qx [p, N, n, n], Ru [p, T, m, m])`` with dt/terminal scaling
    (``test/objective/objective.jl:57-63``).
    """
    p, n, m, N, T = spec.p, spec.n, spec.m, spec.N, spec.T
    dtype = traj.x.dtype
    scale = _dt_scale(spec, dtype)
    # Diagonal embeddings as eye-broadcast multiplies, not scatters.
    Qx = ((obj.Qd[:, None, :] * scale[None, :, None])[..., None]
          * jnp.eye(n, dtype=dtype))                         # [p, N, n, n]
    Ru = jnp.broadcast_to(
        ((obj.Rd * spec.dt)[:, :, None] * jnp.eye(m, dtype=dtype))[:, None],
        (p, T, m, m))                                        # [p, T, m, m]
    if obj.pair_i:
        _, ch = _pair_grad_hess(obj, traj.x, n, want_hess=True)
        ch = ch * scale[None, :, None, None]
        for idx, i in enumerate(obj.pair_i):
            Qx = Qx.at[i].add(ch[idx])
    return Qx, Ru


def collision_stage_cost(obj: GameObjective, idx: int, x: jnp.ndarray):
    """Scalar collision cost of pair ``idx`` at state ``x`` —
    ``0.5 mu max(0, r - |xi - xj|)^2`` (``src/objective/objective.jl:127-131``)."""
    pxi = np.asarray(obj.pxi[idx])
    pxj = np.asarray(obj.pxj[idx])
    dn = jnp.linalg.norm(x[pxi] - x[pxj])
    return 0.5 * obj.mu[idx] * jnp.maximum(0.0, obj.r[idx] - dn) ** 2


def total_cost(spec: ProblemSpec, obj: GameObjective, traj: PrimalDual, i: int):
    """Player i's total objective (LQR stage*dt + terminal + collision costs).

    Matches the reference cost semantics: stage LQR cost
    ``0.5 (x-xf)'Q(x-xf) dt + 0.5 (u-uf)'R(u-uf) dt`` for k<N, terminal
    ``0.5 (x-xf)'Q(x-xf)`` (zero R), collision costs likewise dt-scaled.
    """
    dx = traj.x - obj.xf[i][None]
    du = traj.u - obj.uf[i][None]
    stage_x = 0.5 * jnp.sum(dx * obj.Qd[i][None] * dx, axis=-1)   # [N]
    stage_u = 0.5 * jnp.sum(du * obj.Rd[i][None] * du, axis=-1)   # [T]
    scale = _dt_scale(spec, traj.x.dtype)
    J = jnp.sum(stage_x * scale) + jnp.sum(stage_u) * spec.dt
    for idx in range(len(obj.pair_i)):
        if obj.pair_i[idx] != i:
            continue
        pxi = np.asarray(obj.pxi[idx])
        pxj = np.asarray(obj.pxj[idx])
        dn = jnp.linalg.norm(traj.x[:, pxi] - traj.x[:, pxj], axis=-1)
        c = 0.5 * obj.mu[idx] * jnp.maximum(0.0, obj.r[idx] - dn) ** 2
        J = J + jnp.sum(c * scale)
    return J
