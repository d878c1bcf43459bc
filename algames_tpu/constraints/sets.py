"""Game constraint container, AL state, and lifecycle updates.

JAX equivalent of the reference ``GameConstraintValues`` plus the
Altro ``ALConVal`` subset it relies on
(``src/constraints/game_constraints.jl:5-53``,
``src/constraints/constraints_methods.jl:287-446``).

Instead of lists of conval objects, constraints are a static tuple of
``ConBlock`` pytrees, each pairing a family-parameter pytree (see
``kernels.py``) with stacked AL state arrays ``lam``/``mu`` of shape [K, C]
(K = applied knots, C = constraint rows).  The builder functions mirror the
reference ``add_*!`` API; state constraints apply at knots 2..N and control
constraints at knots 1..N-1 exactly as in the reference builders.

AL math (verified against the reference oracle
``test/constraints/constraint_derivatives.jl:29-36``):

    Irho  = ((c >= 0) | (lam > 0)) * mu          (Inequality)
    grad  = J' lam + J' (Irho * c)
    hess  = J' diag(Irho) J
    dual update: lam <- clamp(lam + alpha*mu*c, 0, lam_max)
    penalty update: mu <- phi * mu
    active set: (c >= -tol) | (lam > 0)

Everything is a pure function: update ops return new ``GameConstraints``
pytrees, so the whole AL outer loop stays on-device and vmappable.
"""
from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.spec import ProblemSpec
from ..utils import pytree_dataclass
from . import kernels
from .kernels import (BoundParams, CircleParams, CollisionParams,
                      CylinderParams, Wall2DParams, Wall3DParams, make_bound)


@pytree_dataclass(meta_fields=("owner", "is_state", "sense"))
class ConBlock:
    """One constraint instance: family params + AL state.

    ``owner``: player index whose stationarity rows receive the AL gradient
    (state constraints); -1 for shared control constraints (which couple to
    every player's control rows through his own ``pu`` slice, reference
    ``src/constraints/constraint_derivatives.jl:60-69``).

    ``sense``: constraint cone — "ineq" (c <= 0; all reference builders),
    "eq" (c == 0), or "soc" (second-order cone) — matching the reference's
    Equality/Inequality/SecondOrderCone dual updates
    (``constraints_methods.jl:427-445``).
    """
    params: object                    # family params pytree
    lam: jnp.ndarray                  # [K, C] Lagrange multiplier estimates
    mu: jnp.ndarray                   # [K, C] penalties
    active: jnp.ndarray               # [K, C] active-set flags (bool)
    owner: int
    is_state: bool
    sense: str = "ineq"


@pytree_dataclass(meta_fields=())
class GameConstraints:
    """All constraint blocks + dual-ascent step sizes.

    Mirrors ``GameConstraintValues`` (``game_constraints.jl:5-31``): per-player
    state constraint lists and one shared control constraint list, plus
    ``alpha_dual``/``alphax_dual`` and the AL parameters pushed in by
    ``set_constraint_params!`` (``game_constraints.jl:33-53``).
    """
    state_blocks: Tuple[ConBlock, ...]
    control_blocks: Tuple[ConBlock, ...]
    alpha_dual: jnp.ndarray           # scalar: control dual step size
    alphax_dual: jnp.ndarray          # [p]: per-player state dual step size
    phi: jnp.ndarray                  # penalty increase factor (rho_increase)
    mu0: jnp.ndarray                  # initial penalty (rho_0)
    mu_max: jnp.ndarray               # penalty cap (rho_max)
    lam_max: jnp.ndarray              # multiplier cap
    active_tol: jnp.ndarray           # active-set tolerance


def game_constraints(spec: ProblemSpec, dtype=jnp.float64) -> GameConstraints:
    """Empty constraint set with reference-default parameters
    (``game_constraints.jl:16-31``)."""
    return GameConstraints(
        state_blocks=(), control_blocks=(),
        alpha_dual=jnp.asarray(1.0, dtype),
        alphax_dual=jnp.ones((spec.p,), dtype),
        phi=jnp.asarray(10.0, dtype),
        mu0=jnp.asarray(1.0, dtype),
        mu_max=jnp.asarray(1e7, dtype),
        lam_max=jnp.asarray(1e7, dtype),
        active_tol=jnp.asarray(0.0, dtype),
    )


def set_constraint_params(gc: GameConstraints, opts) -> GameConstraints:
    """Push solver options into the constraint set
    (reference ``set_constraint_params!``, ``game_constraints.jl:33-53``)."""
    dtype = gc.alpha_dual.dtype
    p = gc.alphax_dual.shape[0]
    gc = _replace(
        gc,
        alpha_dual=jnp.asarray(opts.alpha_dual, dtype),
        alphax_dual=jnp.asarray(np.asarray(opts.alphax_dual[:p]), dtype),
        phi=jnp.asarray(opts.rho_increase, dtype),
        mu0=jnp.asarray(opts.rho_0, dtype),
        mu_max=jnp.asarray(opts.rho_max, dtype),
        lam_max=jnp.asarray(opts.lam_max, dtype),
        active_tol=jnp.asarray(opts.active_set_tolerance, dtype),
    )
    new_state = tuple(_replace(b, mu=jnp.full_like(b.mu, opts.rho_0))
                      for b in gc.state_blocks)
    new_ctrl = tuple(_replace(b, mu=jnp.full_like(b.mu, opts.rho_0))
                     for b in gc.control_blocks)
    return _replace(gc, state_blocks=new_state, control_blocks=new_ctrl)


def _replace(obj, **kw):
    import dataclasses
    return dataclasses.replace(obj, **kw)


def _new_block(spec: ProblemSpec, params, owner: int, is_state: bool,
               dtype, sense: str = "ineq") -> ConBlock:
    K = spec.N - 1 if is_state else spec.T   # state: knots 2..N; control: 1..N-1
    C = kernels.num_rows(params)
    return ConBlock(
        params=params,
        lam=jnp.zeros((K, C), dtype),
        mu=jnp.ones((K, C), dtype),
        active=jnp.zeros((K, C), bool),
        owner=owner, is_state=is_state, sense=sense,
    )


def _push_state(gc: GameConstraints, block: ConBlock) -> GameConstraints:
    return _replace(gc, state_blocks=gc.state_blocks + (block,))


def _push_control(gc: GameConstraints, block: ConBlock) -> GameConstraints:
    return _replace(gc, control_blocks=gc.control_blocks + (block,))


# --------------------------------------------------------------------------
# Builders (reference src/constraints/constraints_methods.jl:5-282)
# --------------------------------------------------------------------------

def add_collision_avoidance(spec: ProblemSpec, gc: GameConstraints, radius,
                            i: int = None, j: int = None) -> GameConstraints:
    """Pairwise planar collision avoidance.

    With ``i``/``j``: one constraint owned by player i against j with summed
    radius (reference ``add_collision_avoidance!(game_con, i, j, radius)``,
    ``constraints_methods.jl:5-19``).  Without: one per ordered pair using
    ``radius[i] + radius[j]`` (``constraints_methods.jl:21-40``); a scalar
    radius is broadcast.
    """
    dtype = gc.alpha_dual.dtype
    if i is not None:
        par = CollisionParams(radius=jnp.asarray(radius, dtype),
                              pxi=spec.px[i], pxj=spec.px[j])
        return _push_state(gc, _new_block(spec, par, i, True, dtype))
    radius = np.broadcast_to(np.asarray(radius, np.float64), (spec.p,))
    for a in range(spec.p):
        for b in range(spec.p):
            if a == b:
                continue
            gc = add_collision_avoidance(spec, gc, radius[a] + radius[b], a, b)
    return gc


def add_spherical_collision_avoidance(spec: ProblemSpec, gc: GameConstraints,
                                      radius) -> GameConstraints:
    """3D collision avoidance on the first three state dims of each player
    (reference ``constraints_methods.jl:46-82``)."""
    dtype = gc.alpha_dual.dtype
    radius = np.broadcast_to(np.asarray(radius, np.float64), (spec.p,))
    for a in range(spec.p):
        for b in range(spec.p):
            if a == b:
                continue
            par = CollisionParams(
                radius=jnp.asarray(radius[a] + radius[b], dtype),
                pxi=spec.pz[a][:3], pxj=spec.pz[b][:3])
            gc = _push_state(gc, _new_block(spec, par, a, True, dtype))
    return gc


def _promote_bound(z, dim):
    """Scalar -> full-dim vector promotion (reference ``checkBounds``,
    ``control_bound_constraint.jl:95-117``)."""
    z = np.asarray(z, dtype=np.float64)
    return np.full((dim,), float(z)) if z.ndim == 0 else z


def add_state_bound(spec: ProblemSpec, gc: GameConstraints, i: int,
                    x_max, x_min) -> GameConstraints:
    """Box bound on the full state, owned by player i
    (reference ``constraints_methods.jl:88-100``)."""
    dtype = gc.alpha_dual.dtype
    par = make_bound(_promote_bound(x_max, spec.n),
                     _promote_bound(x_min, spec.n), dtype)
    return _push_state(gc, _new_block(spec, par, i, True, dtype))


def add_control_bound(spec: ProblemSpec, gc: GameConstraints,
                      u_max, u_min) -> GameConstraints:
    """Shared box bound on the full control vector
    (reference ``constraints_methods.jl:106-118``)."""
    dtype = gc.alpha_dual.dtype
    par = make_bound(_promote_bound(u_max, spec.m),
                     _promote_bound(u_min, spec.m), dtype)
    return _push_control(gc, _new_block(spec, par, -1, False, dtype))


def add_circle_constraint(spec: ProblemSpec, gc: GameConstraints,
                          xc, yc, radius, i: int = None) -> GameConstraints:
    """Static circular obstacles on player i's position (or all players)
    (reference ``constraints_methods.jl:124-155``)."""
    dtype = gc.alpha_dual.dtype
    if i is None:
        for a in range(spec.p):
            gc = add_circle_constraint(spec, gc, xc, yc, radius, a)
        return gc
    par = CircleParams(xc=jnp.asarray(xc, dtype), yc=jnp.asarray(yc, dtype),
                       radius=jnp.asarray(radius, dtype),
                       xi=spec.px[i][0], yi=spec.px[i][1])
    return _push_state(gc, _new_block(spec, par, i, True, dtype))


class Wall:
    """2D wall segment (reference ``Wall`` struct, ``constraints_methods.jl:161-166``)."""

    def __init__(self, p1, p2, v):
        self.p1, self.p2, self.v = np.asarray(p1), np.asarray(p2), np.asarray(v)


class Wall3D:
    """3D parallelepiped facet (reference ``Wall3D``, ``constraints_methods.jl:203-208``)."""

    def __init__(self, p1, p2, p3, v):
        self.p1, self.p2 = np.asarray(p1), np.asarray(p2)
        self.p3, self.v = np.asarray(p3), np.asarray(v)


class CylinderWall:
    """Axis-aligned finite cylinder (reference ``CylinderWall``,
    ``constraints_methods.jl:254-259``); ``v`` in ('x','y','z')."""

    def __init__(self, p, v, l, r):
        self.p, self.v, self.l, self.r = np.asarray(p), v, float(l), float(r)


def add_wall_constraint(spec: ProblemSpec, gc: GameConstraints, walls,
                        i: int = None) -> GameConstraints:
    """Add wall-family constraints for player i (or all players)
    (reference ``constraints_methods.jl:168-293``)."""
    dtype = gc.alpha_dual.dtype
    if i is None:
        for a in range(spec.p):
            gc = add_wall_constraint(spec, gc, walls, a)
        return gc
    kinds = {type(w) for w in walls}
    assert len(kinds) == 1, "mix of wall kinds in one call"
    kind = kinds.pop()
    arr = lambda vals: jnp.asarray(np.asarray(vals, np.float64), dtype)
    if kind is Wall:
        par = Wall2DParams(
            x1=arr([w.p1[0] for w in walls]), y1=arr([w.p1[1] for w in walls]),
            x2=arr([w.p2[0] for w in walls]), y2=arr([w.p2[1] for w in walls]),
            xv=arr([w.v[0] for w in walls]), yv=arr([w.v[1] for w in walls]),
            xi=spec.px[i][0], yi=spec.px[i][1])
    elif kind is Wall3D:
        par = Wall3DParams(
            x1=arr([w.p1[0] for w in walls]), y1=arr([w.p1[1] for w in walls]),
            z1=arr([w.p1[2] for w in walls]),
            x2=arr([w.p2[0] for w in walls]), y2=arr([w.p2[1] for w in walls]),
            z2=arr([w.p2[2] for w in walls]),
            x3=arr([w.p3[0] for w in walls]), y3=arr([w.p3[1] for w in walls]),
            z3=arr([w.p3[2] for w in walls]),
            xv=arr([w.v[0] for w in walls]), yv=arr([w.v[1] for w in walls]),
            zv=arr([w.v[2] for w in walls]),
            xi=spec.pz[i][0], yi=spec.pz[i][1], zi=spec.pz[i][2])
    elif kind is CylinderWall:
        axis_of = {'x': 0, 'y': 1, 'z': 2}
        par = CylinderParams(
            p1=arr([w.p[0] for w in walls]), p2=arr([w.p[1] for w in walls]),
            p3=arr([w.p[2] for w in walls]),
            l=arr([w.l for w in walls]), r=arr([w.r for w in walls]),
            axis=tuple(axis_of[w.v] for w in walls),
            xi=spec.pz[i][0], yi=spec.pz[i][1], zi=spec.pz[i][2])
    else:
        raise TypeError(kind)
    return _push_state(gc, _new_block(spec, par, i, True, dtype))


def add_velocity_bound(spec: ProblemSpec, model, gc: GameConstraints,
                       v_max, v_min) -> GameConstraints:
    """Speed bounds: per player i with a finite bound, add a state bound on
    that player's velocity index to ALL players (reference
    ``src/constraints/velocity_constraint.jl:1-27``)."""
    v_max = np.asarray(v_max, np.float64)
    v_min = np.asarray(v_min, np.float64)
    assert v_max.shape == v_min.shape == (spec.p,)
    for i in range(spec.p):
        if not (np.isinf(v_max[i]) and np.isinf(v_min[i])):
            x_max = np.full((spec.n,), np.inf)
            x_min = np.full((spec.n,), -np.inf)
            vi = model.velocity_index(i)
            x_max[vi] = v_max[i]
            x_min[vi] = v_min[i]
            for j in range(spec.p):
                gc = add_state_bound(spec, gc, j, x_max, x_min)
    return gc


# --------------------------------------------------------------------------
# Evaluation helpers
# --------------------------------------------------------------------------

def _block_inputs(block: ConBlock, traj):
    """Stack of knot inputs a block is applied to: states x_2..x_N or
    controls u_1..u_{N-1} (reference conval ``inds``)."""
    return traj.x[1:] if block.is_state else traj.u


def block_values(block: ConBlock, traj) -> jnp.ndarray:
    return kernels.evaluate(block.params, _block_inputs(block, traj))


def block_jacobian(block: ConBlock, traj) -> jnp.ndarray:
    return kernels.jacobian(block.params, _block_inputs(block, traj))


def al_expansion(block: ConBlock, traj):
    """AL gradient and Gauss-Newton Hessian of a block at every applied knot.

    Matches the Altro oracle (``test/constraints/constraint_derivatives.jl:29-36``):
    ``Irho = ((c >= 0) | (lam > 0)) * mu``; ``grad = J'lam + J'(Irho*c)``;
    ``hess = J' diag(Irho) J``.
    Returns (grad [K, dim], hess [K, dim, dim]).
    """
    grad, hess, _ = al_expansion_full(block, traj)
    return grad, hess


def al_expansion_full(block: ConBlock, traj):
    """As :func:`al_expansion`, but also returns the constraint values so
    callers (the fused assembly) can derive violations without re-evaluating
    the block."""
    c = block_values(block, traj)                    # [K, C]
    J = block_jacobian(block, traj)                  # [K, C, dim]
    if block.sense == "eq":
        irho = block.mu                              # always penalized
    else:
        irho = jnp.where((c >= 0.0) | (block.lam > 0.0), block.mu, 0.0)
    w = block.lam + irho * c
    if J.shape[1] == 1:
        # Single-row constraints (collision/circle): elementwise outer
        # products instead of a C=1 contraction.
        grad = J[:, 0, :] * w[:, 0, None]
        hess = (J[:, 0, :, None] * J[:, 0, None, :]) * irho[:, 0, None, None]
    else:
        hi = jax.lax.Precision.HIGHEST
        grad = jnp.einsum('kcd,kc->kd', J, w, precision=hi)
        hess = jnp.einsum('kcd,kc,kce->kde', J, irho, J, precision=hi)
    return grad, hess, c


def block_violation_max(block: ConBlock, c: jnp.ndarray) -> jnp.ndarray:
    """Scalar max violation of a block given its values (Inequality:
    max(0, c); Equality: |c|)."""
    cv = jnp.abs(c) if block.sense == "eq" else jnp.maximum(c, 0.0)
    return jnp.max(cv)


def dual_update(gc: GameConstraints, traj) -> GameConstraints:
    """AL dual ascent on every block (Inequality cone projection).

    Reference ``dual_update!`` (``constraints_methods.jl:421-436``):
    ``lam <- clamp(lam + alpha*mu*c, 0, lam_max)`` with per-player state step
    sizes ``alphax_dual[i]`` and the shared control step ``alpha_dual``.
    """
    def upd(block: ConBlock, alpha):
        c = block_values(block, traj)
        if block.sense == "eq":
            # Equality: lam <- clamp(lam + a*mu*c, -lam_max, lam_max)
            lam = jnp.clip(block.lam + alpha * block.mu * c,
                           -gc.lam_max, gc.lam_max)
        elif block.sense == "soc":
            # SOC: lam <- proj_soc(lam - a*mu*c) (constraints_methods.jl:443-445);
            # the last row is the cone axis.
            lam = _soc_projection(block.lam - alpha * block.mu * c)
        else:
            lam = jnp.clip(block.lam + alpha * block.mu * c, 0.0, gc.lam_max)
        return _replace(block, lam=lam)

    state = tuple(upd(b, gc.alphax_dual[b.owner]) for b in gc.state_blocks)
    ctrl = tuple(upd(b, gc.alpha_dual) for b in gc.control_blocks)
    return _replace(gc, state_blocks=state, control_blocks=ctrl)


def _soc_projection(v: jnp.ndarray) -> jnp.ndarray:
    """Projection onto the second-order cone {(x, t): |x| <= t}, rows [K, C]
    with the cone axis in the last component (TO ``projection(SOC, .)``)."""
    x, t = v[:, :-1], v[:, -1]
    nx = jnp.linalg.norm(x, axis=1)
    scale = jnp.clip((nx + t) / jnp.maximum(2.0 * nx, 1e-30), 0.0, 1.0)
    inside = nx <= t
    below = nx <= -t
    x_p = jnp.where(inside[:, None], x,
                    jnp.where(below[:, None], 0.0, scale[:, None] * x))
    t_p = jnp.where(inside, t, jnp.where(below, 0.0, scale * nx))
    return jnp.concatenate([x_p, t_p[:, None]], axis=1)


def penalty_update(gc: GameConstraints) -> GameConstraints:
    """``mu <- phi * mu`` capped at mu_max (reference ``penalty_update!``,
    ``constraints_methods.jl:329-352``; the cap comes from conval params)."""
    def upd(block: ConBlock):
        return _replace(block, mu=jnp.minimum(block.mu * gc.phi, gc.mu_max))

    return _replace(gc,
                    state_blocks=tuple(upd(b) for b in gc.state_blocks),
                    control_blocks=tuple(upd(b) for b in gc.control_blocks))


def update_active_set(gc: GameConstraints, traj) -> GameConstraints:
    """Recompute active flags: ``(c >= -tol) | (lam > 0)``
    (Altro ``update_active_set!`` semantics, ``constraints_methods.jl:396-415``)."""
    def upd(block: ConBlock):
        c = block_values(block, traj)
        if block.sense == "eq":
            act = jnp.ones_like(c, dtype=bool)       # equalities always active
        else:
            act = (c >= -gc.active_tol) | (block.lam > 0.0)
        return _replace(block, active=act)

    return _replace(gc,
                    state_blocks=tuple(upd(b) for b in gc.state_blocks),
                    control_blocks=tuple(upd(b) for b in gc.control_blocks))


def reset_constraints(gc: GameConstraints) -> GameConstraints:
    """Zero duals, reset penalties to mu0 (reference ``reset!``,
    ``constraints_methods.jl:299-327``)."""
    def upd(block: ConBlock):
        return _replace(block, lam=jnp.zeros_like(block.lam),
                        mu=jnp.full_like(block.mu, gc.mu0))

    return _replace(gc,
                    state_blocks=tuple(upd(b) for b in gc.state_blocks),
                    control_blocks=tuple(upd(b) for b in gc.control_blocks))


def reset_penalties(gc: GameConstraints) -> GameConstraints:
    """Reset penalties to mu0, KEEP duals (reference ``reset_penalties!``
    via Altro, ``constraints_methods.jl:305-315``) — the MPC dual-warm-start
    combination: carried multipliers + a fresh penalty schedule."""
    def upd(block: ConBlock):
        return _replace(block, mu=jnp.full_like(block.mu, gc.mu0))

    return _replace(gc,
                    state_blocks=tuple(upd(b) for b in gc.state_blocks),
                    control_blocks=tuple(upd(b) for b in gc.control_blocks))


def reset_constraint_duals(gc: GameConstraints) -> GameConstraints:
    """Zero duals, KEEP penalties (reference ``reset_duals!`` via Altro,
    ``constraints_methods.jl:296-303``)."""
    def upd(block: ConBlock):
        return _replace(block, lam=jnp.zeros_like(block.lam))

    return _replace(gc,
                    state_blocks=tuple(upd(b) for b in gc.state_blocks),
                    control_blocks=tuple(upd(b) for b in gc.control_blocks))


# --------------------------------------------------------------------------
# Violations
# --------------------------------------------------------------------------

def state_violation(gc: GameConstraints, traj) -> jnp.ndarray:
    """Max state-constraint violation per knot, [N]; Inequality: max(0, c)
    (reference ``state_violation``, ``src/struct/violations.jl:105-121``)."""
    N = traj.x.shape[0]
    vio = jnp.zeros((N,), traj.x.dtype)
    for b in gc.state_blocks:
        c = block_values(b, traj)                     # [N-1, C]
        cv = jnp.abs(c) if b.sense == "eq" else jnp.maximum(c, 0.0)
        vio = vio.at[1:].max(jnp.max(cv, axis=1))
    return vio


def dynamics_violation_vector(model, spec, traj) -> jnp.ndarray:
    """Max-abs RK2 dynamics defect per interval, [T] (the per-knot vector the
    reference keeps in ``DynamicsViolation.vio``,
    ``src/struct/violations.jl:16-24``; the scalar max is
    ``problem.residual.dynamics_violation``)."""
    from ..problem.residual import dynamics_residual
    return jnp.max(jnp.abs(dynamics_residual(model, spec, traj)), axis=1)


def control_violation(gc: GameConstraints, traj) -> jnp.ndarray:
    """Max control-constraint violation per interval, [T]
    (reference ``control_violation``, ``src/struct/violations.jl:57-67``)."""
    T = traj.u.shape[0]
    vio = jnp.zeros((T,), traj.u.dtype)
    for b in gc.control_blocks:
        c = block_values(b, traj)
        cv = jnp.abs(c) if b.sense == "eq" else jnp.maximum(c, 0.0)
        vio = jnp.maximum(vio, jnp.max(cv, axis=1))
    return vio
