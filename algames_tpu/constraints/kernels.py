"""Constraint-family kernels: pure eval/jacobian functions over knot batches.

JAX equivalent of the reference constraint types
(``src/constraints/wall_constraint.jl``, ``cylinder_constraint.jl``,
``state_bound_constraint.jl``, ``control_bound_constraint.jl`` and the
TrajectoryOptimization ``CollisionConstraint``/``CircleConstraint`` subset).

Each family is a small pytree of parameter arrays plus two pure functions

    evaluate(block, z)  -> vals [K, C]
    jacobian(block, z)  -> jac  [K, C, dim]

where ``z`` is the stack of states (or controls) at the applied knots.  All
constraints are Inequality-sense: feasible iff ``c <= 0``.  The reference
kernels are already written in branch-free gated-arithmetic style (bool
masks multiplied into values/Jacobians) — exactly what vector units want — so
the math here is a direct vectorization over knots, never a port of any
object hierarchy.

Infinite bounds are handled with a static finite-mask: masked rows evaluate
to exactly 0 with zero Jacobian, so they contribute nothing to AL
gradients, duals, or violations under ANY cone sense (max(0, 0) = |0| = 0)
— equivalent to the reference's finite-index extraction
(``state_bound_constraint.jl:28-44``) without dynamic shapes.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..utils import pytree_dataclass


# --------------------------------------------------------------------------
# Collision avoidance between two players
# --------------------------------------------------------------------------

@pytree_dataclass(meta_fields=("pxi", "pxj"))
class CollisionParams:
    """TO ``CollisionConstraint``: c = r^2 - |x_i - x_j|^2  (C = 1)."""
    radius: jnp.ndarray               # scalar
    pxi: Tuple[int, ...]
    pxj: Tuple[int, ...]


def collision_evaluate(par: CollisionParams, xs: jnp.ndarray) -> jnp.ndarray:
    d = xs[:, np.asarray(par.pxi)] - xs[:, np.asarray(par.pxj)]   # [K, d]
    r2 = jnp.reshape(par.radius, (1, 1)) ** 2
    return r2 - jnp.sum(d * d, axis=-1)[:, None]                  # [K, 1]


def collision_jacobian(par: CollisionParams, xs: jnp.ndarray) -> jnp.ndarray:
    K, n = xs.shape
    pxi, pxj = np.asarray(par.pxi), np.asarray(par.pxj)
    d = xs[:, pxi] - xs[:, pxj]                                   # [K, d]
    jac = jnp.zeros((K, 1, n), xs.dtype)
    jac = jac.at[:, 0, pxi].set(-2.0 * d)
    jac = jac.at[:, 0, pxj].set(2.0 * d)
    return jac


# --------------------------------------------------------------------------
# Static circular obstacles
# --------------------------------------------------------------------------

@pytree_dataclass(meta_fields=("xi", "yi"))
class CircleParams:
    """TO ``CircleConstraint``: c_j = r_j^2 - (x-xc_j)^2 - (y-yc_j)^2 (C = n_circ)."""
    xc: jnp.ndarray                   # [C]
    yc: jnp.ndarray                   # [C]
    radius: jnp.ndarray               # [C]
    xi: int                           # state index of the x coordinate
    yi: int


def circle_evaluate(par: CircleParams, xs: jnp.ndarray) -> jnp.ndarray:
    dx = xs[:, par.xi][:, None] - par.xc[None]
    dy = xs[:, par.yi][:, None] - par.yc[None]
    return par.radius[None] ** 2 - dx * dx - dy * dy


def circle_jacobian(par: CircleParams, xs: jnp.ndarray) -> jnp.ndarray:
    K, n = xs.shape
    C = par.xc.shape[0]
    dx = xs[:, par.xi][:, None] - par.xc[None]
    dy = xs[:, par.yi][:, None] - par.yc[None]
    jac = jnp.zeros((K, C, n), xs.dtype)
    jac = jac.at[:, :, par.xi].set(-2.0 * dx)
    jac = jac.at[:, :, par.yi].set(-2.0 * dy)
    return jac


# --------------------------------------------------------------------------
# 2D finite wall segments
# --------------------------------------------------------------------------

@pytree_dataclass(meta_fields=("xi", "yi"))
class Wall2DParams:
    """Reference ``WallConstraint`` (``wall_constraint.jl:30-96``):
    c = (x-p1)'v gated by being within the segment (C = n_walls)."""
    x1: jnp.ndarray
    y1: jnp.ndarray
    x2: jnp.ndarray
    y2: jnp.ndarray
    xv: jnp.ndarray
    yv: jnp.ndarray
    xi: int
    yi: int


def _wall2d_gates(par: Wall2DParams, x, y):
    left = (x - par.x1) * (par.x2 - par.x1) + (y - par.y1) * (par.y2 - par.y1) > 0
    right = (x - par.x2) * (par.x1 - par.x2) + (y - par.y2) * (par.y1 - par.y2) > 0
    return left, right


def wall2d_evaluate(par: Wall2DParams, xs: jnp.ndarray) -> jnp.ndarray:
    x = xs[:, par.xi][:, None]
    y = xs[:, par.yi][:, None]
    left, right = _wall2d_gates(par, x, y)
    out = (x - par.x1) * par.xv + (y - par.y1) * par.yv
    return out * left * right


def wall2d_jacobian(par: Wall2DParams, xs: jnp.ndarray) -> jnp.ndarray:
    K, n = xs.shape
    C = par.x1.shape[0]
    x = xs[:, par.xi][:, None]
    y = xs[:, par.yi][:, None]
    left, right = _wall2d_gates(par, x, y)
    gate = (left & right).astype(xs.dtype)
    jac = jnp.zeros((K, C, n), xs.dtype)
    jac = jac.at[:, :, par.xi].set(gate * par.xv)
    jac = jac.at[:, :, par.yi].set(gate * par.yv)
    return jac


# --------------------------------------------------------------------------
# 3D parallelepiped-facet walls
# --------------------------------------------------------------------------

@pytree_dataclass(meta_fields=("xi", "yi", "zi"))
class Wall3DParams:
    """Reference ``Wall3DConstraint`` (``wall_constraint.jl:141-249``)."""
    x1: jnp.ndarray
    y1: jnp.ndarray
    z1: jnp.ndarray
    x2: jnp.ndarray
    y2: jnp.ndarray
    z2: jnp.ndarray
    x3: jnp.ndarray
    y3: jnp.ndarray
    z3: jnp.ndarray
    xv: jnp.ndarray
    yv: jnp.ndarray
    zv: jnp.ndarray
    xi: int
    yi: int
    zi: int


def _wall3d_gates(par: Wall3DParams, x, y, z):
    left = ((x - par.x1) * (par.x2 - par.x1) + (y - par.y1) * (par.y2 - par.y1)
            + (z - par.z1) * (par.z2 - par.z1)) > 0
    right = ((x - par.x2) * (par.x1 - par.x2) + (y - par.y2) * (par.y1 - par.y2)
             + (z - par.z2) * (par.z1 - par.z2)) > 0
    bottom = ((x - par.x3) * (par.x2 - par.x3) + (y - par.y3) * (par.y2 - par.y3)
              + (z - par.z3) * (par.z2 - par.z3)) > 0
    top = ((x - par.x2) * (par.x3 - par.x2) + (y - par.y2) * (par.y3 - par.y2)
           + (z - par.z2) * (par.z3 - par.z2)) > 0
    return left & right & bottom & top


def wall3d_evaluate(par: Wall3DParams, xs: jnp.ndarray) -> jnp.ndarray:
    x = xs[:, par.xi][:, None]
    y = xs[:, par.yi][:, None]
    z = xs[:, par.zi][:, None]
    gate = _wall3d_gates(par, x, y, z)
    out = (x - par.x1) * par.xv + (y - par.y1) * par.yv + (z - par.z1) * par.zv
    return out * gate


def wall3d_jacobian(par: Wall3DParams, xs: jnp.ndarray) -> jnp.ndarray:
    K, n = xs.shape
    C = par.x1.shape[0]
    x = xs[:, par.xi][:, None]
    y = xs[:, par.yi][:, None]
    z = xs[:, par.zi][:, None]
    gate = _wall3d_gates(par, x, y, z).astype(xs.dtype)
    jac = jnp.zeros((K, C, n), xs.dtype)
    jac = jac.at[:, :, par.xi].set(gate * par.xv)
    jac = jac.at[:, :, par.yi].set(gate * par.yv)
    jac = jac.at[:, :, par.zi].set(gate * par.zv)
    return jac


# --------------------------------------------------------------------------
# Axis-aligned finite cylinder keep-out
# --------------------------------------------------------------------------

@pytree_dataclass(meta_fields=("axis", "xi", "yi", "zi"))
class CylinderParams:
    """Reference ``CylinderConstraint`` (``cylinder_constraint.jl:33-137``).

    ``axis`` is a static tuple of 0/1/2 (x/y/z) per cylinder, replacing the
    reference's Symbol vector.
    """
    p1: jnp.ndarray
    p2: jnp.ndarray
    p3: jnp.ndarray
    l: jnp.ndarray
    r: jnp.ndarray
    axis: Tuple[int, ...]
    xi: int
    yi: int
    zi: int


def _cylinder_terms(par: CylinderParams, xs):
    x = xs[:, par.xi][:, None]
    y = xs[:, par.yi][:, None]
    z = xs[:, par.zi][:, None]
    t0 = (x - par.p1, y - par.p2, z - par.p3)
    ax = np.asarray(par.axis)
    is_ax = tuple((ax == a).astype(xs.dtype) for a in range(3))
    valid = jnp.zeros(t0[0].shape, bool)
    for a in range(3):
        valid = valid | ((ax == a) & (t0[a] > 0.0) & (t0[a] < par.l))
    return t0, is_ax, valid


def cylinder_evaluate(par: CylinderParams, xs: jnp.ndarray) -> jnp.ndarray:
    t0, is_ax, valid = _cylinder_terms(par, xs)
    out = par.r ** 2 - t0[0] ** 2 - t0[1] ** 2 - t0[2] ** 2
    for a in range(3):
        out = out + is_ax[a] * t0[a] ** 2
    return out * valid


def cylinder_jacobian(par: CylinderParams, xs: jnp.ndarray) -> jnp.ndarray:
    K, n = xs.shape
    C = par.p1.shape[0]
    t0, is_ax, valid = _cylinder_terms(par, xs)
    v = valid.astype(xs.dtype)
    jac = jnp.zeros((K, C, n), xs.dtype)
    jac = jac.at[:, :, par.xi].set(-v * 2.0 * t0[0] * (1.0 - is_ax[0]))
    jac = jac.at[:, :, par.yi].set(-v * 2.0 * t0[1] * (1.0 - is_ax[1]))
    jac = jac.at[:, :, par.zi].set(-v * 2.0 * t0[2] * (1.0 - is_ax[2]))
    return jac


# --------------------------------------------------------------------------
# Box bounds (state or control)
# --------------------------------------------------------------------------

@pytree_dataclass(meta_fields=("mask",))
class BoundParams:
    """Box bound: c = [z - z_max; z_min - z] with infinite rows masked out.

    Reference ``StateBoundConstraint``/``ControlBoundConstraint``
    (``state_bound_constraint.jl:15-103``, ``control_bound_constraint.jl``).
    ``mask`` is the static finite-bound pattern (length 2*dim).
    """
    z_max: jnp.ndarray                # [dim] (inf-padded)
    z_min: jnp.ndarray                # [dim]
    mask: Tuple[bool, ...]            # [2*dim] finite-bound flags


def make_bound(z_max, z_min, dtype=jnp.float64) -> BoundParams:
    z_max = np.asarray(z_max, dtype=np.float64)
    z_min = np.asarray(z_min, dtype=np.float64)
    assert np.all(z_max >= z_min), \
        "Upper bounds must be greater than or equal to lower bounds"
    mask = tuple(bool(b) for b in np.isfinite(np.concatenate([z_max, z_min])))
    # Replace infinities so arithmetic stays finite; masked rows are forced
    # to a feasible constant below.
    big = 0.0
    zmx = np.where(np.isfinite(z_max), z_max, big)
    zmn = np.where(np.isfinite(z_min), z_min, big)
    return BoundParams(z_max=jnp.asarray(zmx, dtype),
                       z_min=jnp.asarray(zmn, dtype), mask=mask)


def bound_evaluate(par: BoundParams, zs: jnp.ndarray) -> jnp.ndarray:
    c = jnp.concatenate([zs - par.z_max[None], par.z_min[None] - zs], axis=1)
    mask = jnp.asarray(par.mask)
    return jnp.where(mask[None], c, 0.0)


def bound_jacobian(par: BoundParams, zs: jnp.ndarray) -> jnp.ndarray:
    K, dim = zs.shape
    mask = np.asarray(par.mask, dtype=np.float64)
    eye = np.eye(dim)
    J = np.concatenate([eye, -eye], axis=0) * mask[:, None]       # [2*dim, dim]
    return jnp.broadcast_to(jnp.asarray(J, zs.dtype), (K, 2 * dim, dim))


# --------------------------------------------------------------------------
# Dispatch tables
# --------------------------------------------------------------------------

EVALUATE = {
    CollisionParams: collision_evaluate,
    CircleParams: circle_evaluate,
    Wall2DParams: wall2d_evaluate,
    Wall3DParams: wall3d_evaluate,
    CylinderParams: cylinder_evaluate,
    BoundParams: bound_evaluate,
}

JACOBIAN = {
    CollisionParams: collision_jacobian,
    CircleParams: circle_jacobian,
    Wall2DParams: wall2d_jacobian,
    Wall3DParams: wall3d_jacobian,
    CylinderParams: cylinder_jacobian,
    BoundParams: bound_jacobian,
}


def evaluate(par, zs):
    return EVALUATE[type(par)](par, zs)


def jacobian(par, zs):
    return JACOBIAN[type(par)](par, zs)


def num_rows(par) -> int:
    """Static number of constraint rows C of a family instance."""
    if isinstance(par, CollisionParams):
        return 1
    if isinstance(par, CircleParams):
        return int(par.xc.shape[0])
    if isinstance(par, (Wall2DParams, Wall3DParams)):
        return int(par.x1.shape[0])
    if isinstance(par, CylinderParams):
        return int(par.p1.shape[0])
    if isinstance(par, BoundParams):
        return 2 * int(par.z_max.shape[0])
    raise TypeError(type(par))
