"""p-player quadrotor game (12-state MRP attitude per player).

JAX equivalent of the reference ``QuadrotorGame``
(``src/dynamics/quadrotor.jl:21-206``).  Per-player state
``[x, y, z, mrp1..3, vx..vz, wx..wz]`` interleaved across players; control
``[w1..w4]`` rotor speeds with thrust clamp ``F = max(0, kf*w)``
(``src/dynamics/quadrotor.jl:58-63``).

Unlike the reference, which hand-unrolls the dynamics per player count and
asserts ``p <= 4`` (``src/dynamics/quadrotor.jl:122-206``), this
implementation is vectorized over the player axis with batched 3-vector
algebra and supports any ``p``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from .base import GameModel, interleaved_indices


def _skew(v: jnp.ndarray) -> jnp.ndarray:
    """Batched skew-symmetric matrix: v [..., 3] -> [..., 3, 3]."""
    z = jnp.zeros_like(v[..., 0])
    return jnp.stack([
        jnp.stack([z, -v[..., 2], v[..., 1]], axis=-1),
        jnp.stack([v[..., 2], z, -v[..., 0]], axis=-1),
        jnp.stack([-v[..., 1], v[..., 0], z], axis=-1),
    ], axis=-2)


def mrp_rotation_matrix(q: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix of a Modified Rodrigues Parameter vector, batched.

    Matches Rotations.jl ``MRP`` (used at ``src/dynamics/quadrotor.jl:53``):
    ``R = I + (8 S^2 + 4 (1 - |q|^2) S) / (1 + |q|^2)^2`` with ``S = skew(q)``.
    """
    s = _skew(q)
    n2 = jnp.sum(q * q, axis=-1)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), s.shape)
    return eye + (8.0 * (s @ s) + 4.0 * (1.0 - n2) * s) / (1.0 + n2) ** 2


def mrp_kinematics(q: jnp.ndarray, w: jnp.ndarray) -> jnp.ndarray:
    """MRP attitude kinematics, batched over leading axes.

    Matches Rotations.jl ``kinematics(MRP, omega)`` (used at
    ``src/dynamics/quadrotor.jl:112``):
    ``qdot = 0.25 ((1 - q'q) I + 2 skew(q) + 2 q q') w``.
    """
    n2 = jnp.sum(q * q, axis=-1)[..., None, None]
    eye = jnp.broadcast_to(jnp.eye(3, dtype=q.dtype), n2.shape[:-2] + (3, 3))
    mat = 0.25 * ((1.0 - n2) * eye + 2.0 * _skew(q)
                  + 2.0 * q[..., :, None] * q[..., None, :])
    return jnp.einsum('...ij,...j->...i', mat, w)


@dataclasses.dataclass(frozen=True)
class QuadrotorGame(GameModel):
    mass: float = 0.5
    J: Tuple[float, float, float] = (0.0023, 0.0023, 0.004)
    gravity: Tuple[float, float, float] = (0.0, 0.0, -9.81)
    motor_dist: float = 0.1750
    kf: float = 1.245
    km: float = 1.0
    # Optional smooth thrust clamp: 0.0 reproduces the reference's
    # non-smooth max(0, kf*w) exactly; beta > 0 substitutes
    # softplus(beta*kf*w)/beta (>= 0, -> max as beta -> inf, deviation
    # <= ln(2)/beta at the kink).  The exact clamp's subgradient kink caps
    # the quasi-Newton stationarity floor at ~3e-2 whenever a rotor rides
    # the boundary (both here and structurally in the reference,
    # ``src/dynamics/quadrotor.jl:58-63``); beta ~ 1e2 restores the 1e-3
    # stationarity gate at <= 7e-3 thrust deviation.  See
    # ``tests/test_models.py::test_quadrotor_smooth_clamp_converges``.
    thrust_smoothing: float = 0.0

    def dynamics(self, x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        p = self.p
        # Deinterleave: block j of size p holds component j of every player.
        # xb[j, i] = x[j*p + i]  ->  per-player [p, 12] after transpose.
        xs = x.reshape(12, p).T          # [p, 12]
        us = u.reshape(4, p).T           # [p, 4]
        q = xs[:, 3:6]                   # MRP
        v = xs[:, 6:9]
        w = xs[:, 9:12]

        J = jnp.asarray(self.J, dtype=x.dtype)
        g = jnp.asarray(self.gravity, dtype=x.dtype)

        # Rotor thrusts with the max(0, .) clamp
        # (reference src/dynamics/quadrotor.jl:58-63, 85-95), optionally
        # softplus-smoothed (see thrust_smoothing above).
        if self.thrust_smoothing > 0.0:
            beta = self.thrust_smoothing
            F_rot = jax.nn.softplus(beta * self.kf * us) / beta
        else:
            F_rot = jnp.maximum(0.0, self.kf * us)       # [p, 4]
        F_body = jnp.stack([
            jnp.zeros_like(F_rot[:, 0]),
            jnp.zeros_like(F_rot[:, 0]),
            jnp.sum(F_rot, axis=1),
        ], axis=-1)                                       # [p, 3]
        M_rot = self.km * us                              # [p, 4]
        L = self.motor_dist
        tau = jnp.stack([
            L * (F_rot[:, 1] - F_rot[:, 3]),
            L * (F_rot[:, 2] - F_rot[:, 0]),
            M_rot[:, 0] - M_rot[:, 1] + M_rot[:, 2] - M_rot[:, 3],
        ], axis=-1)                                       # [p, 3]

        R = mrp_rotation_matrix(q)                        # [p, 3, 3]
        f_world = self.mass * g + jnp.einsum('pij,pj->pi', R, F_body)

        xdot = v
        qdot = mrp_kinematics(q, w)
        vdot = f_world / self.mass
        Jw = J * w
        wdot = (tau - jnp.cross(w, Jw)) / J

        ds = jnp.concatenate([xdot, qdot, vdot, wdot], axis=-1)  # [p, 12]
        return ds.T.reshape(-1)                                   # interleave back

    @property
    def dim(self) -> int:
        return 3

    def velocity_index(self, i: int) -> int:
        raise NotImplementedError(
            "Velocity index is not implemented for QuadrotorGame")


def quadrotor_game(p: int = 2, mass: float = 0.5,
                   thrust_smoothing: float = 0.0) -> QuadrotorGame:
    """Constructor mirroring ``QuadrotorGame(;p, mass)``; see
    ``QuadrotorGame.thrust_smoothing`` for the optional smooth clamp."""
    return QuadrotorGame(
        n=12 * p, m=4 * p, p=p,
        ni=(12,) * p, mi=(4,) * p,
        pu=interleaved_indices(p, 4),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 12),
        mass=mass,
        thrust_smoothing=thrust_smoothing,
    )
