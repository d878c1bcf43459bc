"""p-player d-dimensional double integrator game.

JAX equivalent of the reference ``DoubleIntegratorGame``
(``src/dynamics/double_integrator.jl:13-33``).  State = [positions (d*p,
interleaved); velocities (d*p)], control = accelerations (d*p).  The vector
field is the branch-free concatenation ``xdot = [x[d*p:], u]`` — a single
static slice, ideal for XLA fusion (no per-player loop).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .base import GameModel, interleaved_indices


@dataclasses.dataclass(frozen=True)
class DoubleIntegratorGame(GameModel):
    d: int = 2

    def dynamics(self, x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        # qdot = velocities (second half of the state), qddot = controls
        # (reference src/dynamics/double_integrator.jl:27-31).
        return jnp.concatenate([x[self.m:], u])

    @property
    def dim(self) -> int:
        return self.d

    def velocity_index(self, i: int) -> int:
        raise NotImplementedError(
            "Velocity index is not implemented for DoubleIntegratorGame "
            "(reference src/constraints/velocity_constraint.jl:39-42)")


def double_integrator_game(p: int = 2, d: int = 2) -> DoubleIntegratorGame:
    """Constructor mirroring ``DoubleIntegratorGame(;p, d)``."""
    n = 2 * d * p
    m = d * p
    return DoubleIntegratorGame(
        n=n, m=m, p=p,
        ni=(2 * d,) * p, mi=(d,) * p,
        pu=interleaved_indices(p, d),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 2 * d),
        d=d,
    )
