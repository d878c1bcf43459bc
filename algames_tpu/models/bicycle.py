"""p-player kinematic bicycle game.

JAX equivalent of the reference ``BicycleGame``
(``src/dynamics/bicycle.jl:15-43``).  Per-player state ``[x, y, v, psi]``,
control ``[a, delta]``; slip angle ``beta = atan2(lr*tan(delta), lr+lf)``.
Vectorized over the player axis.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .base import GameModel, interleaved_indices


@dataclasses.dataclass(frozen=True)
class BicycleGame(GameModel):
    lf: float = 0.05
    lr: float = 0.05

    def dynamics(self, x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        p = self.p
        v = x[2 * p:3 * p]
        psi = x[3 * p:4 * p]
        a = u[0:p]
        delta = u[p:2 * p]
        # beta = atan(lr*tan(delta), lr+lf)
        # Xdot = [v cos(beta+psi), v sin(beta+psi), a, v sin(beta)/lr]
        # (reference src/dynamics/bicycle.jl:34-42).
        beta = jnp.arctan2(self.lr * jnp.tan(delta), self.lr + self.lf)
        return jnp.concatenate([
            v * jnp.cos(beta + psi),
            v * jnp.sin(beta + psi),
            a,
            v * jnp.sin(beta) / self.lr,
        ])

    @property
    def dim(self) -> int:
        return 2

    def velocity_index(self, i: int) -> int:
        # reference src/constraints/velocity_constraint.jl:34-37: pz[i][3]
        return self.pz[i][2]


def bicycle_game(p: int = 2, lf: float = 0.05, lr: float = 0.05) -> BicycleGame:
    """Constructor mirroring ``BicycleGame(;p, lf, lr)``."""
    return BicycleGame(
        n=4 * p, m=2 * p, p=p,
        ni=(4,) * p, mi=(2,) * p,
        pu=interleaved_indices(p, 2),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 4),
        lf=lf, lr=lr,
    )
