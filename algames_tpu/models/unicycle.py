"""p-player unicycle game.

JAX equivalent of the reference ``UnicycleGame``
(``src/dynamics/unicycle.jl:14-34``).  Per-player state ``[x, y, theta, v]``
interleaved across players; control ``[omega, a]``.  The vector field is
written as vectorized slices over the player axis — no per-player unrolling,
everything fuses into elementwise kernels.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .base import GameModel, interleaved_indices


@dataclasses.dataclass(frozen=True)
class UnicycleGame(GameModel):

    def dynamics(self, x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        p = self.p
        th = x[2 * p:3 * p]
        v = x[3 * p:4 * p]
        # xd_i = cos(theta_i) v_i, yd_i = sin(theta_i) v_i, (thd, vd) = u
        # (reference src/dynamics/unicycle.jl:28-33).
        return jnp.concatenate([jnp.cos(th) * v, jnp.sin(th) * v, u])

    @property
    def dim(self) -> int:
        return 2

    def velocity_index(self, i: int) -> int:
        # reference src/constraints/velocity_constraint.jl:29-32: pz[i][4]
        return self.pz[i][3]


def unicycle_game(p: int = 2) -> UnicycleGame:
    """Constructor mirroring ``UnicycleGame(;p)``."""
    return UnicycleGame(
        n=4 * p, m=2 * p, p=p,
        ni=(4,) * p, mi=(2,) * p,
        pu=interleaved_indices(p, 2),
        px=interleaved_indices(p, 2),
        pz=interleaved_indices(p, 4),
    )
