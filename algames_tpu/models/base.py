"""Game dynamics model base.

JAX equivalent of the reference ``AbstractGameModel``
(``src/dynamics/game_model.jl:1-7``).  A model is a *static* (hashable,
frozen) dataclass carrying the player-interleaved index layout plus a pure
``dynamics(x, u) -> xdot`` continuous-time vector field written in jnp.
Models are closed over by jitted solver functions; all shape information is
trace-time constant.

Interleaved state layout (identical to the reference, 0-based): player ``i``
owns indices ``i, i+p, i+2p, ...`` of both the state and control vectors
(``src/dynamics/double_integrator.jl:20-23``).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax.numpy as jnp


def interleaved_indices(p: int, blocks: int) -> Tuple[Tuple[int, ...], ...]:
    """Index tuples ``[(i + j*p for j in range(blocks)) for i in range(p)]``."""
    return tuple(tuple(i + j * p for j in range(blocks)) for i in range(p))


@dataclasses.dataclass(frozen=True)
class GameModel:
    """Base class for N-player game dynamics models.

    Fields mirror the reference model structs (n, m, p, ni, mi, pu, px, pz —
    ``src/dynamics/double_integrator.jl:1-11``).  Subclasses implement
    ``dynamics``.
    """

    n: int
    m: int
    p: int
    ni: Tuple[int, ...]
    mi: Tuple[int, ...]
    pu: Tuple[Tuple[int, ...], ...]
    px: Tuple[Tuple[int, ...], ...]
    pz: Tuple[Tuple[int, ...], ...]

    def dynamics(self, x: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
        """Continuous-time dynamics ``xdot = f(x, u)``, shape [n]."""
        raise NotImplementedError

    @property
    def dim(self) -> int:
        """Workspace dimension of the position block (2 or 3).

        Reference ``dim(model)`` (``src/dynamics/unicycle.jl:34`` etc.).
        """
        raise NotImplementedError

    def velocity_index(self, i: int) -> int:
        """State index of player i's scalar speed (for velocity bounds).

        Reference ``src/constraints/velocity_constraint.jl:29-42``; raises for
        models without a scalar speed state.
        """
        raise NotImplementedError(
            f"velocity_index not implemented for {type(self).__name__}")

    def size(self):
        """(n, m, pu, p) — reference ``Base.size(model)``."""
        return self.n, self.m, self.pu, self.p
