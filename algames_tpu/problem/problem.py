"""GameProblem: the top-level problem record.

JAX equivalent of the reference ``GameProblem`` + ``Penalty``
(``src/problem/problem.jl:5-53``).  Instead of preallocated trajectories,
views, and a mutable Newton core, the problem is a slim pytree: static shape
information (spec, model, options) as aux data, and the traced scenario data
(x0, objective, constraints).  Everything downstream is a pure function of
this record — which is what makes ``vmap`` over thousands of scenarios and
``shard_map`` over a mesh trivial.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..constraints.sets import (GameConstraints,
                                            set_constraint_params)
from ..core.spec import ProblemSpec, spec_from_model
from ..objective.objective import GameObjective
from ..utils import pytree_dataclass
from .options import Options


@pytree_dataclass(meta_fields=("spec", "model", "opts"))
class GameProblem:
    spec: ProblemSpec
    model: object
    opts: Options
    x0: jnp.ndarray
    obj: GameObjective
    gc: GameConstraints


def game_problem(N: int, dt: float, x0, model, opts: Options,
                 obj: GameObjective, gc: GameConstraints) -> GameProblem:
    """Build a GameProblem (reference ctor ``src/problem/problem.jl:35-53``);
    pushes the solver options into the constraint parameters
    (``set_constraint_params!``)."""
    spec = spec_from_model(model, N, dt)
    gc = set_constraint_params(gc, opts)
    return GameProblem(spec=spec, model=model, opts=opts,
                       x0=jnp.asarray(x0), obj=obj, gc=gc)
