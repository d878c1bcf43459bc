"""Primal-dual trajectory pytree and its lifecycle operations.

JAX equivalent of the reference ``PrimalDualTraj``
(``src/struct/primal_dual_traj.jl:5-158``).  Instead of a vector of
knot-point structs plus nested dual vectors, the trajectory is a flat pytree
of stacked device arrays:

* ``x``   [N, n]   states (``x[0]`` is the fixed initial state)
* ``u``   [T, m]   controls, T = N-1
* ``lam`` [p, T, n] each player's multiplier on the shared dynamics

All lifecycle ops (init/shift, scatter/gather to the flat Newton vector,
axpy updates, step metric) are pure functions, trivially vmappable over a
scenario batch.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.spec import ProblemSpec
from ..utils import pytree_dataclass


@pytree_dataclass
class PrimalDual:
    x: jnp.ndarray    # [N, n]
    u: jnp.ndarray    # [T, m]
    lam: jnp.ndarray  # [p, T, n]


def zero_traj(spec: ProblemSpec, dtype=jnp.float32) -> PrimalDual:
    return PrimalDual(
        x=jnp.zeros((spec.N, spec.n), dtype),
        u=jnp.zeros((spec.T, spec.m), dtype),
        lam=jnp.zeros((spec.p, spec.T, spec.n), dtype),
    )


def init_traj(spec: ProblemSpec, x0: jnp.ndarray, key=None,
              amplitude: float = 1e-8, shift: int = 2 ** 10,
              prev: PrimalDual | None = None) -> PrimalDual:
    """Random small-amplitude init with MPC warm-start shift semantics.

    Mirrors ``init_traj!`` (``src/struct/primal_dual_traj.jl:29-44``):
    entry k is taken from ``prev`` shifted by ``s`` knots when ``k+s`` is in
    range, else re-drawn at ``amplitude``; finally ``x[0]`` is pinned to x0.
    The reference draws with Julia's seeded RNG; amplitudes are 1e-8 so the
    draw is numerically immaterial — we use jax.random when a key is given
    and zeros otherwise (SURVEY.md §7 hard-part 3).
    """
    dtype = x0.dtype
    if key is None:
        fresh = zero_traj(spec, dtype)
    else:
        kx, ku, kl = jax.random.split(key, 3)
        fresh = PrimalDual(
            x=amplitude * jax.random.uniform(kx, (spec.N, spec.n), dtype),
            u=amplitude * jax.random.uniform(ku, (spec.T, spec.m), dtype),
            lam=amplitude * jax.random.uniform(kl, (spec.p, spec.T, spec.n), dtype),
        )
    if prev is not None and shift < spec.N:
        s = shift
        roll_x = jnp.concatenate([prev.x[s:], fresh.x[spec.N - s:]], axis=0)
        roll_u = (jnp.concatenate([prev.u[s:], fresh.u[spec.T - s:]], axis=0)
                  if s < spec.T else fresh.u)
        roll_l = (jnp.concatenate([prev.lam[:, s:], fresh.lam[:, spec.T - s:]], axis=1)
                  if s < spec.T else fresh.lam)
        fresh = PrimalDual(x=roll_x, u=roll_u, lam=roll_l)
    return PrimalDual(x=fresh.x.at[0].set(x0), u=fresh.u, lam=fresh.lam)


def update_traj(source: PrimalDual, alpha, delta: PrimalDual) -> PrimalDual:
    """``target = source + alpha * delta`` on primals and duals.

    Mirrors ``update_traj!`` (``src/struct/primal_dual_traj.jl:109-128``);
    note the reference never touches ``x[0]`` (state of knot 1 is fixed), and
    neither do we because ``delta.x[0]`` is identically zero by construction
    (see :func:`unpack_step`).
    """
    return PrimalDual(
        x=source.x + alpha * delta.x,
        u=source.u + alpha * delta.u,
        lam=source.lam + alpha * delta.lam,
    )


def delta_step(delta: PrimalDual, alpha) -> jnp.ndarray:
    """Mean 1-norm of the primal step — reference ``Δ_step``
    (``src/struct/primal_dual_traj.jl:130-147``): sum of |x_{k+1}| and |u_k|
     1-norms, times alpha, divided by (N-1)(n+m).  Duals excluded."""
    N, n = delta.x.shape
    T, m = delta.u.shape
    s = jnp.sum(jnp.abs(delta.x[1:])) + jnp.sum(jnp.abs(delta.u))
    return s * alpha / (T * (n + m))


def reset_duals(traj: PrimalDual) -> PrimalDual:
    """Zero the dynamics multipliers (reference ``reset_duals!``)."""
    return PrimalDual(x=traj.x, u=traj.u, lam=jnp.zeros_like(traj.lam))


# --------------------------------------------------------------------------
# Flat Newton-vector scatter/gather (reference set_traj!/get_traj!,
# src/struct/primal_dual_traj.jl:46-107).  Flat layout is the "horizontal"
# column order of core/spec.py: per knot [x_{k+1}; u_k; lam_{0..p-1,k}].
# --------------------------------------------------------------------------

def unpack_step(spec: ProblemSpec, flat: jnp.ndarray) -> PrimalDual:
    """Scatter a flat Newton step [S] into a structured PrimalDual.

    ``delta.x[0]`` is zero: knot-1 state is not a decision variable.
    """
    blocks = flat.reshape(spec.T, spec.W)
    dx = blocks[:, :spec.n]                                   # [T, n] = x_{k+1}
    du = blocks[:, spec.n:spec.n + spec.m]                    # [T, m]
    dl = blocks[:, spec.n + spec.m:]                          # [T, p*n]
    x = jnp.concatenate([jnp.zeros((1, spec.n), flat.dtype), dx], axis=0)
    lam = dl.reshape(spec.T, spec.p, spec.n).transpose(1, 0, 2)
    return PrimalDual(x=x, u=du, lam=lam)


def pack_traj(spec: ProblemSpec, traj: PrimalDual) -> jnp.ndarray:
    """Gather a structured PrimalDual into the flat [S] column order."""
    dl = traj.lam.transpose(1, 0, 2).reshape(spec.T, spec.p * spec.n)
    blocks = jnp.concatenate([traj.x[1:], traj.u, dl], axis=1)
    return blocks.reshape(-1)
