"""Solver options.

JAX equivalent of the reference ``Options`` / ``IBROptions`` /
``Regularizer`` (``src/struct/options.jl:5-136``,
``src/struct/regularizer.jl:5-15``).  A single frozen (hashable) dataclass:
it is *static* under jit — iteration caps and flags shape the compiled
program; scalar knobs are baked as constants (re-jit on change, which is the
idiomatic JAX treatment of solver hyper-parameters).  Penalty state that
evolves during the solve (rho, reg schedule) lives in the solver carry, not
here.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class Options:
    # Gauss-Newton convergence tolerance (reference theta).
    theta: float = 1e-2
    # Initialization amplitude of the primal-dual vector.
    amplitude_init: float = 1e-8
    # Shift of the trajectory for the initial guess (MPC warm start uses 1).
    shift: int = 2 ** 10

    # Regularization (reference Regularizer has per-kind x/u/lam coefficients;
    # only x and u are ever applied: src/problem/global_quantities.jl:168-178).
    regularize: bool = True
    reg_0: float = 1e-3

    # Line search.
    alpha_0: float = 1.0
    alpha_increase: float = 1.2
    alpha_decrease: float = 0.5
    beta: float = 0.01
    ls_iter: int = 25
    delta_min: float = 1e-9
    # Evaluate the first ls_parallel backtracking trials in ONE vectorized
    # residual pass (first-accept semantics identical to the sequential
    # reference loop, ``solver_methods.jl:105-125``); deeper trials fall back
    # to the sequential loop.  Rationale: under vmap every lane pays the MAX
    # line-search depth across the batch per Newton iteration — sequential
    # trials serialize, parallel trials amortize.  0 = pure sequential.
    # Default 1: on the flagship the batch p50 accept depth is 1, so K=2
    # pays a full second trial evaluation every iteration to save a rare
    # whole-batch sequential pass.  Raise for problems whose accept-depth
    # histogram has real mass past 1.
    ls_parallel: int = 1

    # Augmented Lagrangian penalty schedule.
    rho_0: float = 1.0
    rho_trial: float = 1.0
    rho_increase: float = 10.0
    rho_max: float = 1e7
    lam_max: float = 1e7
    alpha_dual: float = 1.0
    alphax_dual: Tuple[float, ...] = (1.0,) * 10
    active_set_tolerance: float = 1e-4

    # Convergence criteria.
    eps_dyn: float = 1e-3
    eps_sta: float = 1e-3
    eps_con: float = 1e-3
    eps_opt: float = 1e-3

    # Iteration caps.
    outer_iter: int = 7
    inner_iter: int = 20

    # Flatten the AL outer loop and the Newton inner loop into ONE
    # lax.while_loop state machine (identical per-lane iteration sequence).
    # Under vmap the nested loops run ``sum_k max_lanes(inner_trips_k)``
    # bodies, the flat machine ``max_lanes(sum_k inner_trips_k)`` — strictly
    # fewer: straggler mitigation for large scenario batches.
    flat_loop: bool = True

    # Iterations per flat-machine while_loop trip (flat_loop=True only).
    # Each extra sub-iteration is guarded by a per-lane select on the loop
    # condition — exactly the masking JAX's while batching rule applies per
    # trip — so the per-lane iteration sequence is bitwise identical at any
    # unroll.  >1 trades while-trip overhead (cond evaluations, batching-
    # rule carry selects) against the guard selects over the carried
    # PointData + up to unroll-1 masked tail iterations per lane.  Default
    # 1; not yet measured on the GPU.
    loop_unroll: int = 1

    # Adaptive penalty safeguard (NOT in the reference, opt-in): ramp the
    # penalties only when the constraint violation failed to shrink by
    # ``adaptive_ratio``; otherwise take the dual-ascent step alone
    # (classic LANCELOT-style AL update).  Stabilizes strongly-infeasible
    # starts (e.g. symmetric crossing scenarios) that diverge under the
    # reference's unconditional x10 ramp.
    adaptive_penalty: bool = False
    adaptive_ratio: float = 0.25

    # Objective scaling (unused by the reference solver path, kept for parity).
    gamma: float = 1.0

    # MPC.
    mpc_horizon: int = 20
    upsampling: int = 2

    # Printing / reproducibility.
    inner_print: bool = False
    outer_print: bool = False
    seed: int = 100
    dual_reset: bool = True


@dataclasses.dataclass(frozen=True)
class Regularizer:
    """Per-variable-kind Tikhonov coefficients (reference ``Regularizer``,
    ``src/struct/regularizer.jl:5-15``, with ``set!``/``mult!``,
    ``:17-35``).

    The solver itself carries the scalar schedule ``reg = reg_0 * l^4`` in
    its loop state (only the x/u entries are ever applied by the reference,
    ``src/problem/global_quantities.jl:168-193``); this mirror of the
    reference API exists for users who drive iterations manually via
    ``residual.jacobian_blocks(reg_x=..., reg_u=...)``.
    """
    x: float = 0.0
    u: float = 0.0
    lam: float = 0.0

    def set(self, rho: float) -> "Regularizer":
        """All coefficients <- rho (reference ``set!``)."""
        return Regularizer(x=rho, u=rho, lam=rho)

    def mult(self, gamma: float) -> "Regularizer":
        """All coefficients *= gamma (reference ``mult!``)."""
        return Regularizer(x=self.x * gamma, u=self.u * gamma,
                           lam=self.lam * gamma)


@dataclasses.dataclass(frozen=True)
class Penalty:
    """AL penalty pair (reference ``Penalty``, ``src/problem/problem.jl:5-13``).

    The live value evolves in the solver carry and is returned as
    ``SolveResult.rho``; this record mirrors the reference's constructor API.
    """
    rho: float = 1.0
    rho_trial: float = 1.0


@dataclasses.dataclass(frozen=True)
class IBROptions:
    """Iterative-best-response options (reference ``IBROptions``,
    ``src/struct/options.jl:123-136``)."""
    ibr_iter: int = 100
    ordering: Tuple[int, ...] = tuple(range(100))
    delta_min: float = 1e-9
    live_plotting: bool = False
