"""tpu-algames: a batched JAX engine for constrained dynamic games.

Brand-new JAX/XLA implementation of the ALGAMES capabilities
(RoboticExplorationLab/Algames.jl): open-loop generalized Nash equilibria for
N-player trajectory games via a quasi-Newton root-find on the stacked KKT
conditions with an augmented-Lagrangian treatment of inequality constraints.

The public API mirrors the reference export manifest
(``/root/reference/src/Algames.jl:20-165``) in snake_case; the architecture
is accelerator-first: static shapes, dense per-knot blocks, batched
block-tridiagonal KKT factorization, the whole solver under
``jit``/``vmap``/``shard_map``.
"""

from .core.spec import ProblemSpec, spec_from_model
from .core.traj import (PrimalDual, delta_step, init_traj, pack_traj,
                        reset_duals, unpack_step, update_traj, zero_traj)
from .models import (BicycleGame, DoubleIntegratorGame, GameModel,
                     HeteroDoubleIntegratorGame, QuadrotorGame, UnicycleGame,
                     bicycle_game, double_integrator_game,
                     hetero_double_integrator_game, quadrotor_game, rk2_step,
                     rk3_step, rollout_rk3, step_jacobians, unicycle_game)
from .objective import (GameObjective, add_collision_cost, cost_gradient,
                        cost_hessian, expand_vector, game_objective,
                        total_cost)
from .constraints import (ConBlock, CylinderWall, GameConstraints, Wall,
                          Wall3D, add_circle_constraint,
                          add_collision_avoidance, add_control_bound,
                          add_spherical_collision_avoidance, add_state_bound,
                          add_velocity_bound, add_wall_constraint,
                          control_violation, dual_update,
                          dynamics_violation_vector, game_constraints,
                          penalty_update, reset_constraint_duals,
                          reset_constraints, reset_penalties,
                          set_constraint_params, state_violation,
                          update_active_set)
from .problem import (GameProblem, IBROptions, Options, Penalty,
                      Regularizer, SolveResult, game_problem, newton_solve,
                      newton_solve_jit)
from .problem.ibr import (ibr_newton_solve, ibr_newton_solve_jit,
                          ibr_newton_solve_player, player_violations)
from .stats import Statistics
from .utils import scn
from . import presets  # noqa: E402  (BASELINE problem configurations)
from . import parallel  # noqa: E402  (registers ag.parallel.*)
from . import active_set  # noqa: E402
from .mpc import MPCResult, mpc_solve, mpc_solve_jit  # noqa: E402
from . import profiling  # noqa: E402  (device traces, timed_solve/t_elap)
from .runtime import (device_info, enable_compile_cache,  # noqa: E402
                      kkt_method)

__version__ = "0.1.0"
