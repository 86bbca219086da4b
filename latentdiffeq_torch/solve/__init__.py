from .rk import (ButcherTableau, AbstractSolver, Euler, Midpoint, RK4, Tsit5,
                 Dopri5, rk_step, interpolate_dense, n_solution_stages,
                 tableau_f32)
from .fixed import solve_fixed_grid
from .adaptive import AdaptiveConfig, solve_adaptive
from .problem import ODEProblem, SDEProblem, Solution, remake
from .sde import (AbstractSDESolver, EulerMaruyama, StochasticHeun, SRA1,
                  SRIW1, SOSRI, SDEAdaptiveConfig, solve_sde_fixed_grid,
                  solve_sde_adaptive)
from .api import autosize_max_steps, make_options, solve, solve_ensemble

__all__ = ["ButcherTableau", "AbstractSolver", "Euler", "Midpoint", "RK4",
           "Tsit5", "Dopri5", "rk_step", "interpolate_dense",
           "n_solution_stages",
           "tableau_f32", "solve_fixed_grid", "AdaptiveConfig",
           "solve_adaptive", "ODEProblem", "SDEProblem", "Solution",
           "remake", "solve", "solve_ensemble", "make_options",
           "autosize_max_steps", "AbstractSDESolver", "EulerMaruyama",
           "StochasticHeun", "SRA1", "SRIW1", "SOSRI", "SDEAdaptiveConfig",
           "solve_sde_fixed_grid", "solve_sde_adaptive"]
