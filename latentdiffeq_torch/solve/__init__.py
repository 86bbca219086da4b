from .rk import (ButcherTableau, AbstractSolver, Euler, Midpoint, RK4, Tsit5,
                 Dopri5, rk_step, n_solution_stages, tableau_f32)
from .fixed import solve_fixed_grid

__all__ = ["ButcherTableau", "AbstractSolver", "Euler", "Midpoint", "RK4",
           "Tsit5", "Dopri5", "rk_step", "n_solution_stages",
           "tableau_f32",
           "solve_fixed_grid"]
