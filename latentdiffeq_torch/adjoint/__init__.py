from .modes import (AbstractSensealg, BacksolveAdjoint, InterpolatingAdjoint,
                    Unrolled)
from .odeint import SolveOptions, odeint

__all__ = ["AbstractSensealg", "Unrolled", "InterpolatingAdjoint",
           "BacksolveAdjoint", "SolveOptions", "odeint"]
