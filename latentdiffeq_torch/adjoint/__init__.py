from .modes import AbstractSensealg, Unrolled
from .odeint import SolveOptions, odeint

__all__ = ["AbstractSensealg", "Unrolled", "SolveOptions", "odeint"]
