from . import jax_params, profiler
from .profiler import StepTimer

__all__ = ["jax_params", "profiler", "StepTimer"]
