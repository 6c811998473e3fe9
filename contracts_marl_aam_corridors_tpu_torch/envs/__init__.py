from .env import reset as env_reset
from .env import step as env_step
from .types import EnvParams, EnvState, TimeStep, TubeParams, env_state_from_numpy

# NOTE: no bare ``reset``/``step`` re-exports: they would shadow the
# ``envs.reset`` submodule.

__all__ = [
    "env_reset",
    "env_step",
    "EnvParams",
    "EnvState",
    "TimeStep",
    "TubeParams",
    "env_state_from_numpy",
]
