from .buffer import RolloutBuffer, compute_returns
from .mappo import TrainState
from .runner import RolloutCarry, Runner
from .valuenorm import ValueNormState, vn_denormalize, vn_init

__all__ = [
    "RolloutBuffer",
    "compute_returns",
    "TrainState",
    "RolloutCarry",
    "Runner",
    "ValueNormState",
    "vn_init",
    "vn_denormalize",
]
