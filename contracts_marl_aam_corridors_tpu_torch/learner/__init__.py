from .buffer import RolloutBuffer, compute_returns
from .mappo import GRMAPPOTrainer, TrainState
from .popart import PopArtState, popart_init
from .runner import RolloutCarry, Runner
from .valuenorm import ValueNormState, vn_denormalize, vn_init, vn_normalize, vn_update

__all__ = [
    "RolloutBuffer",
    "compute_returns",
    "GRMAPPOTrainer",
    "TrainState",
    "PopArtState",
    "popart_init",
    "RolloutCarry",
    "Runner",
    "ValueNormState",
    "vn_init",
    "vn_denormalize",
    "vn_normalize",
    "vn_update",
]
