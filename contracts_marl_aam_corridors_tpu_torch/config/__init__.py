from .flags import build_env_params, build_model_config, parse_all, scenario_kind
from .physics import (
    DynamicsType,
    RewardToggles,
    RewardWeights,
    VehicleConfig,
    vehicle_config,
)

__all__ = [
    "build_env_params",
    "build_model_config",
    "parse_all",
    "scenario_kind",
    "DynamicsType",
    "RewardToggles",
    "RewardWeights",
    "VehicleConfig",
    "vehicle_config",
]
