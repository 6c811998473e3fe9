from .physics import (
    DynamicsType,
    RewardToggles,
    RewardWeights,
    VehicleConfig,
    vehicle_config,
)

__all__ = [
    "DynamicsType",
    "RewardToggles",
    "RewardWeights",
    "VehicleConfig",
    "vehicle_config",
]
