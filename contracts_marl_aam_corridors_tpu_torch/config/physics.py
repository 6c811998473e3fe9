"""Physical-constant configuration for the three vehicle models.

The port's own copy of ``contracts_marl_aam_corridors_tpu/config/physics.py``
(the port imports nothing of the JAX package).  Counterpart of the reference's
``multiagent/config.py`` (classes ``AirTaxiConfig`` at :4-33,
``UnicycleVehicleConfig`` at :36-53, ``DoubleIntegratorConfig`` at :94-116,
``RewardWeightConfig`` at :132-143 and ``RewardBinaryConfig`` at :146-155), as
immutable dataclasses: a change of vehicle model is a change of Python
branch, never a tensor-level branch inside the step.
"""
from __future__ import annotations

import dataclasses
import enum
import math


class DynamicsType(enum.IntEnum):
    """Mirrors ``EntityDynamicsType`` (reference ``multiagent/core.py:23-26``)."""

    DOUBLE_INTEGRATOR = 0
    UNICYCLE = 1
    AIR_TAXI = 2


KNOTS_TO_KM_S = 0.514444 * 0.001
FT_TO_KM = 0.0003048


@dataclasses.dataclass(frozen=True)
class VehicleConfig:
    """Constants shared by all vehicle models.

    Velocity/acceleration bounds, the integration timestep, goal thresholds and
    the coordination (communication/graph) range.  ``accel`` bounds are the raw
    motion-primitive table values *before* the environment's action-sensitivity
    multiplier (reference ``multiagent/environment.py:460-463`` multiplies every
    decoded action by ``sensitivity`` = ``agent.accel`` or 5.0).
    """

    dynamics: DynamicsType
    v_min: float
    v_max: float
    v_nominal: float
    accel_min: float
    accel_max: float
    angular_rate_max: float
    accel_options: int
    angrate_options: int
    dt: float
    goal_threshold: float
    goal_heading_threshold: float
    goal_speed_threshold: float
    collision_distance: float
    separation_distance: float
    coordination_range: float
    cbf_rate: float
    engagement_distance: float

    @property
    def num_motion_primitives(self) -> int:
        return self.accel_options * self.angrate_options


AIR_TAXI = VehicleConfig(
    # reference multiagent/config.py:4-33 (AirTaxiConfig)
    dynamics=DynamicsType.AIR_TAXI,
    v_min=60 * KNOTS_TO_KM_S,
    v_max=175 * KNOTS_TO_KM_S,
    v_nominal=110 * KNOTS_TO_KM_S,
    accel_min=-0.001,
    accel_max=0.002,
    angular_rate_max=0.1,
    accel_options=5,
    angrate_options=5,
    dt=1.0,
    goal_threshold=0.35,
    goal_heading_threshold=math.pi / 4,
    goal_speed_threshold=0.03,
    collision_distance=1500 * FT_TO_KM,
    separation_distance=1500 * FT_TO_KM,
    coordination_range=3 * 1.60934,
    cbf_rate=3.0,
    engagement_distance=1.4,
)

UNICYCLE = VehicleConfig(
    # reference multiagent/config.py:36-53 (UnicycleVehicleConfig).
    # COORDINATION_RANGE is not defined there; World.__init__ (core.py:565)
    # reads it unconditionally, so only air_taxi runs unmodified end-to-end in
    # the reference (SURVEY.md §2.1 "latent config gaps").  We adopt the
    # documented COMMUNICATION_RANGE=5 as the coordination range so the
    # unicycle path is actually usable.
    dynamics=DynamicsType.UNICYCLE,
    v_min=0.4,
    v_max=0.75,
    v_nominal=0.5,
    accel_min=-0.5,
    accel_max=0.5,
    angular_rate_max=0.5,
    accel_options=5,
    angrate_options=5,
    dt=0.1,
    goal_threshold=0.2,
    goal_heading_threshold=math.pi / 4,
    goal_speed_threshold=0.03,
    collision_distance=0.4,
    separation_distance=0.4,
    coordination_range=5.0,
    cbf_rate=3.0,
    engagement_distance=0.6,
)

DOUBLE_INTEGRATOR = VehicleConfig(
    # reference multiagent/config.py:94-116 (DoubleIntegratorConfig).  For the
    # DI model accel_{min,max} are the per-axis ACCELX/ACCELY bounds, and
    # v_{min,max} bound per-axis velocity; the speed magnitude cap is
    # sqrt(2)*v_max as in the reference's V_MAX.
    dynamics=DynamicsType.DOUBLE_INTEGRATOR,
    v_min=0.1,
    v_max=1.0,
    v_nominal=0.5,
    accel_min=-1.0,
    accel_max=1.0,
    angular_rate_max=0.0,
    accel_options=3,
    angrate_options=3,
    dt=0.1,
    goal_threshold=0.2,
    goal_heading_threshold=math.pi,
    goal_speed_threshold=0.03,
    collision_distance=0.5,
    separation_distance=0.5,
    coordination_range=5.0,
    cbf_rate=3.0,
    engagement_distance=0.75,
)

_BY_NAME = {
    "air_taxi": AIR_TAXI,
    "unicycle_vehicle": UNICYCLE,
    "double_integrator": DOUBLE_INTEGRATOR,
}


def vehicle_config(name: str) -> VehicleConfig:
    """Look up a vehicle config by the reference's ``--dynamics_type`` string."""
    try:
        return _BY_NAME[name]
    except KeyError:
        raise ValueError(
            f"unknown dynamics_type {name!r}; expected one of {sorted(_BY_NAME)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class RewardWeights:
    """Reference ``RewardWeightConfig`` (multiagent/config.py:132-143)."""

    min_reward: float = -40.0
    max_reward: float = 50.0
    goal_reach: float = 50.0
    safety_violation: float = -20.0
    hj_value: float = -2.0
    potential_conflict: float = -1.0
    diff_from_filtered_action: float = -1.0


@dataclasses.dataclass(frozen=True)
class RewardToggles:
    """Reference ``RewardBinaryConfig`` (multiagent/config.py:146-155).

    All safety reward terms default to off, matching the reference.
    """

    safety_violation: bool = False
    hj_value: bool = False
    potential_conflict: bool = False
    separation_distance_curriculum: bool = False
    initial_phase_use_safety_filter: bool = False
    diff_from_filtered_action: bool = False
