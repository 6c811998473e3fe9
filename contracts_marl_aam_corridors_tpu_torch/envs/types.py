"""Struct-of-tensors environment state and parameters.

Port of ``contracts_marl_aam_corridors_tpu/envs/types.py``.  Every tensor of
``EnvState``, ``TubeParams`` and ``TimeStep`` carries a leading env axis
``B``: one state object holds the whole batch of environments, and the env
functions are plain functions on those batched tensors.

Entity ordering on the graph axis matches the reference's ``World.entities``
(core.py:574-582): agents, then landmarks.

This slice carries the ``rotate_tube_july`` scenario (point landmark
formation, heading-model dynamics, closed-form integrator, no obstacles,
walls or safety filter).  ``EnvState`` holds only the fields that scenario
reads or writes (no ``prev_proj``, ``obstacle_pos``, ``goal_history``,
safety-filter or sequential-scenario fields), and no RNG key: every random
draw takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config.physics import DynamicsType, RewardWeights, VehicleConfig

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static configuration of the ``rotate_tube_july`` scenario (reference
    ``make_world``, july:154-242).  Field names and defaults are the JAX
    package's; fields of the scenarios, integrators and filters not ported
    yet are absent."""

    cfg: VehicleConfig
    num_agents: int = 3
    num_landmarks: int = 3
    episode_length: int = 25
    world_size: float = 2.0
    total_actions: int = 5
    collision_rew: float = 5.0
    goal_rew: float = 50.0
    formation_rew: float = 1.0
    max_speed: float = 2.0
    reward_weights: RewardWeights = dataclasses.field(default_factory=RewardWeights)
    # entrance-gate ratios (july:611-613)
    gate_front_ratio: float = 0.08
    gate_back_ratio: float = 0.02

    def __post_init__(self):
        if self.cfg.dynamics == DynamicsType.DOUBLE_INTEGRATOR:
            raise NotImplementedError(
                "the torch port carries the heading models (air_taxi, unicycle) only"
            )

    @property
    def num_entities(self) -> int:
        return self.num_agents + self.num_landmarks

    @property
    def node_feat_dim(self) -> int:
        # july (8): [rel_vel(2), rel_pos(2), rel_goal(2), occupied(1), type(1)]
        return 8

    @property
    def obs_dim(self) -> int:
        return 19

    @property
    def num_actions(self) -> int:
        return self.cfg.num_motion_primitives


@dataclasses.dataclass
class TubeParams:
    """Rotated corridor geometry (july ``setup_tube_params``:518-613)."""

    entrance: Tensor  # (B, 2)
    exit: Tensor  # (B, 2)
    width: Tensor  # (B,)
    angle: Tensor  # (B,)
    length: Tensor  # (B,)  nominal 0.8*world_size
    e: Tensor  # (B, 2) unit corridor direction entrance->exit
    n: Tensor  # (B, 2) left-hand normal
    frame_length: Tensor  # (B,) ||exit-entrance|| + 1e-9
    half_width: Tensor  # (B,)


@dataclasses.dataclass
class EnvState:
    """Per-environment episode state, batched over a leading env axis B."""

    agent_states: Tensor  # (B, N, 4) [x, y, theta, v]
    p_dist: Tensor  # (B, N) odometry
    time: Tensor  # (B, N) per-agent clock
    status: Tensor  # (B, N) bool: frozen at goal (july:1187-1191)
    prev_phase: Tensor  # (B, N) long; persists across auto-reset
    phase_reached: Tensor  # (B, N) long
    entry_cooldown: Tensor  # (B, N) long
    tube: TubeParams
    landmark_pos: Tensor  # (B, L, 2)
    occupied: Tensor  # (B, N) landmark_poses_occupied (july:506)
    goal_match: Tensor  # (B, N) long
    goal_tracker: Tensor  # (B, N) long, -1 until the agent freezes on its goal
    goal_reached: Tensor  # (B, N) long nearest-landmark bookkeeping (info)
    spacing_violation: Tensor  # (B, N)
    conformance: Tensor  # (B, N)
    steps_in_corridor: Tensor  # (B, N)
    delta_spacing_sum: Tensor  # (B,)
    times_required: Tensor  # (B, N)
    dists_to_goal: Tensor  # (B, N)
    dist_left_to_goal: Tensor  # (B, N) int-truncated on store (reference parity)
    dist_left_float: Tensor  # (B, N) precise float distance
    num_agent_collisions: Tensor  # (B, N)
    num_obstacle_collisions: Tensor  # (B, N)
    goal_min_time: Tensor  # (B, N)
    t: Tensor  # (B,) long step counter
    sim_time: Tensor  # (B,)


@dataclasses.dataclass
class TimeStep:
    """What the learner consumes per step (``MultiAgentGraphEnv.step``,
    environment.py:1021-1063), batched over envs."""

    obs: Tensor  # (B, N, obs_dim)
    agent_id: Tensor  # (B, N, 1) long
    node_obs: Tensor  # (B, N, E, F)
    adj: Tensor  # (B, E, E)
    reward: Tensor  # (B, N)
    done: Tensor  # (B, N) bool
    info: dict = dataclasses.field(default_factory=dict)
    truncated: Optional[Tensor] = None  # (B, N) bool: time-limit-only done


def map_state(fn, *states):
    """Apply ``fn`` leaf-wise over one or more ``EnvState``s (tube included)."""
    out = {}
    for f in dataclasses.fields(EnvState):
        vals = [getattr(s, f.name) for s in states]
        if f.name == "tube":
            out[f.name] = TubeParams(**{
                g.name: fn(*[getattr(v, g.name) for v in vals])
                for g in dataclasses.fields(TubeParams)
            })
        else:
            out[f.name] = fn(*vals)
    return EnvState(**out)


def env_state_from_numpy(fields: dict, device, dtype=torch.float64) -> EnvState:
    """``EnvState`` from a dict of numpy arrays with a leading env axis.

    ``fields`` is keyed by the JAX package's ``EnvState`` field names, with
    ``tube`` a dict keyed by ``TubeParams`` names (for example built from a
    vmapped JAX state with ``np.asarray`` on each leaf).  Fields this slice
    does not carry (``key``, ``prev_proj``, safety and sequential fields) are
    ignored.  Floating arrays become ``dtype``, integer arrays ``torch.long``,
    booleans stay boolean.
    """

    def conv(a):
        a = np.asarray(a)
        if a.dtype == np.bool_:
            return torch.tensor(a, device=device)
        if np.issubdtype(a.dtype, np.integer):
            return torch.tensor(a, dtype=torch.long, device=device)
        return torch.tensor(a, dtype=dtype, device=device)

    tube = fields["tube"]
    return EnvState(**{
        f.name: (
            TubeParams(**{g.name: conv(tube[g.name]) for g in dataclasses.fields(TubeParams)})
            if f.name == "tube" else conv(fields[f.name])
        )
        for f in dataclasses.fields(EnvState)
    })
