"""Struct-of-tensors environment state and parameters.

Port of ``contracts_marl_aam_corridors_tpu/envs/types.py``.  Every tensor of
``EnvState``, ``TubeParams`` and ``TimeStep`` carries a leading env axis
``B``: one state object holds the whole batch of environments, and the env
functions are plain functions on those batched tensors.

Entity ordering on the graph axis matches the reference's ``World.entities``
(core.py:574-582): agents, then landmarks, then obstacles, then walls.

The port carries the ``rotate_tube_july`` scenario, the exit-gated
``rot_inv``, ``two_phase`` and ``three_phase`` scenarios and ``v4oct``
(the point, circle and line landmark formations, all three vehicle models,
the closed-form and rk45 integrators, obstacles and walls, the safety
filters).  ``EnvState`` holds only the fields those scenarios read or write
(no ``goal_history`` or sequential-scenario fields), and no RNG key: every
random draw takes an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config.physics import DynamicsType, RewardToggles, RewardWeights, VehicleConfig

Tensor = torch.Tensor

SCENARIOS = ("rotate_tube_july", "rot_inv", "two_phase", "three_phase", "v4oct")
FORMATIONS = ("point", "circle", "line")
GATED_SCENARIOS = ("rot_inv", "two_phase", "three_phase")


@dataclasses.dataclass(frozen=True)
class EnvParams:
    """Static configuration of the corridor scenarios (reference
    ``make_world``, july:154-242).  Field names and defaults are the JAX
    package's; fields of the scenarios and filters not ported yet are
    absent."""

    cfg: VehicleConfig
    # 'rotate_tube_july', 'v4oct', or one of the exit-gated 'rot_inv',
    # 'two_phase', 'three_phase'
    scenario: str = "rotate_tube_july"
    num_agents: int = 3
    num_landmarks: int = 3
    num_obstacles: int = 0
    # axis-aligned walls, all at the reference's default geometry
    # (corridor.WALL_*; july:315-323 never places them elsewhere)
    num_walls: int = 0
    episode_length: int = 25
    world_size: float = 2.0
    total_actions: int = 5
    collision_rew: float = 5.0
    goal_rew: float = 50.0
    formation_rew: float = 1.0
    max_speed: float = 2.0
    # landmark placement: 'point', 'circle' or 'line' (envs/reset.py)
    formation_type: str = "point"
    reward_weights: RewardWeights = dataclasses.field(default_factory=RewardWeights)
    # the safety reward terms (all off by default; no flag sets them)
    reward_toggles: RewardToggles = dataclasses.field(default_factory=RewardToggles)
    # the safety filter on the decoded controls (corridor.safety_filter):
    # 'rvo' is ORCA; any other type (the flag's 'hj', 'cbf', 'exp_cbf') is
    # the double integrator's exponential CBF or a heading model's HJ filter
    use_safety_filter: bool = False
    safety_filter_type: str = "hj"
    # entrance-gate ratios (july:611-613)
    gate_front_ratio: float = 0.08
    gate_back_ratio: float = 0.02
    # exit-gate ratios (rot_inv:619-620; two/three_phase use exit_back 0.02)
    exit_back_ratio: float = 0.05
    exit_front_ratio: float = 0.08
    # 'closed_form' (exact, the default) or 'rk45' (the scipy replica)
    integrator: str = "closed_form"
    # parity hook: an agent frozen at its goal takes this heading instead of
    # drawing one (the reference draws U(0, 2pi), core.py:324-333), so that
    # two implementations can be held through whole episodes; no flag sets it
    parity_fixed_reset_theta: Optional[float] = None

    def __post_init__(self):
        if self.scenario not in SCENARIOS:
            raise NotImplementedError(f"the torch port has no {self.scenario!r} scenario")
        if self.formation_type not in FORMATIONS:
            raise ValueError(f"unknown formation_type {self.formation_type!r}")
        if self.gated and self.num_walls:
            # the gated node features have rows for agents, landmarks and
            # obstacles only, while the adjacency also counts the walls: the
            # JAX package's graph is inconsistent there and its train CLI
            # fails on the reshape
            n, l, o, w = self.num_agents, self.num_landmarks, self.num_obstacles, self.num_walls
            raise ValueError(
                f"the {self.scenario} scenario has no graph with walls: its node features "
                f"hold n + l + o = {n + l + o} rows but its adjacency n + l + o + w = "
                f"{n + l + o + w} entities")

    @property
    def num_entities(self) -> int:
        return self.num_agents + self.num_landmarks + self.num_obstacles + self.num_walls

    @property
    def gated(self) -> bool:
        """The exit-gated scenario family (rot_inv, two_phase, three_phase)."""
        return self.scenario in GATED_SCENARIOS

    @property
    def node_feat_dim(self) -> int:
        # july (8): [rel_vel(2), rel_pos(2), rel_goal(2), occupied(1), type(1)]
        # gated (7): rotated into the ego heading, no occupied flag
        # (rot_inv:1690-1740)
        # with walls (13): adds goal_history and the wall corners (july:1765-1767)
        if self.gated:
            return 7
        return 13 if self.num_walls else 8

    @property
    def obs_dim(self) -> int:
        if self.scenario == "rot_inv":
            return 13  # rot_inv:1453-1556
        if self.scenario in ("two_phase", "three_phase"):
            return 15  # adds the heading alignment (2)
        return 19

    @property
    def spawn_jitter_range(self) -> float:
        """Spawn jitter draw bound: U(-ws, ws) everywhere except v4oct's
        hard-coded U(-10, 10) (v4oct:481)."""
        return 10.0 if self.scenario == "v4oct" else self.world_size

    @property
    def fixed_tube_angle(self):
        """v4oct pins the tube angle to -pi/2 instead of drawing it
        (v4oct:547-548); None means draw U(-pi/2, pi/2) (july:530)."""
        return -math.pi / 2 if self.scenario == "v4oct" else None

    @property
    def randomize_tube_length(self) -> bool:
        """two/three_phase draw length += U(-0.3ws, 0.1ws) (two_phase setup)."""
        return self.scenario in ("two_phase", "three_phase")

    @property
    def exit_back(self) -> float:
        # two/three_phase override exit_back_ratio to 0.02
        if self.scenario in ("two_phase", "three_phase"):
            return 0.02
        return self.exit_back_ratio

    @property
    def spawn_jitter_scale(self) -> float:
        """Spawn jitter: 0.2*U (july:462) vs 0.3*U (the gated family)."""
        return 0.3 if self.gated else 0.2

    @property
    def spawn_spacing_div(self) -> float:
        """distance_from_entrance = (ws+k)/5 (july) vs /3 (the gated family)."""
        return 3.0 if self.gated else 5.0

    @property
    def cooldown_steps(self) -> int:
        """phase_reward_cooldown_steps: ep_len/10 (rot_inv:228) or the full
        ep_len (two/three_phase).  july never uses the cooldown in its reward."""
        if self.scenario in ("two_phase", "three_phase"):
            return int(self.episode_length)
        return int(self.episode_length / 10)

    @property
    def num_actions(self) -> int:
        if self.cfg.dynamics == DynamicsType.DOUBLE_INTEGRATOR:
            return self.total_actions
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

    agent_states: Tensor  # (B, N, 4) [x, y, theta, v], or [x, y, vx, vy]
    p_dist: Tensor  # (B, N) odometry
    time: Tensor  # (B, N) per-agent clock
    status: Tensor  # (B, N) bool: frozen at goal (july:1187-1191)
    prev_phase: Tensor  # (B, N) long; persists across auto-reset
    phase_reached: Tensor  # (B, N) long
    entry_cooldown: Tensor  # (B, N) long
    prev_proj: Tensor  # (B, N) rot_inv progress-reward state (rot_inv:1265-1275)
    tube: TubeParams
    landmark_pos: Tensor  # (B, L, 2)
    obstacle_pos: Tensor  # (B, O, 2); the reset never places them: zeros
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
    # v4oct's stale position cache (B, N, 2), None elsewhere.  v4oct keys its
    # cache on a nonexistent ``world.step_count`` (v4oct:334-341), so the
    # cache is filled once, by the first observation, and never again: it
    # holds the first reset's spawn through every step and episode after.
    # Neighbour ranking and agent collisions read it.
    frozen_pos: Optional[Tensor] = None
    # the safety filter's bookkeeping (core.py:691-736), zero at a reset and
    # written by a filtered step: ||u_raw - u_filtered|| and the "filtered"
    # flags, (B, N)
    action_diff: Optional[Tensor] = None
    safety_violations: Optional[Tensor] = None


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
    """Apply ``fn`` leaf-wise over one or more ``EnvState``s (tube included;
    a field that is None in every state stays None)."""
    out = {}
    for f in dataclasses.fields(EnvState):
        vals = [getattr(s, f.name) for s in states]
        if all(v is None for v in vals):
            out[f.name] = None
        elif f.name == "tube":
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
    does not carry (``key``, ``goal_history`` and the sequential fields)
    are ignored, and ``frozen_pos`` is None where ``fields`` has none.
    Floating arrays become ``dtype``, integer arrays ``torch.long``,
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
    out = {}
    for f in dataclasses.fields(EnvState):
        if f.name == "tube":
            out[f.name] = TubeParams(**{g.name: conv(tube[g.name])
                                        for g in dataclasses.fields(TubeParams)})
        elif f.name == "frozen_pos" and fields.get(f.name) is None:
            out[f.name] = None
        else:
            out[f.name] = conv(fields[f.name])
    return EnvState(**out)
