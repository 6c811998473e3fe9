"""The rotated-corridor scenario step on a batch of envs (port of
``envs/corridor.py``: ``rotate_tube_july``, the exit-gated rot_inv,
two_phase and three_phase, and v4oct).

Port of the composition of ``MultiAgentGraphEnv.step``
(multiagent/environment.py:1021-1063), ``World.step``
(multiagent/core.py:687-756) and the july scenario callbacks
``observation``/``reward``/``graph_observation``/``info_callback``
(custom_scenarios/nav_metered_one_goal_graph_rotate_tube_july.py).

The reference evaluates the callbacks per agent, in id order, with in-place
mutation: agent i's reward sees the status flips and velocity resets of
agents j<i in the same step, the phase machine runs twice per agent per step
(once from ``observation``, once from ``reward``), and every agent receives
the final masked adjacency.  The ordering is kept literally: observations
are vectorized over agents (each reads only its own mutable state), rewards
run as a Python loop over the small agent count on tensors batched over
envs, and the adjacency comes from the post-loop state.  two_phase and
three_phase interleave the sweep (environment.py:1036-1052): agent i's
observation row is taken after the rewards of agents j < i, so it sees their
status flips and cooldown decrements.

The exit-gated scenarios round through float32 at the reference's exact
sites (``_f32r``: rot_inv:1469-1556, 1690-1740), which the float64 parity
with the JAX package needs; in float32 those roundings are no-ops.

v4oct's observation and reward read a position cache filled once, at the
first reset (``EnvState.frozen_pos``); its phase is 0 or 1 and its agents
never freeze.  Every vehicle model runs in every scenario: heading, speed
and velocity come from ``dynamics.heading_of``/``speed_of``/``velocity_of``,
and the double integrator's freeze zeroes the velocity without a draw.

Obstacles and walls enter the graph after the landmarks, with zero
velocity, and cost an agent on them 3 collision penalties (july, v4oct,
rot_inv).  The reset never places obstacles (they stay at the origin) and
every wall has the reference's default geometry; with walls the july and
v4oct node rows take the 13-dim layout.  The gated scenarios' node rows
have no wall rows, so ``EnvParams`` refuses them with walls.

With ``use_safety_filter`` the decoded controls of every agent, frozen ones
included, pass the safety filter before the integration
(``safety_filter``; core.py:691-736), and the july reward adds the safety
terms its ``reward_toggles`` turn on between its two clips.  The gated and
v4oct rewards take no such terms, but their steps are filtered too.

Sequential and fairassign are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..config.physics import DynamicsType
from ..ops import distance as dist_ops
from ..safety import cbf as cbf_mod, hj as hj_mod, rvo as rvo_mod
from . import actions as action_mod
from . import dynamics
from . import tube as tube_mod
from .types import EnvParams, EnvState, TimeStep, TubeParams


Tensor = torch.Tensor

AGENT_SIZE = 0.06  # Entity.size default (core.py:385)
ENTITY_AGENT, ENTITY_LANDMARK, ENTITY_OBSTACLE, ENTITY_WALL = 0.0, 1.0, 2.0, 3.0

# Wall geometry: the reference creates walls with the class defaults and
# never moves them (july:315-323; core.py:354-368): horizontal, axis_pos
# 0.0, endpoints (-1, 1), width 0.1.  Several walls coincide.
WALL_AXIS_POS = 0.0
WALL_ENDPOINTS = (-1.0, 1.0)
WALL_WIDTH = 0.1

# fields the per-agent reward sweep writes in place (step() hands it copies)
_REWARD_WRITES = (
    "status", "prev_phase", "phase_reached", "entry_cooldown", "goal_tracker",
    "spacing_violation", "conformance", "steps_in_corridor", "delta_spacing_sum",
    "prev_proj",
)


def _wall_positions(params: EnvParams, like: Tensor) -> Tensor:
    """The walls' nominal centres (B, W, 2) for the entity distances."""
    cx = (WALL_ENDPOINTS[0] + WALL_ENDPOINTS[1]) / 2.0
    return like.new_tensor([cx, WALL_AXIS_POS]).expand(like.shape[0], params.num_walls, 2)


def _entity_positions(params: EnvParams, pos: Tensor, state: EnvState) -> Tensor:
    """Agents, landmarks, obstacles and walls (B, E, 2)."""
    parts = [pos, state.landmark_pos, state.obstacle_pos]
    if params.num_walls:
        parts.append(_wall_positions(params, pos))
    return torch.cat(parts, dim=1)


def _wall_collision(pos: Tensor) -> Tensor:
    """Inside the axis-aligned wall box with 1.5*size margins (july:877-890),
    for agent positions (..., 2)."""
    m = 1.5 * AGENT_SIZE
    x, y = pos[..., 0], pos[..., 1]
    in_y = (WALL_AXIS_POS - m <= y) & (y <= WALL_AXIS_POS + m)
    in_x = (WALL_ENDPOINTS[0] - m <= x) & (x <= WALL_ENDPOINTS[1] + m)
    return in_y & in_x


def _obstacle_collision(params: EnvParams, obstacle_pos: Tensor, pos: Tensor) -> Tensor:
    """july ``is_obstacle_collision``:864-890, obstacles and walls: positions
    (B, K, 2) against ``obstacle_pos`` (B, O, 2) -> (B, K) bool."""
    hit = torch.zeros(pos.shape[:-1], dtype=torch.bool, device=pos.device)
    if params.num_obstacles:
        d = _norm(obstacle_pos[:, None, :, :] - pos[:, :, None, :])  # (B, K, O)
        hit = hit | (d < 2.0 * (AGENT_SIZE + AGENT_SIZE)).any(dim=-1)
    if params.num_walls:
        hit = hit | _wall_collision(pos)
    return hit


def _obstacle_penalty(params: EnvParams, state: EnvState, pos_i: Tensor) -> Tensor:
    """The -3*collision_rew term of agent positions ``pos_i`` (B, 2) on an
    obstacle or a wall (july:1117-1124; v4oct, rot_inv alike), (B,)."""
    hit = _obstacle_collision(params, state.obstacle_pos, pos_i[:, None])[:, 0]
    return (params.collision_rew * 3) * hit.to(pos_i.dtype)


def _decrement_cooldown(cooldown: Tensor) -> Tensor:
    """Each ``get_agent_phase`` call decrements a positive cooldown (july:702-704)."""
    return cooldown - (cooldown > 0).to(cooldown.dtype)


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, M, D), idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def goal_positions(landmark_pos: Tensor, goal_match: Tensor) -> Tensor:
    """``landmark_pos[goal_match]`` per env, (B, K, 2), with the index
    clamped to the last landmark as a JAX gather clamps it: an env with more
    agents than landmarks sends the extra agents to the last landmark."""
    idx = goal_match.clamp(max=landmark_pos.shape[1] - 1)
    return torch.gather(landmark_pos, 1, idx[..., None].expand(*idx.shape, 2))


def _norm(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _agent_ids(params: EnvParams, B: int, device) -> Tensor:
    n = params.num_agents
    return torch.arange(n, device=device).expand(B, n)[..., None]


# ---------------------------------------------------------------------------
# The exit-gated scenarios (rot_inv, two_phase, three_phase)
# ---------------------------------------------------------------------------


def _f32r(x: Tensor) -> Tensor:
    """Round through float32, keeping the working type (the reference's
    ``.astype(np.float32)`` sites, rot_inv:1469-1556)."""
    return x.to(torch.float32).to(x.dtype)


def _rot_into_heading(v: Tensor, heading: Tensor) -> Tensor:
    """World-frame vectors (..., 2) into the ego heading frame, ``heading``
    broadcast against ``v[..., 0]`` (utils.py
    ``get_rotated_position_from_relative``:66-75: R = [[cos, sin], [-sin, cos]])."""
    c, s = torch.cos(heading), torch.sin(heading)
    return torch.stack([c * v[..., 0] + s * v[..., 1], -s * v[..., 0] + c * v[..., 1]], dim=-1)


def _gate_levels(params: EnvParams) -> int:
    return {"rot_inv": 0, "two_phase": 1, "three_phase": 2}[params.scenario]


def _gated_phase(params: EnvParams, tube: TubeParams, pos: Tensor, prev: Tensor,
                 reached: Tensor) -> Tensor:
    """The gated phase machine for positions (B, K, 2), prev/reached (B, K)."""
    return tube_mod.agent_phase_gated(
        tube, pos, prev, reached,
        params.gate_front_ratio, params.gate_back_ratio,
        params.exit_back, params.exit_front_ratio,
        in_tube_exit_levels=_gate_levels(params),
    )


def _corridor_heading_error(tube: TubeParams, heading: Tensor) -> Tensor:
    """Heading minus the corridor axis, wrapped into [-pi, pi); ``heading``
    (B, ...) with the tube's (B,) axis broadcast."""
    axis = torch.atan2(tube.e[:, 1], tube.e[:, 0]).reshape((-1,) + (1,) * (heading.ndim - 1))
    return torch.remainder(heading - axis + math.pi, 2 * math.pi) - math.pi


def _two_nearest_rel(params: EnvParams, pos: Tensor, status: Tensor) -> Tensor:
    """Each agent's two nearest neighbours' relative vectors (B, n, 2, 2),
    zero where excluded.  rot_inv counts done agents (rot_inv:1477-1494);
    two/three_phase skip ``status`` agents.  Excluded distances are inf and
    the sort is stable, so ties order by index as ``jnp.argsort`` does."""
    n = params.num_agents
    rel = pos[:, None, :, :] - pos[:, :, None, :]  # [b, i, j] = pos_j - pos_i
    d = _norm(rel)
    exclude = torch.eye(n, dtype=torch.bool, device=pos.device).expand_as(d)
    if params.scenario in ("two_phase", "three_phase"):
        exclude = exclude | status[:, None, :]
    d = torch.where(exclude, math.inf, d)
    order = torch.argsort(d, dim=-1, stable=True)[..., :2]  # (B, n, 2)
    vecs = torch.gather(rel, 2, order[..., None].expand(*order.shape, 2))
    valid = torch.gather(~exclude, 2, order)
    return vecs * valid[..., None]


def _gated_obs(params: EnvParams, state: EnvState, values: Tensor) -> Tensor:
    """The 13-dim rot_inv observation (rot_inv:1453-1556), or the 15-dim
    two/three_phase one (adds the heading alignment; two_phase's goal is the
    tube exit), for every agent from ``values`` and the current status:
    [cos, sin heading, speed, rot goal(2), rot two nearest(4), s/L, y/hw,
    exit distance/L, (cos, sin heading error), phase]."""
    n = params.num_agents
    pos = values[..., :2]
    heading = dynamics.heading_of(values, params.cfg)
    speed = dynamics.speed_of(values, params.cfg)
    tube = state.tube
    phase = _gated_phase(params, tube, pos, state.prev_phase, state.phase_reached)

    if params.scenario == "two_phase":
        goal_vec = _f32r(tube.exit)[:, None, :] - pos  # the exit cast to float32 first
    else:
        goal_vec = goal_positions(state.landmark_pos, state.goal_match) - pos
    rot_goal = _rot_into_heading(goal_vec, heading)
    # the neighbour vectors are cast to float32 BEFORE the rotation (rot_inv:1489-1492)
    nb = _f32r(_two_nearest_rel(params, pos, state.status))
    rot_nb = _rot_into_heading(nb, heading[..., None]).reshape(pos.shape[0], n, 4)

    s, y = tube_mod.tube_coords(tube, pos)
    L = tube.frame_length[:, None]
    cols = [
        torch.cos(heading)[..., None],
        torch.sin(heading)[..., None],
        speed[..., None],
        rot_goal,
        rot_nb,
        torch.clamp(s / L, -2.0, 2.0)[..., None],
        torch.clamp(y / (tube.half_width[:, None] + 1e-9), -2.0, 2.0)[..., None],
        (tube_mod.exit_gate_distance(tube, s, y) / (L + 1e-9))[..., None],
    ]
    if params.scenario in ("two_phase", "three_phase"):
        he = _corridor_heading_error(tube, heading)
        cols += [torch.cos(he)[..., None], torch.sin(he)[..., None]]
    cols.append(phase[..., None].to(pos.dtype))
    return _f32r(torch.cat(cols, dim=-1))  # the final .astype(np.float32)


def _observations_gated(params: EnvParams, state: EnvState) -> tuple[EnvState, Tensor]:
    """Every agent's gated observation from the state's positions, with
    phase call #1's cooldown decrement (the gated machine changes no
    ``previous_phase``)."""
    obs = _gated_obs(params, state, state.agent_states)
    return dataclasses.replace(state, entry_cooldown=_decrement_cooldown(state.entry_cooldown)), obs


def _obs_gated_row(params: EnvParams, state: EnvState, values: Tensor, i: int) -> Tensor:
    """Agent i's observation row (B, obs_dim) from the CURRENT values and
    status, for the interleaved two/three_phase sweep where the rewards of
    agents j < i already changed them this step (environment.py:1036-1052).
    Decrements agent i's cooldown in place."""
    state.entry_cooldown[:, i] = _decrement_cooldown(state.entry_cooldown[:, i])
    return _gated_obs(params, state, values)[:, i]


def _node_obs_gated(params: EnvParams, state: EnvState, values: Tensor, i: int) -> Tensor:
    """Rotation-invariant node features wrt ego agent i, (B, E, 7)
    (rot_inv ``_get_entity_feat_relative``:1690-1740): [rot rel_vel(2),
    rot rel_pos(2), rot rel_goal(2), entity_type(1)]; rows for agents,
    landmarks and obstacles."""
    n, l, o = params.num_agents, params.num_landmarks, params.num_obstacles
    B = values.shape[0]
    # positions and velocities are cast to float32 BEFORE the relative
    # subtraction (rot_inv:1702-1715)
    pos = _f32r(values[..., :2])
    vel = _f32r(dynamics.velocity_of(values, params.cfg))
    heading_i = dynamics.heading_of(values[:, i], params.cfg)[:, None]
    lm = _f32r(state.landmark_pos)
    entity_pos = torch.cat([pos, lm, _f32r(state.obstacle_pos)], dim=1)
    entity_vel = torch.cat([vel, vel.new_zeros(B, l + o, 2)], dim=1)
    pos_i = pos[:, i : i + 1]
    # float32 minus float32 is computed in float32 by numpy: the differences
    # round too
    rel_pos = _f32r(_rot_into_heading(_f32r(entity_pos - pos_i), heading_i))
    rel_vel = _f32r(_rot_into_heading(_f32r(entity_vel - vel[:, i : i + 1]), heading_i))
    if params.scenario == "two_phase":
        goal_world = _f32r(state.tube.exit)[:, None, :].expand(B, n, 2)
    else:
        goal_world = goal_positions(lm, state.goal_match)
    goal_rel = _f32r(_rot_into_heading(_f32r(goal_world - pos_i), heading_i))
    rel_goal = torch.cat([goal_rel, rel_pos[:, n:]], dim=1)
    etype = torch.cat([pos.new_full((B, n), ENTITY_AGENT), pos.new_full((B, l), ENTITY_LANDMARK),
                       pos.new_full((B, o), ENTITY_OBSTACLE)], dim=1)[..., None]
    return torch.cat([rel_vel, rel_pos, rel_goal, etype], dim=-1)


def _reward_one_agent_gated(
    params: EnvParams, state: EnvState, values: Tensor, i: int, gen: torch.Generator
) -> Tensor:
    """Reward for agent ``i`` in the exit-gated family (rot_inv ``reward``
    :1122-1343 and its two/three_phase variants), with its in-step
    mutations: writes the ``_REWARD_WRITES`` fields of ``state`` and row
    ``i`` of ``values`` in place, in agent-id order like the july reward."""
    cfg = params.cfg
    scenario = params.scenario
    dtype = values.dtype
    n = params.num_agents
    pos = values[..., :2].clone()
    pos_i = pos[:, i]
    pos_ii = pos[:, i : i + 1]
    tube = state.tube
    dev = values.device

    # phase call #2 (get_agent_phase inside reward): decrements agent i's cooldown
    state.entry_cooldown[:, i] = _decrement_cooldown(state.entry_cooldown[:, i])
    prev_i = state.prev_phase[:, i].clone()
    reached_i = state.phase_reached[:, i].clone()
    status_i = state.status[:, i].clone()
    cur = _gated_phase(params, tube, pos_ii, prev_i[:, None], reached_i[:, None])[:, 0]

    # collisions: rot_inv x4 agent, x3 obstacle (rot_inv:1134-1142);
    # three_phase x1 agent; two_phase none
    not_self = torch.arange(n, device=dev) != i
    colliding = (
        (_norm(pos - pos_i[:, None]) < cfg.separation_distance)
        & ~state.status
        & ~status_i[:, None]
        & not_self
    )
    rew = torch.zeros_like(pos_i[:, 0])
    if scenario == "rot_inv":
        rew = rew - (params.collision_rew * 4) * colliding.sum(dim=-1).to(dtype)
        if params.num_obstacles:  # the gated scenarios refuse walls
            rew = rew - _obstacle_penalty(params, state, pos_i)
    elif scenario == "three_phase":
        rew = rew - params.collision_rew * colliding.sum(dim=-1).to(dtype)

    # front/back spacing neighbours by own heading (rot_inv:1149-1161)
    heading = dynamics.heading_of(values[:, i], cfg)
    rel = pos - pos_i[:, None]
    proj_h = rel[..., 0] * torch.cos(heading)[:, None] + rel[..., 1] * torch.sin(heading)[:, None]
    front_mask = not_self & (proj_h > 0)
    back_mask = not_self & (proj_h <= 0)
    front_idx = torch.where(front_mask, proj_h, math.inf).argmin(dim=-1)
    back_idx = torch.where(back_mask, proj_h, -math.inf).argmax(dim=-1)
    desired = cfg.separation_distance

    s, y = tube_mod.tube_coords(tube, pos_ii)
    in_tube = tube_mod.in_tube_rect(tube, s, y)[:, 0]
    valid_exit = tube_mod.in_exit_gate(tube, s, y, params.exit_back, params.exit_front_ratio)[:, 0]
    in_gate = tube_mod.in_entrance_gate(
        tube, s, y, params.gate_front_ratio, params.gate_back_ratio)[:, 0]
    proj = tube_mod.entrance_projection(tube, pos_ii)[0][:, 0]

    # phase-skip penalty (rot_inv:1177-1181)
    rew = rew - params.goal_rew * ((cur == 2) & (cur > prev_i + 1)).to(dtype)

    # transition bonuses (rot_inv:1189-1216)
    trans = (cur == prev_i + 1) & (reached_i == cur - 1)
    cooldown_i = state.entry_cooldown[:, i]
    enter_bonus = trans & (cur == 1) & in_gate & (cooldown_i == 0)
    exit_bonus = trans & (cur == 2)
    rew = rew + params.goal_rew * (enter_bonus | exit_bonus).to(dtype)
    state.entry_cooldown[:, i] = torch.where(
        enter_bonus, torch.full_like(cooldown_i, params.cooldown_steps), cooldown_i)
    reached_i = torch.where(enter_bonus, torch.ones_like(reached_i), reached_i)
    reached_i = torch.where(exit_bonus, torch.full_like(reached_i, 2), reached_i)

    # two_phase freezes at the exit transition (+5g, status, reset velocity)
    newly = torch.zeros_like(status_i)
    if scenario == "two_phase":
        newly = exit_bonus & ~status_i
        rew = rew + newly.to(dtype) * params.goal_rew * 5

    # heading error to the corridor axis (two/three_phase penalties)
    he = _corridor_heading_error(tube, heading).abs()

    is_p0_b = cur == 0
    is_p0 = is_p0_b.to(dtype)
    is_p1_b = cur == 1
    is_p1 = is_p1_b.to(dtype)
    demote = (cur == 2) & (reached_i == 0)
    goal_branch = (cur == 2) & ~demote

    # phase 0: distance to the entrance edge (rot_inv:1227-1232)
    egd = tube_mod.entrance_gate_distance(tube, s, y)[:, 0]
    rew = rew - is_p0 * egd
    if scenario in ("two_phase", "three_phase"):
        near_gate = egd < params.world_size * 0.1
        rew = rew - (is_p0_b & near_gate).to(dtype) * he * params.formation_rew * 0.5

    # phase 1 (rot_inv:1244-1276)
    front_diff = _norm(_gather_rows(pos, front_idx[:, None])[:, 0] - pos_i) - desired
    back_diff = _norm(_gather_rows(pos, back_idx[:, None])[:, 0] - pos_i) - desired
    zero = torch.zeros_like(front_diff)
    spacing_error = torch.where(
        front_mask.any(dim=-1) & (front_diff < 0), -front_diff, zero
    ) + torch.where(back_mask.any(dim=-1) & (back_diff < 0), -back_diff, zero)
    state.spacing_violation[:, i] += (is_p1_b & (spacing_error > 0)).to(dtype)
    if scenario in ("rot_inv", "three_phase"):
        state.delta_spacing_sum += is_p1 * spacing_error
    state.steps_in_corridor[:, i] += is_p1
    rew = rew - is_p1 * spacing_error * params.formation_rew
    rew = rew - is_p1 * tube_mod.exit_gate_distance(tube, s, y)[:, 0]
    if scenario == "rot_inv":
        progress_gain = params.goal_rew / (tube.length * 10.0)
        # prev_proj is float32 in the reference (rot_inv:374): stored rounded
        delta_proj = proj - state.prev_proj[:, i]
        rew = rew + is_p1 * progress_gain * torch.clamp(delta_proj, min=-0.05)
        state.prev_proj[:, i] = torch.where(
            is_p1_b, _f32r(proj).to(state.prev_proj.dtype), state.prev_proj[:, i])
    else:
        rew = rew - is_p1 * he * params.formation_rew * 0.1

    # phase 2: goal seek and freeze (rot_inv:1286-1301; three_phase the same
    # without goal_tracker; two_phase has no phase-2 term, it froze at the exit)
    if scenario in ("rot_inv", "three_phase"):
        goal_pos = goal_positions(state.landmark_pos, state.goal_match[:, i : i + 1])[:, 0]
        dist_goal = _norm(pos_i - goal_pos)
        at_goal = goal_branch & (dist_goal < cfg.goal_threshold)
        newly = at_goal & ~status_i
        rew = rew + newly.to(dtype) * params.goal_rew * 5
        rew = rew - (goal_branch & (dist_goal >= cfg.goal_threshold)).to(dtype) * dist_goal
    if scenario == "rot_inv":
        state.goal_tracker[:, i] = torch.where(
            newly, state.goal_match[:, i], state.goal_tracker[:, i])

    # the freeze resets the velocity (core.py:324-333)
    row = values[:, i]
    stopped = dynamics.stopped_row(row, cfg, gen, params.parity_fixed_reset_theta)
    values[:, i] = torch.where(newly[:, None], stopped, row)
    state.status[:, i] = status_i | newly

    # conformance / phase_reached / regression (rot_inv:1306-1325)
    cur2 = torch.where(demote, torch.zeros_like(cur), cur)
    state.conformance[:, i] += ((reached_i == 1) & (cur2 == 0)).to(dtype)
    new_pr = torch.maximum(reached_i, cur2)
    rew = rew - params.collision_rew * (cur2 < prev_i).to(dtype)
    rew = rew - params.collision_rew * (cur2 < new_pr).to(dtype)

    # in the tube but not in phase 1 (rot_inv:1327-1329; three_phase also
    # requires not in the exit gate)
    bad_in_tube = in_tube & (cur2 != 1)
    if scenario == "three_phase":
        bad_in_tube = bad_in_tube & ~valid_exit
    rew = rew - params.collision_rew * bad_in_tube.to(dtype)

    # skipped corridor (rot_inv:1332-1334)
    rew = rew - params.goal_rew * ((s[:, 0] > tube.frame_length) & (new_pr < 1)).to(dtype)

    state.phase_reached[:, i] = new_pr
    state.prev_phase[:, i] = cur2
    return torch.clamp(rew, -4 * params.collision_rew, params.goal_rew * 5)


def observations(params: EnvParams, state: EnvState) -> tuple[EnvState, Tensor]:
    """The 19-dim observation for every agent (july:1337-1463).

    Layout: [pos(2), vel(2), rel_goal(2), goal_occupied(1), rel_second(2)
    (= rel_goal), two nearest neighbors rel pos(4), rel_entrance(2),
    rel_exit(2), tube_width(1), phase(1)].  Performs phase-machine call #1
    for each agent (cooldown decrement and the possible 1->2
    ``previous_phase`` mutation), as the reference's ``observation`` does.
    The gated scenarios take their own observation (``_gated_obs``).
    """
    if params.gated:
        return _observations_gated(params, state)
    n = params.num_agents
    pos = state.agent_states[..., :2]
    vel = dynamics.velocity_of(state.agent_states, params.cfg)
    goal = goal_positions(state.landmark_pos, state.goal_match)
    rel_goal = goal - pos
    occupied = torch.gather(state.occupied, 1, state.goal_match)[..., None]
    if params.scenario == "v4oct":
        # stale-cache neighbours (v4oct:1290-1308); v4oct has no entry
        # cooldown and never advances previous_phase (v4oct:938, dead code)
        neighbors = _v4oct_two_nearest(params, state, pos)
        phase = tube_mod.agent_phase_v4oct(state.tube, pos)
        cooldown, new_prev = state.entry_cooldown, state.prev_phase
    else:
        neighbors = dist_ops.two_nearest_neighbors(pos)
        cooldown = _decrement_cooldown(state.entry_cooldown)
        phase, new_prev = tube_mod.agent_phase(
            state.tube, pos, state.prev_phase, params.gate_front_ratio, params.gate_back_ratio
        )
    tube = state.tube
    B = pos.shape[0]
    obs = torch.cat(
        [
            pos,
            vel,
            rel_goal,
            occupied,
            rel_goal,
            neighbors,
            tube.entrance[:, None, :] - pos,
            tube.exit[:, None, :] - pos,
            tube.width[:, None, None].expand(B, n, 1),
            phase[..., None].to(pos.dtype),
        ],
        dim=-1,
    )
    return dataclasses.replace(state, entry_cooldown=cooldown, prev_phase=new_prev), obs


def _node_obs_for_agent(params: EnvParams, state: EnvState, values: Tensor, i: int) -> Tensor:
    """Relative node features wrt ego agent i (july:1694-1771), (B, E, 8),
    or with walls (B, E, 13); the gated scenarios' (B, E, 7) come from
    ``_node_obs_gated``."""
    if params.gated:
        return _node_obs_gated(params, state, values, i)
    n, l, o, w = params.num_agents, params.num_landmarks, params.num_obstacles, params.num_walls
    pos = values[..., :2]
    vel = dynamics.velocity_of(values, params.cfg)
    B = pos.shape[0]
    entity_pos = _entity_positions(params, pos, state)
    entity_vel = torch.cat([vel, vel.new_zeros(B, l + o + w, 2)], dim=1)
    pos_i = pos[:, i : i + 1]
    rel_pos = entity_pos - pos_i
    rel_vel = entity_vel - vel[:, i : i + 1]
    # agents: goal = landmark_poses[entity.id]; the others: their own rel_pos
    goal_idx = torch.arange(n, device=pos.device) % l
    agent_goal_rel = state.landmark_pos[:, goal_idx] - pos_i
    rel_goal = torch.cat([agent_goal_rel, rel_pos[:, n:]], dim=1)
    occ_agents = torch.gather(state.occupied, 1, state.goal_match)
    occupied = torch.cat([occ_agents, occ_agents.new_ones(B, l + o + w)], dim=1)[..., None]
    etype = torch.cat(
        [pos.new_full((B, n), ENTITY_AGENT), pos.new_full((B, l), ENTITY_LANDMARK),
         pos.new_full((B, o), ENTITY_OBSTACLE), pos.new_full((B, w), ENTITY_WALL)], dim=1
    )[..., None]
    base = [rel_vel, rel_pos, rel_goal, occupied]
    if w == 0:
        return torch.cat(base + [etype], dim=-1)
    # the 13-dim wall layout (july:1765-1767): [rel_vel, rel_pos, rel_goal,
    # occupied, goal_history, o_corner(2), d_corner(2), type]; goal_history
    # is zero, and the corners, relative to the ego agent, only on wall rows
    E = n + l + o + w
    corner = lambda x, y: (pos_i.new_tensor([x, y]) - pos_i).expand(B, w, 2)
    pad = lambda c: torch.cat([c.new_zeros(B, E - w, 2), c], dim=1)
    o_corner = pad(corner(WALL_ENDPOINTS[0], WALL_AXIS_POS + WALL_WIDTH / 2))
    d_corner = pad(corner(WALL_ENDPOINTS[1], WALL_AXIS_POS - WALL_WIDTH / 2))
    return torch.cat(base + [pos.new_zeros(B, E, 1), o_corner, d_corner, etype], dim=-1)


def masked_adjacency(params: EnvParams, state: EnvState, values: Tensor) -> Tensor:
    """Distance-magnitude adjacency (B, E, E) with done rows/cols zeroed
    (july:1625-1648): agents disconnect once ``status`` is set; a landmark
    disconnects when any ``goal_tracker`` entry equals its id; obstacles and
    walls never do."""
    l = params.num_landmarks
    adj = dist_ops.pairwise_distances(_entity_positions(params, values[..., :2], state))
    lm = torch.arange(l, device=adj.device)
    landmark_done = (state.goal_tracker[:, :, None] == lm).any(dim=1)
    fixed = landmark_done.new_zeros(adj.shape[0], params.num_obstacles + params.num_walls)
    keep = ~torch.cat([state.status, landmark_done, fixed], dim=1)
    return adj * keep[:, :, None] * keep[:, None, :]


def _v4oct_two_nearest(params: EnvParams, state: EnvState, pos: Tensor) -> Tensor:
    """Each agent's two nearest neighbours (B, n, 4), ranked by the pairwise
    distances of v4oct's stale cache; the vectors are the cached neighbour
    position minus the CURRENT ego position (v4oct:1296-1308).  With two
    agents the second slot is the agent itself at distance inf: zero."""
    n = params.num_agents
    B = pos.shape[0]
    frozen = state.frozen_pos
    d = _norm(frozen[:, None, :, :] - frozen[:, :, None, :])  # [b, i, j] = |f_j - f_i|
    d = torch.where(torch.eye(n, dtype=torch.bool, device=pos.device), math.inf, d)
    order = torch.argsort(d, dim=-1, stable=True)[..., :2]  # (B, n, 2), jnp.argsort's ties
    rel = _gather_rows(frozen, order.reshape(B, -1)).reshape(B, n, -1, 2) - pos[:, :, None, :]
    valid = torch.isfinite(torch.gather(d, 2, order))
    return (rel * valid[..., None]).reshape(B, n, -1)


def _reward_one_agent_v4oct(params: EnvParams, state: EnvState, values: Tensor,
                            i: int) -> Tensor:
    """v4oct ``reward`` for agent ``i`` (v4oct:883-938; all after the
    mid-function ``return`` is dead code).  Writes ``steps_in_corridor`` of
    ``state`` in place and nothing else:

    * agent collisions test the CACHED positions and ``break`` at the first
      hit: at most one -4*collision_rew penalty, fixed as agents move
      (v4oct:893-900, 838-841), on squared distances (dist2 < sep2);
    * the current position on an obstacle or a wall pays -3*collision_rew;
    * phase 0 pays -dist(entrance), phase 1 -dist(exit); phase 2 and the
      goal branch are unreachable, so no agent freezes;
    * no reward clip and no phase_reached/conformance/spacing bookkeeping.
    """
    cfg = params.cfg
    dtype = values.dtype
    pos_i = values[:, i, :2]
    tube = state.tube
    cur = tube_mod.agent_phase_v4oct(tube, pos_i[:, None])[:, 0]

    frozen = state.frozen_pos
    diff = frozen - frozen[:, i : i + 1]
    not_self = torch.arange(params.num_agents, device=values.device) != i
    colliding = (
        (diff[..., 0] * diff[..., 0] + diff[..., 1] * diff[..., 1] < cfg.separation_distance**2)
        & ~state.status
        & ~state.status[:, i : i + 1]
        & not_self
    )
    rew = -(params.collision_rew * 4) * colliding.any(dim=-1).to(dtype)
    if params.num_obstacles or params.num_walls:
        rew = rew - _obstacle_penalty(params, state, pos_i)
    is_p1 = (cur == 1).to(dtype)
    rew = rew - (cur == 0).to(dtype) * _norm(tube.entrance - pos_i)
    rew = rew - is_p1 * _norm(tube.exit - pos_i)
    state.steps_in_corridor[:, i] += is_p1
    return rew


def _safety_reward_addons(params: EnvParams, state: EnvState, values: Tensor, i: int,
                          hj_pair: Tensor | None) -> Tensor:
    """The toggled safety reward terms of agent ``i`` (july:1208-1218),
    added between the july reward's two clips; every toggle defaults off
    (RewardBinaryConfig, multiagent/config.py:146-155)."""
    tg = params.reward_toggles
    w = params.reward_weights
    cfg = params.cfg
    n = params.num_agents
    rew = torch.zeros_like(values[:, 0, 0])
    pos = values[..., :2]
    rel = pos - pos[:, i : i + 1]
    d = _norm(rel)
    others_alive = (torch.arange(n, device=values.device) != i) & ~state.status
    zero = torch.zeros_like(d)

    if tg.safety_violation:
        # reward_safety_violation (july:1057-1062): per agent within the
        # separation distance
        conflict = others_alive & (d <= cfg.separation_distance)
        rew = rew + w.safety_violation * conflict.sum(dim=-1).to(rew.dtype)
    if tg.potential_conflict:
        # reward_multiple_engagement (july:1064-1085)
        eng_dist = cfg.engagement_distance
        eng = others_alive & (d <= eng_dist)
        closeness = 1.0 - torch.clamp(
            (d - cfg.separation_distance) / (eng_dist - cfg.separation_distance), 0, 1)
        vel = dynamics.velocity_of(values, cfg)
        dirv = rel / (d[..., None] + 1e-8)
        closing = (dirv * (vel - vel[:, i : i + 1])).sum(dim=-1)
        closing = torch.abs(torch.minimum(zero, closing))
        pen = torch.where(eng, closing * closeness, zero).sum(dim=-1)
        rew = rew + torch.where(eng.sum(dim=-1) > 1, w.potential_conflict * pen,
                                torch.zeros_like(pen))
    if tg.diff_from_filtered_action:
        # reward_diff_from_filtered_action (july:1087-1090)
        rew = rew + torch.where(~state.status[:, i],
                                w.diff_from_filtered_action * state.action_diff[:, i],
                                torch.zeros_like(rew))
    if tg.hj_value and hj_pair is not None:
        # reward_hj_value (july:1092-1102), eps_hj = 0.4
        pen = torch.where(others_alive,
                          torch.abs(torch.minimum(hj_pair[:, i] - 0.4, zero)), zero).sum(dim=-1)
        rew = rew + w.hj_value * pen
    return rew


def _reward_one_agent(
    params: EnvParams, state: EnvState, values: Tensor, i: int, gen: torch.Generator,
    hj_pair: Tensor | None = None,
) -> Tensor:
    """Reward for agent ``i`` with its in-step mutations (july ``reward``
    :1105-1221).  Writes the ``_REWARD_WRITES`` fields of ``state`` and row
    ``i`` of ``values`` in place; must run in agent-id order, since it reads
    the status and velocities earlier agents wrote this step.  The gated
    scenarios take ``_reward_one_agent_gated``, v4oct
    ``_reward_one_agent_v4oct``.  ``hj_pair`` is the pairwise HJ values of
    the ``hj_value`` term.
    """
    if params.gated:
        return _reward_one_agent_gated(params, state, values, i, gen)
    if params.scenario == "v4oct":
        return _reward_one_agent_v4oct(params, state, values, i)
    cfg = params.cfg
    dtype = values.dtype
    n = params.num_agents
    pos = values[..., :2].clone()
    pos_i = pos[:, i]
    tube = state.tube
    dev = values.device

    # --- phase call #2 (get_agent_phase inside reward, july:1113) ---
    state.entry_cooldown[:, i] = _decrement_cooldown(state.entry_cooldown[:, i])
    cur, prev_i = tube_mod.agent_phase(
        tube, pos[:, i : i + 1], state.prev_phase[:, i : i + 1],
        params.gate_front_ratio, params.gate_back_ratio,
    )
    cur, prev_i = cur[:, 0], prev_i[:, 0]
    reached_i = state.phase_reached[:, i].clone()
    status_i = state.status[:, i].clone()

    # --- collision penalties (july:1117-1124) ---
    not_self = torch.arange(n, device=dev) != i
    colliding = (
        (_norm(pos - pos_i[:, None]) < cfg.separation_distance)
        & ~state.status
        & ~status_i[:, None]
        & not_self
    )
    rew = -(params.collision_rew * 4) * colliding.sum(dim=-1).to(dtype)
    if params.num_obstacles or params.num_walls:
        rew = rew - _obstacle_penalty(params, state, pos_i)

    # --- front/back spacing neighbors by own heading (july:1127-1144) ---
    heading = dynamics.heading_of(values[:, i], cfg)
    rel = pos - pos_i[:, None]
    proj = rel[..., 0] * torch.cos(heading)[:, None] + rel[..., 1] * torch.sin(heading)[:, None]
    front_mask = not_self & (proj > 0)
    back_mask = not_self & (proj <= 0)
    front_idx = torch.where(front_mask, proj, math.inf).argmin(dim=-1)
    back_idx = torch.where(back_mask, proj, -math.inf).argmax(dim=-1)
    desired = cfg.separation_distance

    # --- phase transition rewards (july:1146-1161) ---
    rew = rew - (params.goal_rew * 3) * ((cur == 2) & (cur > prev_i + 1)).to(dtype)
    proj_e, perp_e = tube_mod.entrance_projection(tube, pos[:, i : i + 1])
    proj_e, perp_e = proj_e[:, 0], perp_e[:, 0]
    span_len = _norm(tube.exit - tube.entrance)
    entered = (cur == prev_i + 1) & (reached_i == cur - 1)
    bonus = entered & (
        ((cur == 1) & (0 <= proj_e) & (proj_e < 0.1 * span_len) & (perp_e < 0.2 * span_len))
        | (cur == 2)
    )
    rew = rew + (params.goal_rew * 3) * bonus.to(dtype)

    # --- phase-specific terms (july:1163-1194) ---
    is_p0 = (cur == 0).to(dtype)
    is_p1_b = cur == 1
    is_p1 = is_p1_b.to(dtype)
    demote = (cur == 2) & (reached_i == 0)
    goal_branch = (cur == 2) & ~demote

    rew = rew - is_p0 * _norm(tube.entrance - pos_i)

    front_diff = _norm(_gather_rows(pos, front_idx[:, None])[:, 0] - pos_i) - desired
    back_diff = _norm(_gather_rows(pos, back_idx[:, None])[:, 0] - pos_i) - desired
    zero = torch.zeros_like(front_diff)
    spacing_error = torch.where(
        front_mask.any(dim=-1) & (front_diff < 0), -front_diff, zero
    ) + torch.where(back_mask.any(dim=-1) & (back_diff < 0), -back_diff, zero)
    state.spacing_violation[:, i] += (is_p1_b & (spacing_error > 0)).to(dtype)
    state.delta_spacing_sum += is_p1 * spacing_error
    state.steps_in_corridor[:, i] += is_p1
    rew = rew - is_p1 * spacing_error * params.formation_rew
    rew = rew - is_p1 * _norm(tube.exit - pos_i)

    # goal logic (july:1186-1194)
    goal_pos = goal_positions(state.landmark_pos, state.goal_match[:, i : i + 1])[:, 0]
    dist_goal = _norm(pos_i - goal_pos)
    at_goal = goal_branch & (dist_goal < cfg.goal_threshold)
    newly = at_goal & ~status_i
    rew = rew + newly.to(dtype) * (params.goal_rew * 5)
    rew = rew - (goal_branch & (dist_goal >= cfg.goal_threshold)).to(dtype) * dist_goal

    # freeze + reset_velocity on first goal reach (july:1188-1190,
    # core.py:324-333)
    row = values[:, i]
    stopped = dynamics.stopped_row(row, cfg, gen, params.parity_fixed_reset_theta)
    values[:, i] = torch.where(newly[:, None], stopped, row)
    state.status[:, i] = status_i | newly
    state.goal_tracker[:, i] = torch.where(
        newly, state.goal_match[:, i], state.goal_tracker[:, i]
    )

    # --- conformance / phase_reached / regression penalties (july:1196-1204) ---
    cur2 = torch.where(demote, torch.zeros_like(cur), cur)
    state.conformance[:, i] += ((reached_i == 1) & (cur2 == 0)).to(dtype)
    new_pr = torch.maximum(reached_i, cur2)
    rew = rew - (params.collision_rew * 3) * (cur2 < prev_i).to(dtype)
    rew = rew - params.collision_rew * (cur2 < new_pr).to(dtype)
    state.phase_reached[:, i] = new_pr
    state.prev_phase[:, i] = cur2

    # --- clips (july:1207, 1221), the safety terms between them ---
    rew = torch.clamp(rew, -4 * params.collision_rew, params.goal_rew * 5)
    if params.use_safety_filter:
        rew = rew + _safety_reward_addons(params, state, values, i, hj_pair)
    w = params.reward_weights
    return torch.clamp(rew, w.min_reward, w.max_reward)


def _update_info_stats(params: EnvParams, state: EnvState, values: Tensor) -> EnvState:
    """``info_callback`` bookkeeping (july:741-829), once per step from the
    post-sweep state (its mutations feed only logged metrics)."""
    cfg = params.cfg
    dtype = values.dtype
    pos = values[..., :2]
    d_landmarks = _norm(pos[:, :, None, :] - state.landmark_pos[:, None, :, :])
    nearest = d_landmarks.argmin(dim=-1)
    dist_goal = d_landmarks.min(dim=-1).values
    near = dist_goal < cfg.goal_threshold

    goal_reached = state.goal_reached
    times_required = state.times_required
    dists_to_goal = state.dists_to_goal
    dist_left = state.dist_left_to_goal

    # the reference's stat arrays are integer (np.full(n, -1), july
    # reset_world:368-373), so every stored float truncates toward zero
    t_time = torch.trunc(state.t.to(dtype) * cfg.dt)[:, None].expand_as(dist_goal)
    dist_goal_store = torch.trunc(dist_goal)
    p_dist_store = torch.trunc(state.p_dist)

    # 1. new goal after having one
    c1 = near & (nearest != goal_reached) & (goal_reached != -1)
    goal_reached = torch.where(c1, nearest, goal_reached)
    dist_left = torch.where(c1, dist_goal_store, dist_left)
    # 2. first time at a goal
    c2 = near & (times_required == -1)
    times_required = torch.where(c2, t_time, times_required)
    dists_to_goal = torch.where(c2, p_dist_store, dists_to_goal)
    dist_left = torch.where(c2, dist_goal_store, dist_left)
    goal_reached = torch.where(c2, nearest, goal_reached)
    # 3. not yet reached
    c3 = times_required == -1
    dists_to_goal = torch.where(c3, p_dist_store, dists_to_goal)
    dist_left = torch.where(c3, dist_goal_store, dist_left)
    # 4. left the goal
    c4 = (dist_goal > cfg.goal_threshold) & (times_required != -1)
    dists_to_goal = torch.where(c4, p_dist_store, dists_to_goal)
    times_required = torch.where(c4, t_time, times_required)
    dist_left = torch.where(c4, dist_goal_store, dist_left)
    # 5. still on the same goal
    c5 = near & (nearest == goal_reached)
    dist_left = torch.where(c5, dist_goal_store, dist_left)

    # collision counters (july:777-786); obstacles and walls count for every
    # agent, done or not
    n = params.num_agents
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    coll = (
        (dist_ops.pairwise_distances(pos) < cfg.separation_distance)
        & ~state.status[:, :, None]
        & ~state.status[:, None, :]
        & ~eye
    )
    obst = state.num_obstacle_collisions
    if params.num_obstacles or params.num_walls:
        obst = obst + _obstacle_collision(params, state.obstacle_pos, pos).to(dtype)
    return dataclasses.replace(
        state,
        goal_reached=goal_reached,
        times_required=times_required,
        dists_to_goal=dists_to_goal,
        dist_left_to_goal=dist_left,
        dist_left_float=dist_goal,
        num_agent_collisions=state.num_agent_collisions + coll.sum(dim=-1).to(dtype),
        num_obstacle_collisions=obst,
    )


def _info_dict(params: EnvParams, state: EnvState) -> dict:
    """Logged metrics with the info_callback keys (july:806-829): per-agent
    values are (B, N), per-env values (B,)."""
    eps = 1e-4
    dmean = state.dists_to_goal.mean(dim=-1)
    dstd = state.dists_to_goal.std(dim=-1, correction=0)
    tmean = state.times_required.mean(dim=-1)
    tstd = state.times_required.std(dim=-1, correction=0)
    spacing_tot = state.spacing_violation.sum(dim=-1)
    ones = torch.ones_like(spacing_tot)
    return {
        "Dist_to_goal": state.dist_left_to_goal,
        # precise float distance (the reference's Dist_to_goal is
        # int-truncated); the eval success criterion uses this one
        "Dist_to_goal_precise": state.dist_left_float,
        "Time_req_to_goal": state.times_required,
        "Num_agent_collisions": state.num_agent_collisions,
        "Num_obst_collisions": state.num_obstacle_collisions,
        "Distance_mean": dmean,
        "Distance_variance": dstd,
        "Mean_by_variance": dmean / (dstd + eps),
        "Dists_traveled": state.dists_to_goal,
        "Time_taken": state.times_required,
        "Time_mean": tmean,
        "Time_stddev": tstd,
        "Time_mean_by_stddev": tmean / (tstd + eps),
        "Conformance": state.conformance / params.episode_length,
        "Delta_spacing": state.delta_spacing_sum
        / torch.where(spacing_tot != 0, spacing_tot, ones),
        "Spacing_violations": state.spacing_violation
        / torch.where(state.steps_in_corridor != 0, state.steps_in_corridor,
                      torch.ones_like(state.steps_in_corridor)),
        "Min_time_to_goal": state.goal_min_time,
        "Phase_reached": state.phase_reached.to(state.dists_to_goal.dtype),
    }


def safety_filter(params: EnvParams, agent_states: Tensor, u: Tensor, hj_data=None,
                  trace: dict | None = None):
    """The safety filter on the decoded controls ``u`` (B, N, 2) of every
    agent (core.py:691-736), dispatched as the JAX package's step does:
    'rvo' is ORCA; otherwise the double integrator takes the exponential
    CBF and a heading model the HJ filter, which needs ``hj_data``.
    Returns (controls, filtered flags, action_diff); ``trace``: see
    ``safety/cbf.py``."""
    cfg = params.cfg
    if params.safety_filter_type == "rvo":
        out = rvo_mod.rvo_filter(agent_states, u, cfg, trace=trace)
    elif cfg.dynamics == DynamicsType.DOUBLE_INTEGRATOR:
        out = cbf_mod.di_exp_cbf_filter(agent_states, u, cfg, trace=trace)
    else:
        if hj_data is None:
            raise ValueError(
                "use_safety_filter with heading dynamics requires HJ value data "
                "(safety.hj.load_hj_pickle / make_synthetic_airtaxi_hj)")
        out = hj_mod.airtaxi_hj_filter(agent_states, u, hj_data, cfg, trace=trace)
    return out[:3]


def step(
    params: EnvParams, state: EnvState, action_idx: Tensor, gen: torch.Generator,
    hj_data=None,
) -> tuple[EnvState, TimeStep]:
    """One environment step for a batch of envs; ``action_idx`` is (B, N).

    Order of operations of ``MultiAgentGraphEnv.step`` (environment.py:
    1021-1063): counters, action decode (``_set_action``), the safety
    filter where ``params.use_safety_filter`` is set, ``world.step()``
    physics, then the per-agent obs/reward/graph/done/info sweep in agent-id
    order.  ``gen`` supplies the goal-reach heading draws of the heading
    models.  ``params.integrator`` picks the integrator.  ``hj_data`` is
    the HJ table (``safety.hj.HjValueData``) of a heading model's filter,
    on the state's device in its dtype.
    """
    cfg = params.cfg
    dtype = state.agent_states.dtype
    n = params.num_agents
    B = action_idx.shape[0]

    t_new = state.t + 1
    table = torch.as_tensor(
        action_mod.action_table(cfg, params.total_actions), dtype=dtype,
        device=action_idx.device,
    )
    u = action_mod.decode(action_idx, table)
    hj_pair = None
    if params.use_safety_filter:
        u, violations, action_diff = safety_filter(params, state.agent_states, u, hj_data)
        state = dataclasses.replace(state, action_diff=action_diff,
                                    safety_violations=violations)
        if params.reward_toggles.hj_value and hj_data is not None:
            # the pairwise HJ values of the hj_value term (july:1092-1102)
            s = state.agent_states
            rel = hj_mod.relative_state_airtaxi(s[:, :, None, :], s[:, None, :, :])
            hj_pair, in_rng = hj_mod.interpolate(hj_data.lo, hj_data.hi, hj_data.values, rel)
            hj_pair = torch.where(in_rng, hj_pair, torch.inf)
    active = ~state.status
    values = dynamics.integrate(state.agent_states, u, cfg, active, method=params.integrator)
    speed = dynamics.speed_of(values, cfg)
    zero = torch.zeros_like(speed)
    state = dataclasses.replace(
        state,
        t=t_new,
        sim_time=state.sim_time + cfg.dt,
        p_dist=state.p_dist + torch.where(active, speed * cfg.dt, zero),
        time=state.time + torch.where(active, zero + cfg.dt, zero),
        agent_states=values,
    )

    interleaved = params.scenario in ("two_phase", "three_phase")
    if not interleaved:
        # observations for all agents (phase call #1), vectorized: july and
        # rot_inv observations read only per-agent state that earlier
        # rewards cannot have changed
        state, obs = observations(params, state)

    # sequential reward sweep (phase call #2 each); node features are taken
    # per agent right after its reward (environment.py:1040-1046).  The sweep
    # writes into copies of the fields it changes, never into the caller's.
    state = dataclasses.replace(state, **{k: getattr(state, k).clone() for k in _REWARD_WRITES})
    values = values.clone()
    obs_rows, rewards, node_obs = [], [], []
    for i in range(n):
        if interleaved:
            # agent i's row sees the rewards of agents j < i (two/three_phase)
            obs_rows.append(_obs_gated_row(params, state, values, i))
        rewards.append(_reward_one_agent(params, state, values, i, gen, hj_pair))
        node_obs.append(_node_obs_for_agent(params, state, values, i))
    if interleaved:
        obs = torch.stack(obs_rows, dim=1)
    state = dataclasses.replace(state, agent_states=values)
    reward = torch.stack(rewards, dim=1)
    node_obs = torch.stack(node_obs, dim=1)

    adj = masked_adjacency(params, state, values)
    done = state.status | (t_new >= params.episode_length)[:, None]
    state = _update_info_stats(params, state, values)
    info = _info_dict(params, state)

    ts = TimeStep(
        obs=obs,
        agent_id=_agent_ids(params, B, values.device),
        node_obs=node_obs,
        adj=adj,
        reward=reward,
        done=done,
        info=info,
        truncated=done & ~state.status,
    )
    return state, ts


def reset_outputs(params: EnvParams, state: EnvState):
    """Post-reset observations (``MultiAgentGraphEnv.reset``,
    environment.py:1066-1084): phase call #1 per agent (mutating state), node
    features and adjacency from the fresh state."""
    values = state.agent_states
    state, obs = observations(params, state)
    node_obs = torch.stack(
        [_node_obs_for_agent(params, state, values, i) for i in range(params.num_agents)],
        dim=1,
    )
    adj = masked_adjacency(params, state, values)
    return state, obs, node_obs, adj, _agent_ids(params, values.shape[0], values.device)
