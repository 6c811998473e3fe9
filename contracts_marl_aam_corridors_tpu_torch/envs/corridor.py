"""The ``rotate_tube_july`` scenario step on a batch of envs (port of
``envs/corridor.py``, july only).

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
envs, and the adjacency comes from the post-loop state.

The gated scenarios (rot_inv, two_phase, three_phase), v4oct, sequential,
fairassign, obstacles, walls and the safety filter are not ported yet.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ops import distance as dist_ops
from . import actions as action_mod
from . import dynamics
from . import tube as tube_mod
from .types import EnvParams, EnvState, TimeStep


Tensor = torch.Tensor

ENTITY_AGENT, ENTITY_LANDMARK = 0.0, 1.0

# fields the per-agent reward sweep writes in place (step() hands it copies)
_REWARD_WRITES = (
    "status", "prev_phase", "phase_reached", "entry_cooldown", "goal_tracker",
    "spacing_violation", "conformance", "steps_in_corridor", "delta_spacing_sum",
)


def _entity_positions(pos: Tensor, state: EnvState) -> Tensor:
    return torch.cat([pos, state.landmark_pos], dim=1)


def _decrement_cooldown(cooldown: Tensor) -> Tensor:
    """Each ``get_agent_phase`` call decrements a positive cooldown (july:702-704)."""
    return cooldown - (cooldown > 0).to(cooldown.dtype)


def _gather_rows(x: Tensor, idx: Tensor) -> Tensor:
    """x (B, M, D), idx (B, K) -> (B, K, D)."""
    return torch.gather(x, 1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def _norm(x: Tensor) -> Tensor:
    return torch.linalg.vector_norm(x, dim=-1)


def _agent_ids(params: EnvParams, B: int, device) -> Tensor:
    n = params.num_agents
    return torch.arange(n, device=device).expand(B, n)[..., None]


def observations(params: EnvParams, state: EnvState) -> tuple[EnvState, Tensor]:
    """The 19-dim observation for every agent (july:1337-1463).

    Layout: [pos(2), vel(2), rel_goal(2), goal_occupied(1), rel_second(2)
    (= rel_goal), two nearest neighbors rel pos(4), rel_entrance(2),
    rel_exit(2), tube_width(1), phase(1)].  Performs phase-machine call #1
    for each agent (cooldown decrement and the possible 1->2
    ``previous_phase`` mutation), as the reference's ``observation`` does.
    """
    n = params.num_agents
    pos = state.agent_states[..., :2]
    vel = dynamics.velocity_of(state.agent_states)
    goal = _gather_rows(state.landmark_pos, state.goal_match)
    rel_goal = goal - pos
    occupied = torch.gather(state.occupied, 1, state.goal_match)[..., None]
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
    """Relative node features wrt ego agent i (july:1694-1771), (B, E, 8)."""
    n, l = params.num_agents, params.num_landmarks
    pos = values[..., :2]
    vel = dynamics.velocity_of(values)
    B = pos.shape[0]
    entity_pos = _entity_positions(pos, state)
    entity_vel = torch.cat([vel, vel.new_zeros(B, l, 2)], dim=1)
    pos_i = pos[:, i : i + 1]
    rel_pos = entity_pos - pos_i
    rel_vel = entity_vel - vel[:, i : i + 1]
    # agents: goal = landmark_poses[entity.id]; landmarks: own rel_pos
    goal_idx = torch.arange(n, device=pos.device) % l
    agent_goal_rel = state.landmark_pos[:, goal_idx] - pos_i
    rel_goal = torch.cat([agent_goal_rel, rel_pos[:, n:]], dim=1)
    occ_agents = torch.gather(state.occupied, 1, state.goal_match)
    occupied = torch.cat([occ_agents, occ_agents.new_ones(B, l)], dim=1)[..., None]
    etype = torch.cat(
        [pos.new_full((B, n), ENTITY_AGENT), pos.new_full((B, l), ENTITY_LANDMARK)], dim=1
    )[..., None]
    return torch.cat([rel_vel, rel_pos, rel_goal, occupied, etype], dim=-1)


def masked_adjacency(params: EnvParams, state: EnvState, values: Tensor) -> Tensor:
    """Distance-magnitude adjacency (B, E, E) with done rows/cols zeroed
    (july:1625-1648): agents disconnect once ``status`` is set; a landmark
    disconnects when any ``goal_tracker`` entry equals its id."""
    l = params.num_landmarks
    adj = dist_ops.pairwise_distances(_entity_positions(values[..., :2], state))
    lm = torch.arange(l, device=adj.device)
    landmark_done = (state.goal_tracker[:, :, None] == lm).any(dim=1)
    keep = ~torch.cat([state.status, landmark_done], dim=1)
    return adj * keep[:, :, None] * keep[:, None, :]


def _reward_one_agent(
    params: EnvParams, state: EnvState, values: Tensor, i: int, gen: torch.Generator
) -> Tensor:
    """Reward for agent ``i`` with its in-step mutations (july ``reward``
    :1105-1221).  Writes the ``_REWARD_WRITES`` fields of ``state`` and row
    ``i`` of ``values`` in place; must run in agent-id order, since it reads
    the status and velocities earlier agents wrote this step.
    """
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

    # --- collision penalty (july:1117-1124) ---
    not_self = torch.arange(n, device=dev) != i
    colliding = (
        (_norm(pos - pos_i[:, None]) < cfg.separation_distance)
        & ~state.status
        & ~status_i[:, None]
        & not_self
    )
    rew = -(params.collision_rew * 4) * colliding.sum(dim=-1).to(dtype)

    # --- front/back spacing neighbors by own heading (july:1127-1144) ---
    heading = values[:, i, 2]
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
    goal_pos = _gather_rows(state.landmark_pos, state.goal_match[:, i : i + 1])[:, 0]
    dist_goal = _norm(pos_i - goal_pos)
    at_goal = goal_branch & (dist_goal < cfg.goal_threshold)
    newly = at_goal & ~status_i
    rew = rew + newly.to(dtype) * (params.goal_rew * 5)
    rew = rew - (goal_branch & (dist_goal >= cfg.goal_threshold)).to(dtype) * dist_goal

    # freeze + reset_velocity on first goal reach (july:1188-1190,
    # core.py:324-333): a fresh heading theta ~ U(0, 2pi) at speed v_min
    row = values[:, i]
    theta = (2 * math.pi) * torch.rand(row.shape[0], generator=gen, dtype=dtype, device=dev)
    reset_row = torch.stack(
        [row[:, 0], row[:, 1], theta, torch.full_like(theta, cfg.v_min)], dim=-1
    )
    values[:, i] = torch.where(newly[:, None], reset_row, row)
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

    # --- clips (july:1207, 1221) ---
    rew = torch.clamp(rew, -4 * params.collision_rew, params.goal_rew * 5)
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

    # collision counters (july:777-786)
    n = params.num_agents
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)
    coll = (
        (dist_ops.pairwise_distances(pos) < cfg.separation_distance)
        & ~state.status[:, :, None]
        & ~state.status[:, None, :]
        & ~eye
    )
    return dataclasses.replace(
        state,
        goal_reached=goal_reached,
        times_required=times_required,
        dists_to_goal=dists_to_goal,
        dist_left_to_goal=dist_left,
        dist_left_float=dist_goal,
        num_agent_collisions=state.num_agent_collisions + coll.sum(dim=-1).to(dtype),
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


def step(
    params: EnvParams, state: EnvState, action_idx: Tensor, gen: torch.Generator
) -> tuple[EnvState, TimeStep]:
    """One environment step for a batch of envs; ``action_idx`` is (B, N).

    Order of operations of ``MultiAgentGraphEnv.step`` (environment.py:
    1021-1063): counters, action decode (``_set_action``), ``world.step()``
    physics, then the per-agent obs/reward/graph/done/info sweep in agent-id
    order.  ``gen`` supplies the goal-reach heading draws.
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
    active = ~state.status
    values = dynamics.step_closed_form(state.agent_states, u, cfg, active)
    speed = dynamics.speed_of(values)
    zero = torch.zeros_like(speed)
    state = dataclasses.replace(
        state,
        t=t_new,
        sim_time=state.sim_time + cfg.dt,
        p_dist=state.p_dist + torch.where(active, speed * cfg.dt, zero),
        time=state.time + torch.where(active, zero + cfg.dt, zero),
        agent_states=values,
    )

    # observations for all agents (phase call #1)
    state, obs = observations(params, state)

    # sequential reward sweep (phase call #2 each); node features are taken
    # per agent right after its reward (environment.py:1040-1046)
    state = dataclasses.replace(state, **{k: getattr(state, k).clone() for k in _REWARD_WRITES})
    values = values.clone()
    rewards, node_obs = [], []
    for i in range(n):
        rewards.append(_reward_one_agent(params, state, values, i, gen))
        node_obs.append(_node_obs_for_agent(params, state, values, i))
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
