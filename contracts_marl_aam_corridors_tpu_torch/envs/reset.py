"""Episode reset for a batch of envs: tube sampling, agent spawning, landmark
placement (port of ``envs/reset.py``: the july, exit-gated and v4oct
scenarios, with the point, circle and line formations).

Same distributions and rejection rule as the reference's ``reset_world`` ->
``random_scenario`` -> ``setup_tube_params`` chain (july:339-613; the
gated scenarios' spawn jitter and spacing, two/three_phase's tube length
draw, and v4oct's fixed tube angle and wider jitter, as the JAX package's
``EnvParams`` properties give them); the random stream is a
``torch.Generator``'s, so draws differ from both the reference and the JAX
package.  What the JAX package draws nothing for (v4oct's angle, the double
integrator's spawn velocity) takes nothing from the generator here either.
Obstacles are never placed: they stay at the origin, as in the reference
(core.py:400 default state), and spawns avoid them and the walls.

``reset_parity_numpy`` is the JAX package's host-side mirror of the
reference reset: it draws from numpy's global stream in the reference's
call order, so one seeded env starts where the JAX package's does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config.physics import DynamicsType
from . import corridor
from . import tube as tube_mod
from .types import EnvParams, EnvState, TubeParams

Tensor = torch.Tensor

SPAWN_CANDIDATES = 32


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, like: Tensor) -> Tensor:
    u = torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)
    return lo + (hi - lo) * u


def _blank_state(params: EnvParams, B: int, tube: TubeParams, dtype, device) -> dict:
    n, o = params.num_agents, params.num_obstacles
    zf = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.long, device=device)
    full = lambda v, dt: torch.full((B, n), v, dtype=dt, device=device)
    return dict(
        p_dist=zf(B, n),
        time=zf(B, n),
        status=torch.zeros((B, n), dtype=torch.bool, device=device),
        phase_reached=zi(B, n),
        entry_cooldown=zi(B, n),
        prev_proj=zf(B, n),
        tube=tube,
        obstacle_pos=zf(B, o, 2),
        occupied=zf(B, n),
        goal_match=torch.arange(n, device=device).expand(B, n).clone(),
        goal_tracker=full(-1, torch.long),
        goal_reached=full(-1, torch.long),
        spacing_violation=zf(B, n),
        conformance=zf(B, n),
        steps_in_corridor=zf(B, n),
        delta_spacing_sum=zf(B),
        times_required=full(-1.0, dtype),
        dists_to_goal=full(-1.0, dtype),
        dist_left_to_goal=full(-1.0, dtype),
        dist_left_float=full(-1.0, dtype),
        num_agent_collisions=zf(B, n),
        num_obstacle_collisions=zf(B, n),
        t=zi(B),
        sim_time=zf(B),
        action_diff=zf(B, n),
        safety_violations=torch.zeros((B, n), dtype=torch.bool, device=device),
    )


def _place_landmarks(params: EnvParams, tube: TubeParams) -> Tensor:
    """Landmark positions (B, L, 2) of the configured formation, in the
    tube's dtype (the JAX package's ``_place_landmarks``, whose intermediates
    take JAX's default float: the state's float32 in training, float64 where
    x64 is on):

    * ``point`` (utils.py ``set_landmarks_in_point``:165-194): every landmark
      at ``exit + R(angle) @ [0, -world_size/3]``;
    * ``circle`` (utils.py:231+): landmark k at angle 2 pi k / L on the ring
      of radius world_size/3 about ``(0, exit_y + world_size/5)``;
    * ``line`` (july:493): from ``(-ws/2, -ws/2)`` to ``(ws/2, -ws/2)`` at
      ``linspace(0, 1, L)``, whose fractions are k / (L - 1) as
      ``jnp.linspace`` computes them.
    """
    ws, l = params.world_size, params.num_landmarks
    B = tube.angle.shape[0]
    if params.formation_type == "point":
        c, s = torch.cos(tube.angle), torch.sin(tube.angle)
        offset = torch.stack([-s * (ws / 3), -c * (ws / 3)], dim=-1)
        point = tube.exit + offset
        return point[:, None, :].expand(-1, l, 2).clone()
    k = torch.arange(l, dtype=tube.angle.dtype, device=tube.angle.device)
    if params.formation_type == "circle":
        ang = 2 * math.pi * k / l
        ring = (ws / 3) * torch.stack([torch.cos(ang), torch.sin(ang)], dim=-1)  # (L, 2)
        center = torch.stack([torch.zeros_like(tube.angle), tube.exit[:, 1] + ws / 5], dim=-1)
        return center[:, None, :] + ring
    frac = k / (l - 1) if l > 1 else k
    start = torch.tensor([-ws / 2, -ws / 2], dtype=k.dtype, device=k.device)
    end = torch.tensor([ws / 2, -ws / 2], dtype=k.dtype, device=k.device)
    return (start + frac[:, None] * (end - start)).expand(B, l, 2).clone()


def _spawn_agents(params: EnvParams, tube: TubeParams, obstacle_pos: Tensor,
                  gen: torch.Generator) -> Tensor:
    """Sequential rejection-sampled spawn along the pre-entrance axis.

    july:452-486: agent k tries ``entrance + (world_size+k)/div * perp +
    jitter`` with jitter ~ scale*U(-jr, jr)^2 (div 5 and scale 0.2 for july
    and v4oct, 3 and 0.3 for the gated scenarios; jr = ws, v4oct's 10),
    rejected while within separation distance of an already-placed agent,
    inside the wall box or within 2*(size + size) of an obstacle
    (july:864-890; agent 0 too).  Like the JAX package, a fixed block of K
    candidates is drawn per agent and the first collision-free one is taken
    (the first candidate if none is free; failure probability is below
    reject_rate^K), so no data-dependent loop runs on the device.
    """
    n, ws = params.num_agents, params.world_size
    K = SPAWN_CANDIDATES
    ang = tube.angle
    B = ang.shape[0]
    perp = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    sep = params.cfg.separation_distance
    jscale, sdiv = params.spawn_jitter_scale, params.spawn_spacing_div
    jr = params.spawn_jitter_range
    placed = []
    for k in range(n):
        jitter = jscale * _uniform(gen, (B, K, 2), -jr, jr, ang)
        base = tube.entrance + (ws + k) / sdiv * perp
        cand = base[:, None, :] + jitter  # (B, K, 2)
        collide = None
        if placed:
            prev = torch.stack(placed, dim=1)  # (B, k, 2)
            d = torch.linalg.vector_norm(prev[:, None, :, :] - cand[:, :, None, :], dim=-1)
            collide = (d < sep).any(dim=-1)  # (B, K)
        if params.num_obstacles or params.num_walls:
            hit = corridor._obstacle_collision(params, obstacle_pos, cand)
            collide = hit if collide is None else collide | hit
        if collide is None:
            first_ok = torch.zeros(B, dtype=torch.long, device=ang.device)
        else:
            first_ok = (~collide).to(torch.uint8).argmax(dim=1)
        idx = first_ok[:, None, None].expand(B, 1, 2)
        placed.append(torch.gather(cand, 1, idx)[:, 0, :])
    return torch.stack(placed, dim=1)


def _initial_velocity(params: EnvParams, gen: torch.Generator, B: int, like: Tensor):
    """reset_velocity() at spawn (core.py:145-153, 223-225, 324-333), the
    last two state columns (B, N, 2): heading models draw theta ~ U(0, 2pi)
    at speed v_min; the double integrator starts at rest and draws nothing."""
    if params.cfg.dynamics == DynamicsType.DOUBLE_INTEGRATOR:
        return like.new_zeros((B, params.num_agents, 2))
    theta = _uniform(gen, (B, params.num_agents), 0.0, 2 * math.pi, like)
    return torch.stack([theta, torch.full_like(theta, params.cfg.v_min)], dim=-1)


def reset(
    params: EnvParams, num_envs: int, gen: torch.Generator, device, dtype=torch.float32
) -> EnvState:
    """Fresh episodes for ``num_envs`` envs.

    ``prev_phase`` starts at zero here; ``env.step``'s auto-reset carries the
    previous episode's value through instead (the reference never clears
    ``agent.previous_phase``), and v4oct's ``frozen_pos`` likewise.
    """
    B, n = num_envs, params.num_agents
    ref = torch.empty((B,), dtype=dtype, device=device)
    if params.fixed_tube_angle is not None:
        # v4oct pins the angle (v4oct:548), in the state's type; no draw
        angle = torch.full_like(ref, params.fixed_tube_angle)
    else:
        angle = _uniform(gen, (B,), -math.pi / 2, math.pi / 2, ref)
    length = None
    if params.randomize_tube_length:
        # two_phase setup: length = 0.8ws + U(-0.3ws, 0.1ws)
        ws = params.world_size
        length = ws * 0.8 + _uniform(gen, (B,), -0.3 * ws, 0.1 * ws, ref)
    tube = tube_mod.make_tube(angle, params.world_size, corridor.AGENT_SIZE, length)
    fields = _blank_state(params, B, tube, dtype, device)
    agent_pos = _spawn_agents(params, tube, fields["obstacle_pos"], gen)
    agent_states = torch.cat([agent_pos, _initial_velocity(params, gen, B, ref)], dim=-1)
    landmark_pos = _place_landmarks(params, tube)
    goal = corridor.goal_positions(landmark_pos, fields["goal_match"])
    fields["goal_min_time"] = (
        torch.linalg.vector_norm(agent_pos - goal, dim=-1) / params.max_speed
    )
    return EnvState(
        agent_states=agent_states,
        prev_phase=torch.zeros((B, n), dtype=torch.long, device=device),
        landmark_pos=landmark_pos,
        # v4oct's stale position cache: on a fresh env this reset's spawn
        frozen_pos=agent_pos.clone() if params.scenario == "v4oct" else None,
        **fields,
    )


def reset_parity_numpy(params: EnvParams, prev_phase=None, device="cpu") -> EnvState:
    """One env (B = 1) reset from numpy's global stream, drawn in the
    reference's call order (reset_world july:339-421 -> random_scenario
    :440-515), as the JAX package's ``reset_parity_numpy`` draws it:

    1. wall_length ~ U(0.2, 0.8) (july:368; the value is unused);
    2. tube angle ~ U(-pi/2, pi/2) (july:530), unless the scenario fixes it;
    3. the tube length's U(-0.3ws, 0.1ws) where the scenario randomizes it;
    4. per spawn attempt the jitter ~ scale * U(-jr, jr)^2 (july:462), and
       on acceptance the heading ~ U(0, 2pi) of a heading model
       (core.py:328).

    The rejection loop is unbounded, as the reference's is, and tests only
    the agents placed before and the obstacles at the origin (the JAX
    mirror does not test the walls).  Float64 throughout, on ``device``;
    an env with more agents than landmarks raises ``IndexError`` at the
    goal lookup, as the JAX mirror's numpy indexing does.
    """
    cfg = params.cfg
    n, ws = params.num_agents, params.world_size
    f64 = dict(dtype=torch.float64, device=device)
    np.random.uniform(0.2, 0.8)  # wall_length draw (value unused; stream parity)
    if params.fixed_tube_angle is not None:
        angle = params.fixed_tube_angle
    else:
        angle = np.random.uniform(-np.pi / 2, np.pi / 2)
    length = None
    if params.randomize_tube_length:
        length = torch.tensor([ws * 0.8 + np.random.uniform(-ws * 0.3, ws * 0.1)], **f64)
    tube = tube_mod.make_tube(torch.tensor([angle], **f64), ws, corridor.AGENT_SIZE, length)
    perp = np.array([np.sin(angle), np.cos(angle)])
    entrance = tube.entrance[0].cpu().numpy()
    obstacle_pos = np.zeros((params.num_obstacles, 2))
    jr = params.spawn_jitter_range
    placed, thetas, speeds = [], [], []
    while len(placed) < n:
        k = len(placed)
        jitter = params.spawn_jitter_scale * np.random.uniform(-jr, jr, 2)
        pos = entrance + (ws + k) / params.spawn_spacing_div * perp + jitter
        obs_collide = any(np.linalg.norm(o - pos) < 4.0 * corridor.AGENT_SIZE
                          for o in obstacle_pos)
        agent_collide = any(np.linalg.norm(p - pos) < cfg.separation_distance for p in placed)
        if obs_collide or agent_collide:
            continue
        placed.append(pos)
        if cfg.dynamics == DynamicsType.DOUBLE_INTEGRATOR:
            thetas.append(0.0)
            speeds.append(0.0)
        else:
            thetas.append(np.random.uniform(0, 2 * np.pi))
            speeds.append(cfg.v_min)
    agent_pos = np.stack(placed)
    agent_states = np.concatenate(
        [agent_pos, np.array(thetas)[:, None], np.array(speeds)[:, None]], axis=-1)
    landmark_pos = _place_landmarks(params, tube)
    fields = _blank_state(params, 1, tube, torch.float64, device)
    goal = landmark_pos[0].cpu().numpy()[fields["goal_match"][0].cpu().numpy()]
    fields["goal_min_time"] = torch.tensor(
        np.linalg.norm(agent_pos - goal, axis=-1) / params.max_speed, **f64)[None]
    if prev_phase is None:
        prev_phase = np.zeros((n,), np.int64)
    return EnvState(
        agent_states=torch.tensor(agent_states, **f64)[None],
        prev_phase=torch.tensor(np.asarray(prev_phase), dtype=torch.long, device=device)[None],
        landmark_pos=landmark_pos,
        frozen_pos=torch.tensor(agent_pos, **f64)[None] if params.scenario == "v4oct" else None,
        **fields,
    )
