"""Episode reset for a batch of envs: tube sampling, agent spawning, landmark
placement (port of ``envs/reset.py``, july branch).

Same distributions and rejection rule as the reference's ``reset_world`` ->
``random_scenario`` -> ``setup_tube_params`` chain (july:339-613); the random
stream is a ``torch.Generator``'s, so draws differ from both the reference
and the JAX package.
"""
from __future__ import annotations

import math

import torch

from . import tube as tube_mod
from .types import EnvParams, EnvState, TubeParams

Tensor = torch.Tensor

AGENT_SIZE = 0.06  # Entity.size default (core.py:385)
SPAWN_CANDIDATES = 32
# july spawn rule (july:452-486): jitter 0.2*U(-ws, ws), spacing (ws+k)/5
SPAWN_JITTER_SCALE = 0.2
SPAWN_SPACING_DIV = 5.0


def _uniform(gen: torch.Generator, shape, lo: float, hi: float, like: Tensor) -> Tensor:
    u = torch.rand(shape, generator=gen, dtype=like.dtype, device=like.device)
    return lo + (hi - lo) * u


def _blank_state(params: EnvParams, B: int, tube: TubeParams, dtype, device) -> dict:
    n = params.num_agents
    zf = lambda *s: torch.zeros(s, dtype=dtype, device=device)
    zi = lambda *s: torch.zeros(s, dtype=torch.long, device=device)
    full = lambda v, dt: torch.full((B, n), v, dtype=dt, device=device)
    return dict(
        p_dist=zf(B, n),
        time=zf(B, n),
        status=torch.zeros((B, n), dtype=torch.bool, device=device),
        phase_reached=zi(B, n),
        entry_cooldown=zi(B, n),
        tube=tube,
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
    )


def _place_landmarks(params: EnvParams, tube: TubeParams) -> Tensor:
    """Landmark positions (B, L, 2) of the ``point`` formation
    (utils.py ``set_landmarks_in_point``:165-194): every landmark at
    ``exit + R(angle) @ [0, -world_size/3]``."""
    ws = params.world_size
    c, s = torch.cos(tube.angle), torch.sin(tube.angle)
    offset = torch.stack([-s * (ws / 3), -c * (ws / 3)], dim=-1)
    point = tube.exit + offset
    return point[:, None, :].expand(-1, params.num_landmarks, 2).clone()


def _spawn_agents(params: EnvParams, tube: TubeParams, gen: torch.Generator) -> Tensor:
    """Sequential rejection-sampled spawn along the pre-entrance axis.

    july:452-486: agent k tries ``entrance + (world_size+k)/5 * perp +
    jitter`` with jitter ~ 0.2*U(-ws, ws)^2, rejected while within separation
    distance of an already-placed agent.  Like the JAX package, a fixed block
    of K candidates is drawn per agent and the first collision-free one is
    taken (the first candidate if none is free; failure probability is below
    reject_rate^K), so no data-dependent loop runs on the device.
    """
    n, ws = params.num_agents, params.world_size
    K = SPAWN_CANDIDATES
    ang = tube.angle
    B = ang.shape[0]
    perp = torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1)
    sep = params.cfg.separation_distance
    placed = []
    for k in range(n):
        jitter = SPAWN_JITTER_SCALE * _uniform(gen, (B, K, 2), -ws, ws, ang)
        base = tube.entrance + (ws + k) / SPAWN_SPACING_DIV * perp
        cand = base[:, None, :] + jitter  # (B, K, 2)
        if placed:
            prev = torch.stack(placed, dim=1)  # (B, k, 2)
            d = torch.linalg.vector_norm(prev[:, None, :, :] - cand[:, :, None, :], dim=-1)
            collide = (d < sep).any(dim=-1)  # (B, K)
            first_ok = (~collide).to(torch.uint8).argmax(dim=1)
        else:
            first_ok = torch.zeros(B, dtype=torch.long, device=ang.device)
        idx = first_ok[:, None, None].expand(B, 1, 2)
        placed.append(torch.gather(cand, 1, idx)[:, 0, :])
    return torch.stack(placed, dim=1)


def _initial_velocity(params: EnvParams, gen: torch.Generator, B: int, like: Tensor):
    """reset_velocity() at spawn (core.py:145-153, 324-333): heading models
    draw theta ~ U(0, 2pi) at speed v_min."""
    theta = _uniform(gen, (B, params.num_agents), 0.0, 2 * math.pi, like)
    return theta, torch.full_like(theta, params.cfg.v_min)


def reset(
    params: EnvParams, num_envs: int, gen: torch.Generator, device, dtype=torch.float32
) -> EnvState:
    """Fresh episodes for ``num_envs`` envs.

    ``prev_phase`` starts at zero here; ``env.step``'s auto-reset carries the
    previous episode's value through instead (the reference never clears
    ``agent.previous_phase``).
    """
    B, n = num_envs, params.num_agents
    ref = torch.empty((B,), dtype=dtype, device=device)
    angle = _uniform(gen, (B,), -math.pi / 2, math.pi / 2, ref)
    tube = tube_mod.make_tube(angle, params.world_size, AGENT_SIZE)
    agent_pos = _spawn_agents(params, tube, gen)
    theta, speed = _initial_velocity(params, gen, B, ref)
    agent_states = torch.cat([agent_pos, theta[..., None], speed[..., None]], dim=-1)
    landmark_pos = _place_landmarks(params, tube)
    fields = _blank_state(params, B, tube, dtype, device)
    goal = torch.gather(
        landmark_pos, 1, fields["goal_match"][..., None].expand(B, n, 2)
    )
    fields["goal_min_time"] = (
        torch.linalg.vector_norm(agent_pos - goal, dim=-1) / params.max_speed
    )
    return EnvState(
        agent_states=agent_states,
        prev_phase=torch.zeros((B, n), dtype=torch.long, device=device),
        landmark_pos=landmark_pos,
        **fields,
    )
