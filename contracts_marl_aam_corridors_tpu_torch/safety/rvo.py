"""Batched ORCA (reciprocal velocity obstacles) action projection (port of
``safety/rvo.py``).

The reference's ``multiagent/rvo.py`` wraps the external ``rvo2``
simulator (the ORCA algorithm of van den Berg et al.) and is dead code
upstream.  As in the JAX package, the ORCA half-planes are built for all
agent pairs at once and a fixed number of cyclic projections replaces
rvo2's 2-D linear program, on a batch of envs: states (B, N, 4).

Default parameters mirror the reference's RVOPolicy (time horizon 2.5 s,
radius (1 + 5e-2) * agent radius).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..config.physics import VehicleConfig
from .cbf import argmin_gap, pick_rows

Tensor = torch.Tensor

TIME_HORIZON = 2.5  # rvo.py:14 rvo_time_horizon
RADIUS_SCALE = 1.0 + 5e-2  # rvo.py setAgentRadius
ORCA_ITERS = 8


def _perp(v: Tensor) -> Tensor:
    return torch.stack([-v[..., 1], v[..., 0]], dim=-1)


def orca_halfplanes(pos: Tensor, vel: Tensor, radius: float, tau: float, dt: float):
    """The ORCA half-plane (point, normal) of every ordered agent pair.

    pos/vel: (..., N, 2).  Returns (points, normals, valid), (..., N, N,
    ...): the constraint of agent a with respect to b is
    (v - point[a, b]) . normal[a, b] >= 0.  Each agent takes half the
    correction (reciprocity)."""
    n = pos.shape[-2]
    rel_pos = pos[..., None, :, :] - pos[..., :, None, :]  # b - a
    rel_vel = vel[..., :, None, :] - vel[..., None, :, :]  # a - b
    dist_sq = (rel_pos**2).sum(dim=-1)
    R = 2.0 * radius
    R_sq = R * R
    eye = torch.eye(n, dtype=torch.bool, device=pos.device)

    no_collision = dist_sq > R_sq

    # no collision: the velocity obstacle's cone truncated at the horizon
    w = rel_vel - rel_pos / tau
    w_len_sq = torch.clamp((w**2).sum(dim=-1), min=1e-12)
    dot1 = (w * rel_pos).sum(dim=-1)
    # onto the cut-off circle?
    on_circle = (dot1 < 0.0) & (dot1 * dot1 > R_sq * w_len_sq)
    w_len = torch.sqrt(w_len_sq)
    unit_w = w / w_len[..., None]
    u_circle = (R / tau - w_len)[..., None] * unit_w
    n_circle = unit_w

    # onto the legs
    leg = torch.sqrt(torch.clamp(dist_sq - R_sq, min=1e-12))
    det = rel_pos[..., 0] * w[..., 1] - rel_pos[..., 1] * w[..., 0]
    dist_sq_c = torch.clamp(dist_sq, min=1e-12)[..., None]
    dir_right = (rel_pos * leg[..., None] - _perp(rel_pos) * R) / dist_sq_c
    dir_left = (rel_pos * leg[..., None] + _perp(rel_pos) * R) / dist_sq_c
    direction = torch.where((det > 0.0)[..., None], dir_left, dir_right)
    dot2 = (rel_vel * direction).sum(dim=-1)
    u_leg = dot2[..., None] * direction - rel_vel
    n_leg = u_leg / torch.clamp(torch.linalg.vector_norm(u_leg, dim=-1, keepdim=True),
                                min=1e-12)

    u_nc = torch.where(on_circle[..., None], u_circle, u_leg)
    n_nc = torch.where(on_circle[..., None], n_circle, n_leg)

    # collision: push apart within one dt
    w_c = rel_vel - rel_pos / dt
    w_c_len = torch.clamp(torch.linalg.vector_norm(w_c, dim=-1), min=1e-12)
    unit_wc = w_c / w_c_len[..., None]
    u_c = (R / dt - w_c_len)[..., None] * unit_wc

    u = torch.where(no_collision[..., None], u_nc, u_c)
    nrm = torch.where(no_collision[..., None], n_nc, unit_wc)

    points = vel[..., :, None, :] + 0.5 * u  # the reciprocal half-correction
    valid = ~eye
    return points, nrm, valid


def orca_project(pos: Tensor, vel: Tensor, pref_vel: Tensor, max_speed: float, radius: float,
                 tau: float = TIME_HORIZON, dt: float = 0.1, iters: int = ORCA_ITERS,
                 trace: Optional[dict] = None) -> Tensor:
    """Each agent's preferred velocity projected onto its ORCA-feasible set.

    ``iters`` cyclic projections, each onto the most-violated constraint
    (the first on a tie), each followed by a speed clamp: the JAX package's
    ``lax.scan`` of fixed length as a loop.  ``trace`` takes the most
    violated constraint of every iteration, (..., N, iters), and its gap."""
    points, normals, valid = orca_halfplanes(pos, vel, radius, tau, dt)
    v = torch.clamp(pref_vel, -max_speed, max_speed)
    worsts, gaps = [], []
    for _ in range(iters):
        viol = ((v[..., :, None, :] - points) * normals).sum(dim=-1)  # (..., N, N)
        viol = torch.where(valid, viol, torch.inf)
        worst = viol.argmin(dim=-1)
        p = pick_rows(points, worst)
        nn = pick_rows(normals, worst)
        amount = ((v - p) * nn).sum(dim=-1)
        v = torch.where((amount < 0.0)[..., None], v - amount[..., None] * nn, v)
        speed = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        v = torch.where(speed > max_speed, v / torch.clamp(speed, min=1e-12) * max_speed, v)
        if trace is not None:
            worsts.append(worst)
            gaps.append(argmin_gap(viol))
    if trace is not None:
        trace["most_violated"] = (torch.stack(worsts, dim=-1), torch.stack(gaps, dim=-1))
    return v


def rvo_filter(states: Tensor, actions: Tensor, cfg: VehicleConfig, agent_radius: float = 0.06,
               trace: Optional[dict] = None):
    """The action filter through ORCA, for a batch of envs.

    The desired post-step velocity ``v + a * dt`` is projected onto the ORCA
    set and the acceleration recovered from it (clipped to the
    acceleration box).  It reads ``states[..., 2:]`` as a velocity whatever
    the vehicle, as the JAX package's does.  Returns the CBF and HJ
    filters' tuple; ``trace``: see ``safety/cbf.py``.
    """
    pos, vel = states[..., :2], states[..., 2:]
    # one rounding, as the jitted JAX package's fused multiply-add
    pref = torch.addcmul(vel, actions, actions.new_tensor(cfg.dt))
    v_safe = orca_project(pos, vel, pref, cfg.v_max, RADIUS_SCALE * agent_radius, dt=cfg.dt,
                          trace=trace)
    a = (v_safe - vel) / cfg.dt
    a = torch.clamp(a, cfg.accel_min, cfg.accel_max).to(actions.dtype)
    diff = torch.linalg.vector_norm(actions - a, dim=-1).to(actions.dtype)
    filtered = diff > 1e-4
    if trace is not None:
        trace["filtered"] = (filtered, (diff - 1e-4).abs())
        trace["applied"] = torch.ones_like(filtered)
    return a, filtered, diff, torch.zeros(states.shape[:-1], dtype=torch.long,
                                          device=states.device)
