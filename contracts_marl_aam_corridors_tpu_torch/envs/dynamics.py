"""Batched vehicle dynamics, closed-form integrator (port of
``envs/dynamics.py``: ``step_closed_form`` and its helpers, heading models).

The exact solution of the constant-control ODEs over one ``dt`` (the limit
the reference's per-agent RK45 converges to) for the Unicycle/AirTaxi state
``[x, y, theta, v]`` under action ``[dtheta, dv]`` (reference
``multiagent/core.py``), then the reference's speed clamp.  The double
integrator and the scipy-replica ``rk45`` integrator are not ported yet.
"""
from __future__ import annotations

import torch

from ..config.physics import VehicleConfig

Tensor = torch.Tensor


def _closed_form_heading(values: Tensor, action: Tensor, dt: float) -> Tensor:
    """Exact update for [x, y, theta, v] with constant [omega, accel].

    theta(t) = theta0 + w t;  v(t) = v0 + a t
    x(t) = x0 + [(v0+at) sin(th1) - v0 sin(th0)] / w + (a/w^2)(cos(th1)-cos(th0))
    y(t) = y0 - [(v0+at) cos(th1) - v0 cos(th0)] / w + (a/w^2)(sin(th1)-sin(th0))
    with the w -> 0 limit x += (v0 t + a t^2/2) cos(th0) (and sin for y).
    """
    x0, y0, th0, v0 = values.unbind(-1)
    w, a = action.unbind(-1)
    th1 = th0 + w * dt
    v1 = v0 + a * dt

    arc = v0 * dt + 0.5 * a * dt * dt
    x_straight = x0 + arc * torch.cos(th0)
    y_straight = y0 + arc * torch.sin(th0)

    turning = w.abs() >= 1e-8
    w_safe = torch.where(turning, w, torch.ones_like(w))
    sin0, cos0 = torch.sin(th0), torch.cos(th0)
    sin1, cos1 = torch.sin(th1), torch.cos(th1)
    x_turn = x0 + (v1 * sin1 - v0 * sin0) / w_safe + (a / (w_safe * w_safe)) * (cos1 - cos0)
    y_turn = y0 - (v1 * cos1 - v0 * cos0) / w_safe + (a / (w_safe * w_safe)) * (sin1 - sin0)

    x1 = torch.where(turning, x_turn, x_straight)
    y1 = torch.where(turning, y_turn, y_straight)
    return torch.stack([x1, y1, th1, v1], dim=-1)


def clamp_speed(values: Tensor, cfg: VehicleConfig) -> Tensor:
    """Clamp the scalar speed into [v_min, v_max] (core.py:132-135, 309-312)."""
    v = torch.clamp(values[..., 3], cfg.v_min, cfg.v_max)
    return torch.cat([values[..., :3], v[..., None]], dim=-1)


def speed_of(values: Tensor) -> Tensor:
    """Scalar speed per agent (reference ``state.speed``)."""
    return values[..., 3]


def velocity_of(values: Tensor) -> Tensor:
    """Cartesian velocity per agent (reference ``state.p_vel``)."""
    v = values[..., 3]
    th = values[..., 2]
    return torch.stack([v * torch.cos(th), v * torch.sin(th)], dim=-1)


def step_closed_form(
    values: Tensor,
    action: Tensor,
    cfg: VehicleConfig,
    active: Tensor | None = None,
) -> Tensor:
    """Advance ``[..., 4]`` states one ``cfg.dt`` under constant ``[..., 2]``
    controls.  ``active`` (bool, the leading dims) freezes inactive agents,
    like the reference's skip of agents with ``status=True`` (core.py:819-826).
    """
    new_values = clamp_speed(_closed_form_heading(values, action, cfg.dt), cfg)
    if active is not None:
        new_values = torch.where(active[..., None], new_values, values)
    return new_values
