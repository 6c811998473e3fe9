"""Rotated-corridor ("tube") geometry and the july phase machine (port of
``envs/tube.py``).

Counterparts of the reference scenario helpers ``setup_tube_params``
(july:518-613), ``_tube_coords``/``_in_tube_rect``/``_in_entrance_gate``
(july:616-645) and ``get_agent_phase`` (july:683-733).

Batch convention: tube fields are ``(B, 2)`` or ``(B,)``; positions are
``(B, K, 2)`` (K agents per env) and results ``(B, K)``.
"""
from __future__ import annotations

import torch

from .types import TubeParams

Tensor = torch.Tensor

EPS = 0.05


def _vec(x: Tensor) -> Tensor:
    return x[:, None, :]


def _sc(x: Tensor) -> Tensor:
    return x[:, None]


def _dot(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


def make_tube(
    angle: Tensor,
    world_size: float,
    agent_size: float,
    length: Tensor | None = None,
) -> TubeParams:
    """Tube geometry for sampled rotation angles ``(B,)`` (july:518-613):
    width = max(3*size*2.5, 0.15*world_size), length = 0.8*world_size,
    entrance/exit at -/+ length/4 rotated about the origin."""
    width = torch.full_like(angle, max(3 * agent_size * 2.5, world_size * 0.15))
    if length is None:
        length = torch.full_like(angle, world_size * 0.8)
    c, s = torch.cos(angle), torch.sin(angle)
    entrance = torch.stack([s * (length / 4), c * (length / 4)], dim=-1)
    exit_ = -entrance
    span = exit_ - entrance
    frame_length = torch.linalg.vector_norm(span, dim=-1) + 1e-9
    e = span / frame_length[:, None]
    n = torch.stack([-e[:, 1], e[:, 0]], dim=-1)
    return TubeParams(
        entrance=entrance,
        exit=exit_,
        width=width,
        angle=angle,
        length=length,
        e=e,
        n=n,
        frame_length=frame_length,
        half_width=width * 0.5,
    )


def tube_coords(tube: TubeParams, pos: Tensor) -> tuple[Tensor, Tensor]:
    """Longitudinal s (from entrance, along e) and signed lateral y.

    The reference rounds the position to float32 (july:624) and stores the
    normal in float32 (july:602); the dots then promote back to the working
    type.  That mixed precision is kept so gate and phase decisions flip at
    the same thresholds.
    """
    dtype = tube.entrance.dtype
    r = pos.to(torch.float32).to(dtype) - _vec(tube.entrance)
    s = _dot(r, _vec(tube.e))
    y = _dot(r, _vec(tube.n.to(torch.float32).to(dtype)))
    return s, y


def in_tube_rect(tube: TubeParams, s: Tensor, y: Tensor) -> Tensor:
    L = _sc(tube.frame_length)
    return (-EPS <= s) & (s <= L + EPS) & (y.abs() <= _sc(tube.half_width) + EPS)


def in_entrance_gate(
    tube: TubeParams, s: Tensor, y: Tensor, gate_front_ratio: float, gate_back_ratio: float
) -> Tensor:
    L = _sc(tube.frame_length)
    gate_front = gate_front_ratio * L
    gate_back = gate_back_ratio * L
    return (
        (-gate_back - EPS <= s)
        & (s <= gate_front + EPS)
        & (y.abs() <= _sc(tube.half_width) + EPS)
    )


def passed_tube(tube: TubeParams, pos: Tensor) -> Tensor:
    """dot(pos - exit, unit(exit-entrance)) > 0 (july:688-691), normalized
    without the 1e-9 epsilon of the cached frame, like the reference."""
    span = tube.exit - tube.entrance
    direction = span / torch.linalg.vector_norm(span, dim=-1, keepdim=True)
    return _dot(pos - _vec(tube.exit), _vec(direction)) > 0


def entrance_projection(tube: TubeParams, pos: Tensor) -> tuple[Tensor, Tensor]:
    """(proj, perp_dist) of pos relative to the entrance along the tube
    (july:1151-1158), in the working type (no float32 rounding here)."""
    span = tube.exit - tube.entrance
    direction = _vec(span / torch.linalg.vector_norm(span, dim=-1, keepdim=True))
    rel = pos - _vec(tube.entrance)
    proj = _dot(rel, direction)
    perp = torch.linalg.vector_norm(rel - proj[..., None] * direction, dim=-1)
    return proj, perp


def agent_phase(
    tube: TubeParams,
    pos: Tensor,
    prev_phase: Tensor,
    gate_front_ratio: float,
    gate_back_ratio: float,
) -> tuple[Tensor, Tensor]:
    """One evaluation of the reference phase machine (july:683-733).

    Returns ``(phase, new_prev_phase)``.  The reference mutates
    ``agent.previous_phase`` only on the 1->2 exit transition (july:724-728).
    Branches (0-indexed phases):
      not in_tube and not passed      -> 0
      in_tube: prev==0 -> 1 if valid_entrance else 0 ; prev>0 -> 1
      past the exit plane: prev==1 and passed -> 2 (and prev:=2)
                           prev==2 and passed -> 2 ; otherwise 0
    """
    s, y = tube_coords(tube, pos)
    in_tube = in_tube_rect(tube, s, y)
    passed = passed_tube(tube, pos)
    valid_entrance = in_entrance_gate(tube, s, y, gate_front_ratio, gate_back_ratio)

    zero = torch.zeros_like(prev_phase)
    one = torch.ones_like(prev_phase)
    two = torch.full_like(prev_phase, 2)
    pre_tube = ~in_tube & ~passed
    phase_in = torch.where(prev_phase == 0, torch.where(valid_entrance, one, zero), one)
    phase_out = torch.where((prev_phase == 1) | ((prev_phase == 2) & passed), two, zero)
    phase = torch.where(pre_tube, zero, torch.where(in_tube, phase_in, phase_out))
    out_of_tube = ~in_tube & ~pre_tube
    phase = torch.where(out_of_tube & (prev_phase == 1) & ~passed, zero, phase)
    exited = out_of_tube & (prev_phase == 1) & passed
    new_prev = torch.where(exited, two, prev_phase)
    return phase, new_prev
