"""Batched vehicle dynamics (port of ``envs/dynamics.py``).

Two integrators over ``(..., 4)`` state tensors, as in the JAX package:

* ``step_closed_form`` — the exact solution of the constant-control ODEs
  over one ``dt`` (the limit the reference's per-agent RK45 converges to);
  the default for training.
* ``step_rk45`` — a replica of scipy's Dormand–Prince RK45 (the reference's
  ``solve_ivp(..., method='RK45')``, multiagent/core.py:125-139, 207-218,
  300-316) with scipy's initial-step selection and step-size controller
  (rtol 1e-3, atol 1e-6), for parity runs.

State layouts (reference ``multiagent/core.py``):
  DoubleIntegrator: ``[x, y, vx, vy]``      action ``[ax, ay]``
  Unicycle/AirTaxi: ``[x, y, theta, v]``    action ``[dtheta, dv]``

After integration the reference's clamp follows: the heading models clamp
the scalar speed into ``[v_min, v_max]`` (core.py:132-135, 309-312); the
double integrator rescales its velocity vector only above ``v_max``
(core.py:213-215).  ``speed_of``, ``velocity_of`` and ``heading_of`` read
both layouts, as the reference's ``state.speed``, ``p_vel`` and ``theta``
properties do.
"""
from __future__ import annotations

import torch

from ..config.physics import DynamicsType, VehicleConfig

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


def _closed_form_di(values: Tensor, action: Tensor, dt: float) -> Tensor:
    """Exact update for [x, y, vx, vy] with constant [ax, ay].

    The velocity is one ``addcmul``, rounded once, for bit parity with the
    jitted JAX reference: XLA compiles the JAX package's
    ``vel + action * dt`` to a fused multiply-add on its CPU backend, and
    the difference is not in the last bit where a velocity component comes
    back to rest: 0.5 - 5 * 0.1 is 0 rounded twice but -2.8e-17 rounded
    once, and the heading ``atan2(vy, vx)`` of the agent then turns by pi.
    PyTorch's CPU and CUDA ``addcmul`` kernels both round once, equal bit
    for bit (``scripts/torch_fma_probe.py``)."""
    pos = values[..., :2]
    vel = values[..., 2:]
    pos1 = pos + vel * dt + 0.5 * action * dt * dt
    vel1 = torch.addcmul(vel, action, action.new_tensor(dt))
    return torch.cat([pos1, vel1], dim=-1)


def _is_di(cfg: VehicleConfig) -> bool:
    return cfg.dynamics == DynamicsType.DOUBLE_INTEGRATOR


def clamp_speed(values: Tensor, cfg: VehicleConfig) -> Tensor:
    """Post-integration speed clamp, the reference's for each model."""
    if _is_di(cfg):
        # core.py:213-215: rescale the velocity vector only above v_max
        vel = values[..., 2:]
        speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
        scale = torch.where(speed > cfg.v_max, cfg.v_max / torch.clamp(speed, min=1e-30),
                            torch.ones_like(speed))
        return torch.cat([values[..., :2], vel * scale], dim=-1)
    # core.py:132-135 / 309-312: clamp the scalar speed into [v_min, v_max]
    v = torch.clamp(values[..., 3], cfg.v_min, cfg.v_max)
    return torch.cat([values[..., :3], v[..., None]], dim=-1)


def speed_of(values: Tensor, cfg: VehicleConfig) -> Tensor:
    """Scalar speed per agent (reference ``state.speed``)."""
    if _is_di(cfg):
        return torch.linalg.vector_norm(values[..., 2:], dim=-1)
    return values[..., 3]


def velocity_of(values: Tensor, cfg: VehicleConfig) -> Tensor:
    """Cartesian velocity per agent (reference ``state.p_vel``)."""
    if _is_di(cfg):
        return values[..., 2:]
    v = values[..., 3]
    th = values[..., 2]
    return torch.stack([v * torch.cos(th), v * torch.sin(th)], dim=-1)


def heading_of(values: Tensor, cfg: VehicleConfig) -> Tensor:
    """Heading angle per agent (reference ``state.theta``): for the double
    integrator ``atan2(vy, vx)`` (core.py:187-189), so a velocity of signed
    zeros gives 0 or +-pi as the signs say."""
    if _is_di(cfg):
        return torch.atan2(values[..., 3], values[..., 2])
    return values[..., 2]


def stopped_row(row: Tensor, cfg: VehicleConfig, gen: torch.Generator,
                fixed_theta: float | None = None) -> Tensor:
    """``reset_velocity()`` of an agent frozen at its goal (core.py:145-153,
    223-225, 324-333), for rows (B, 4): the double integrator zeroes its
    velocity and draws nothing; the heading models take a heading at speed
    v_min, ``fixed_theta`` where it is given (``EnvParams``'s parity hook:
    no draw), else theta ~ U(0, 2pi) from ``gen`` (one draw a row)."""
    if _is_di(cfg):
        return torch.cat([row[:, :2], torch.zeros_like(row[:, 2:])], dim=-1)
    if fixed_theta is not None:
        theta = torch.full_like(row[:, 2], fixed_theta)
    else:
        theta = (2 * torch.pi) * torch.rand(row.shape[0], generator=gen, dtype=row.dtype,
                                            device=row.device)
    return torch.stack([row[:, 0], row[:, 1], theta, torch.full_like(theta, cfg.v_min)],
                       dim=-1)


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
    if _is_di(cfg):
        new_values = _closed_form_di(values, action, cfg.dt)
    else:
        new_values = _closed_form_heading(values, action, cfg.dt)
    new_values = clamp_speed(new_values, cfg)
    if active is not None:
        new_values = torch.where(active[..., None], new_values, values)
    return new_values


# ---------------------------------------------------------------------------
# scipy's RK45 (Dormand–Prince 4(5)): the published tableau, scipy's step-size
# controller (rtol 1e-3, atol 1e-6, SAFETY 0.9, MIN_FACTOR 0.2, MAX_FACTOR
# 10, error exponent -1/5) and its initial-step heuristic (Hairer, Norsett &
# Wanner, Solving ODEs I, II.4).  The JAX package runs one while loop per
# state under vmap; here one loop advances a batch of states, each with its
# own (t, y, h_abs, rejected, done), and a state that is done is held
# exactly while the others go on.
# ---------------------------------------------------------------------------

_DP_A = [
    [],
    [1 / 5],
    [3 / 40, 9 / 40],
    [44 / 45, -56 / 15, 32 / 9],
    [19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729],
    [9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656],
]
_DP_B = [35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84]
_DP_E = [71 / 57600, 0.0, -71 / 16695, 71 / 1920, -17253 / 339200, 22 / 525, -1 / 40]

_RTOL = 1e-3
_ATOL = 1e-6
_SAFETY = 0.9
_MIN_FACTOR = 0.2
_MAX_FACTOR = 10.0
# a step of scipy's controller shrinks h at most fivefold and takes no more
# than a few accepted steps over one dt; far beyond that the loop is broken
RK45_MAX_ITERATIONS = 10_000


def _ode(y: Tensor, action: Tensor, dynamics: DynamicsType) -> Tensor:
    if dynamics == DynamicsType.DOUBLE_INTEGRATOR:
        return torch.stack([y[:, 2], y[:, 3], action[:, 0], action[:, 1]], dim=-1)
    return torch.stack([y[:, 3] * torch.cos(y[:, 2]), y[:, 3] * torch.sin(y[:, 2]),
                        action[:, 0], action[:, 1]], dim=-1)


def _rms(x: Tensor) -> Tensor:
    """sqrt(mean(x ** 2)) over the 4 state components, summed in order."""
    sq = x * x
    return torch.sqrt((((sq[:, 0] + sq[:, 1]) + sq[:, 2]) + sq[:, 3]) / 4.0)


def _rk_step(f, y: Tensor, h: Tensor):
    """One Dormand–Prince step of size h (L,) from y (L, 4): (y_new, error)."""
    A, Bc, Ec = _DP_A, _DP_B, _DP_E
    h = h[:, None]
    k0 = f(y)
    k1 = f(y + h * (A[1][0] * k0))
    k2 = f(y + h * (A[2][0] * k0 + A[2][1] * k1))
    k3 = f(y + h * (A[3][0] * k0 + A[3][1] * k1 + A[3][2] * k2))
    k4 = f(y + h * (A[4][0] * k0 + A[4][1] * k1 + A[4][2] * k2 + A[4][3] * k3))
    k5 = f(y + h * (A[5][0] * k0 + A[5][1] * k1 + A[5][2] * k2 + A[5][3] * k3
                    + A[5][4] * k4))
    y_new = y + h * (Bc[0] * k0 + Bc[2] * k2 + Bc[3] * k3 + Bc[4] * k4 + Bc[5] * k5)
    k6 = f(y_new)
    err = h * (Ec[0] * k0 + Ec[2] * k2 + Ec[3] * k3 + Ec[4] * k4 + Ec[5] * k5 + Ec[6] * k6)
    return y_new, err


def _error_norm(err: Tensor, y0: Tensor, y1: Tensor) -> Tensor:
    scale = _ATOL + torch.maximum(y0.abs(), y1.abs()) * _RTOL
    return _rms(err / scale)


def _select_initial_step(f, y0: Tensor, f0: Tensor, t_bound: Tensor) -> Tensor:
    """scipy ``select_initial_step`` for direction +1 and error order 4.

    Both sides of each ``where`` are computed, as in the JAX package: where
    ``d1`` is 0 (in float32 ``1e-300`` is 0 too) the unselected side is inf
    or nan and never reaches the result."""
    scale = _ATOL + y0.abs() * _RTOL
    d0 = _rms(y0 / scale)
    d1 = _rms(f0 / scale)
    tiny = (d0 < 1e-5) | (d1 < 1e-5)
    h0 = torch.where(tiny, torch.full_like(d0, 1e-6), 0.01 * d0 / torch.clamp(d1, min=1e-300))
    h0 = torch.minimum(h0, t_bound)  # the interval length clamp before the probe
    f1 = f(y0 + h0[:, None] * f0)
    d2 = _rms((f1 - f0) / scale) / h0
    flat = (d1 <= 1e-15) & (d2 <= 1e-15)
    h1 = torch.where(flat, torch.clamp(h0 * 1e-3, min=1e-6),
                     (0.01 / torch.maximum(d1, d2)) ** (1.0 / 5.0))
    return torch.minimum(torch.minimum(100 * h0, h1), t_bound)


def rk45_solve(y0: Tensor, action: Tensor, dt: float, dynamics: DynamicsType):
    """Integrate each state of ``y0`` (L, 4) over [0, dt] under its constant
    ``action`` (L, 2) as scipy's RK45 does.  Returns the states at ``dt``
    and each state's count of accepted steps (L,).

    The loop runs until every state is done and reads that condition on the
    host once an iteration; past ``RK45_MAX_ITERATIONS`` it raises."""
    f = lambda y: _ode(y, action, dynamics)
    L = y0.shape[0]
    t_bound = torch.full((L,), dt, dtype=y0.dtype, device=y0.device)
    t = torch.zeros_like(t_bound)
    y = y0
    h_abs = _select_initial_step(f, y0, f(y0), t_bound)
    rejected = torch.zeros((L,), dtype=torch.bool, device=y0.device)
    done = torch.zeros_like(rejected)
    accepted = torch.zeros((L,), dtype=torch.long, device=y0.device)
    for _ in range(RK45_MAX_ITERATIONS):
        if bool(done.all()):
            return y, accepted
        # scipy clips the proposal so as not to overshoot t_bound; h is the
        # step actually taken
        t_new_prop = torch.minimum(t + h_abs, t_bound)
        h = t_new_prop - t
        y_new, err = _rk_step(f, y, h)
        norm = _error_norm(err, y, y_new)
        accept = norm < 1.0
        grow = _SAFETY * norm ** (-1.0 / 5.0)
        factor_acc = torch.where(norm == 0.0, torch.full_like(norm, _MAX_FACTOR),
                                 torch.clamp(grow, max=_MAX_FACTOR))
        # after a rejection within this dt the accepted step does not grow h
        factor_acc = torch.where(rejected, torch.clamp(factor_acc, max=1.0), factor_acc)
        factor_rej = torch.clamp(grow, min=_MIN_FACTOR)
        h_abs_new = h.abs() * torch.where(accept, factor_acc, factor_rej)
        t_next = torch.where(accept, t_new_prop, t)
        y_next = torch.where(accept[:, None], y_new, y)
        live = ~done
        t = torch.where(live, t_next, t)
        y = torch.where(live[:, None], y_next, y)
        h_abs = torch.where(live, h_abs_new, h_abs)
        rejected = torch.where(live, ~accept, rejected)
        accepted = accepted + (live & accept).to(accepted.dtype)
        done = done | (accept & (t_next >= t_bound))
    raise RuntimeError(f"rk45 did not finish {L} states in {RK45_MAX_ITERATIONS} iterations")


def step_rk45(
    values: Tensor,
    action: Tensor,
    cfg: VehicleConfig,
    active: Tensor | None = None,
) -> Tensor:
    """One ``cfg.dt`` of scipy's adaptive RK45 on ``[..., 4]`` states, then
    the speed clamp; ``active`` as in ``step_closed_form``."""
    flat_values = values.reshape(-1, 4)
    flat_action = action.reshape(-1, 2).to(values.dtype)
    new_values, _ = rk45_solve(flat_values, flat_action, cfg.dt, cfg.dynamics)
    new_values = clamp_speed(new_values.reshape(values.shape), cfg)
    if active is not None:
        new_values = torch.where(active[..., None], new_values, values)
    return new_values


def integrate(
    values: Tensor,
    action: Tensor,
    cfg: VehicleConfig,
    active: Tensor | None = None,
    method: str = "closed_form",
) -> Tensor:
    if method == "closed_form":
        return step_closed_form(values, action, cfg, active)
    if method == "rk45":
        return step_rk45(values, action, cfg, active)
    raise ValueError(f"unknown integrator {method!r}")
