"""The torch port's dynamics (``envs/dynamics.py``: the double integrator and
the scipy-replica RK45) against scipy's ``solve_ivp`` and the JAX package's,
on the CPU in float64.

The states and controls are numpy arrays drawn from a seed (the ranges of
``tests/test_dynamics.py``, with a few double-integrator states at rest
under zero control, where the heading is ``atan2`` of signed zeros, and a
few on the env's grid of velocities, multiples of 0.5 under controls of
0 and +-5, which the step brings back to rest).  RK45
is held at atol 1e-12 to scipy and to the JAX ``step_rk45``, as the JAX
package's own test holds it to scipy (``tests/test_dynamics.py:70-75``); the
closed form at 1e-12 to the JAX closed form, and within 5e-8 of RK45
(``tests/test_dynamics.py:79-87``).  One jitted JAX ``step_rk45`` per vehicle.
"""
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.integrate import solve_ivp

from contracts_marl_aam_corridors_tpu.config import physics as jphysics
from contracts_marl_aam_corridors_tpu.envs import dynamics as jdynamics

from contracts_marl_aam_corridors_tpu_torch.config import physics
from contracts_marl_aam_corridors_tpu_torch.envs import dynamics

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-12)
VEHICLES = ("air_taxi", "unicycle_vehicle", "double_integrator")
N = 64


def is_di(cfg):
    return cfg.dynamics == physics.DynamicsType.DOUBLE_INTEGRATOR


def sample(cfg, n, seed):
    """States and decoded controls (the action decoder's x5 sensitivity).
    Of the double-integrator states the first four sit at rest under zero
    control and the next twelve have velocity components of -1 to 1 in
    steps of 0.5 under controls of 0 or +-5, as the env's 5-action table
    gives them."""
    rng = np.random.RandomState(seed)
    if is_di(cfg):
        states = rng.uniform(-2, 2, size=(n, 4))
        acts = rng.uniform(cfg.accel_min, cfg.accel_max, size=(n, 2)) * 5.0
        states[:4, 2:] = 0.0
        acts[:4] = 0.0
        states[4:16, 2:] = rng.randint(-2, 3, (12, 2)) * 0.5
        acts[4:16] = rng.randint(-1, 2, (12, 2)) * 5.0
        return states, acts
    states = np.stack([rng.uniform(-2, 2, n), rng.uniform(-2, 2, n),
                       rng.uniform(-np.pi, np.pi, n), rng.uniform(cfg.v_min, cfg.v_max, n)],
                      axis=-1)
    acts = np.stack([rng.uniform(-cfg.angular_rate_max, cfg.angular_rate_max, n) * 5.0,
                     rng.uniform(cfg.accel_min, cfg.accel_max, n) * 5.0], axis=-1)
    return states, acts


def scipy_step(values, action, cfg):
    """The reference's step: solve_ivp RK45 over dt, then its speed clamp."""
    if is_di(cfg):
        ode = lambda t, y: np.array([y[2], y[3], action[0], action[1]])
    else:
        ode = lambda t, y: np.array([y[3] * np.cos(y[2]), y[3] * np.sin(y[2]),
                                     action[0], action[1]])
    out = solve_ivp(ode, [0, cfg.dt], values, method="RK45").y[:, -1].copy()
    if is_di(cfg):
        speed = np.hypot(out[2], out[3])
        if speed > cfg.v_max:
            out[2:] *= cfg.v_max / speed
    else:
        out[3] = np.clip(out[3], cfg.v_min, cfg.v_max)
    return out


@functools.lru_cache(maxsize=None)
def jax_rk45(vehicle):
    return jax.jit(partial(jdynamics.step_rk45, cfg=jphysics.vehicle_config(vehicle)))


@functools.lru_cache(maxsize=None)
def jax_closed_form(vehicle):
    """Jitted, as the JAX env runs it: XLA's CPU backend fuses the velocity
    update into a multiply-add (see the port's ``_closed_form_di``)."""
    return jax.jit(partial(jdynamics.step_closed_form, cfg=jphysics.vehicle_config(vehicle)))


def port(x):
    return torch.as_tensor(x, dtype=torch.float64)


@pytest.mark.parametrize("vehicle", VEHICLES)
def test_rk45_matches_scipy(vehicle):
    cfg = physics.vehicle_config(vehicle)
    states, acts = sample(cfg, N, 0)
    got = dynamics.step_rk45(port(states), port(acts), cfg).numpy()
    want = np.stack([scipy_step(s, a, cfg) for s, a in zip(states, acts)])
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("vehicle", VEHICLES)
def test_rk45_matches_jax(vehicle):
    """(N, 3, 4) states, some agents frozen, against the JAX step_rk45."""
    cfg = physics.vehicle_config(vehicle)
    states, acts = sample(cfg, 3 * N, 1)
    active = np.random.RandomState(2).rand(N, 3) < 0.8
    got = dynamics.step_rk45(port(states).reshape(N, 3, 4), port(acts).reshape(N, 3, 2), cfg,
                             torch.as_tensor(active)).numpy()
    want = np.asarray(jax_rk45(vehicle)(jnp.asarray(states.reshape(N, 3, 4)),
                                        jnp.asarray(acts.reshape(N, 3, 2)),
                                        active=jnp.asarray(active)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("vehicle", VEHICLES)
def test_rk45_lanes_are_independent(vehicle):
    """A state's result and step count are the same in a batch as alone,
    bit for bit: a state that is done is held while the others go on.  The
    controls are scaled by 1 to 300 so that the states take different
    numbers of steps."""
    cfg = physics.vehicle_config(vehicle)
    states, acts = sample(cfg, 16, 3)
    acts = acts * np.logspace(0, 2.5, 16)[:, None]
    y, steps = dynamics.rk45_solve(port(states), port(acts), cfg.dt, cfg.dynamics)
    for k in range(16):
        yk, sk = dynamics.rk45_solve(port(states[k:k + 1]), port(acts[k:k + 1]), cfg.dt,
                                     cfg.dynamics)
        assert torch.equal(yk[0], y[k]) and int(sk[0]) == int(steps[k])
    assert int(steps.min()) >= 1 and int(steps.max()) > int(steps.min())


@pytest.mark.parametrize("vehicle", VEHICLES)
def test_closed_form_matches_jax(vehicle):
    """The closed form with its clamp, and speed_of, velocity_of and
    heading_of on its output, signed zeros included; the double
    integrator's velocities bit for bit."""
    cfg = physics.vehicle_config(vehicle)
    jcfg = jphysics.vehicle_config(vehicle)
    states, acts = sample(cfg, N, 4)
    got = dynamics.step_closed_form(port(states), port(acts), cfg)
    want = jax_closed_form(vehicle)(jnp.asarray(states), jnp.asarray(acts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("speed_of", "velocity_of", "heading_of"):
        g = getattr(dynamics, name)(got, cfg).numpy()
        w = np.asarray(getattr(jdynamics, name)(want, jcfg))
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        assert np.array_equal(np.signbit(g), np.signbit(w)), name
    if is_di(cfg):
        np.testing.assert_array_equal(got.numpy()[:, 2:], np.asarray(want)[:, 2:])
        # at rest under zero control: heading atan2(+0, +0) = +0
        assert np.all(got.numpy()[:4, 2:] == 0.0) and not np.signbit(got.numpy()[:4, 2:]).any()
        # brought back to rest by the control: -2.8e-17 rounded once, not 0
        back = (states[4:16, 2:] != 0) & (np.abs(got.numpy()[4:16, 2:]) < 1e-15)
        assert back.any() and np.all(got.numpy()[4:16, 2:][back] != 0.0)
        # the clamp rescaled some velocities to v_max and left the others
        speed = np.hypot(got.numpy()[:, 2], got.numpy()[:, 3])
        assert np.isclose(speed, cfg.v_max, rtol=0, atol=1e-12).sum() > 4
        assert (speed < cfg.v_max - 1e-3).sum() > 4


def test_double_integrator_clamp_matches_jax():
    """The velocity rescale only above v_max, with max(speed, 1e-30), on
    velocities of every size around v_max (zero included)."""
    cfg = physics.vehicle_config("double_integrator")
    rng = np.random.RandomState(5)
    ang = rng.uniform(-np.pi, np.pi, 40)
    speed = np.concatenate([[0.0, cfg.v_max, 1e-40], rng.uniform(0, 2 * cfg.v_max, 37)])
    values = np.stack([rng.uniform(-1, 1, 40), rng.uniform(-1, 1, 40),
                       speed * np.cos(ang), speed * np.sin(ang)], axis=-1)
    got = dynamics.clamp_speed(port(values), cfg).numpy()
    want = np.asarray(jdynamics.clamp_speed(jnp.asarray(values),
                                            jphysics.vehicle_config("double_integrator")))
    np.testing.assert_allclose(got, want, **TOL)
    assert np.array_equal(np.signbit(got), np.signbit(want))


@pytest.mark.parametrize("vehicle", VEHICLES)
def test_closed_form_within_rk45_truncation(vehicle):
    cfg = physics.vehicle_config(vehicle)
    states, acts = sample(cfg, N, 6)
    cf = dynamics.step_closed_form(port(states), port(acts), cfg)
    rk = dynamics.step_rk45(port(states), port(acts), cfg)
    np.testing.assert_allclose(cf.numpy(), rk.numpy(), rtol=0, atol=5e-8)


@pytest.mark.parametrize("method", ("closed_form", "rk45"))
@pytest.mark.parametrize("vehicle", ("air_taxi", "double_integrator"))
def test_inactive_agents_are_held(vehicle, method):
    """Agents with ``active`` False keep their state bit for bit; the others
    move."""
    cfg = physics.vehicle_config(vehicle)
    states, acts = sample(cfg, 16, 7)
    active = np.array([True, False] * 8)
    out = dynamics.integrate(port(states), port(acts), cfg, torch.as_tensor(active),
                             method=method).numpy()
    np.testing.assert_array_equal(out[~active], states[~active])
    moved = np.abs(out[active] - states[active]).max(axis=-1)
    assert (moved > 0).sum() >= 6
    with pytest.raises(ValueError, match="unknown integrator"):
        dynamics.integrate(port(states), port(acts), cfg, method="euler")
