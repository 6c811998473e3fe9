"""The torch port's july env against the JAX package's, on the CPU in float64.

Both packages get the same state (a JAX ``EnvState`` converted with
``env_state_from_numpy``) and the same numpy actions; obs, node_obs, adj,
reward, done, truncated and every info key are held at 1e-9, the bar of
``tests/test_golden_parity.py:143-161``.  Where an env auto-resets the two
random streams differ, so the fresh episode is checked against the spawn rule
and its deterministic fields, and the port then continues from the JAX state.
"""
import dataclasses
import functools
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.config import physics as jphysics
from contracts_marl_aam_corridors_tpu.envs import actions as jactions
from contracts_marl_aam_corridors_tpu.envs import corridor as jcorridor
from contracts_marl_aam_corridors_tpu.envs import env as jenv
from contracts_marl_aam_corridors_tpu.envs import reset as jreset
from contracts_marl_aam_corridors_tpu.envs import tube as jtube
from contracts_marl_aam_corridors_tpu.envs.types import EnvParams as JEnvParams

from contracts_marl_aam_corridors_tpu_torch.config import physics
from contracts_marl_aam_corridors_tpu_torch.envs import actions, corridor, tube
from contracts_marl_aam_corridors_tpu_torch.envs import env as tenv
from contracts_marl_aam_corridors_tpu_torch.envs.types import (
    EnvParams,
    env_state_from_numpy,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(atol=1e-9, rtol=0)
EP_LEN = 6


@functools.lru_cache(maxsize=None)
def jax_env():
    """JAX env params and its jitted batched step (compiled once per file)."""
    jparams = JEnvParams(cfg=jphysics.vehicle_config("air_taxi"), num_agents=3,
                         num_landmarks=3, episode_length=EP_LEN)
    return jparams, jax.jit(jax.vmap(partial(jenv.step, jparams)))


def jax_state_fields(state) -> dict:
    """A (vmapped) JAX EnvState as a dict of numpy arrays."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if v is None:
            continue
        if f.name == "tube":
            out["tube"] = {g.name: np.asarray(getattr(v, g.name)) for g in dataclasses.fields(v)}
        else:
            out[f.name] = np.asarray(v)
    return out


def to_port(state):
    return env_state_from_numpy(jax_state_fields(state), CPU, torch.float64)


@pytest.mark.parametrize(
    "name,total", [("air_taxi", 5), ("unicycle_vehicle", 5),
                   ("double_integrator", 5), ("double_integrator", 9)]
)
def test_action_table_matches_jax(name, total):
    got = actions.action_table(physics.vehicle_config(name), total)
    want = jactions.action_table(jphysics.vehicle_config(name), total)
    np.testing.assert_array_equal(got, want)
    assert actions.stop_action_index(got.shape[0]) == jactions.stop_action_index(want.shape[0])


def test_tube_geometry_and_phase_match_jax():
    rng = np.random.RandomState(0)
    B, K = 16, 5
    angle = rng.uniform(-np.pi / 2, np.pi / 2, B)
    pos = rng.uniform(-1.0, 1.0, (B, K, 2))
    prev = rng.randint(0, 3, (B, K))
    t_tube = tube.make_tube(torch.as_tensor(angle), 2.0, 0.06)
    t_pos = torch.as_tensor(pos)
    s, y = tube.tube_coords(t_tube, t_pos)
    phase, new_prev = tube.agent_phase(t_tube, t_pos, torch.as_tensor(prev), 0.08, 0.02)
    proj, perp = tube.entrance_projection(t_tube, t_pos)
    got = dict(
        s=s, y=y, rect=tube.in_tube_rect(t_tube, s, y),
        gate=tube.in_entrance_gate(t_tube, s, y, 0.08, 0.02),
        passed=tube.passed_tube(t_tube, t_pos), proj=proj, perp=perp,
        phase=phase, new_prev=new_prev,
    )

    def one(a, p, pv):
        tb = jtube.make_tube(a, 2.0, 0.06, jnp.float64)
        js, jy = jtube.tube_coords(tb, p)
        jph, jnp_ = jtube.agent_phase(tb, p, pv, 0.08, 0.02)
        jpr, jpe = jtube.entrance_projection(tb, p)
        return dict(
            s=js, y=jy, rect=jtube.in_tube_rect(tb, js, jy),
            gate=jtube.in_entrance_gate(tb, js, jy, 0.08, 0.02),
            passed=jtube.passed_tube(tb, p), proj=jpr, perp=jpe,
            phase=jph, new_prev=jnp_,
        )

    want = jax.vmap(one)(jnp.asarray(angle), jnp.asarray(pos), jnp.asarray(prev, jnp.int32))
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    # every branch of the phase machine was exercised
    assert set(np.unique(phase.numpy())) >= {0, 1}


def _spawn_rule_holds(params, state, b):
    """The fresh episode of env ``b`` obeys the july spawn rule."""
    tb = state.tube
    ws = params.world_size
    ang = float(tb.angle[b])
    assert -np.pi / 2 <= ang <= np.pi / 2
    np.testing.assert_allclose(float(tb.width[b]), 0.45, **TOL)
    np.testing.assert_allclose(
        tb.entrance[b].numpy(), [np.sin(ang) * 0.4, np.cos(ang) * 0.4], **TOL)
    pos = state.agent_states[b, :, :2].numpy()
    perp = np.array([np.sin(ang), np.cos(ang)])
    for k in range(params.num_agents):
        base = tb.entrance[b].numpy() + (ws + k) / 5.0 * perp
        assert np.all(np.abs(pos[k] - base) <= 0.2 * ws + 1e-12)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    sep = params.cfg.separation_distance
    assert np.all(d[~np.eye(params.num_agents, dtype=bool)] >= sep)
    speed = state.agent_states[b, :, 3].numpy()
    np.testing.assert_allclose(speed, params.cfg.v_min, **TOL)


def test_reset_outputs_and_steps_match_jax():
    B, steps = 4, 10
    params = EnvParams(cfg=physics.vehicle_config("air_taxi"), episode_length=EP_LEN)
    jparams, jstep = jax_env()
    keys = jax.random.split(jax.random.PRNGKey(3), B)
    jstate = jax.vmap(partial(jreset.reset, jparams, dtype=jnp.float64))(keys)

    # reset_outputs from the same raw state
    tstate, obs, node_obs, adj, aid = corridor.reset_outputs(params, to_port(jstate))
    jstate, jobs, jnode, jadj, jaid = jax.jit(jax.vmap(
        partial(jcorridor.reset_outputs, jparams)))(jstate)
    for got, want in ((obs, jobs), (node_obs, jnode), (adj, jadj), (aid, jaid)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(tstate.prev_phase.numpy(), np.asarray(jstate.prev_phase))
    np.testing.assert_array_equal(
        tstate.entry_cooldown.numpy(), np.asarray(jstate.entry_cooldown))

    rng = np.random.RandomState(7)
    gen = torch.Generator().manual_seed(0)
    resets = 0
    for t in range(steps):
        act = rng.randint(0, params.num_actions, (B, params.num_agents))
        tstate, ts = tenv.step(params, tstate, torch.as_tensor(act), gen)
        jstate, jts = jstep(jstate, jnp.asarray(act, jnp.int32))
        for k in ("reward", "done", "truncated"):
            np.testing.assert_allclose(
                getattr(ts, k).numpy(), np.asarray(getattr(jts, k)),
                err_msg=f"{k} step {t}", **TOL)
        assert set(ts.info) == set(jts.info)
        for k in ts.info:
            np.testing.assert_allclose(
                ts.info[k].numpy(), np.asarray(jts.info[k]),
                err_msg=f"info[{k}] step {t}", **TOL)
        all_done = np.asarray(jts.done).all(axis=1)
        keep = ~all_done
        for k in ("obs", "node_obs", "adj"):
            np.testing.assert_allclose(
                getattr(ts, k).numpy()[keep], np.asarray(getattr(jts, k))[keep],
                err_msg=f"{k} step {t}", **TOL)
        if all_done.any():
            resets += 1
            jf = jax_state_fields(jstate)
            # deterministic fields of the fresh episode match exactly
            for k in ("t", "status", "prev_phase", "phase_reached", "entry_cooldown",
                      "goal_match", "goal_tracker", "goal_reached", "p_dist", "time",
                      "conformance", "num_agent_collisions", "times_required"):
                np.testing.assert_array_equal(
                    getattr(tstate, k).numpy()[all_done], jf[k][all_done], err_msg=k)
            for b in np.flatnonzero(all_done):
                _spawn_rule_holds(params, tstate, b)
            # the port's fresh adjacency is its fresh state's
            adj_r = corridor.masked_adjacency(params, tstate, tstate.agent_states)
            np.testing.assert_allclose(
                adj_r.numpy()[all_done], ts.adj.numpy()[all_done], **TOL)
            # continue from the JAX draw so later steps stay comparable
            tstate = to_port(jstate)
    assert resets == 1


def test_reward_branches_match_jax():
    """One step from hand-placed agents, against the JAX step: the phase-1
    entry bonus, the 1->2 exit, a goal reach (freeze, landmark disconnect,
    reward clip), a demotion and a collision."""
    jparams, jstep = jax_env()
    params = EnvParams(cfg=physics.vehicle_config("air_taxi"), episode_length=EP_LEN)
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    jstate = jax.vmap(partial(jreset.reset, jparams, dtype=jnp.float64))(keys)
    f = jax_state_fields(jstate)
    tb = f["tube"]
    pos, prev, reached = (f[k].copy() for k in ("agent_states", "prev_phase", "phase_reached"))

    def at(b, s, y=0.0):  # tube coordinates (fraction of length, lateral) -> world
        return tb["entrance"][b] + s * tb["frame_length"][b] * tb["e"][b] + y * tb["n"][b]

    def along(b):
        return np.arctan2(tb["e"][b][1], tb["e"][b][0])

    pos[0, 0, :3] = [*at(0, 0.02), along(0)]  # enters the gate from phase 0
    pos[1, 1, :3] = [*at(1, 1.15), along(1)]  # leaves the tube from phase 1
    prev[1, 1] = reached[1, 1] = 1
    pos[2, 2, :2] = f["landmark_pos"][2, f["goal_match"][2, 2]]  # on its goal, phase 2
    prev[2, 2] = reached[2, 2] = 2
    pos[3, 0, :2] = f["landmark_pos"][3, 0]  # on its goal, never entered: demoted
    prev[3, 0] = 2
    pos[3, 1, :2], pos[3, 2, :2] = at(3, 0.5), at(3, 0.5, 0.01)  # collide
    f.update(agent_states=pos, prev_phase=prev, phase_reached=reached)
    jstate = jstate.replace(agent_states=jnp.asarray(pos), prev_phase=jnp.asarray(prev),
                            phase_reached=jnp.asarray(reached))
    tstate = env_state_from_numpy(f, CPU, torch.float64)

    act = np.full((4, 3), 12)  # no turn, mild acceleration
    tstate, ts = tenv.step(params, tstate, torch.tensor(act), torch.Generator().manual_seed(0))
    jstate, jts = jstep(jstate, jnp.asarray(act, jnp.int32))
    jf = jax_state_fields(jstate)

    # the reference took every branch this test is for
    assert jf["status"][2, 2] and not jf["status"][3, 0]
    assert jf["prev_phase"][1, 1] == 2 and jf["phase_reached"][0, 0] == 1
    assert jf["goal_tracker"][2, 2] == f["goal_match"][2, 2]
    assert np.asarray(jts.reward)[3, 1] < -params.collision_rew

    for k in ("reward", "done", "truncated", "obs", "adj"):
        np.testing.assert_allclose(getattr(ts, k).numpy(), np.asarray(getattr(jts, k)),
                                   err_msg=k, **TOL)
    for k in ts.info:
        np.testing.assert_allclose(ts.info[k].numpy(), np.asarray(jts.info[k]),
                                   err_msg=f"info[{k}]", **TOL)
    # a goal reach draws a fresh heading (framework RNGs differ): relative
    # velocities seen by the frozen agent's own graph differ, all else matches
    node, jnode = ts.node_obs.numpy(), np.asarray(jts.node_obs)
    np.testing.assert_allclose(node[..., 2:], jnode[..., 2:], **TOL)
    vel_ok = np.ones(node.shape[:2], bool)
    vel_ok[2, 2] = False
    np.testing.assert_allclose(node[vel_ok][..., :2], jnode[vel_ok][..., :2], **TOL)
    for k in ("status", "goal_tracker", "prev_phase", "phase_reached", "entry_cooldown",
              "conformance", "spacing_violation", "steps_in_corridor", "delta_spacing_sum",
              "p_dist", "time"):
        np.testing.assert_allclose(getattr(tstate, k).numpy(), jf[k], err_msg=k, **TOL)
    np.testing.assert_allclose(tstate.agent_states[..., :2].numpy(),
                               jf["agent_states"][..., :2], **TOL)
    frozen = tstate.agent_states[2, 2]
    assert float(frozen[3]) == params.cfg.v_min and 0.0 <= float(frozen[2]) < 2 * np.pi
