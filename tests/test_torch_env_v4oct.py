"""The torch port's v4oct scenario and its double-integrator and rk45 env
paths against the JAX package's, on the CPU in float64.

Both packages get the same state and the same numpy actions: a port reset
(drawn from a seeded generator, then placed by hand where a test says so)
as numpy arrays, given to the port and, with the fields the port does not
carry at their reset values, to the JAX package; the JAX outputs come back
through the helpers of ``tests/test_torch_env.py``.  obs, node_obs, adj,
reward, done, truncated, every info key and the state are held at 1e-9, the
bar of ``tests/test_golden_parity.py:143-161``.  v4oct runs with air_taxi,
the unicycle and the double integrator; july, rot_inv and two_phase with the
double integrator.  The double integrator's freeze and v4oct draw nothing,
so a step is held whole, freezes included.  One jitted JAX
``reset_outputs`` and one jitted JAX ``corridor.step`` per (scenario,
vehicle) pair serve every test of it; one jitted JAX ``env.step`` (v4oct,
air_taxi) holds the auto-reset and the cache it carries
(``test_v4oct_auto_reset_matches_jax``).
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
from contracts_marl_aam_corridors_tpu.envs import corridor as jcorridor
from contracts_marl_aam_corridors_tpu.envs import env as jenv
from contracts_marl_aam_corridors_tpu.envs.types import EnvParams as JEnvParams
from contracts_marl_aam_corridors_tpu.envs.types import EnvState as JEnvState
from contracts_marl_aam_corridors_tpu.envs.types import TubeParams as JTubeParams

from contracts_marl_aam_corridors_tpu_torch.config import physics
from contracts_marl_aam_corridors_tpu_torch.envs import corridor, dynamics, tube
from contracts_marl_aam_corridors_tpu_torch.envs import env as tenv
from contracts_marl_aam_corridors_tpu_torch.envs import reset as treset
from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams, env_state_from_numpy
from test_torch_env import jax_state_fields

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(atol=1e-9, rtol=0)
EP_LEN = 6
B = 8
DI = "double_integrator"
PAIRS = [("v4oct", "air_taxi"), ("v4oct", "unicycle_vehicle"), ("v4oct", DI),
         ("rotate_tube_july", DI), ("rot_inv", DI), ("two_phase", DI)]
# the gated scenarios at the shipped gated checkpoints' recipes (world 4,
# goal 20, formation 5), the others at the defaults
SETTINGS = {
    "rot_inv": dict(world_size=4.0, collision_rew=30.0, goal_rew=20.0, formation_rew=5.0),
    "two_phase": dict(world_size=4.0, collision_rew=20.0, goal_rew=20.0, formation_rew=5.0),
}
# deterministic fields a step writes, held after every step
STATE_KEYS = ("t", "status", "prev_phase", "phase_reached", "entry_cooldown", "prev_proj",
              "goal_tracker", "goal_reached", "p_dist", "time", "conformance",
              "spacing_violation", "steps_in_corridor", "delta_spacing_sum",
              "num_agent_collisions", "times_required", "dists_to_goal",
              "dist_left_to_goal", "dist_left_float", "agent_states")


def settings(scenario, n, integrator):
    return dict(scenario=scenario, num_agents=n, num_landmarks=n, episode_length=EP_LEN,
                integrator=integrator, **SETTINGS.get(scenario, {}))


def port_params(scenario, vehicle, n=3, integrator="closed_form"):
    return EnvParams(cfg=physics.vehicle_config(vehicle), **settings(scenario, n, integrator))


def jax_env(scenario, vehicle, n=3, integrator="closed_form"):
    """The JAX params, its jitted batched ``reset_outputs`` and its jitted
    batched ``corridor.step``."""
    return _jax_env(scenario, vehicle, n, integrator)


@functools.lru_cache(maxsize=None)
def _jax_env(scenario, vehicle, n, integrator):
    jparams = JEnvParams(cfg=jphysics.vehicle_config(vehicle),
                         **settings(scenario, n, integrator))
    return (jparams, jax.jit(jax.vmap(partial(jcorridor.reset_outputs, jparams))),
            jax.jit(jax.vmap(partial(jcorridor.step, jparams))))


def reset_fields(params, seed) -> dict:
    """A port reset of B envs in float64 as numpy arrays under the JAX
    package's field names."""
    st = treset.reset(params, B, torch.Generator().manual_seed(seed), CPU, torch.float64)
    out = {}
    for f in dataclasses.fields(st):
        v = getattr(st, f.name)
        if f.name == "tube":
            out["tube"] = {g.name: getattr(v, g.name).numpy() for g in dataclasses.fields(v)}
        elif v is not None:
            out[f.name] = v.numpy()
    return out


def both(fields, jparams):
    """The numpy fields as the port's state and the JAX package's; the JAX
    fields the port does not carry take their reset values."""
    n, l = jparams.num_agents, jparams.num_landmarks

    def conv(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)

    jf = {k: conv(v) for k, v in fields.items() if k != "tube"}
    jf.update(
        tube=JTubeParams(**{k: conv(v) for k, v in fields["tube"].items()}),
        goal_history=jnp.full((B, l), -1, jnp.int32),
        action_diff=jnp.zeros((B, n)),
        safety_violations=jnp.zeros((B, n), bool),
        key=jax.random.split(jax.random.PRNGKey(0), B),
    )
    return env_state_from_numpy(fields, CPU, torch.float64), JEnvState(**jf)


def close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **TOL)


def step_both(params, jstep, tstate, jstate, act, label):
    """One step of both from equal states, everything held; the port's
    generator must not move (nothing of these paths draws)."""
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    tstate2, ts = corridor.step(params, tstate, torch.as_tensor(act), gen)
    assert torch.equal(gen.get_state(), before), f"{label}: the step drew"
    jstate2, jts = jstep(jstate, jnp.asarray(act, jnp.int32))
    for k in ("obs", "node_obs", "adj", "reward", "done", "truncated"):
        close(getattr(ts, k), getattr(jts, k), f"{label} {k}")
    assert set(ts.info) == set(jts.info)
    for k in ts.info:
        close(ts.info[k], jts.info[k], f"{label} info[{k}]")
    jf = jax_state_fields(jstate2)
    for k in STATE_KEYS:
        close(getattr(tstate2, k), jf[k], f"{label} state {k}")
    assert np.array_equal(np.signbit(tstate2.agent_states.numpy()),
                          np.signbit(jf["agent_states"])), f"{label} signed zeros"
    if params.scenario == "v4oct":
        close(tstate2.frozen_pos, tstate.frozen_pos, f"{label} frozen_pos")
        close(jf["frozen_pos"], tstate.frozen_pos, f"{label} JAX frozen_pos")
    return tstate2, ts, jstate2, jts


@pytest.mark.parametrize("scenario,vehicle", PAIRS)
def test_reset_outputs_and_steps_match_jax(scenario, vehicle):
    """reset_outputs of a port reset, then EP_LEN steps of random actions
    to the time limit."""
    params = port_params(scenario, vehicle)
    jparams, jreset_outputs, jstep = jax_env(scenario, vehicle)
    tstate, jstate = both(reset_fields(params, 3), jparams)
    tstate, obs, node_obs, adj, aid = corridor.reset_outputs(params, tstate)
    jstate, jobs, jnode, jadj, jaid = jreset_outputs(jstate)
    assert obs.shape[-1] == params.obs_dim and node_obs.shape[-1] == params.node_feat_dim
    for name, got, want in (("obs", obs, jobs), ("node_obs", node_obs, jnode),
                            ("adj", adj, jadj), ("agent_id", aid, jaid)):
        close(got, want, f"reset {name}")
    jf = jax_state_fields(jstate)
    for k in ("entry_cooldown", "prev_phase"):
        close(getattr(tstate, k), jf[k], f"reset {k}")

    rng = np.random.RandomState(7)
    for t in range(EP_LEN):
        act = rng.randint(0, params.num_actions, (B, params.num_agents))
        tstate, ts, jstate, jts = step_both(params, jstep, tstate, jstate, act, f"step {t}")
    assert ts.done.all() and ts.truncated.all()
    if vehicle == DI:  # some velocity component came back to rest
        vel = tstate.agent_states[..., 2:]
        assert ((vel.abs() < 1e-15) & (vel != 0)).any()


@pytest.mark.parametrize("scenario,vehicle", PAIRS)
def test_port_reset_rule(scenario, vehicle):
    """The port's own resets: v4oct's tube at -pi/2 (cast to the state's
    type) and its U(-10, 10) jitter, the double integrator at rest, the
    frozen cache at the spawn; the rule's constants as the JAX package's
    EnvParams gives them."""
    params = port_params(scenario, vehicle)
    jparams = jax_env(scenario, vehicle)[0]
    for k in ("obs_dim", "node_feat_dim", "num_actions", "spawn_jitter_range",
              "fixed_tube_angle", "spawn_jitter_scale", "spawn_spacing_div",
              "randomize_tube_length", "integrator"):
        assert getattr(params, k) == getattr(jparams, k), k
    for dtype in (torch.float32, torch.float64):
        state, ts = tenv.reset(params, 64, torch.Generator().manual_seed(2), "cpu", dtype)
        angle = state.tube.angle
        if scenario == "v4oct":
            assert torch.equal(angle, torch.full_like(angle, -np.pi / 2))
            assert torch.equal(state.frozen_pos, state.agent_states[..., :2])
            ws = params.world_size
            perp = torch.stack([torch.sin(angle), torch.cos(angle)], -1)
            base = (state.tube.entrance[:, None] + (ws + torch.arange(3.0, dtype=dtype))[:, None]
                    / 5.0 * perp[:, None])
            off = (state.agent_states[..., :2] - base).abs()
            assert float(off.max()) <= 2.0 + 1e-6 and float(off.max()) > ws * 0.2
        else:
            assert state.frozen_pos is None and len(angle.unique()) == 64
        if vehicle == DI:
            assert not state.agent_states[..., 2:].any()
            assert not torch.signbit(state.agent_states[..., 2:]).any()
        assert ts.obs.shape == (64, 3, params.obs_dim)
        assert ts.node_obs.shape == (64, 3, 6, params.node_feat_dim)


def _built_v4oct(params):
    """B v4oct states with hand-placed agents and cache (see
    ``test_v4oct_reward_branches_match_jax``), as numpy fields."""
    f = reset_fields(params, 5)
    tb = f["tube"]
    st, frozen, status = (f[k].copy() for k in ("agent_states", "frozen_pos", "status"))

    def at(b, s, y=0.0):  # tube coordinates (fraction of length, of half width) -> world
        return tb["entrance"][b] + s * tb["frame_length"][b] * tb["e"][b] \
            + y * tb["half_width"][b] * tb["n"][b]

    if params.cfg.dynamics == physics.DynamicsType.DOUBLE_INTEGRATOR:
        st[..., 2:] = 0.0  # at rest, and the action below holds it there
    else:
        st[..., 2] = np.arctan2(tb["e"][:, None, 1], tb["e"][:, None, 0])  # along the tube
    spread = lambda b: [at(b, -0.6), at(b, 0.6, 1.8), at(b, 1.6)]  # phase 0, far apart
    for b in range(5):
        st[b, :, :2] = frozen[b] = spread(b)
    # env 0: agent 0 in the entrance region (phase 1), agent 1 before the
    # tube, agent 2 in the tube beyond the entrance region (both phase 0)
    st[0, 0, :2], st[0, 1, :2], st[0, 2, :2] = at(0, 0.0), at(0, -0.2), at(0, 0.5)
    # env 1: agent 0 on the entrance point itself, agent 1 at the side of the
    # entrance region, agent 2 just outside it sideways
    st[1, 0, :2], st[1, 1, :2], st[1, 2, :2] = at(1, 0.0), at(1, 0.02, 0.9), at(1, 0.02, 1.2)
    # env 2: the cache has all three within the separation, the agents are
    # far apart: one penalty each, though agent 0 has two partners
    frozen[2] = [at(2, 0.2), at(2, 0.2, 0.5), at(2, 0.25, -0.5)]
    # env 3: the agents collide, the cache is far apart: no penalty
    st[3, :, :2] = [at(3, 0.3), at(3, 0.3, 0.2), at(3, 0.32)]
    # env 4: the cache collides, agent 1 is done: it pays nothing and
    # costs the others nothing
    frozen[4] = frozen[2] + (tb["entrance"][4] - tb["entrance"][2])
    status[4, 1] = True
    return {**f, "agent_states": st, "frozen_pos": frozen, "status": status}


@pytest.mark.parametrize("vehicle", ["air_taxi", "unicycle_vehicle", DI])
def test_v4oct_reward_branches_match_jax(vehicle):
    """One step from hand-placed agents: phase 1 only in the entrance
    region, collisions on the cache with at most one penalty, done agents
    out of it; no clip, no freeze."""
    params = port_params("v4oct", vehicle)
    jparams, _, jstep = jax_env("v4oct", vehicle)
    tstate, jstate = both(_built_v4oct(params), jparams)
    act = np.zeros((B, 3), int) if vehicle == DI else np.full((B, 3), 12)
    _, ts, jstate2, jts = step_both(params, jstep, tstate, jstate, act, vehicle)
    r, phase = np.asarray(jts.reward), np.asarray(jts.obs)[..., -1]
    jf = jax_state_fields(jstate2)
    tb = jf["tube"]
    pos = jf["agent_states"][..., :2]
    dist = np.where(phase == 1, np.linalg.norm(tb["exit"][:, None] - pos, axis=-1),
                    np.linalg.norm(tb["entrance"][:, None] - pos, axis=-1))
    penalty = -(r + dist)  # what the collision term took
    c4 = 4 * params.collision_rew
    np.testing.assert_array_equal(phase[0], [1, 0, 0])
    np.testing.assert_array_equal(phase[1], [1, 1, 0])
    close(penalty[2], [c4] * 3, "one penalty each")
    close(penalty[3], [0] * 3, "current positions do not count")
    close(penalty[4], [c4, 0, c4], "a done agent")
    close(penalty[:2], 0 * penalty[:2], "no collision")
    assert not jf["status"][:4].any()
    np.testing.assert_array_equal(jf["steps_in_corridor"][:2], [[1, 0, 0], [1, 1, 0]])


def test_v4oct_two_agents_mask_the_second_neighbour():
    """With two agents the second neighbour slot is the agent itself at
    distance inf: zero in the port as in the JAX package."""
    params = port_params("v4oct", "air_taxi", n=2)
    jparams, jreset_outputs, jstep = jax_env("v4oct", "air_taxi", n=2)
    tstate, jstate = both(reset_fields(params, 1), jparams)
    tout = corridor.reset_outputs(params, tstate)
    jout = jreset_outputs(jstate)
    for name, got, want in zip(("state", "obs", "node_obs", "adj", "agent_id"), tout, jout):
        if name != "state":
            close(got, want, name)
    nb = tout[1][..., 9:13].numpy()  # the two nearest neighbours' vectors
    assert np.all(nb[..., 2:] == 0.0) and np.all(np.abs(nb[..., :2]) > 0)
    act = np.random.RandomState(3).randint(0, params.num_actions, (B, 2))
    _, ts, _, _ = step_both(params, jstep, tout[0], jout[0], act, "two agents")
    assert np.all(ts.obs[..., 11:13].numpy() == 0.0)


def test_v4oct_frozen_pos_outlives_the_episode():
    """Through an episode and its auto-reset the cache keeps the first
    reset's spawn while the agents move and respawn (``env.step`` carries
    it as the JAX package's ``env.step`` does)."""
    params = port_params("v4oct", "air_taxi")
    gen = torch.Generator().manual_seed(4)
    state, _ = tenv.reset(params, B, gen, "cpu", torch.float64)
    first = state.frozen_pos.clone()
    spawn = state.agent_states[..., :2].clone()
    rng = np.random.RandomState(4)
    for t in range(EP_LEN):
        state, ts = tenv.step(params, state,
                              torch.as_tensor(rng.randint(0, 25, (B, 3))), gen)
        assert torch.equal(state.frozen_pos, first)
    assert ts.done.all() and state.t.eq(0).all()
    assert not torch.equal(state.agent_states[..., :2], spawn)


def test_v4oct_auto_reset_matches_jax():
    """``env.step`` with its auto-reset against the JAX package's, from equal
    states whose envs are two steps apart in time, so that each step after
    the first reset holds envs that reset beside envs that did not.  Each
    framework draws its fresh episodes from its own stream: where an env
    resets, the fresh observations the JAX step returns are held against
    the port's ``reset_outputs`` on the JAX fresh state (the carried cache
    included), and the port goes on from that state."""
    params = port_params("v4oct", "air_taxi")
    jparams, jreset_outputs, _ = jax_env("v4oct", "air_taxi")
    jenv_step = jax.jit(jax.vmap(partial(jenv.step, jparams)))
    f = reset_fields(params, 5)
    f["t"] = np.where(np.arange(B) % 2 == 1, 2, 0).astype(f["t"].dtype)
    tstate, jstate = both(f, jparams)
    tstate = corridor.reset_outputs(params, tstate)[0]
    jstate = jreset_outputs(jstate)[0]
    first = tstate.frozen_pos.clone()
    gen = torch.Generator().manual_seed(5)
    rng = np.random.RandomState(5)
    resets = 0
    for t in range(EP_LEN):
        act = rng.randint(0, params.num_actions, (B, params.num_agents))
        tstate2, ts = tenv.step(params, tstate, torch.as_tensor(act), gen)
        jstate2, jts = jenv_step(jstate, jnp.asarray(act, jnp.int32))
        for k in ("reward", "done", "truncated"):
            close(getattr(ts, k), getattr(jts, k), f"step {t} {k}")
        jf = jax_state_fields(jstate2)
        assert torch.equal(tstate2.frozen_pos, first)
        close(jf["frozen_pos"], first, f"step {t} JAX frozen_pos")
        reset = ts.done.all(dim=1).numpy()
        kept = ~reset
        for k in ("obs", "node_obs", "adj"):
            close(getattr(ts, k).numpy()[kept], np.asarray(getattr(jts, k))[kept],
                  f"step {t} {k} of the envs that went on")
        for k in STATE_KEYS:
            close(getattr(tstate2, k).numpy()[kept], jf[k][kept], f"step {t} state {k}")
        if reset.any():
            resets += int(reset.sum())
            fresh = env_state_from_numpy(jf, CPU, torch.float64)
            fresh, obs, node_obs, adj, _ = corridor.reset_outputs(params, fresh)
            for k, got in (("obs", obs), ("node_obs", node_obs), ("adj", adj)):
                close(got.numpy()[reset], np.asarray(getattr(jts, k))[reset],
                      f"step {t} fresh {k}")
            assert (fresh.t.numpy()[reset] == 0).all()
            tstate2 = tenv._select_state(torch.as_tensor(reset), fresh, tstate2)
        tstate, jstate = tstate2, jstate2
    assert resets == B  # the odd envs reset at step 3, the even ones at step 5


@pytest.mark.parametrize("scenario", ["rotate_tube_july", "rot_inv", "two_phase"])
def test_double_integrator_freeze_matches_jax(scenario):
    """Agents that freeze (july and rot_inv on their goal, two_phase at the
    exit) stop dead with no draw: the step is held whole against the JAX
    step, node features after the freeze included."""
    params = port_params(scenario, DI)
    jparams, _, jstep = jax_env(scenario, DI)
    f = reset_fields(params, 6)
    tb = f["tube"]
    st, prev, reached = (f[k].copy() for k in ("agent_states", "prev_phase", "phase_reached"))
    frozen = ((0, 0), (1, 2), (2, 1))
    for b, i in frozen:
        if scenario == "two_phase":  # 0.1 past the tube's end, from phase 1
            st[b, i, :2] = tb["entrance"][b] + (tb["frame_length"][b] + 0.1) * tb["e"][b]
            prev[b, i] = reached[b, i] = 1
        else:  # on its goal in phase 2
            st[b, i, :2] = f["landmark_pos"][b, f["goal_match"][b, i]]
            prev[b, i] = reached[b, i] = 2
        st[b, i, 2:] = 0.05 * tb["e"][b]  # moving along the tube
    tstate, jstate = both({**f, "agent_states": st, "prev_phase": prev,
                           "phase_reached": reached}, jparams)
    act = np.random.RandomState(8).randint(0, params.num_actions, (B, 3))
    act[tuple(zip(*frozen))] = 0  # no acceleration for the agents that freeze
    tstate2, _, _, _ = step_both(params, jstep, tstate, jstate, act, scenario)
    for b, i in frozen:
        assert tstate2.status[b, i] and not tstate2.agent_states[b, i, 2:].any()
    # at rest: the heading atan2(+0, +0) is +0
    heading = dynamics.heading_of(tstate2.agent_states, params.cfg)
    assert all(float(heading[b, i]) == 0.0 for b, i in frozen)


def test_rk45_env_step_matches_jax():
    """One step of the env with ``integrator="rk45"`` (v4oct, air_taxi)."""
    params = port_params("v4oct", "air_taxi", integrator="rk45")
    jparams, _, jstep = jax_env("v4oct", "air_taxi", integrator="rk45")
    tstate, jstate = both(reset_fields(params, 9), jparams)
    act = np.random.RandomState(9).randint(0, params.num_actions, (B, 3))
    tstate2, ts, _, _ = step_both(params, jstep, tstate, jstate, act, "rk45")
    closed = corridor.step(dataclasses.replace(params, integrator="closed_form"),
                           tstate, torch.as_tensor(act), torch.Generator())[0]
    diff = (tstate2.agent_states - closed.agent_states).abs().max().item()
    assert 0 < diff < 5e-8  # rk45's truncation error, as in test_torch_dynamics
    phase = tube.agent_phase_v4oct(tstate2.tube, tstate2.agent_states[..., :2])
    close(ts.obs[..., -1], phase, "phase")
