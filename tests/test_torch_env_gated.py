"""The torch port's exit-gated envs (rot_inv, two_phase, three_phase) against
the JAX package's, on the CPU in float64.

Both packages get the same state (a JAX ``EnvState`` converted with
``env_state_from_numpy``) and the same numpy actions; obs, node_obs, adj,
reward, done, truncated and every info key are held at 1e-9, the bar of
``tests/test_golden_parity.py:143-161``.  One jitted, vmapped JAX step per
scenario serves every test of it.

A freeze (the goal reach of rot_inv and three_phase, two_phase's exit) draws
a fresh heading, and the two frameworks' random streams differ.  So the
frozen agent's heading is held to the rule (speed v_min, heading in
[0, 2pi)), and the node features of the graphs taken after the freeze are
held to the JAX package's node-feature function on the values the port's
sweep had at that point; everything else is held to the JAX step, and the
port then continues from the JAX state.  Where an env auto-resets, the fresh
episode is held to the gated spawn rule and its deterministic fields.
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
from contracts_marl_aam_corridors_tpu.envs import reset as jreset
from contracts_marl_aam_corridors_tpu.envs import tube as jtube
from contracts_marl_aam_corridors_tpu.envs.types import EnvParams as JEnvParams

from contracts_marl_aam_corridors_tpu_torch.config import physics
from contracts_marl_aam_corridors_tpu_torch.envs import actions, corridor, dynamics, tube
from contracts_marl_aam_corridors_tpu_torch.envs import env as tenv
from contracts_marl_aam_corridors_tpu_torch.envs import reset as treset
from contracts_marl_aam_corridors_tpu_torch.envs.types import (
    EnvParams,
    env_state_from_numpy,
)

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(atol=1e-9, rtol=0)
EP_LEN = 6
B = 8  # every test of a scenario steps 8 envs: one compile of its JAX step
SCENARIOS = ("rot_inv", "two_phase", "three_phase")
# the shipped checkpoints' recipes (scripts/final_eval.py, three_phase_eval.py,
# two_phase_eval.py): world 4, goal 20, formation 5; collision 30 for rot_inv
SETTINGS = {
    "rot_inv": dict(world_size=4.0, collision_rew=30.0, goal_rew=20.0, formation_rew=5.0),
    "two_phase": dict(world_size=4.0, collision_rew=20.0, goal_rew=20.0, formation_rew=5.0),
    "three_phase": dict(world_size=4.0, collision_rew=20.0, goal_rew=20.0, formation_rew=5.0),
}


def port_params(scenario):
    return EnvParams(cfg=physics.vehicle_config("air_taxi"), scenario=scenario,
                     episode_length=EP_LEN, **SETTINGS[scenario])


@functools.lru_cache(maxsize=None)
def jax_env(scenario):
    """JAX env params and its jitted batched step (compiled once per scenario)."""
    jparams = JEnvParams(cfg=jphysics.vehicle_config("air_taxi"), scenario=scenario,
                         num_agents=3, num_landmarks=3, episode_length=EP_LEN,
                         **SETTINGS[scenario])
    return jparams, jax.jit(jax.vmap(partial(jenv.step, jparams)))


@functools.lru_cache(maxsize=None)
def jax_resets(scenario):
    """The JAX reset and reset_outputs, jitted and batched (compiling them
    costs less CPU time than running them op by op)."""
    jparams, _ = jax_env(scenario)
    return (jax.jit(jax.vmap(partial(jreset.reset, jparams, dtype=jnp.float64))),
            jax.jit(jax.vmap(partial(jcorridor.reset_outputs, jparams))))


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


def jax_reset(scenario, seed):
    return jax_resets(scenario)[0](jax.random.split(jax.random.PRNGKey(seed), B))


def close(got, want, msg):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **TOL)


# deterministic fields a step writes, held after every step
STATE_KEYS = ("t", "status", "prev_phase", "phase_reached", "entry_cooldown", "prev_proj",
              "goal_tracker", "goal_reached", "p_dist", "time", "conformance",
              "spacing_violation", "steps_in_corridor", "delta_spacing_sum",
              "num_agent_collisions", "times_required", "dists_to_goal",
              "dist_left_to_goal", "dist_left_float")


def step_both(scenario, tstate, jstate, act, gen, label=""):
    """One step of both envs from equal states, held as the module docstring
    says.  Returns (the state to go on from, the port's TimeStep, the JAX
    TimeStep, the JAX state, the (env, agent) pairs that froze)."""
    params = port_params(scenario)
    jparams, jstep = jax_env(scenario)
    before = tstate
    tstate, ts = tenv.step(params, tstate, torch.as_tensor(act), gen)
    jstate2, jts = jstep(jstate, jnp.asarray(act, jnp.int32))
    jf = jax_state_fields(jstate2)

    for k in ("reward", "done", "truncated"):
        close(getattr(ts, k), getattr(jts, k), f"{label} {k}")
    assert set(ts.info) == set(jts.info)
    for k in ts.info:
        close(ts.info[k], jts.info[k], f"{label} info[{k}]")
    all_done = np.asarray(jts.done).all(axis=1)
    keep = ~all_done
    for k in ("obs", "adj"):
        close(getattr(ts, k).numpy()[keep], np.asarray(getattr(jts, k))[keep], f"{label} {k}")

    # the freezes of this step: heading drawn by each framework's own stream
    newly = np.asarray(jts.done) & ~before.status.numpy() & (np.asarray(jts.truncated) == 0)
    newly &= keep[:, None]
    frozen = list(zip(*np.nonzero(newly)))
    vals = tstate.agent_states.numpy()
    for b, i in frozen:
        assert vals[b, i, 3] == params.cfg.v_min and 0.0 <= vals[b, i, 2] < 2 * np.pi
        close(vals[b, i, :2], jf["agent_states"][b, i, :2], f"{label} frozen position")
    node, jnode = ts.node_obs.numpy(), np.asarray(jts.node_obs)
    fenv = sorted({b for b, _ in frozen})
    plain = [b for b in np.flatnonzero(keep) if b not in fenv]
    close(node[plain], jnode[plain], f"{label} node_obs")
    if fenv:
        # the sweep's values when agent j's graph was taken: the dynamics'
        # values, with the rows of agents k <= j that froze replaced
        table = torch.as_tensor(actions.action_table(params.cfg, params.total_actions),
                                dtype=torch.float64)
        pre = dynamics.step_closed_form(before.agent_states,
                                        actions.decode(torch.as_tensor(act), table),
                                        params.cfg, ~before.status).numpy()
        for b in fenv:
            jsb = jax.tree.map(lambda x: x[b], jstate2)
            for j in range(params.num_agents):
                seen = pre[b].copy()
                for k in range(j + 1):
                    if newly[b, k]:
                        seen[k] = vals[b, k]
                want = jcorridor._node_obs_for_agent(jparams, jsb, jnp.asarray(seen), j)
                close(node[b, j], want, f"{label} node_obs env {b} agent {j}")
    for k in STATE_KEYS:
        close(getattr(tstate, k).numpy()[keep], jf[k][keep], f"{label} state {k}")
    if frozen or all_done.any():
        tstate = to_port(jstate2)  # go on from the JAX draw
    return tstate, ts, jts, jstate2, frozen


def _spawn_rule_holds(params, state, b):
    """The fresh episode of env ``b`` obeys the gated spawn rule."""
    tb = state.tube
    ws = params.world_size
    ang = float(tb.angle[b])
    length = float(tb.length[b])
    assert -np.pi / 2 <= ang <= np.pi / 2
    if params.randomize_tube_length:  # 0.8 ws + U(-0.3 ws, 0.1 ws)
        assert 0.5 * ws <= length <= 0.9 * ws
    else:
        close(length, 0.8 * ws, "tube length")
    close(float(tb.width[b]), max(0.45, 0.15 * ws), "tube width")
    close(tb.entrance[b].numpy(), [np.sin(ang) * length / 4, np.cos(ang) * length / 4],
          "entrance")
    pos = state.agent_states[b, :, :2].numpy()
    perp = np.array([np.sin(ang), np.cos(ang)])
    for k in range(params.num_agents):
        base = tb.entrance[b].numpy() + (ws + k) / 3.0 * perp
        assert np.all(np.abs(pos[k] - base) <= 0.3 * ws + 1e-12)
    d = np.linalg.norm(pos[:, None] - pos[None], axis=-1)
    assert np.all(d[~np.eye(params.num_agents, dtype=bool)] >= params.cfg.separation_distance)
    close(state.agent_states[b, :, 3].numpy(), params.cfg.v_min, "spawn speed")
    assert not state.prev_proj[b].any()


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_gated_reset_outputs_and_steps_match_jax(scenario):
    params = port_params(scenario)
    jparams, _ = jax_env(scenario)
    jstate = jax_reset(scenario, 3)

    tstate, obs, node_obs, adj, aid = corridor.reset_outputs(params, to_port(jstate))
    jstate, jobs, jnode, jadj, jaid = jax_resets(scenario)[1](jstate)
    assert obs.shape[-1] == params.obs_dim and node_obs.shape[-1] == params.node_feat_dim == 7
    for got, want in ((obs, jobs), (node_obs, jnode), (adj, jadj), (aid, jaid)):
        close(got, want, "reset outputs")
    close(tstate.entry_cooldown, jstate.entry_cooldown, "reset cooldown")
    close(tstate.prev_phase, jstate.prev_phase, "reset prev_phase")

    rng = np.random.RandomState(7)
    gen = torch.Generator().manual_seed(0)
    resets = 0
    for t in range(10):
        act = rng.randint(0, params.num_actions, (B, params.num_agents))
        before = tstate
        tstate, ts, jts, jstate, _ = step_both(scenario, tstate, jstate, act, gen, f"step {t}")
        all_done = np.asarray(jts.done).all(axis=1)
        if all_done.any():
            resets += 1
            # the port's own fresh episodes, before the state was taken from JAX
            fresh = tenv.step(params, before, torch.as_tensor(act),
                              torch.Generator().manual_seed(t))[0]
            jf = jax_state_fields(jstate)
            for k in ("t", "status", "prev_phase", "phase_reached", "entry_cooldown",
                      "prev_proj", "goal_match", "goal_tracker"):
                np.testing.assert_array_equal(
                    getattr(fresh, k).numpy()[all_done], jf[k][all_done], err_msg=k)
            for b in np.flatnonzero(all_done):
                _spawn_rule_holds(params, fresh, b)
    assert resets == 1


def _scrambled(scenario, seed):
    """B fresh JAX states with the agents scattered over and around the tube
    (some on their goals), random phases, cooldowns and progress, and one in
    ten agents already frozen."""
    jstate = jax_reset(scenario, seed)
    f = jax_state_fields(jstate)
    rng = np.random.RandomState(seed)
    tb = f["tube"]
    L, hw = tb["frame_length"][:, None], tb["half_width"][:, None]
    n = 3
    s = rng.uniform(-0.3, 1.4, (B, n)) * L
    y = rng.uniform(-2.0, 2.0, (B, n)) * hw
    pos = tb["entrance"][:, None] + s[..., None] * tb["e"][:, None] + y[..., None] * tb["n"][:, None]
    u = rng.rand(B, n)
    on_goal, at_exit = u < 0.25, u > 0.8
    goal = f["landmark_pos"][np.arange(B)[:, None], f["goal_match"]]
    pos = np.where(on_goal[..., None], goal + rng.uniform(-0.2, 0.2, (B, n, 2)), pos)
    # in the exit gate from phase 1, every phase reached so far
    s_exit = L + rng.uniform(-0.02, 0.06, (B, n)) * L
    pos = np.where(at_exit[..., None], tb["entrance"][:, None]
                   + s_exit[..., None] * tb["e"][:, None], pos)
    st = f["agent_states"].copy()
    st[..., :2] = pos
    st[..., 2] = np.where(at_exit, np.arctan2(tb["e"][:, None, 1], tb["e"][:, None, 0]),
                          rng.uniform(0, 2 * np.pi, (B, n)))
    st[..., 3] = rng.uniform(0.035, 0.085, (B, n))
    upd = dict(
        agent_states=st,
        # on a goal: phase 2 with phase 1 or 2 reached (a goal reach)
        prev_phase=np.select([at_exit, on_goal], [1, 2],
                             rng.randint(0, 3, (B, n))).astype(np.int32),
        phase_reached=np.select([at_exit, on_goal], [1, rng.randint(1, 3, (B, n))],
                                rng.randint(0, 3, (B, n))).astype(np.int32),
        entry_cooldown=rng.randint(0, 4, (B, n)).astype(np.int32),
        prev_proj=rng.uniform(0, 3, (B, n)).astype(np.float32).astype(np.float64),
        status=rng.rand(B, n) < 0.1,
    )
    return jstate.replace(**{k: jnp.asarray(v) for k, v in upd.items()})


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_gated_scrambled_steps_match_jax(scenario):
    """Four steps from states scattered over every phase and gate."""
    params = port_params(scenario)
    jstate = _scrambled(scenario, 11)
    tstate = to_port(jstate)
    rng = np.random.RandomState(5)
    gen = torch.Generator().manual_seed(1)
    froze, rewards = 0, []
    for t in range(4):
        act = rng.randint(0, params.num_actions, (B, params.num_agents))
        tstate, ts, jts, jstate, frozen = step_both(scenario, tstate, jstate, act, gen, f"t{t}")
        froze += len(frozen)
        rewards.append(np.asarray(jts.reward))
    phases = set(np.unique(np.asarray(jstate.prev_phase)))
    assert phases == {0, 1, 2} and froze >= 1 and len(np.unique(np.concatenate(rewards))) > 20


def _built_state(scenario):
    """B fresh JAX states with hand-placed agents, one branch each (see
    ``test_gated_reward_branches_match_jax``)."""
    jstate = jax_reset(scenario, 5)
    f = jax_state_fields(jstate)
    tb = f["tube"]
    st, prev, reached, cool = (f[k].copy() for k in
                               ("agent_states", "prev_phase", "phase_reached", "entry_cooldown"))

    def at(b, s, y=0.0):  # tube coordinates (fraction of length, of half width) -> world
        return tb["entrance"][b] + s * tb["frame_length"][b] * tb["e"][b] \
            + y * tb["half_width"][b] * tb["n"][b]

    past = lambda b: 1.0 + 0.1 / tb["frame_length"][b]  # 0.1 beyond the tube's end
    along = lambda b: np.arctan2(tb["e"][b][1], tb["e"][b][0])
    far = lambda b, k: at(b, -1.5 - 0.5 * k, 3.0)  # phase 0, out of everyone's way
    for b in range(B):
        for k in range(3):
            st[b, k, :3] = [*far(b, k), along(b)]
    # env 0: entering the gate from phase 0, agent 0 with the cooldown run
    # out, agent 1 inside the cooldown
    st[0, 0, :2], st[0, 1, :2] = at(0, 0.02, -0.9), at(0, 0.02, 0.9)
    cool[0, 1] = 4
    # env 1: agent 0 leaves through the exit gate from phase 1; agent 1 just
    # behind it, so that agent 0 is one of its two nearest neighbours
    st[1, 0, :2], st[1, 1, :2] = at(1, past(1)), at(1, 0.9, 0.5)
    prev[1, :2] = reached[1, :2] = 1
    # env 2: agent 2 on its goal in phase 2
    st[2, 2, :2] = f["landmark_pos"][2, f["goal_match"][2, 2]]
    prev[2, 2] = reached[2, 2] = 2
    # env 3: agent 0 in the tube's exit gate from phase 1 without ever having
    # entered (two/three_phase demote it); agent 1 past the tube with no
    # phase reached (the skipped corridor); agent 2 back in the tube from
    # phase 2 (regression)
    st[3, 0, :2], st[3, 1, :2], st[3, 2, :2] = at(3, 0.99), at(3, 1.2, 2.0), at(3, 0.5)
    prev[3, 0], reached[3, 0] = 1, 0
    prev[3, 2] = reached[3, 2] = 2
    # env 4: two agents in phase 1 closer than the separation (spacing and
    # collision terms); rot_inv's progress on prev_proj
    st[4, 0, :2], st[4, 1, :2] = at(4, 0.4), at(4, 0.45, 0.3)
    prev[4, :2] = reached[4, :2] = 1
    upd = dict(agent_states=st, prev_phase=prev, phase_reached=reached, entry_cooldown=cool,
               prev_proj=np.where(prev == 1, 0.5, 0.0))
    return jstate.replace(**{k: jnp.asarray(v) for k, v in upd.items()})


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_gated_reward_branches_match_jax(scenario):
    """One step from hand-placed agents: the entrance bonus outside and
    inside the cooldown, the exit (two_phase's freeze), the goal reach, the
    demotion, the skipped corridor, a regression, spacing and collisions."""
    params = port_params(scenario)
    jstate = _built_state(scenario)
    act = np.full((B, 3), params.num_actions // 2)  # no turn, no acceleration
    _, ts, jts, jstate2, frozen = step_both(scenario, to_port(jstate), jstate, act,
                                            torch.Generator().manual_seed(0), scenario)
    jf = jax_state_fields(jstate2)
    r = np.asarray(jts.reward)
    g = params.goal_rew
    # the JAX step took every branch this test is for
    assert jf["phase_reached"][0, 0] == 1 and jf["entry_cooldown"][0, 0] == params.cooldown_steps
    assert jf["entry_cooldown"][0, 1] == 2
    assert r[0, 0] > r[0, 1] + g / 2
    assert jf["phase_reached"][1, 0] == 2 and jf["prev_phase"][1, 0] == 2
    assert bool(jf["status"][1, 0]) == (scenario == "two_phase")
    assert bool(jf["status"][2, 2]) == (scenario != "two_phase")
    if scenario == "rot_inv":
        assert jf["goal_tracker"][2, 2] == jf["goal_match"][2, 2]
        assert np.all(jf["prev_proj"][4, :2] != 0.5)
    else:
        assert jf["prev_phase"][3, 0] == 0 and jf["phase_reached"][3, 0] == 0  # demoted
    assert r[3, 1] <= -g  # skipped the corridor
    assert jf["prev_phase"][3, 2] == 1 and r[3, 2] < 0  # regressed
    assert jf["spacing_violation"][4, 0] == 1
    assert len(frozen) == 1


def test_two_phase_interleaving_matches_jax():
    """two_phase: agent 0 freezes at the exit and agent 1's observation row,
    taken after agent 0's reward in the same step, already leaves it out of
    its two nearest neighbours."""
    scenario = "two_phase"
    params = port_params(scenario)
    jstate = _built_state(scenario)
    tstate = to_port(jstate)
    act = np.full((B, 3), params.num_actions // 2)
    _, ts, jts, _, frozen = step_both(scenario, tstate, jstate, act,
                                      torch.Generator().manual_seed(0), scenario)
    assert (1, 0) in frozen
    # the rows a vectorized observation would give from the status before
    # the sweep: agent 0 still among agent 1's neighbours
    table = torch.as_tensor(actions.action_table(params.cfg, params.total_actions),
                            dtype=torch.float64)
    vals = dynamics.step_closed_form(tstate.agent_states,
                                     actions.decode(torch.as_tensor(act), table),
                                     params.cfg, ~tstate.status)
    vectorized = corridor._gated_obs(params, tstate, vals)
    row, jrow = ts.obs[1, 1].numpy(), np.asarray(jts.obs)[1, 1]
    close(row, jrow, "interleaved row")
    nb = slice(5, 9)  # the rotated two nearest neighbours
    assert np.abs(vectorized[1, 1, nb].numpy() - row[nb]).max() > 1e-3
    assert np.all(row[7:9] == 0.0)  # the second slot is empty: only agent 2 is left


def test_gated_tube_gates_match_jax():
    """The entrance and exit gates, their distances and the gated phase
    machine at its three levels, on a grid of points around rotated tubes."""
    rng = np.random.RandomState(0)
    nb, K = 6, 96
    angle = rng.uniform(-np.pi / 2, np.pi / 2, nb)
    length = rng.uniform(1.0, 3.6, nb)
    t_tube = tube.make_tube(torch.as_tensor(angle), 4.0, 0.06, torch.as_tensor(length))
    ss, yy = np.meshgrid(np.linspace(-0.3, 1.3, 12), np.linspace(-1.6, 1.6, 8))
    s_f, y_f = ss.ravel(), yy.ravel()  # K points in tube coordinates
    tb = {g.name: getattr(t_tube, g.name).numpy() for g in dataclasses.fields(t_tube)}
    pos = (tb["entrance"][:, None] + (s_f[None] * tb["frame_length"][:, None])[..., None]
           * tb["e"][:, None] + (y_f[None] * tb["half_width"][:, None])[..., None]
           * tb["n"][:, None])
    prev = rng.randint(0, 3, (nb, K))
    reached = rng.randint(0, 3, (nb, K))
    t_pos = torch.as_tensor(pos)
    s, y = tube.tube_coords(t_tube, t_pos)
    got = dict(
        egd=tube.entrance_gate_distance(t_tube, s, y),
        exit=tube.in_exit_gate(t_tube, s, y, 0.05, 0.08),
        xgd=tube.exit_gate_distance(t_tube, s, y),
        **{f"phase{lv}": tube.agent_phase_gated(
            t_tube, t_pos, torch.as_tensor(prev), torch.as_tensor(reached),
            0.08, 0.02, 0.02 if lv else 0.05, 0.08, lv) for lv in (0, 1, 2)},
    )

    def one(a, ln, p, pv, rc):
        tbj = jtube.make_tube(a, 4.0, 0.06, jnp.float64, ln)
        js, jy = jtube.tube_coords(tbj, p)
        return dict(
            egd=jtube.entrance_gate_distance(tbj, js, jy),
            exit=jtube.in_exit_gate(tbj, js, jy, 0.05, 0.08),
            xgd=jtube.exit_gate_distance(tbj, js, jy),
            **{f"phase{lv}": jtube.agent_phase_gated(
                tbj, p, pv, rc, 0.08, 0.02, 0.02 if lv else 0.05, 0.08, lv)
               for lv in (0, 1, 2)},
        )

    want = jax.vmap(one)(jnp.asarray(angle), jnp.asarray(length), jnp.asarray(pos),
                         jnp.asarray(prev, jnp.int32), jnp.asarray(reached, jnp.int32))
    for k in got:
        close(got[k].numpy(), want[k], k)
    # every phase at every level, and the levels differ
    for lv in (0, 1, 2):
        assert set(np.unique(got[f"phase{lv}"].numpy())) == {0, 1, 2}
    assert not torch.equal(got["phase0"], got["phase2"])


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_gated_reset_rule(scenario):
    """The port's own resets: the tube length draw (two/three_phase), the
    gated spawn jitter and spacing, prev_proj at zero, the observation and
    node-feature widths."""
    params = port_params(scenario)
    state, ts = tenv.reset(params, 64, torch.Generator().manual_seed(2), "cpu", torch.float64)
    for b in range(64):
        _spawn_rule_holds(params, state, b)
    lengths = state.tube.length.numpy()
    if params.randomize_tube_length:
        assert lengths.max() - lengths.min() > 0.5
    assert ts.obs.shape == (64, 3, params.obs_dim) and ts.node_obs.shape == (64, 3, 6, 7)
    assert params.obs_dim == (13 if scenario == "rot_inv" else 15)
    # the rule's constants, as the JAX package's EnvParams gives them
    jparams, _ = jax_env(scenario)
    for k in ("obs_dim", "node_feat_dim", "randomize_tube_length", "exit_back",
              "spawn_jitter_scale", "spawn_spacing_div", "cooldown_steps"):
        assert getattr(params, k) == getattr(jparams, k), k
    assert treset.SPAWN_CANDIDATES == 32
