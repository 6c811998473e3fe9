"""The torch port's obstacles and walls against the JAX package's, on the CPU
in float64.

Both packages get the same state and the same numpy actions: a port reset
(drawn from a seeded generator, then placed by hand where a test says so) as
numpy arrays, given to the port and, with the fields the port does not carry
at their reset values, to the JAX package.  obs, node_obs (the 13-dim wall
rows included), adj, reward, done, truncated, every info key (with
``Num_obst_collisions``) and the state are held at 1e-9, the bar of
``tests/test_golden_parity.py:143-161``.  The cases: july with air_taxi, 5
agents, 5 landmarks and 3 obstacles (BASELINE config 2, E = 13); july with
the double integrator and one wall (E = 7); v4oct with 2 obstacles and 2
walls (E = 10); rot_inv with 3 obstacles.  One jitted JAX
``reset_outputs`` and one jitted JAX ``corridor.step`` per case serve every
test of it; one jitted JAX ``env.step`` holds the auto-reset.  The spawn
rejection is held as a property, since the two frameworks draw differently.
A gated scenario with walls has no consistent graph in the JAX package (its
node rows leave the walls out, its adjacency counts them): the port refuses
it.
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
from contracts_marl_aam_corridors_tpu_torch.envs import corridor
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
# name: (vehicle, settings); the gated case at the shipped rot_inv recipe
CASES = {
    "config2": ("air_taxi", dict(num_agents=5, num_landmarks=5, num_obstacles=3,
                                 world_size=4.0)),
    "july_wall": (DI, dict(num_walls=1)),
    "v4oct": ("air_taxi", dict(scenario="v4oct", num_obstacles=2, num_walls=2)),
    "rot_inv": ("air_taxi", dict(scenario="rot_inv", num_obstacles=3, world_size=4.0,
                                 collision_rew=30.0, goal_rew=20.0, formation_rew=5.0)),
}
STATE_KEYS = ("t", "status", "prev_phase", "phase_reached", "entry_cooldown", "prev_proj",
              "goal_tracker", "goal_reached", "p_dist", "time", "conformance",
              "spacing_violation", "steps_in_corridor", "delta_spacing_sum",
              "num_agent_collisions", "num_obstacle_collisions", "times_required",
              "dists_to_goal", "dist_left_to_goal", "dist_left_float", "agent_states",
              "obstacle_pos")
# points on the obstacles (all at the origin, reach 0.24), on the wall box
# (|y| <= 0.09, |x| <= 1.09) and on neither
ON_OBSTACLE, ON_WALL, CLEAR = (0.1, 0.1), (0.8, 0.05), (0.8, 0.2)


def settings(name):
    vehicle, kw = CASES[name]
    return vehicle, {"num_landmarks": kw.get("num_agents", 3), "episode_length": EP_LEN, **kw}


def port_params(name, **over):
    vehicle, kw = settings(name)
    return EnvParams(cfg=physics.vehicle_config(vehicle), **{**kw, **over})


@functools.lru_cache(maxsize=None)
def jax_env(name):
    """The JAX params, its jitted batched ``reset_outputs`` and its jitted
    batched ``corridor.step``."""
    vehicle, kw = settings(name)
    jparams = JEnvParams(cfg=jphysics.vehicle_config(vehicle), **kw)
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
    """One step of both from equal states, everything held.  No agent of
    these steps freezes, so the goal-reach headings the heading models draw
    from the port's generator are never used."""
    tstate2, ts = corridor.step(params, tstate, torch.as_tensor(act), torch.Generator())
    assert torch.equal(tstate2.status, tstate.status), f"{label}: an agent froze"
    jstate2, jts = jstep(jstate, jnp.asarray(act, jnp.int32))
    for k in ("obs", "node_obs", "adj", "reward", "done", "truncated"):
        close(getattr(ts, k), getattr(jts, k), f"{label} {k}")
    assert set(ts.info) == set(jts.info)
    for k in ts.info:
        close(ts.info[k], jts.info[k], f"{label} info[{k}]")
    jf = jax_state_fields(jstate2)
    for k in STATE_KEYS:
        close(getattr(tstate2, k), jf[k], f"{label} state {k}")
    return tstate2, ts, jstate2, jts


def hits(pos, params):
    """Which positions (..., 2) lie on an obstacle or in the wall box, by
    the reference's geometry (july:864-890)."""
    pos = np.asarray(pos)
    on = np.zeros(pos.shape[:-1], bool)
    if params.num_obstacles:
        on |= np.linalg.norm(pos, axis=-1) < 0.24
    if params.num_walls:
        on |= (np.abs(pos[..., 1]) <= 1.5 * 0.06) & (np.abs(pos[..., 0]) <= 1.0 + 1.5 * 0.06)
    return on


def near_origin(fields):
    """Agent 1 of envs 0-2 on an obstacle, on the wall and beside both, so
    that the steps from there pay the obstacle term and count collisions."""
    st = fields["agent_states"].copy()
    for b, p in enumerate((ON_OBSTACLE, ON_WALL, CLEAR)):
        st[b, 1, :2] = p
    return {**fields, "agent_states": st}


@pytest.mark.parametrize("name", sorted(CASES))
def test_reset_outputs_and_steps_match_jax(name):
    """reset_outputs of a port reset with agents moved next to the
    obstacles and walls, then EP_LEN steps of random actions to the time
    limit."""
    params = port_params(name)
    jparams, jreset_outputs, jstep = jax_env(name)
    for k in ("num_entities", "node_feat_dim", "obs_dim", "num_actions"):
        assert getattr(params, k) == getattr(jparams, k), k
    tstate, jstate = both(near_origin(reset_fields(params, 3)), jparams)
    tstate, obs, node_obs, adj, aid = corridor.reset_outputs(params, tstate)
    jstate, jobs, jnode, jadj, jaid = jreset_outputs(jstate)
    E, n = params.num_entities, params.num_agents
    assert node_obs.shape == (B, n, E, params.node_feat_dim) and adj.shape == (B, E, E)
    for label, got, want in (("obs", obs, jobs), ("node_obs", node_obs, jnode),
                             ("adj", adj, jadj), ("agent_id", aid, jaid)):
        close(got, want, f"reset {label}")
    o, w = params.num_obstacles, params.num_walls
    kinds = node_obs[..., -1].numpy()
    assert (kinds[..., E - o - w:E - w] == 2.0).all() and (kinds[..., E - w:] == 3.0).all()
    if w:  # 13-dim rows: the corners on wall rows only, goal_history zero
        corners = node_obs[..., 8:12].numpy()
        assert (corners[..., :E - w, :] == 0).all()
        assert (np.abs(corners[..., E - w:, :]).sum(-1) > 0).all()
        assert (node_obs[..., 7].numpy() == 0).all()

    rng = np.random.RandomState(7)
    counted = np.zeros((B, n))
    for t in range(EP_LEN):
        act = rng.randint(0, params.num_actions, (B, n))
        before = tstate.num_obstacle_collisions.numpy().copy()
        tstate, ts, jstate, jts = step_both(params, jstep, tstate, jstate, act, f"step {t}")
        counted += hits(tstate.agent_states[..., :2].numpy(), params)
        close(tstate.num_obstacle_collisions.numpy() - before,
              hits(tstate.agent_states[..., :2].numpy(), params), f"step {t} count")
    assert ts.done.all() and ts.truncated.all()
    close(ts.info["Num_obst_collisions"], counted, "counted collisions")
    assert counted[0, 1] > 0 and counted[2, 1] == 0  # the obstacle, then beside it
    if w:
        assert counted[1, 1] > 0


# agents placed per env: (agent, point) pairs, the rest where the reset put them
BUILT = [((0, ON_OBSTACLE),), ((0, ON_WALL),), ((0, CLEAR),), ((1, ON_OBSTACLE), (2, ON_WALL)),
         ((0, (0.0, 0.2)),), ((0, (1.05, -0.08)),), ((2, (0.0, 0.3)),), ()]


@pytest.mark.parametrize("name", sorted(CASES))
def test_obstacle_and_wall_terms_match_jax(name):
    """One step from agents placed on an obstacle, in the wall box and
    beside both, held against the JAX step; then the reward term and the
    counter on both of their branches: the reward of the same step without
    obstacles and walls is higher by 3 collision penalties exactly where an
    agent ends the step on one (the july and v4oct rewards, rot_inv's), and
    the counter grows by one there."""
    params = port_params(name)
    jparams, _, jstep = jax_env(name)
    f = reset_fields(params, 5)
    st = f["agent_states"].copy()
    if params.cfg.dynamics == physics.DynamicsType.DOUBLE_INTEGRATOR:
        st[..., 2:] = 0.0
    else:
        st[..., 3] = params.cfg.v_min
    for b, placed in enumerate(BUILT):
        for i, p in placed:
            st[b, i, :2] = p
    if params.scenario == "rot_inv":
        # the obstacles lie in rot_inv's tube, where phase 0 pays one more
        # collision penalty and the reward clips: env 4's agent is in phase 1
        for k in ("prev_phase", "phase_reached"):
            f[k] = f[k].copy()
            f[k][4, 0] = 1
    tstate, jstate = both({**f, "agent_states": st}, jparams)
    act = np.zeros((B, params.num_agents), int)  # the slowest, straightest move
    tstate2, ts, _, _ = step_both(params, jstep, tstate, jstate, act, name)
    on = hits(tstate2.agent_states[..., :2].numpy(), params)
    placed = np.zeros_like(on)
    for b, pl in enumerate(BUILT):
        for i, _ in pl:
            placed[b, i] = True
    assert on[placed].any() and not on[placed].all()  # both branches
    close(tstate2.num_obstacle_collisions, on, "counter")

    bare = port_params(name, num_obstacles=0, num_walls=0)
    tbare = env_state_from_numpy({**f, "agent_states": st, "obstacle_pos": np.zeros((B, 0, 2))},
                                 CPU, torch.float64)
    _, ts_bare = corridor.step(bare, tbare, torch.as_tensor(act), torch.Generator())
    # july and rot_inv clip the reward below at -4 collision penalties, v4oct not
    lo = -np.inf if params.scenario == "v4oct" else -4 * params.collision_rew
    want = np.maximum(ts_bare.reward.numpy() - 3 * params.collision_rew * on, lo)
    close(ts.reward, want, "the obstacle term")
    assert (on & (want > lo)).any()  # a term seen whole


@pytest.mark.parametrize("scenario", ["two_phase", "three_phase"])
def test_two_and_three_phase_have_no_obstacle_term(scenario):
    """two_phase and three_phase count obstacle collisions but pay none
    (the JAX package's gated reward adds the term for rot_inv only)."""
    params = port_params("rot_inv", scenario=scenario)
    f = reset_fields(params, 6)
    st = f["agent_states"].copy()
    st[0, 0, :2], st[1, 2, :2] = ON_OBSTACLE, (0.0, -0.2)
    st[..., 3] = params.cfg.v_min
    tstate = env_state_from_numpy({**f, "agent_states": st}, CPU, torch.float64)
    bare = env_state_from_numpy({**f, "agent_states": st, "obstacle_pos": np.zeros((B, 0, 2))},
                                CPU, torch.float64)
    act = torch.zeros((B, 3), dtype=torch.long)
    s1, ts = corridor.step(params, tstate, act, torch.Generator())
    _, ts_bare = corridor.step(dataclasses.replace(params, num_obstacles=0), bare, act,
                               torch.Generator())
    close(ts.reward, ts_bare.reward, "no obstacle term")
    on = hits(s1.agent_states[..., :2].numpy(), params)
    assert on[0, 0] and on[1, 2] and on.sum() == 2
    close(ts.info["Num_obst_collisions"], on, "counted")


@pytest.mark.parametrize("name", ["config2", "july_wall", "v4oct"])
def test_spawn_avoids_walls_and_obstacles(name, monkeypatch):
    """Over 4,096 envs each agent, agent 0 included, takes the first of its
    32 candidates that lies neither in the wall box, nor within 0.24 of an
    obstacle, nor within the separation of an agent placed before it (the
    first candidate where all collide, as in the JAX package), the
    candidates rebuilt from the recorded jitter draws.  Agent 0's first
    candidate is rejected somewhere in every case with walls, and no agent
    0 lies on a wall or an obstacle.  With the double integrator's wall at
    world size 2 the bases of agents 1 and 2 lie near the wall, and 13 of
    these 8,192 find no clear candidate and end on it (the JAX reset, with
    its own draws, puts 15 there).  The draws are those of the reset
    without obstacles and walls: the generator ends where that one leaves
    it."""
    params = port_params(name)
    jitters = []
    real = treset._uniform

    def recording(gen, shape, lo, hi, like):
        out = real(gen, shape, lo, hi, like)
        if len(shape) == 3:  # a block of candidates' jitter
            jitters.append(out.numpy())
        return out

    monkeypatch.setattr(treset, "_uniform", recording)
    g = torch.Generator().manual_seed(1)
    st = treset.reset(params, 4096, g, CPU, torch.float64)
    monkeypatch.setattr(treset, "_uniform", real)
    g_bare = torch.Generator().manual_seed(1)
    treset.reset(port_params(name, num_obstacles=0, num_walls=0), 4096, g_bare, CPU,
                 torch.float64)
    assert torch.equal(g.get_state(), g_bare.get_state())

    pos = st.agent_states[..., :2].numpy()
    tb = {k: getattr(st.tube, k).numpy() for k in ("entrance", "angle")}
    perp = np.stack([np.sin(tb["angle"]), np.cos(tb["angle"])], -1)
    sep = params.cfg.separation_distance
    fallback = np.zeros(pos.shape[:2], bool)
    first_rejected = None
    for k, jit in enumerate(jitters):
        base = tb["entrance"] + (params.world_size + k) / params.spawn_spacing_div * perp
        cand = base[:, None] + params.spawn_jitter_scale * jit  # (B, K, 2)
        collide = hits(cand, params)
        if k:
            d = np.linalg.norm(cand[:, :, None] - pos[:, None, :k], axis=-1)
            collide |= (d < sep).any(-1)
        first = np.where(collide.all(1), 0, np.argmax(~collide, axis=1))
        np.testing.assert_allclose(pos[:, k], cand[np.arange(len(cand)), first],
                                   rtol=0, atol=1e-12)
        fallback[:, k] = collide.all(1)
        if k == 0:
            first_rejected = collide[:, 0]
    assert len(jitters) == params.num_agents
    on = hits(pos, params)
    assert not on[:, 0].any() and not fallback[:, 0].any()
    np.testing.assert_array_equal(on, on & fallback)  # on one only where none was clear
    if params.num_walls:
        assert first_rejected.any()
    assert on.sum() == (13 if name == "july_wall" else 0)
    assert st.obstacle_pos.shape == (4096, params.num_obstacles, 2)
    assert not st.obstacle_pos.any()


def test_auto_reset_matches_jax():
    """``env.step`` with its auto-reset against the JAX package's (july with
    the double integrator and a wall), from equal states whose envs are two
    steps apart in time.  Each framework draws its fresh episodes from its
    own stream: where an env resets, the fresh observations the JAX step
    returns are held against the port's ``reset_outputs`` on the JAX fresh
    state, and the port goes on from that state."""
    name = "july_wall"
    params = port_params(name)
    jparams, jreset_outputs, _ = jax_env(name)
    jenv_step = jax.jit(jax.vmap(partial(jenv.step, jparams)))
    f = near_origin(reset_fields(params, 5))
    f["t"] = np.where(np.arange(B) % 2 == 1, 2, 0).astype(f["t"].dtype)
    tstate, jstate = both(f, jparams)
    tstate = corridor.reset_outputs(params, tstate)[0]
    jstate = jreset_outputs(jstate)[0]
    gen = torch.Generator().manual_seed(5)
    rng = np.random.RandomState(5)
    resets = 0
    for t in range(EP_LEN):
        act = rng.randint(0, params.num_actions, (B, params.num_agents))
        tstate2, ts = tenv.step(params, tstate, torch.as_tensor(act), gen)
        jstate2, jts = jenv_step(jstate, jnp.asarray(act, jnp.int32))
        for k in ("reward", "done", "truncated"):
            close(getattr(ts, k), getattr(jts, k), f"step {t} {k}")
        for k in ts.info:
            close(ts.info[k], jts.info[k], f"step {t} info[{k}]")
        jf = jax_state_fields(jstate2)
        reset = ts.done.all(dim=1).numpy()
        kept = ~reset
        for k in ("obs", "node_obs", "adj"):
            close(getattr(ts, k).numpy()[kept], np.asarray(getattr(jts, k))[kept],
                  f"step {t} {k} of the envs that went on")
        for k in STATE_KEYS:
            close(getattr(tstate2, k).numpy()[kept], jf[k][kept], f"step {t} state {k}")
        if reset.any():
            resets += int(reset.sum())
            # the fresh episodes: counters at zero, no agent on the wall
            assert not tstate2.num_obstacle_collisions.numpy()[reset].any()
            assert not hits(tstate2.agent_states[..., :2].numpy()[reset], params).any()
            fresh = env_state_from_numpy(jf, CPU, torch.float64)
            fresh, obs, node_obs, adj, _ = corridor.reset_outputs(params, fresh)
            for k, got in (("obs", obs), ("node_obs", node_obs), ("adj", adj)):
                close(got.numpy()[reset], np.asarray(getattr(jts, k))[reset],
                      f"step {t} fresh {k}")
            tstate2 = tenv._select_state(torch.as_tensor(reset), fresh, tstate2)
        tstate, jstate = tstate2, jstate2
    assert resets == B  # the odd envs reset at step 3, the even ones at step 5


def test_gated_scenario_with_walls_is_refused():
    """The JAX env's rot_inv with one wall builds node rows for agents,
    landmarks and obstacles (6 here) and an adjacency over 7 entities, the
    wall included; the port refuses the configuration with both counts."""
    jparams = JEnvParams(cfg=jphysics.vehicle_config("air_taxi"), scenario="rot_inv",
                         num_walls=1)
    _, ts = jax.jit(partial(jenv.reset, jparams, dtype=jnp.float64))(jax.random.PRNGKey(0))
    assert ts.node_obs.shape == (3, 6, 7) and ts.adj.shape == (7, 7)
    for scenario in ("rot_inv", "two_phase", "three_phase"):
        with pytest.raises(ValueError, match=r"n \+ l \+ o = 6 .* n \+ l \+ o \+ w = 7"):
            EnvParams(cfg=physics.vehicle_config("air_taxi"), scenario=scenario, num_walls=1)
    # obstacles alone give a consistent graph there
    p = EnvParams(cfg=physics.vehicle_config("air_taxi"), scenario="rot_inv", num_obstacles=2)
    assert p.num_entities == 8 and p.node_feat_dim == 7
