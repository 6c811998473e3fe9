"""The torch port's safety filters against the JAX package's, on the CPU in
float64.

The filters (``safety/cbf.py``, ``safety/hj.py``, ``safety/rvo.py``) take
the same seeded numpy states and controls in both packages, batched over
envs in the port and vmapped in the JAX package, at 3, 6 and 10 agents:
coincident agents, rows whose every other agent is inactive, points
outside the HJ grid, both HJ branches, and agents in and out of
coordination range.  Values are held at 1e-9 and the chosen neighbours
exactly.  The HJ tables (the synthetic one, and a pickle the test writes)
are held leaf for leaf.  Whole filtered episodes of ``env.step`` with its
auto-reset are held against the JAX package's jitted ``env.step`` (one per
case): july with air_taxi and HJ with every safety reward term on, july
with the double integrator and the exponential CBF at 6 agents (the JAX
step's scan over agents), the double integrator with ORCA and a wall,
v4oct with the exponential CBF, and rot_inv with HJ.  Each episode must
filter some agent-steps, and the HJ ones must take the evasive branch.
"""
import dataclasses
import functools
import math
import pickle
import types
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu import safety as jsafety
from contracts_marl_aam_corridors_tpu.config import physics as jphysics
from contracts_marl_aam_corridors_tpu.envs import corridor as jcorridor
from contracts_marl_aam_corridors_tpu.envs import env as jenv
from contracts_marl_aam_corridors_tpu.envs.types import EnvParams as JEnvParams
from contracts_marl_aam_corridors_tpu.envs.types import EnvState as JEnvState
from contracts_marl_aam_corridors_tpu.envs.types import TubeParams as JTubeParams
from contracts_marl_aam_corridors_tpu.safety import hj as jhj
from contracts_marl_aam_corridors_tpu.safety import rvo as jrvo

from contracts_marl_aam_corridors_tpu_torch import safety
from contracts_marl_aam_corridors_tpu_torch.config import physics
from contracts_marl_aam_corridors_tpu_torch.envs import actions as tactions
from contracts_marl_aam_corridors_tpu_torch.envs import corridor
from contracts_marl_aam_corridors_tpu_torch.envs import env as tenv
from contracts_marl_aam_corridors_tpu_torch.envs import reset as treset
from contracts_marl_aam_corridors_tpu_torch.envs.types import EnvParams, env_state_from_numpy
from contracts_marl_aam_corridors_tpu_torch.safety import cbf, hj, rvo
from test_torch_env import jax_state_fields

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(atol=1e-9, rtol=0)
AIR, DI = physics.vehicle_config("air_taxi"), physics.vehicle_config("double_integrator")
JAIR, JDI = jphysics.vehicle_config("air_taxi"), jphysics.vehicle_config("double_integrator")
NS = (3, 6, 10)
B = 8


def close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg, **TOL)


def t64(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def jtable(table: hj.HjValueData):
    return jhj.HjValueData(lo=jnp.asarray(table.lo.numpy()), hi=jnp.asarray(table.hi.numpy()),
                           values=jnp.asarray(table.values.numpy()),
                           grads=jnp.asarray(table.grads.numpy()),
                           separation_distance=table.separation_distance)


SYNTH = hj.make_synthetic_airtaxi_hj(AIR)
JSYNTH = jtable(SYNTH)


# ------------------------------------------------------------------ inputs
def di_inputs(n, seed):
    """B envs of n double-integrator agents and table controls.  Env 0: agent
    1 on agent 0; env 1: agents on a collision course; env 2: spread past
    the coordination range (5.0); env 3: velocities past the bounds.  The
    active mask leaves only agent 0 active in env 4 (its row has no
    candidate) and drops agent 1 in env 5."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1.5, 1.5, (B, n, 2))
    vel = rng.uniform(-0.9, 0.9, (B, n, 2))
    pos[0, 1] = pos[0, 0]
    pos[1, 1] = pos[1, 0] + [0.3, 0.0]
    vel[1, 0], vel[1, 1] = [0.8, 0.0], [-0.8, 0.0]
    pos[2, :, 0], pos[2, :, 1] = 6.0 * np.arange(n), 0.0
    vel[3] *= 1.4
    table = tactions.action_table(DI, 5)
    act = table[rng.randint(0, 5, (B, n))]
    active = np.ones((B, n), bool)
    active[4, 1:] = False
    active[5, 1] = False
    return np.concatenate([pos, vel], -1), act, active


def air_inputs(n, seed):
    """B envs of n air taxis and table controls.  Env 0: agent 1 on agent 0;
    env 1: agents 0.3 km apart (the evasive branch); env 2: spread past the
    grid (3 km) and the coordination range (4.83 km); env 3: headings
    over the whole circle (heading differences off the grid); env 4 and 5:
    speeds at the bounds (the box shrinks)."""
    rng = np.random.RandomState(seed)
    pos = rng.uniform(-1.2, 1.2, (B, n, 2))
    th = rng.uniform(-math.pi / 2, math.pi / 2, (B, n))
    v = rng.uniform(AIR.v_min, AIR.v_max, (B, n))
    pos[0, 1] = pos[0, 0]
    pos[1, 1] = pos[1, 0] + [0.3, 0.1]
    pos[2, :, 0], pos[2, :, 1] = 5.0 * np.arange(n), 0.0
    th[3] = rng.uniform(-math.pi, math.pi, n)
    v[4] = AIR.v_min
    v[5] = AIR.v_max
    table = tactions.action_table(AIR, 25)
    act = table[rng.randint(0, 25, (B, n))]
    active = np.ones((B, n), bool)
    active[4, 1:] = False
    active[5, 1] = False
    return np.stack([pos[..., 0], pos[..., 1], th, v], -1), act, active


# ------------------------------------------------------------------ functions
def test_cbf_qp_analytic_matches_jax():
    """Random single-constraint QPs, violated and not, with a degenerate
    (all-zero) constraint row."""
    rng = np.random.RandomState(0)
    u, a, w = rng.randn(64, 4), rng.randn(64, 4), rng.uniform(0.5, 100, (64, 4))
    b = rng.randn(64)
    a[3] = 0.0
    got = cbf.cbf_qp_analytic(t64(u), t64(a), t64(b), t64(w))
    want = jax.jit(jsafety.cbf_qp_analytic)(u, a, b, w)
    close(got, want)
    assert torch.equal(got[3], t64(u[3]))


@functools.lru_cache(maxsize=None)
def jax_filter(kind, masked):
    """The JAX filter vmapped over envs and jitted, once a kind."""
    if kind == "cbf":
        fn = lambda s, a, m: jsafety.di_exp_cbf_filter(s, a, JDI, m if masked else None)
    elif kind == "hj":
        fn = lambda s, a, m: jsafety.airtaxi_hj_filter(s, a, JSYNTH, JAIR,
                                                       m if masked else None)
    else:
        fn = lambda s, a, m: jrvo.rvo_filter(s, a, JDI)
    return jax.jit(jax.vmap(fn))


def check_filter(kind, n, seed):
    inputs = di_inputs if kind in ("cbf", "rvo") else air_inputs
    states, act, active = inputs(n, seed)
    for masked in ((False, True) if kind != "rvo" else (False,)):
        kw = dict(active=torch.as_tensor(active)) if masked else {}
        trace = {}
        if kind == "cbf":
            got = cbf.di_exp_cbf_filter(t64(states), t64(act), DI, trace=trace, **kw)
        elif kind == "hj":
            got = hj.airtaxi_hj_filter(t64(states), t64(act), SYNTH, AIR, trace=trace, **kw)
        else:
            got = rvo.rvo_filter(t64(states), t64(act), DI, trace=trace)
        want = jax_filter(kind, masked)(jnp.asarray(states), jnp.asarray(act),
                                        jnp.asarray(active))
        label = f"{kind} n={n} masked={masked}"
        close(got[0], want[0], f"{label} controls")
        assert np.array_equal(got[1].numpy(), np.asarray(want[1])), f"{label} flags"
        close(got[2], want[2], f"{label} action_diff")
        assert np.array_equal(got[3].numpy(), np.asarray(want[3])), f"{label} neighbours"
        assert got[1].any() and not got[1].all(), f"{label}: some filtered, not all"
        yield masked, got, trace


@pytest.mark.parametrize("n", NS)
def test_di_exp_cbf_filter_matches_jax(n):
    for masked, got, trace in check_filter("cbf", n, n):
        applied = trace["applied"].numpy()
        assert not applied[2].any()  # past the coordination range
        assert applied[0].all() and applied[1].all()
        if masked:
            assert got[3][4, 0] == 0 and not applied[4, 0]  # no candidate: agent 0
            assert (got[3][5] != 1).all()  # agent 1 inactive


@pytest.mark.parametrize("n", NS)
def test_airtaxi_hj_filter_matches_jax(n):
    for masked, got, trace in check_filter("hj", n, 10 + n):
        evasive, applied = trace["evasive"][0].numpy(), trace["applied"].numpy()
        assert (evasive & applied).any() and (~evasive & applied).any()  # both branches
        assert not applied[2].any()  # off the grid and out of range
        if masked:
            assert not applied[4, 0]


@pytest.mark.parametrize("n", NS)
def test_rvo_filter_matches_jax(n):
    """``rvo_filter`` and its pieces, with agents in collision (env 0: on
    each other, env 1: 0.3 apart and closing)."""
    for _, got, trace in check_filter("rvo", n, 20 + n):
        assert trace["most_violated"][0].shape == (B, n, rvo.ORCA_ITERS)
    states, act, _ = di_inputs(n, 20 + n)
    pos, vel = states[..., :2], states[..., 2:]
    radius = rvo.RADIUS_SCALE * 0.06
    got = rvo.orca_halfplanes(t64(pos), t64(vel), radius, rvo.TIME_HORIZON, 0.1)
    want = jax.jit(jax.vmap(partial(jrvo.orca_halfplanes, radius=radius,
                                    tau=jrvo.TIME_HORIZON, dt=0.1)))(pos, vel)
    close(got[0], want[0], "points")
    close(got[1], want[1], "normals")
    assert np.array_equal(got[2].numpy(), np.asarray(want[2][0]))
    pref = vel + act * 0.1
    got = rvo.orca_project(t64(pos), t64(vel), t64(pref), 1.0, radius)
    want = jax.jit(jax.vmap(partial(jrvo.orca_project, max_speed=1.0, radius=radius)))(
        pos, vel, pref)
    close(got, want, "orca_project")


def test_interpolate_and_pieces_match_jax():
    """``interpolate`` on the values (scalar) and the gradients (channel-
    wise) at points inside, on the faces of and outside the grid;
    ``relative_state_airtaxi``, ``_optimal_control`` with the speed bounds."""
    rng = np.random.RandomState(1)
    lo, hi = SYNTH.lo.numpy(), SYNTH.hi.numpy()
    x = lo + (hi - lo) * rng.uniform(-0.2, 1.2, (200, 5))
    x[:5] = lo  # the lower corner
    x[5:10] = hi  # the upper corner: the last cell's far face
    ji = jax.jit(jhj.interpolate)
    for tab, jt in ((SYNTH.values, JSYNTH.values), (SYNTH.grads, JSYNTH.grads)):
        got, rng_in = hj.interpolate(SYNTH.lo, SYNTH.hi, tab, t64(x))
        want, want_in = ji(JSYNTH.lo, JSYNTH.hi, jt, x)
        close(got, want)
        assert np.array_equal(rng_in.numpy(), np.asarray(want_in))
        assert rng_in.any() and not rng_in.all()
    states, _, _ = air_inputs(6, 2)
    rel = hj.relative_state_airtaxi(t64(states)[..., :, None, :], t64(states)[..., None, :, :])
    jrel = jhj.relative_state_airtaxi(states[..., :, None, :], states[..., None, :, :])
    close(rel, jrel)
    grad = rng.randn(*rel.shape)
    close(hj._optimal_control(rel, t64(grad), AIR), jhj._optimal_control(jrel, grad, JAIR))
    close(hj._open_loop(rel), jhj._open_loop(jrel))


def test_synthetic_table_matches_jax():
    """``make_synthetic_airtaxi_hj`` leaf for leaf, and on the env's device
    and dtype through ``HjValueData.to``."""
    want = jhj.make_synthetic_airtaxi_hj(JAIR)
    for k in ("lo", "hi", "values", "grads"):
        assert np.array_equal(getattr(SYNTH, k).numpy(), np.asarray(getattr(want, k))), k
        assert getattr(SYNTH, k).dtype == torch.float64
    assert SYNTH.separation_distance == want.separation_distance
    f32 = SYNTH.to(CPU, torch.float32)
    assert f32.values.dtype == torch.float32 and torch.equal(
        f32.values, SYNTH.values.to(torch.float32))


@pytest.mark.parametrize("meta", ["dict", "object"])
def test_load_hj_pickle_matches_jax(meta, tmp_path):
    """A pickle of the reference's layout, written here (the reference's
    own is not shipped): negated, shifted by the separation change,
    gradients precomputed, leaf for leaf."""
    rng = np.random.RandomState(3)
    lo, hi = np.array([-2.0, -2, -np.pi, 0.03, 0.03]), np.array([2.0, 2, np.pi, 0.09, 0.09])
    grid = {"lo": lo, "hi": hi} if meta == "dict" else types.SimpleNamespace(lo=lo, hi=hi)
    data = types.SimpleNamespace(info={"separation_distance": 0.3}, grid_meta_data=grid,
                                 values=rng.randn(5, 6, 3, 3, 4))
    path = tmp_path / "value_function.pkl"
    path.write_bytes(pickle.dumps(data))
    got = hj.load_hj_pickle(str(path), AIR.separation_distance)
    want = jhj.load_hj_pickle(str(path), JAIR.separation_distance)
    for k in ("lo", "hi", "values", "grads"):
        assert np.array_equal(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k
    assert got.grads.shape == (5, 6, 3, 3, 4, 5)


def test_heading_filter_without_hj_data_raises():
    """A heading model's filter needs the HJ table: with ``cbf`` or
    ``exp_cbf`` the train CLI builds none for the air taxi, and the step of
    both packages raises the same ValueError."""
    kw = dict(num_agents=3, use_safety_filter=True, safety_filter_type="exp_cbf")
    params = EnvParams(cfg=AIR, **kw)
    st = treset.reset(params, B, torch.Generator().manual_seed(0), CPU, torch.float64)
    with pytest.raises(ValueError, match="requires HJ value data"):
        corridor.step(params, st, torch.zeros((B, 3), dtype=torch.long), torch.Generator())
    jparams = JEnvParams(cfg=JAIR, **kw)
    jst = jax.tree.map(lambda x: x[0], both(params, jparams, 0)[1])
    with pytest.raises(ValueError, match="requires HJ value data"):
        jcorridor.step(jparams, jst, jnp.zeros((3,), jnp.int32))


# ------------------------------------------------------------------ episodes
EP_LEN = 8
THETA = 0.7  # the fixed freeze heading: no draw, so both packages agree
ALL_TOGGLES = physics.RewardToggles(safety_violation=True, hj_value=True,
                                    potential_conflict=True, diff_from_filtered_action=True)
# name: (vehicle, filter type, settings)
EPISODES = {
    "july_hj_toggles": ("air_taxi", "hj", dict(reward_toggles=ALL_TOGGLES)),
    "july_exp_cbf_6": ("double_integrator", "exp_cbf", dict(num_agents=6, num_landmarks=6)),
    "rvo_wall": ("double_integrator", "rvo", dict(num_walls=1)),
    "v4oct_exp_cbf": ("double_integrator", "exp_cbf", dict(scenario="v4oct")),
    "rot_inv_hj": ("air_taxi", "hj", dict(scenario="rot_inv")),
}
STATE_KEYS = ("t", "status", "prev_phase", "phase_reached", "entry_cooldown", "prev_proj",
              "goal_tracker", "goal_reached", "p_dist", "time", "conformance",
              "spacing_violation", "steps_in_corridor", "delta_spacing_sum",
              "num_agent_collisions", "num_obstacle_collisions", "times_required",
              "dists_to_goal", "dist_left_to_goal", "dist_left_float", "agent_states",
              "action_diff", "safety_violations")


def episode_params(name):
    vehicle, kind, kw = EPISODES[name]
    kw = {"episode_length": EP_LEN, "use_safety_filter": True, "safety_filter_type": kind,
          "parity_fixed_reset_theta": THETA, **kw}
    jkw = {k: v for k, v in kw.items() if k != "reward_toggles"}
    if "reward_toggles" in kw:
        jkw["reward_toggles"] = jphysics.RewardToggles(**dataclasses.asdict(kw["reward_toggles"]))
    return (EnvParams(cfg=physics.vehicle_config(vehicle), **kw),
            JEnvParams(cfg=jphysics.vehicle_config(vehicle), **jkw))


def both(params, jparams, seed):
    """A port reset of B envs, every odd env two steps into its episode, as
    the port's state and the JAX package's (the JAX fields the port does
    not carry at their reset values); the agents of env 0 packed together
    so that the filter engages from the first step."""
    st = treset.reset(params, B, torch.Generator().manual_seed(seed), CPU, torch.float64)
    st.t[1::2] = 2
    st.agent_states[0, :, :2] = st.agent_states[0, :1, :2] + torch.linspace(
        0, 0.25 * params.cfg.separation_distance * params.num_agents, params.num_agents,
        dtype=torch.float64)[:, None]
    f = {}
    for fl in dataclasses.fields(st):
        v = getattr(st, fl.name)
        if fl.name == "tube":
            f["tube"] = {g.name: getattr(v, g.name).numpy() for g in dataclasses.fields(v)}
        elif v is not None:
            f[fl.name] = v.numpy()

    def conv(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)

    jf = {k: conv(v) for k, v in f.items() if k != "tube"}
    jf.update(tube=JTubeParams(**{k: conv(v) for k, v in f["tube"].items()}),
              goal_history=jnp.full((B, params.num_landmarks), -1, jnp.int32),
              key=jax.random.split(jax.random.PRNGKey(seed), B))
    return env_state_from_numpy(f, CPU, torch.float64), JEnvState(**jf)


@pytest.mark.parametrize("name", sorted(EPISODES))
def test_filtered_episode_matches_jax(name):
    """``EP_LEN`` steps of ``env.step`` with the filter and its auto-reset
    against the JAX package's jitted ``env.step``: reward, done, truncated,
    every info key, and (in the envs that went on) obs, node_obs, adj and
    the state with ``action_diff`` and ``safety_violations`` at 1e-9.
    Where an env resets, each package draws its own fresh episode: the
    fresh observations are held on the JAX fresh state and the port goes on
    from it.  Some agent-steps must be filtered, and with HJ some must take
    the evasive branch; the hj_value term must be paid where it is on."""
    params, jparams = episode_params(name)
    hj_t = SYNTH if params.safety_filter_type == "hj" else None
    jstep = jax.jit(jax.vmap(partial(jenv.step, jparams, hj_data=JSYNTH if hj_t else None)))
    jreset_outputs = jax.jit(jax.vmap(partial(jcorridor.reset_outputs, jparams)))
    tstate, jstate = both(params, jparams, 5)
    tstate = corridor.reset_outputs(params, tstate)[0]
    jstate = jreset_outputs(jstate)[0]
    gen = torch.Generator().manual_seed(5)
    rng = np.random.RandomState(5)
    table = torch.as_tensor(tactions.action_table(params.cfg, params.total_actions))
    untoggled = dataclasses.replace(params, reward_toggles=physics.RewardToggles())
    filtered = evasive = resets = toggled = 0
    for t in range(EP_LEN):
        act = rng.randint(0, params.num_actions, (B, params.num_agents))
        trace = {}
        corridor.safety_filter(params, tstate.agent_states, table[act], hj_t, trace=trace)
        filtered += int(trace["filtered"][0].sum())
        if "evasive" in trace:
            evasive += int((trace["evasive"][0] & trace["applied"]).sum())
        if params.reward_toggles != untoggled.reward_toggles:
            plain = corridor.step(untoggled, tstate, torch.as_tensor(act), gen, hj_t)[1]
        tstate2, ts = tenv.step(params, tstate, torch.as_tensor(act), gen, hj_t)
        if params.reward_toggles != untoggled.reward_toggles:
            toggled += int((ts.reward != plain.reward).sum())
        jstate2, jts = jstep(jstate, jnp.asarray(act, jnp.int32))
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
            fresh = env_state_from_numpy(jf, CPU, torch.float64)
            fresh, obs, node_obs, adj, _ = corridor.reset_outputs(params, fresh)
            for k, got in (("obs", obs), ("node_obs", node_obs), ("adj", adj)):
                close(got.numpy()[reset], np.asarray(getattr(jts, k))[reset],
                      f"step {t} fresh {k}")
            tstate2 = tenv._select_state(torch.as_tensor(reset), fresh, tstate2)
        tstate, jstate = tstate2, jstate2
    assert resets >= B, "every env reaches its time limit"
    assert filtered > 0, "the filter engaged"
    if params.safety_filter_type == "hj":
        assert evasive > 0, "the evasive branch was taken"
    if params.reward_toggles != untoggled.reward_toggles:
        assert toggled > 0, "the safety reward terms were paid"
