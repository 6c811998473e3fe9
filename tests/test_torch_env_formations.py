"""The torch port's circle and line landmark formations, its numpy parity
reset and the fixed freeze heading (``EnvParams.parity_fixed_reset_theta``)
against the JAX package's, on the CPU.

``reset_parity_numpy`` draws from numpy's global stream; from the same
``np.random.seed`` the port's copy and the JAX package's give the same
state (every field the port carries, float64 at 1e-9) and leave the stream
at the same place.  Whole episodes start from those resets, each env from
its own seed, and run with the same numpy actions through the port's
``env.step`` and one jitted JAX reference per case (``reset_outputs``,
then ``env.step`` under ``lax.scan``), held at 1e-9 at every step with no
re-sync: an agent placed beside its goal freezes, and with the fixed
heading both packages give it the same velocity.  The last step's fresh
episodes come from each framework's own generator, so there only what the
terminal step returns and what the auto-reset carries are held.  An env
with more agents than landmarks sends the extra agents to the last
landmark, as the JAX package's clamped gathers do.

These hold the port against the JAX package; the upstream reference's
reset (``tests/test_golden_parity.py``) needs its checkout and is not used.
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
from contracts_marl_aam_corridors_tpu_torch.envs import corridor, dynamics
from contracts_marl_aam_corridors_tpu_torch.envs import env as tenv
from contracts_marl_aam_corridors_tpu_torch.envs import reset as treset
from contracts_marl_aam_corridors_tpu_torch.envs.types import (
    EnvParams,
    TubeParams,
    map_state,
)
from test_torch_env import jax_state_fields
from test_torch_env_v4oct import B, both

torch.set_num_threads(1)

CPU = torch.device("cpu")
TOL = dict(atol=1e-9, rtol=0)
DI = "double_integrator"
THETA = 0.7  # the fixed freeze heading of the episodes
# the gated scenarios at the shipped gated checkpoints' recipes
SETTINGS = {"rot_inv": dict(world_size=4.0, collision_rew=30.0, goal_rew=20.0,
                            formation_rew=5.0)}


def settings(scenario, formation, n=3, l=3, **kw):
    return dict(scenario=scenario, formation_type=formation, num_agents=n, num_landmarks=l,
                **SETTINGS.get(scenario, {}), **kw)


def both_params(scenario, vehicle, formation, **kw):
    s = settings(scenario, formation, **kw)
    return (EnvParams(cfg=physics.vehicle_config(vehicle), **s),
            JEnvParams(cfg=jphysics.vehicle_config(vehicle), **s))


def port_fields(state) -> dict:
    """A port EnvState as numpy arrays under the JAX package's names."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if f.name == "tube":
            out["tube"] = {g.name: getattr(v, g.name).numpy() for g in dataclasses.fields(v)}
        elif v is not None:
            out[f.name] = v.numpy()
    return out


def assert_state_close(tstate, jf: dict, label, keys=None):
    """Every field the port carries (or ``keys``), against the JAX fields."""
    for f in dataclasses.fields(tstate):
        if keys is not None and f.name not in keys:
            continue
        got = getattr(tstate, f.name)
        if got is None:
            assert f.name not in jf or jf[f.name] is None, f"{label}: {f.name}"
        elif f.name == "tube":
            for g in dataclasses.fields(got):
                np.testing.assert_allclose(getattr(got, g.name).numpy(), jf["tube"][g.name],
                                           err_msg=f"{label} tube.{g.name}", **TOL)
        else:
            np.testing.assert_allclose(got.numpy(), jf[f.name], err_msg=f"{label} {f.name}",
                                       **TOL)


# ------------------------------------------------------------ parity reset
PARITY_CASES = {
    "july_air_taxi_point": ("rotate_tube_july", "air_taxi", "point", {}),
    "july_unicycle_circle": ("rotate_tube_july", "unicycle_vehicle", "circle", {}),
    "july_di_line": ("rotate_tube_july", DI, "line", {}),
    "july_obstacles_circle": ("rotate_tube_july", "air_taxi", "circle",
                              dict(n=5, l=5, num_obstacles=2)),
    "v4oct_air_taxi_line": ("v4oct", "air_taxi", "line", {}),
    "v4oct_unicycle_circle": ("v4oct", "unicycle_vehicle", "circle", {}),
    "two_phase_air_taxi_circle": ("two_phase", "air_taxi", "circle", {}),
    "rot_inv_di_line": ("rot_inv", DI, "line", {}),
}


@pytest.mark.parametrize("name", sorted(PARITY_CASES))
def test_reset_parity_numpy_matches_jax(name):
    """Four seeds a case: every field, and the next draw of the stream."""
    scenario, vehicle, formation, kw = PARITY_CASES[name]
    params, jparams = both_params(scenario, vehicle, formation, **kw)
    for seed in range(4):
        prev = np.arange(params.num_agents) % 3 if seed == 3 else None
        np.random.seed(seed)
        jstate = jreset.reset_parity_numpy(jparams, prev)
        j_next = np.random.uniform()
        np.random.seed(seed)
        tstate = treset.reset_parity_numpy(params, prev)
        t_next = np.random.uniform()
        assert t_next == j_next, f"{name} seed {seed}: the stream ends elsewhere"
        jf = jax.tree.map(lambda v: np.asarray(v)[None], jax_state_fields(jstate))
        assert_state_close(tstate, jf, f"{name} seed {seed}")
        assert tstate.agent_states.dtype == torch.float64
        assert (tstate.frozen_pos is not None) == (scenario == "v4oct")
    if formation != "point":  # every agent has a goal of its own
        assert len({tuple(p) for p in tstate.landmark_pos[0].tolist()}) == params.num_landmarks


def test_reset_parity_numpy_more_agents_than_landmarks_raises_as_jax():
    """The JAX mirror looks the goals up with numpy indexing, which raises
    where an agent's goal index passes the last landmark; the port's copy
    raises the same error at the same place in the stream."""
    params, jparams = both_params("rotate_tube_july", "air_taxi", "circle", n=4, l=3)
    np.random.seed(0)
    with pytest.raises(IndexError):
        jreset.reset_parity_numpy(jparams)
    j_next = np.random.uniform()
    np.random.seed(0)
    with pytest.raises(IndexError):
        treset.reset_parity_numpy(params)
    assert np.random.uniform() == j_next


# ------------------------------------------------------------ formations
@pytest.mark.parametrize("formation", ["point", "circle", "line"])
def test_place_landmarks_matches_jax(formation):
    """Each formation on 64 tubes against the JAX function in float32 (JAX
    without x64, as it trains) and in float64, at 1, 3 and 5 landmarks."""
    angle = np.random.RandomState(5).uniform(-np.pi / 2, np.pi / 2, 64)
    length = 3.2 + np.random.RandomState(6).uniform(-1.2, 0.4, 64)
    for l in (1, 3, 5):
        params, jparams = both_params("rotate_tube_july", "air_taxi", formation, l=l,
                                      world_size=4.0)
        for jdt, tdt, x64 in ((jnp.float32, torch.float32, False),
                              (jnp.float64, torch.float64, True)):
            with jax.enable_x64(x64):
                jt = jax.vmap(lambda a, n: jtube.make_tube(a, 4.0, corridor.AGENT_SIZE, jdt, n))(
                    jnp.asarray(angle, jdt), jnp.asarray(length, jdt))
                want = np.asarray(jax.vmap(partial(jreset._place_landmarks, jparams,
                                                   dtype=jdt))(jt))
            tt = TubeParams(**{g.name: torch.tensor(np.asarray(getattr(jt, g.name)))
                               for g in dataclasses.fields(TubeParams)})
            got = treset._place_landmarks(params, tt)
            assert got.dtype == tdt and got.shape == (64, l, 2)
            if tdt == torch.float64:
                np.testing.assert_allclose(got.numpy(), want, **TOL)
            else:  # float32: within one unit of the last place of |x| <= 2 ws
                np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_unknown_formation_is_refused_as_jax():
    with pytest.raises(ValueError, match="formation_type"):
        EnvParams(cfg=physics.vehicle_config("air_taxi"), formation_type="star")
    jparams = JEnvParams(cfg=jphysics.vehicle_config("air_taxi"), formation_type="star")
    with pytest.raises(ValueError, match="formation_type"):
        jreset.reset(jparams, jax.random.PRNGKey(0))


def test_fixed_freeze_heading_draws_nothing():
    """With the parity hook a heading model's freeze takes the fixed
    heading at v_min and leaves the generator where it was; without it the
    freeze draws one heading a row."""
    cfg = physics.vehicle_config("unicycle_vehicle")
    row = torch.tensor([[0.1, 0.2, 3.0, 0.9], [-0.4, 0.5, 1.0, 0.3]], dtype=torch.float64)
    gen = torch.Generator().manual_seed(0)
    before = gen.get_state()
    out = dynamics.stopped_row(row, cfg, gen, THETA)
    assert torch.equal(gen.get_state(), before)
    assert out[:, 2].tolist() == [THETA, THETA] and out[:, 3].tolist() == [cfg.v_min] * 2
    assert torch.equal(out[:, :2], row[:, :2])
    dynamics.stopped_row(row, cfg, gen)
    assert not torch.equal(gen.get_state(), before)


# ------------------------------------------------------------ episodes
EPISODES = {
    "july_unicycle_circle": ("rotate_tube_july", "unicycle_vehicle", "circle", {}),
    "v4oct_air_taxi_line": ("v4oct", "air_taxi", "line", {}),
    "rot_inv_air_taxi_line": ("rot_inv", "air_taxi", "line", {}),
    # more agents than landmarks: the extra agent's goal is the last landmark
    "july_air_taxi_circle_4a3l": ("rotate_tube_july", "air_taxi", "circle", dict(n=4, l=3)),
}


@functools.lru_cache(maxsize=None)
def jax_episode(name):
    """The case's params and one jitted JAX reference: ``reset_outputs`` of
    a batched state, then ``env.step`` over the actions under ``lax.scan``,
    with every step's TimeStep and state."""
    scenario, vehicle, formation, kw = EPISODES[name]
    ep_len = 6 if name.endswith("4a3l") else 25
    params, jparams = both_params(scenario, vehicle, formation, episode_length=ep_len,
                                  parity_fixed_reset_theta=THETA, **kw)

    def run(state, acts):
        out = jax.vmap(partial(jcorridor.reset_outputs, jparams))(state)

        def body(s, a):
            s2, ts = jax.vmap(partial(jenv.step, jparams))(s, a)
            return s2, (ts, s2)

        _, (tss, states) = jax.lax.scan(body, out[0], acts)
        return out, tss, states

    return params, jparams, jax.jit(run)


def place_beside_goals(tfields: dict, count: int = 2):
    """In the first ``count`` envs that have one, an agent whose goal lies
    past the tube (the JAX package's ``passed_tube``), the last such agent,
    starts just inside its goal's threshold in phase 2."""
    from contracts_marl_aam_corridors_tpu.envs.types import TubeParams as JTubeParams

    placed = 0
    for b in range(len(tfields["agent_states"])):
        lm = tfields["landmark_pos"][b]
        goals = lm[np.minimum(tfields["goal_match"][b], len(lm) - 1)]
        tb = JTubeParams(**{k: jnp.asarray(v[b]) for k, v in tfields["tube"].items()})
        past = np.asarray(jax.vmap(lambda g: jtube.passed_tube(tb, g))(jnp.asarray(goals)))
        if not past.any():
            continue
        i = int(np.flatnonzero(past)[-1])
        tfields["agent_states"][b, i, :2] = goals[i] + np.array([0.01, -0.005])
        tfields["prev_phase"][b, i] = tfields["phase_reached"][b, i] = 2
        placed += 1
        if placed == count:
            return
    raise AssertionError(f"only {placed} envs have a goal past the tube")


def start_states(name, params, jparams):
    """B envs, each from its own parity reset (np.random.seed(k)); the
    4-agent, 3-landmark case from the port's batched reset (the JAX mirror
    cannot reset it).  In two envs an agent starts beside its goal."""
    if name.endswith("4a3l"):
        st = treset.reset(params, B, torch.Generator().manual_seed(3), CPU, torch.float64)
        fields = port_fields(st)
        # the reset's goal_min_time by the JAX rule: clamped gathers
        lm, gm = jnp.asarray(fields["landmark_pos"]), jnp.asarray(fields["goal_match"])
        goal = jax.vmap(lambda p, g: p[g])(lm, gm)
        want = jnp.linalg.norm(jnp.asarray(fields["agent_states"][..., :2]) - goal, axis=-1)
        np.testing.assert_allclose(fields["goal_min_time"], np.asarray(want) / params.max_speed,
                                   **TOL)
    else:
        states = []
        for k in range(B):
            np.random.seed(k)
            states.append(treset.reset_parity_numpy(params))
        fields = port_fields(map_state(lambda *xs: torch.cat(xs), *states))
    fields = jax.tree.map(np.copy, fields)
    if params.scenario != "v4oct":  # v4oct's goal branch is unreachable
        place_beside_goals(fields)
    return both(fields, jparams)


@pytest.mark.parametrize("name", sorted(EPISODES))
def test_episode_matches_jax(name):
    """reset_outputs, then the episode to its time limit, every step held."""
    params, jparams, jrun = jax_episode(name)
    tstate, jstate = start_states(name, params, jparams)
    acts = np.random.RandomState(11).randint(
        0, params.num_actions, (params.episode_length, B, params.num_agents))
    (jstate0, *jouts), jtss, jstates = jrun(jstate, jnp.asarray(acts, jnp.int32))
    tstate, *touts = corridor.reset_outputs(params, tstate)
    for k, got, want in zip(("obs", "node_obs", "adj", "agent_id"), touts, jouts):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"reset {k}", **TOL)
    assert_state_close(tstate, jax_state_fields(jstate0), "reset")

    gen = torch.Generator().manual_seed(0)
    freezes = 0
    T = params.episode_length
    jstates = jax_state_fields(jstates)
    for t in range(T):
        status = tstate.status.clone()
        tstate, ts = tenv.step(params, tstate, torch.as_tensor(acts[t]), gen)
        jts = jax.tree.map(lambda x: np.asarray(x)[t], jtss)
        jf = jax.tree.map(lambda x: x[t], jstates)
        label = f"{name} step {t}"
        for k in ("reward", "done", "truncated"):
            np.testing.assert_allclose(getattr(ts, k).numpy(), getattr(jts, k),
                                       err_msg=f"{label} {k}", **TOL)
        assert set(ts.info) == set(jts.info)
        for k in ts.info:
            np.testing.assert_allclose(ts.info[k].numpy(), jts.info[k],
                                       err_msg=f"{label} info[{k}]", **TOL)
        if t == T - 1:  # fresh episodes from each framework's generator
            assert ts.done.all()
            assert_state_close(tstate, jf, label, keys=("prev_phase", "frozen_pos"))
            break
        for k in ("obs", "node_obs", "adj"):
            np.testing.assert_allclose(getattr(ts, k).numpy(), getattr(jts, k),
                                       err_msg=f"{label} {k}", **TOL)
        assert_state_close(tstate, jf, label)
        newly = tstate.status & ~status
        freezes += int(newly.sum())
        if params.cfg.dynamics != physics.DynamicsType.DOUBLE_INTEGRATOR and newly.any():
            assert (tstate.agent_states[..., 2][newly] == THETA).all()
    if params.scenario == "v4oct":
        assert freezes == 0
    else:
        assert freezes >= 2, f"{name}: {freezes} freezes"
