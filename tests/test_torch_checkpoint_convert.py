"""The shipped checkpoints in the torch port's layout
(``model_weights_torch/``, made by ``scripts/orbax_to_torch.py`` from
``model_weights/``: july's ckpt_1561 and the four gated ones), on the CPU.

The committed files must equal a fresh conversion (every tensor, dtype
included); the restored policy must give the JAX policy's values, log-probs
of given actions and entropy at the nets bar (rtol 2e-4 / atol 2e-5,
``tests/test_models.py:529``) on unicycle july observations from the JAX
env; and ``config.json`` must hold the flags of ``config.yaml``, the
activation flags first among them.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.config import flags as jflags
from contracts_marl_aam_corridors_tpu.envs import env as jenv
from contracts_marl_aam_corridors_tpu.utils.checkpoint import load_run_config as jax_run_config
from contracts_marl_aam_corridors_tpu.utils.checkpoint import warm_start_arch_flags

from contracts_marl_aam_corridors_tpu_torch.cli.train import build
from contracts_marl_aam_corridors_tpu_torch.config.flags import parse_all
from contracts_marl_aam_corridors_tpu_torch.learner import PopArtState
from contracts_marl_aam_corridors_tpu_torch.utils.checkpoint import (
    _resolve_ckpt_path,
    arch_act_flags,
    load_run_config,
    restore_checkpoint,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import orbax_to_torch  # noqa: E402

torch.set_num_threads(1)

NET_TOL = dict(rtol=2e-4, atol=2e-5)
COMMITTED = orbax_to_torch.DST


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("converted"))
    orbax_to_torch.convert(out)
    return out


def _state(d):
    return torch.load(os.path.join(_resolve_ckpt_path(d), "train_state.pt"),
                      map_location="cpu", weights_only=True)


def _assert_same(a, b, where="state"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b), where
    else:
        assert a == b, where


def test_committed_checkpoint_equals_a_fresh_conversion(fresh):
    _assert_same(_state(COMMITTED), _state(fresh))
    for name in ("latest.json", "config.json"):
        with open(os.path.join(COMMITTED, name)) as f, open(os.path.join(fresh, name)) as g:
            assert json.load(f) == json.load(g), name
    # the committed pointer is relative to its directory
    with open(os.path.join(COMMITTED, "latest.json")) as f:
        assert json.load(f) == {"episode": 1561, "path": "ckpt_1561"}
    assert _resolve_ckpt_path(COMMITTED) == os.path.join(COMMITTED, "ckpt_1561")


GATED = ("rot_inv", "three_phase", "two_phase_5a", "two_phase_5a_low_collision")


@pytest.mark.parametrize("name", GATED)
def test_committed_gated_checkpoint_equals_a_fresh_conversion(name, tmp_path):
    """Each converted gated checkpoint (``scripts/orbax_to_torch.py NAME``)
    equals a fresh conversion: every tensor of its state, its pointer and
    its flags; its JAX evaluations are there for the card (not rerun)."""
    committed = orbax_to_torch.dst_of(name)
    orbax_to_torch.convert(str(tmp_path), name)
    _assert_same(_state(committed), _state(str(tmp_path)))
    for fname in ("latest.json", "config.json"):
        with open(os.path.join(committed, fname)) as f, open(tmp_path / fname) as g:
            assert json.load(f) == json.load(g), fname
    ckpt = orbax_to_torch.CHECKPOINTS[name][1]
    with open(os.path.join(committed, "latest.json")) as f:
        assert json.load(f) == {"episode": int(ckpt[5:]), "path": ckpt}
    assert load_run_config(committed) == jax_run_config(
        os.path.join(ROOT, orbax_to_torch.CHECKPOINTS[name][0]))
    # tanh everywhere, as each config.yaml records
    assert arch_act_flags(committed) == {
        "use_ReLU": False, "embed_use_ReLU": False, "gnn_use_ReLU": False}
    for fname, extra in orbax_to_torch.CHECKPOINTS[name][3].items():
        with open(os.path.join(committed, fname)) as f:
            rec = json.load(f)
        assert rec["argv"] == orbax_to_torch.recipe(name) + list(extra)
        assert [r["seed"] for r in rec["rows"]] == [100, 101, 102, 103]


def test_config_json_holds_the_flags_of_config_yaml():
    got = load_run_config(COMMITTED)
    want = jax_run_config(orbax_to_torch.SRC)
    assert got == want
    # tanh MLPs, relu GNN: the july recipe's --use_ReLU must not win
    assert arch_act_flags(COMMITTED) == {
        "use_ReLU": False, "embed_use_ReLU": True, "gnn_use_ReLU": True}
    # a ckpt_<N> directory finds the run's flags in its parent
    assert load_run_config(os.path.join(COMMITTED, "ckpt_1561")) == got


def test_arch_act_flags_match_jax(tmp_path):
    """The activation flags the batched comparison takes from the run equal
    the JAX package's ``warm_start_arch_flags`` on the original checkpoint,
    from the run directory and from its ``ckpt_<N>``; none without a
    config."""
    want = warm_start_arch_flags(orbax_to_torch.SRC)
    assert want and arch_act_flags(COMMITTED) == want
    assert arch_act_flags(os.path.join(COMMITTED, "ckpt_1561")) == want
    assert arch_act_flags(str(tmp_path)) == {}


def _port_policy():
    """The committed checkpoint restored into the port on the CPU, built
    from the recipe with the run's activation flags."""
    args = parse_all(orbax_to_torch.recipe())
    for k, v in arch_act_flags(COMMITTED).items():
        setattr(args, k, v)
    _, policy, trainer, _ = build(args, "cpu")
    ts, episode = restore_checkpoint(COMMITTED, trainer.init_state(0))
    assert episode == 1561 and isinstance(ts.vn, PopArtState)
    return policy, ts


def _jax_env_inputs(B=16, steps=12, seed=0):
    """Policy inputs from ``B`` unicycle july envs of the JAX package after
    ``steps`` steps of random actions: per-agent rows of (cent, obs, node,
    adj, agent_id)."""
    params = jflags.build_env_params(jflags.parse_all(orbax_to_torch.recipe()))
    state, ts = jax.jit(jax.vmap(lambda k: jenv.reset(params, k)))(
        jax.random.split(jax.random.PRNGKey(seed), B))
    step = jax.jit(jax.vmap(lambda s, a: jenv.step(params, s, a)))
    rng = np.random.RandomState(seed)
    N = params.num_agents
    for _ in range(steps):
        act = rng.randint(0, params.num_actions, (B, N))
        state, ts = step(state, jnp.asarray(act, jnp.int32))
    obs, node, adj, aid = (np.asarray(x) for x in (ts.obs, ts.node_obs, ts.adj, ts.agent_id))
    E = adj.shape[-1]
    cent = np.repeat(obs.reshape(B, 1, -1), N, axis=1)
    rows = lambda x: x.reshape((B * N,) + x.shape[2:])
    return dict(cent=rows(cent), obs=rows(obs), node=rows(node),
                adj=rows(np.repeat(adj[:, None], N, axis=1).reshape(B, N, E, E)),
                aid=rows(aid).astype(np.int32)), params.num_actions


def test_converted_policy_matches_jax_policy():
    """Values, log-probs of given actions and entropy through
    ``evaluate_actions`` (the PPO loss's inputs; the port's takes a time axis,
    here of length 1), with random RNN states and stop-only rows."""
    _, jpol, jts, _ = orbax_to_torch.jax_side()
    policy, ts = _port_policy()
    x, A = _jax_env_inputs()
    R = x["obs"].shape[0]
    rng = np.random.RandomState(1)
    h_a, h_c = (rng.randn(R, 1, 64).astype(np.float32) * 0.5 for _ in range(2))
    masks = (rng.rand(R, 1) > 0.2).astype(np.float32)
    avail = np.ones((R, A), np.float32)
    avail[::4] = 0.0
    avail[::4, A // 2] = 1.0  # done agents: stop only
    acts = rng.randint(0, A, (R, 1))
    acts[::4] = A // 2
    J = jnp.asarray
    want = jax.jit(jpol.evaluate_actions)(
        jts.params, J(x["cent"]), J(x["obs"]), J(x["node"]), J(x["adj"]), J(x["aid"]),
        J(x["aid"]), J(h_a), J(h_c), J(acts), J(masks), J(avail))
    T = lambda v: torch.tensor(v)[None]  # a time axis of length 1
    with torch.no_grad():
        got = policy.evaluate_actions(
            ts.params, T(x["cent"]), T(x["obs"]), T(x["node"]), T(x["adj"]), T(x["aid"]),
            torch.tensor(h_a), torch.tensor(h_c), T(acts), T(masks), T(avail))
    for name, g, w in zip(("values", "log_probs", "entropy"), got, want):
        np.testing.assert_allclose(g.reshape(np.shape(w)).numpy(), np.asarray(w), err_msg=name,
                                   **NET_TOL)
    # the trained policy is confident: its values and log-probs are not flat
    assert float(np.std(np.asarray(want[0]))) > 0.1


def test_wall_layout_policy_converts():
    """A JAX policy for 10 agents with walls (E = 22, 13 node features, so
    the embedding's ``W1`` has Ds = 14 rows; 5 double-integrator actions),
    through ``policy_params_from_flax`` into the port's policy of the same
    dims (a strict load), gives the JAX values, log-probs of given actions
    and entropy at the nets bar."""
    from contracts_marl_aam_corridors_tpu.config.physics import vehicle_config as jvehicle
    from contracts_marl_aam_corridors_tpu.models import GRMAPPOPolicy as JPolicy
    from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig
    from contracts_marl_aam_corridors_tpu.models import PolicyDims as JDims

    from contracts_marl_aam_corridors_tpu_torch.models import (
        GRMAPPOPolicy,
        ModelConfig,
        PolicyDims,
        policy_params_from_flax,
    )

    OBS, N, E, F, A, R = 19, 10, 22, 13, 5, 40
    rng_range = jvehicle("double_integrator").coordination_range
    jpol = JPolicy(JModelConfig(max_edge_dist=rng_range),
                   JDims(obs_dim=OBS, cent_obs_dim=OBS * N, num_entities=E, node_feat_dim=F,
                         num_actions=A))
    jparams = jax.jit(lambda k: jpol.init_params(k, jnp.float32))(jax.random.PRNGKey(3))
    assert np.shape(jparams.actor["gnn_base"]["embed_layer"]["lin1"]["kernel"]) == (14, 16)
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=rng_range), PolicyDims(OBS, OBS * N, E, F, A),
                        device="cpu")
    params = pol.init_params(0)
    sd_a, sd_c = policy_params_from_flax(
        jax.tree.map(np.asarray, jparams.actor), jax.tree.map(np.asarray, jparams.critic))
    params.actor.load_state_dict(sd_a)
    params.critic.load_state_dict(sd_c)
    assert params.actor.gnn_base.embed_layer.lin1.weight.shape == (16, 14)

    rng = np.random.RandomState(4)
    f32 = np.float32
    node = rng.randn(R, E, F).astype(f32)
    node[..., -1] = rng.randint(0, 4, (R, E))  # agents, landmarks, obstacles, walls
    a = rng.rand(R, E, E) * 2 * rng_range
    adj = ((a + a.transpose(0, 2, 1)) / 2).astype(f32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    x = dict(cent=rng.randn(R, OBS * N).astype(f32), obs=rng.randn(R, OBS).astype(f32),
             aid=(np.arange(R) % N).reshape(R, 1).astype(np.int32))
    h_a, h_c = (rng.randn(R, 1, 64).astype(f32) * 0.5 for _ in range(2))
    masks, avail = np.ones((R, 1), f32), np.ones((R, A), f32)
    acts = rng.randint(0, A, (R, 1))
    J = jnp.asarray
    want = jax.jit(jpol.evaluate_actions)(
        jparams, J(x["cent"]), J(x["obs"]), J(node), J(adj), J(x["aid"]), J(x["aid"]),
        J(h_a), J(h_c), J(acts), J(masks), J(avail))
    T = lambda v: torch.tensor(v)[None]  # a time axis of length 1
    with torch.no_grad():
        got = pol.evaluate_actions(
            params, T(x["cent"]), T(x["obs"]), T(node), T(adj), T(x["aid"]),
            torch.tensor(h_a), torch.tensor(h_c), T(acts), T(masks), T(avail))
    for name, g, w in zip(("values", "log_probs", "entropy"), got, want):
        np.testing.assert_allclose(g.reshape(np.shape(w)).numpy(), np.asarray(w), err_msg=name,
                                   **NET_TOL)
