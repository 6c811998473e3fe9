"""The torch port's policy against the JAX package's, on the CPU.

Both get the same parameters (the flax trees converted with
``policy_params_from_flax``) and the same numpy inputs.  Actions must be
equal; values, log-probs and RNN states are held at rtol 2e-4 / atol 2e-5,
the bar the JAX package holds its own two trunk formulations to
(``tests/test_models.py:502-538``).  The port routes ``act`` and
``get_values`` through the transposed trunk where the JAX package runs its
dense per-graph GNN, so those comparisons also hold that routing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.config.physics import vehicle_config as jvehicle
from contracts_marl_aam_corridors_tpu.models import GRMAPPOPolicy as JPolicy
from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models import PolicyDims as JDims
from contracts_marl_aam_corridors_tpu.models import distributions as jdist

from contracts_marl_aam_corridors_tpu_torch.models import (
    GRMAPPOPolicy,
    ModelConfig,
    PolicyDims,
    policy_params_from_flax,
)
from contracts_marl_aam_corridors_tpu_torch.models import distributions as dist

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-5)
OBS, N, E, F, A = 19, 3, 6, 8, 25


@pytest.fixture(scope="module")
def setup():
    rng_range = jvehicle("air_taxi").coordination_range
    jcfg = JModelConfig(max_edge_dist=rng_range)
    jdims = JDims(obs_dim=OBS, cent_obs_dim=OBS * N, num_entities=E, node_feat_dim=F,
                  num_actions=A)
    jpol = JPolicy(jcfg, jdims)
    # jitted: tracing the flax init op by op costs several times its compile
    jparams = jax.jit(lambda k: jpol.init_params(k, jnp.float32))(jax.random.PRNGKey(0))
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=rng_range),
                        PolicyDims(OBS, OBS * N, E, F, A), device="cpu")
    params = pol.init_params(0)
    sd_a, sd_c = policy_params_from_flax(
        jax.tree.map(np.asarray, jparams.actor), jax.tree.map(np.asarray, jparams.critic))
    params.actor.load_state_dict(sd_a)
    params.critic.load_state_dict(sd_c)

    rng = np.random.RandomState(1)
    R = 48
    f32 = np.float32
    node = rng.randn(R, E, F).astype(f32)
    node[..., -1] = rng.randint(0, 2, (R, E))
    a = rng.rand(R, E, E) * 2 * rng_range
    adj = ((a + a.transpose(0, 2, 1)) / 2).astype(f32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    avail = np.ones((R, A), f32)
    avail[::4] = 0.0
    avail[::4, A // 2] = 1.0  # done agents: stop only
    inputs = dict(
        cent=rng.randn(R, OBS * N).astype(f32), obs=rng.randn(R, OBS).astype(f32),
        node=node, adj=adj, aid=(np.arange(R) % N).reshape(R, 1).astype(np.int32),
        h_a=rng.randn(R, 1, 64).astype(f32) * 0.5, h_c=rng.randn(R, 1, 64).astype(f32) * 0.5,
        masks=(rng.rand(R, 1) > 0.2).astype(f32), avail=avail,
    )
    return jpol, jparams, pol, params, inputs


def T(x):
    return torch.tensor(x)


def J(x):
    return jnp.asarray(x)


def test_converted_params_cover_every_module(setup):
    _, _, _, params, _ = setup
    for mod in (params.actor, params.critic):
        assert all(torch.isfinite(p).all() for p in mod.parameters())


def test_get_actions_deterministic_matches_jax(setup):
    jpol, jparams, pol, params, x = setup
    want = jpol.get_actions(
        jparams, jax.random.PRNGKey(7), J(x["cent"]), J(x["obs"]), J(x["node"]), J(x["adj"]),
        J(x["aid"]), J(x["aid"]), J(x["h_a"]), J(x["h_c"]), J(x["masks"]), J(x["avail"]),
        deterministic=True)
    got = pol.get_actions(
        params, None, T(x["cent"]), T(x["obs"]), T(x["node"]), T(x["adj"]), T(x["aid"]),
        T(x["h_a"]), T(x["h_c"]), T(x["masks"]), T(x["avail"]), deterministic=True)
    names = ["values", "actions", "logp", "h_a", "h_c"]
    for name, g, w in zip(names, got, want):
        assert tuple(g.shape) == tuple(np.shape(w)), name
        if name == "actions":
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    # masked rows took the stop action
    assert (got[1].numpy()[::4] == A // 2).all()


def test_log_probs_and_entropy_of_given_actions(setup):
    jpol, jparams, pol, params, x = setup
    jlogits, _ = jpol.actor.apply(
        {"params": jparams.actor}, J(x["obs"]), J(x["node"]), J(x["adj"]), J(x["aid"]),
        J(x["h_a"]), J(x["masks"]), J(x["avail"]))
    with torch.no_grad():
        logits, _ = params.actor(T(x["obs"]), T(x["node"]), T(x["adj"]), T(x["aid"]),
                                 T(x["h_a"]), T(x["masks"]), T(x["avail"]))
    acts = np.random.RandomState(3).randint(0, A, (x["obs"].shape[0], 1))
    acts[::4] = A // 2
    np.testing.assert_allclose(
        dist.log_probs(logits, T(acts)).numpy(),
        np.asarray(jdist.log_probs(jlogits, J(acts))), **TOL)
    np.testing.assert_allclose(
        dist.entropy(logits).numpy(), np.asarray(jdist.entropy(jlogits)), **TOL)


def test_get_values_matches_jax(setup):
    jpol, jparams, pol, params, x = setup
    want = jpol.get_values(jparams, J(x["cent"]), J(x["node"]), J(x["adj"]), J(x["aid"]),
                           J(x["h_c"]), J(x["masks"]))
    got = pol.get_values(params, T(x["cent"]), T(x["node"]), T(x["adj"]), T(x["h_c"]),
                         T(x["masks"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_act_matches_jax_dense_act(setup):
    jpol, jparams, pol, params, x = setup
    want_a, want_h = jpol.act(jparams, jax.random.PRNGKey(0), J(x["obs"]), J(x["node"]),
                              J(x["adj"]), J(x["aid"]), J(x["h_a"]), J(x["masks"]),
                              J(x["avail"]), deterministic=True)
    got_a, got_h = pol.act(params, None, T(x["obs"]), T(x["node"]), T(x["adj"]),
                           T(x["aid"]), T(x["h_a"]), T(x["masks"]), T(x["avail"]),
                           deterministic=True)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)


def test_sample_respects_mask_and_generator():
    gen = torch.Generator().manual_seed(0)
    logits = torch.zeros(256, 5)
    logits = dist.mask_logits(logits, torch.tensor([0.0, 1.0, 1.0, 0.0, 1.0]).expand(256, 5))
    a = dist.sample(gen, logits)
    assert a.shape == (256, 1)
    assert set(a.flatten().tolist()) == {1, 2, 4}
    again = dist.sample(torch.Generator().manual_seed(0), logits)
    assert torch.equal(a, again)
