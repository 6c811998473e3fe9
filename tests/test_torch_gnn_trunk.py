"""The torch port's GNN trunk against the JAX package's, on the CPU.

The plain trunk (``gnn_trunk_forward_plain``) is held against
``xla_transposed_forward`` and against the Pallas kernel ``make_gnn_forward``
run in interpret mode, at rtol 1e-5 / atol 1e-6 (the bar of
``tests/test_models.py:609``).  The CUDA kernel itself runs only on the card
(``chip_smoke.py`` holds it against the plain version there); here the
wrapper must take the plain path for CPU tensors without counting a launch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.models.config import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models.nets import GNNBase as JGNNBase
from contracts_marl_aam_corridors_tpu.models.nets import _gnn_src_T, gnn_transposed_apply
from contracts_marl_aam_corridors_tpu.ops import gnn_pallas

from contracts_marl_aam_corridors_tpu_torch.models.config import ModelConfig
from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax
from contracts_marl_aam_corridors_tpu_torch.models.nets import GNNBase
from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk

torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
# E = 20 sums over 20 sources per target and layer, so summation order alone
# moves float32 results by a few 1e-6; held at the trunk bar of
# tests/test_models.py:529 instead
WIDE_TOL = dict(rtol=2e-4, atol=2e-5)
MAX_EDGE = 3.0


def jax_cfg(relu):
    return JModelConfig(max_edge_dist=MAX_EDGE, compute_dtype="float32",
                        embed_use_relu=relu, gnn_use_relu=relu, gnn_impl="transposed")


@functools.lru_cache(maxsize=None)
def jax_params(relu, seed):
    """Flax GNNBase params (their shapes do not depend on E)."""
    E = 6
    init = jax.jit(lambda key: JGNNBase(jax_cfg(relu), graph_aggr="node").init(
        key, jnp.zeros((E, 8)), jnp.zeros((E, E)), jnp.zeros((1,), jnp.int32))["params"])
    return init(jax.random.PRNGKey(seed))


def make_case(E, relu, B=64, seed=0):
    """Flax GNNBase params and transposed inputs; graph 0 has no edges."""
    cfg = jax_cfg(relu)
    rng = np.random.RandomState(seed)
    F = 8
    node_obs = np.concatenate(
        [rng.randn(B, E, F - 1), rng.randint(0, 3, (B, E, 1))], axis=-1
    ).astype(np.float32)
    adj = (rng.rand(B, E, E) * 6.0).astype(np.float32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    adj[0] = 0.0
    aid = rng.randint(0, 3, (B, 1)).astype(np.int32)
    params = jax_params(relu, seed)
    src_T = np.asarray(_gnn_src_T(cfg, params, jnp.asarray(node_obs)), np.float32)
    adj_T = np.ascontiguousarray(adj.transpose(1, 2, 0).reshape(E * E, B))
    return cfg, params, node_obs, adj, aid, src_T, adj_T


def dims(cfg, E, src_T):
    return (E, src_T.shape[0] // E, cfg.gnn_num_heads, cfg.gnn_hidden_size,
            cfg.embed_layer_n, cfg.gnn_layer_n, MAX_EDGE,
            (cfg.embed_use_relu, cfg.gnn_use_relu))


def port_flat(cfg, params):
    np_params = jax.tree.map(np.asarray, params)
    return gnn_trunk.flatten_gnn_params(np_params, cfg.embed_layer_n, cfg.gnn_layer_n)


def test_flatten_matches_jax():
    cfg, params, *_ = make_case(6, True)
    got = port_flat(cfg, params)
    want = gnn_pallas.flatten_gnn_params(params, cfg.embed_layer_n, cfg.gnn_layer_n)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("E,relu", [(6, True), (6, False), (20, True)])
def test_plain_trunk_matches_xla_transposed(E, relu):
    cfg, params, _, _, _, src_T, adj_T = make_case(E, relu, B=32 if E == 20 else 64)
    d = dims(cfg, E, src_T)
    flat = port_flat(cfg, params)
    got = gnn_trunk.gnn_trunk_forward_plain(
        *d, flat, torch.tensor(src_T), torch.tensor(adj_T)).numpy()
    want = np.asarray(gnn_pallas.xla_transposed_forward(
        *d, gnn_pallas.flatten_gnn_params(params, cfg.embed_layer_n, cfg.gnn_layer_n),
        jnp.asarray(src_T), jnp.asarray(adj_T)))
    assert got.shape == want.shape == (E * cfg.gnn_hidden_size, src_T.shape[1])
    np.testing.assert_allclose(got, want, **(KERNEL_TOL if E == 6 else WIDE_TOL))
    # the edgeless graph: EmbedConv gives zero, every conv layer only its skip
    assert np.isfinite(got).all()


def test_plain_trunk_matches_pallas_kernel():
    E, B = 6, 64
    cfg, params, _, _, _, src_T, adj_T = make_case(E, True, B=B, seed=1)
    d = dims(cfg, E, src_T)
    fwd = gnn_pallas.make_gnn_forward(*d, blk=64, interpret=True)
    want = np.asarray(fwd(
        gnn_pallas.flatten_gnn_params(params, cfg.embed_layer_n, cfg.gnn_layer_n),
        jnp.asarray(src_T), jnp.asarray(adj_T)))
    got = gnn_trunk.gnn_trunk_forward_plain(
        *d, port_flat(cfg, params), torch.tensor(src_T), torch.tensor(adj_T)).numpy()
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


def test_wrapper_takes_plain_path_on_cpu():
    cfg, params, _, _, _, src_T, adj_T = make_case(6, True, B=16)
    d = dims(cfg, 6, src_T)
    flat = port_flat(cfg, params)
    src, adj = torch.tensor(src_T), torch.tensor(adj_T)
    before = gnn_trunk.gnn_trunk_forward.launches
    got = gnn_trunk.gnn_trunk_forward(*d, flat, src, adj)
    assert gnn_trunk.gnn_trunk_forward.launches == before
    torch.testing.assert_close(got, gnn_trunk.gnn_trunk_forward_plain(*d, flat, src, adj),
                               rtol=0, atol=0)


@pytest.mark.parametrize("aggr", ["node", "global"])
def test_gnnbase_matches_jax_transposed_apply(aggr):
    E = 6
    cfg, params, node_obs, adj, aid, _, _ = make_case(E, True, seed=2)
    gnn = GNNBase(ModelConfig(max_edge_dist=MAX_EDGE), node_feat_dim=8, graph_aggr=aggr)
    gnn.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        got = gnn(torch.tensor(node_obs), torch.tensor(adj),
                  torch.tensor(aid) if aggr == "node" else None).numpy()
    want = np.asarray(gnn_transposed_apply(
        cfg, params, jnp.asarray(node_obs), jnp.asarray(adj),
        jnp.asarray(aid) if aggr == "node" else None,
        "node" if aggr == "node" else "mean"))
    assert got.shape == (node_obs.shape[0], cfg.gnn_hidden_size)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


def test_kernel_params_match_flat_layout_and_follow_updates():
    cfg, params, *_ = make_case(6, True, seed=3)
    gnn = GNNBase(ModelConfig(max_edge_dist=MAX_EDGE), node_feat_dim=8, graph_aggr="node")
    gnn.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    kp = gnn.kernel_params()
    want = gnn_trunk.param_blob(port_flat(cfg, params), cfg.embed_layer_n, cfg.gnn_layer_n)
    assert kp.F1 == want.F1 == cfg.embed_hidden_size
    assert not kp.blob.requires_grad
    torch.testing.assert_close(kp.blob, want.blob, rtol=0, atol=0)
    assert gnn.kernel_params() is kp  # kept while the weights stay as they are
    with torch.no_grad():
        gnn.gnn2_1.lin_value.weight.mul_(2.0)
    updated = gnn.kernel_params()
    assert updated is not kp
    torch.testing.assert_close(
        updated.blob,
        gnn_trunk.param_blob(gnn_trunk.flatten_gnn_params(
            gnn.flax_tree(), cfg.embed_layer_n, cfg.gnn_layer_n),
            cfg.embed_layer_n, cfg.gnn_layer_n).blob.detach(),
        rtol=0, atol=0)


def test_wrapper_refuses_kernel_params_on_cpu():
    cfg, params, _, _, _, src_T, adj_T = make_case(6, True, B=8)
    kp = gnn_trunk.param_blob(port_flat(cfg, params), cfg.embed_layer_n, cfg.gnn_layer_n)
    with pytest.raises(ValueError, match="flat params"):
        gnn_trunk.gnn_trunk_forward(*dims(cfg, 6, src_T), kp, torch.tensor(src_T),
                                    torch.tensor(adj_T))
