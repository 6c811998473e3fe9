"""The torch port's v2 trunk forward (``ops/gnn_trunk_v2.py``) against the
JAX package's ``make_gnn_forward_v2``, on the CPU.

``flatten_gnn_params_v2`` and ``constants`` are pure layout and must equal
the JAX arrays exactly.  The plain version is held against the Pallas kernel
run in interpret mode (once per activation pair, B = 128, ``blk`` 128) and
against the port's plain v1 trunk, at rtol 1e-5 / atol 1e-6 (the kernel
bar of ``tests/test_models.py:609``).  The CUDA kernel runs only on the card
(``chip_smoke.py`` phase ``v2``); here the wrapper must take the plain path
for CPU tensors without counting a launch.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contracts_marl_aam_corridors_tpu.models.config import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models.nets import GNNBase as JGNNBase
from contracts_marl_aam_corridors_tpu.models.nets import _gnn_src_T
from contracts_marl_aam_corridors_tpu.ops import gnn_pallas

from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk, gnn_trunk_v2

torch.set_num_threads(1)

KERNEL_TOL = dict(rtol=1e-5, atol=1e-6)
MAX_EDGE = 3.0
B = 128
# (embed relu, gnn relu): the july default and the pair the checkpoints use
ACTS = {"relu": (True, True), "relu_tanh": (True, False)}


def jax_cfg(acts, embed_hidden=16):
    return JModelConfig(max_edge_dist=MAX_EDGE, compute_dtype="float32",
                        embed_use_relu=acts[0], gnn_use_relu=acts[1],
                        embed_hidden_size=embed_hidden, gnn_impl="transposed")


@functools.lru_cache(maxsize=None)
def jax_params(embed_hidden=16, seed=0):
    """Flax GNNBase params (their shapes do not depend on E or the
    activations)."""
    E = 6
    init = jax.jit(lambda key: JGNNBase(jax_cfg((True, True), embed_hidden),
                                        graph_aggr="node").init(
        key, jnp.zeros((E, 8)), jnp.zeros((E, E)), jnp.zeros((1,), jnp.int32))["params"])
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))


def make_inputs(E, n, seed=0):
    """Transposed src and adjacency of ``n`` random graphs; graph 0 has no
    edges, graph 1 only edges beyond range."""
    cfg = jax_cfg((True, True))
    rng = np.random.RandomState(seed)
    node_obs = np.concatenate(
        [rng.randn(n, E, 7), rng.randint(0, 3, (n, E, 1))], axis=-1).astype(np.float32)
    adj = (rng.rand(n, E, E) * 2 * MAX_EDGE).astype(np.float32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    adj[0] = 0.0
    adj[1] = 2 * MAX_EDGE
    src_T = np.asarray(_gnn_src_T(cfg, jax_params(), jnp.asarray(node_obs)), np.float32)
    adj_T = np.ascontiguousarray(adj.transpose(1, 2, 0).reshape(E * E, n))
    return src_T, adj_T


def dims(E, src_T, acts):
    c = jax_cfg(acts)
    return (E, src_T.shape[0] // E, c.gnn_num_heads, c.gnn_hidden_size, c.embed_layer_n,
            c.gnn_layer_n, MAX_EDGE, acts)


def port_v2(E, params=None):
    c = jax_cfg((True, True))
    return gnn_trunk_v2.flatten_gnn_params_v2(params or jax_params(), E, c.gnn_num_heads,
                                              c.gnn_hidden_size, c.embed_layer_n,
                                              c.gnn_layer_n)


@functools.lru_cache(maxsize=None)
def jax_v2_output(acts_name):
    """The interpreted Pallas v2 kernel on the E = 6 inputs (one jit each)."""
    E = 6
    src_T, adj_T = make_inputs(E, B)
    d = dims(E, src_T, ACTS[acts_name])
    c = jax_cfg(ACTS[acts_name])
    flat = gnn_pallas.flatten_gnn_params_v2(jax_params(), E, c.gnn_num_heads,
                                            c.gnn_hidden_size, c.embed_layer_n, c.gnn_layer_n)
    fwd = jax.jit(gnn_pallas.make_gnn_forward_v2(*d, blk=B, interpret=True))
    return np.asarray(fwd(flat, jnp.asarray(src_T), jnp.asarray(adj_T)))


@pytest.mark.parametrize("E", [6, 10])
def test_constants_match_jax(E):
    got = gnn_trunk_v2.constants(E, 16)
    want = gnn_pallas._constants(E, 16)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("E", [6, 10])
def test_flatten_v2_matches_jax(E):
    c = jax_cfg((True, True))
    got = port_v2(E)
    want = gnn_pallas.flatten_gnn_params_v2(jax_params(), E, c.gnn_num_heads,
                                            c.gnn_hidden_size, c.embed_layer_n, c.gnn_layer_n)
    assert len(got) == len(want) == gnn_trunk_v2.n_flat(c.embed_layer_n, c.gnn_layer_n)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("acts_name", sorted(ACTS))
def test_plain_v2_matches_pallas_v2(acts_name):
    E = 6
    src_T, adj_T = make_inputs(E, B)
    got = gnn_trunk_v2.gnn_forward_v2_plain(
        *dims(E, src_T, ACTS[acts_name]), port_v2(E), torch.tensor(src_T),
        torch.tensor(adj_T)).numpy()
    want = jax_v2_output(acts_name)
    assert got.shape == want.shape == (E * 16, B)
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    # the edgeless graphs give only each conv layer's skip path
    assert np.isfinite(got).all()


@pytest.mark.parametrize("E,n", [(6, 64), (10, 48), (6, 37)])
def test_plain_v2_matches_plain_v1(E, n):
    """Two independent transcriptions of one function, v2 with its
    selection-matrix products and v1 as batched tensor ops, at E = 6,
    E = 10 and a ragged batch."""
    src_T, adj_T = make_inputs(E, n, seed=E + n)
    acts = ACTS["relu_tanh"]
    d = dims(E, src_T, acts)
    c = jax_cfg(acts)
    v1 = gnn_trunk.flatten_gnn_params(jax_params(), c.embed_layer_n, c.gnn_layer_n)
    src, adj = torch.tensor(src_T), torch.tensor(adj_T)
    got = gnn_trunk_v2.gnn_forward_v2_plain(*d, port_v2(E), src, adj)
    want = gnn_trunk.gnn_trunk_forward_plain(*d, v1, src, adj)
    torch.testing.assert_close(got, want, **KERNEL_TOL)


def test_wrapper_takes_plain_on_cpu_and_counts_nothing():
    E = 6
    src_T, adj_T = make_inputs(E, 40, seed=3)
    d = dims(E, src_T, ACTS["relu"])
    flat = port_v2(E)
    src, adj = torch.tensor(src_T), torch.tensor(adj_T)
    gnn_trunk_v2.gnn_forward_v2.launches = 0
    got = gnn_trunk_v2.make_gnn_forward_v2(*d)(flat, src, adj)
    assert torch.equal(got, gnn_trunk_v2.gnn_forward_v2_plain(*d, flat, src, adj))
    assert gnn_trunk_v2.gnn_forward_v2.launches == 0


def test_v2_refuses_embed_width_other_than_c():
    """v2 takes the EmbedConv hidden width to be C (the JAX function fails on
    shapes there); the flattening and the wrapper both say so."""
    E = 6
    params = jax_params(embed_hidden=32)
    with pytest.raises(ValueError, match="embed_hidden_size must equal gnn_hidden_size"):
        port_v2(E, params)
    # a tuple laid out for a 32-wide EmbedConv, as the v1 widths would give it
    flat = list(port_v2(E))
    flat[0] = torch.zeros((E * 32, flat[0].shape[1]))
    src_T, adj_T = make_inputs(E, 8)
    with pytest.raises(ValueError, match="embed_hidden_size must equal gnn_hidden_size"):
        gnn_trunk_v2.gnn_forward_v2(*dims(E, src_T, ACTS["relu"]), tuple(flat),
                                    torch.tensor(src_T), torch.tensor(adj_T))


@pytest.mark.parametrize("which", ["bbig", "lin_edge"])
def test_v2_refuses_misshaped_conv_array(which):
    """Every array of the tuple is held to the shape the kernel indexes it
    by, so a mis-shaped one raises instead of reading out of bounds."""
    E = 6
    c = jax_cfg((True, True))
    flat = list(port_v2(E))
    k = 5 + 4 * c.embed_layer_n + {"bbig": 1, "lin_edge": 2}[which]
    flat[k] = flat[k][:-1]
    src_T, adj_T = make_inputs(E, 8)
    with pytest.raises(ValueError, match=f"{which} of conv layer 0 is"):
        gnn_trunk_v2.gnn_forward_v2(*dims(E, src_T, ACTS["relu"]), tuple(flat),
                                    torch.tensor(src_T), torch.tensor(adj_T))


def test_v2_work_counts():
    """The dense count of the v2 products at E = 6 and the default depth
    (about 1.24M operations a graph), and the function's count shared with
    the v1 trunk."""
    c = jax_cfg((True, True))
    args = (6, 9, c.gnn_num_heads, c.gnn_hidden_size, c.embed_layer_n, c.gnn_layer_n)
    w = gnn_trunk_v2.v2_work(*args, B=1, n_edges=24, n_params=1000)
    assert w["dense_flops"] == 1_238_400
    v1 = gnn_trunk.trunk_work(6, 9, c.gnn_num_heads, 16, 16, c.embed_layer_n, c.gnn_layer_n,
                              1, 24, 1000)
    assert (w["flops"], w["bytes"]) == (v1["flops"], v1["bytes"])
