"""The torch port's GNN trunk against the JAX package's, on the CPU.

The plain trunk (``gnn_trunk_forward_plain``) is held against
``xla_transposed_forward`` and against the Pallas kernel ``make_gnn_forward``
run in interpret mode, at rtol 1e-5 / atol 1e-6 (the bar of
``tests/test_models.py:609``), at every entity count and on the edgeless
and one-in-edge graphs the card's kernel phase holds the kernel to.  The
CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against the plain version there); here the wrapper must take the plain path
for CPU tensors without counting a launch, and each kernel's library name
must follow every header its source reaches.
"""
import dataclasses
import functools
import shutil

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


def one_in_edge_adj(rng, B, E):
    """Distances where graphs 0 and 1 have no edge at all, graphs 2 and 3
    have every distance beyond MAX_EDGE, and every target of the other
    graphs has exactly one in-edge, from a random source."""
    adj = np.full((B, E, E), 2 * MAX_EDGE, np.float32)
    adj[:2] = 0.0
    for b in range(4, B):
        for t in range(E):
            s = (t + 1 + rng.randint(E - 1)) % E
            adj[b, s, t] = rng.uniform(0.05, 0.95) * MAX_EDGE
    adj[:, np.arange(E), np.arange(E)] = 0.0
    return adj


def make_case(E, relu, B=64, seed=0, one_in_edge=False):
    """Flax GNNBase params and transposed inputs; graph 0 has no edges (with
    ``one_in_edge``, the distances of :func:`one_in_edge_adj`)."""
    cfg = jax_cfg(relu)
    rng = np.random.RandomState(seed)
    F = 8
    node_obs = np.concatenate(
        [rng.randn(B, E, F - 1), rng.randint(0, 3, (B, E, 1))], axis=-1
    ).astype(np.float32)
    adj = (rng.rand(B, E, E) * 6.0).astype(np.float32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    adj[0] = 0.0
    if one_in_edge:
        adj = one_in_edge_adj(rng, B, E)
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


@pytest.mark.parametrize("E,relu,one_in_edge", [
    pytest.param(6, True, False, id="6-True"),
    pytest.param(6, False, False, id="6-False"),
    pytest.param(20, True, False, id="20-True"),
    # the entity counts and graphs the card's kernel phase holds the kernel to
    pytest.param(10, True, False, id="10-True"),
    pytest.param(6, True, True, id="6-True-one_in_edge"),
])
def test_plain_trunk_matches_xla_transposed(E, relu, one_in_edge):
    B = 64 if E == 6 and not one_in_edge else 32
    cfg, params, _, _, _, src_T, adj_T = make_case(E, relu, B=B, one_in_edge=one_in_edge)
    d = dims(cfg, E, src_T)
    flat = port_flat(cfg, params)
    got = gnn_trunk.gnn_trunk_forward_plain(
        *d, flat, torch.tensor(src_T), torch.tensor(adj_T)).numpy()
    want = np.asarray(gnn_pallas.xla_transposed_forward(
        *d, gnn_pallas.flatten_gnn_params(params, cfg.embed_layer_n, cfg.gnn_layer_n),
        jnp.asarray(src_T), jnp.asarray(adj_T)))
    assert got.shape == want.shape == (E * cfg.gnn_hidden_size, src_T.shape[1])
    np.testing.assert_allclose(got, want, **(KERNEL_TOL if E <= 10 else WIDE_TOL))
    # the edgeless graph: EmbedConv gives zero, every conv layer only its skip
    assert np.isfinite(got).all()
    if one_in_edge:
        # graphs without an edge in range are alike: each conv layer adds
        # only its skip to a zero EmbedConv output
        np.testing.assert_array_equal(got[:, 1:4], np.repeat(got[:, :1], 3, axis=1))


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


# the headers each kernel's source reaches through quoted includes
KERNEL_HEADERS = {
    "gnn_trunk_fwd": ["gnn_trunk_panel.cuh"],
    "gnn_trunk_bwd": ["gnn_trunk_panel.cuh", "gnn_trunk_bwd.cuh"],
    "gnn_trunk_dual_fwd": ["gnn_trunk_fwd.cuh"],
    "gnn_trunk_dual_bwd": ["gnn_trunk_panel.cuh", "gnn_trunk_bwd.cuh"],
    "gnn_forward_v2": [],
}


@pytest.mark.parametrize("name", gnn_trunk.KERNELS)
def test_kernel_tag_follows_nested_headers(name, tmp_path):
    """A kernel's library name hashes its source and every header it
    reaches, nested ones too, so an edit to any of them builds anew on the
    card (no nvcc needed here).  In a copy of ``csrc`` whose backward
    sources reach the panel header only through ``gnn_trunk_bwd.cuh``, an
    edit to that nested header changes the tag of each kernel that reaches
    it and of no other."""
    assert sorted(gnn_trunk.KERNELS) == sorted(KERNEL_HEADERS)
    assert gnn_trunk.include_closure(name) == KERNEL_HEADERS[name]
    csrc = tmp_path / "csrc"
    shutil.copytree(gnn_trunk.CSRC, csrc)
    for cu in ("gnn_trunk_bwd.cu", "gnn_trunk_dual_bwd.cu"):
        text = (csrc / cu).read_text()
        assert '#include "gnn_trunk_panel.cuh"\n#include "gnn_trunk_bwd.cuh"' in text
        (csrc / cu).write_text(text.replace('#include "gnn_trunk_panel.cuh"\n', ""))
    reached = gnn_trunk.include_closure(name, csrc)
    assert sorted(reached) == sorted(KERNEL_HEADERS[name])
    before = gnn_trunk.source_tag(name, csrc=csrc)
    assert before == gnn_trunk.source_tag(name, csrc=csrc)
    panel = csrc / "gnn_trunk_panel.cuh"
    panel.write_text(panel.read_text() + "// edited\n")
    assert (gnn_trunk.source_tag(name, csrc=csrc) != before) == (
        "gnn_trunk_panel.cuh" in KERNEL_HEADERS[name])


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


# ---------------------------------------------------------------- backward
# The gradient bar of the JAX package (tests/test_models.py:611-613): per
# leaf, |port - jax| <= 1e-4 * max|jax| + 1e-5.  tanh, because relu's
# subgradients flip at zero under a different summation order.
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5


def assert_grad_close(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
    assert np.abs(got - want).max() <= bar, (what, np.abs(got - want).max(), bar)


def test_plain_backward_matches_pallas_bwd_kernel():
    """``gnn_trunk_backward_plain`` against the Pallas backward kernel
    ``make_gnn_bwd`` in interpret mode (B = 128, blk 64, two grid steps
    that accumulate the parameter gradients), which applies ``jax.vjp`` of
    ``xla_transposed_forward`` inside its body: E = 4, tanh, EmbedConv
    without extra layers and one conv layer, graph 0 edgeless (the
    interpreted vjp grows with E^2 and depth: at E = 6 and the default depth
    it takes minutes on the CPU; ``test_gnnbase_grads_match_jax`` holds
    E = 6 and 20 at the default depth).  Held at the JAX gradient bar per
    leaf."""
    E, B = 4, 128
    cfg = JModelConfig(max_edge_dist=MAX_EDGE, compute_dtype="float32", embed_use_relu=False,
                       gnn_use_relu=False, gnn_impl="transposed", embed_layer_n=0,
                       gnn_layer_n=0)
    params = JGNNBase(cfg, graph_aggr="node").init(
        jax.random.PRNGKey(5), jnp.zeros((E, 8)), jnp.zeros((E, E)),
        jnp.zeros((1,), jnp.int32))["params"]
    _, _, _, _, _, src_T, adj_T = make_case(E, False, B=B, seed=5)
    d = dims(cfg, E, src_T)
    g = np.random.RandomState(7).randn(E * cfg.gnn_hidden_size, B).astype(np.float32)
    jflat = gnn_pallas.flatten_gnn_params(params, cfg.embed_layer_n, cfg.gnn_layer_n)
    bwd = gnn_pallas.make_gnn_bwd(*d, tuple(p.shape for p in jflat), blk=64, interpret=True)
    jdp, jds, jda = bwd(jflat, jnp.asarray(src_T), jnp.asarray(adj_T), jnp.asarray(g))
    dp, ds, da = gnn_trunk.gnn_trunk_backward_plain(
        *d, port_flat(cfg, params), torch.tensor(src_T), torch.tensor(adj_T), torch.tensor(g))
    assert len(dp) == len(jdp)
    for i, (a, b) in enumerate(zip(dp, jdp)):
        assert_grad_close(a.numpy(), b, f"param {i}")
    assert_grad_close(ds.numpy(), jds, "dsrc")
    assert_grad_close(da.numpy(), jda, "dadj")
    assert np.isfinite(da.numpy()).all() and np.all(da.numpy()[:, 0] == 0.0)


def _has_node(fn, name):
    seen, todo = set(), [fn]
    while todo:
        f = todo.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        if name in type(f).__name__:
            return True
        todo += [n for n, _ in f.next_functions]
    return False


@pytest.mark.parametrize("E", [6, 20])
def test_gnnbase_grads_match_jax(E):
    """Weight gradients of the port's ``GNNBase`` (autograd through
    ``GNNTrunk``, whose CPU backward is ``gnn_trunk_backward_plain``)
    against ``jax.grad`` of the JAX package's ``GNNBase``, per flax leaf at
    the JAX gradient bar; tanh, at E = 6 and 20, graph 0 edgeless.  The
    JAX side is the dense per-graph GNN, which computes the same function
    as the transposed trunk (tests/test_models.py:502-538); its gradient
    traces in seconds where the unrolled transposed vjp takes minutes at
    E = 20.  The loss weights each node embedding by a fixed cotangent."""
    cfg, params, node_obs, adj, _, _, _ = make_case(E, False, B=8 if E == 20 else 24, seed=4)
    B = node_obs.shape[0]
    dcfg = dataclasses.replace(cfg, gnn_impl="dense")
    jgnn = JGNNBase(dcfg, graph_aggr="none")
    w = np.random.RandomState(9).randn(B, E, cfg.gnn_hidden_size).astype(np.float32)

    def jloss(p):
        nodes = jax.vmap(lambda n, a: jgnn.apply({"params": p}, n, a, jnp.zeros((1,), jnp.int32)))(
            jnp.asarray(node_obs), jnp.asarray(adj))
        return (nodes * w).sum()

    jgrads = jax.jit(jax.grad(jloss))(params)
    gnn = GNNBase(ModelConfig(max_edge_dist=MAX_EDGE, embed_use_relu=False, gnn_use_relu=False),
                  node_feat_dim=8, graph_aggr="node")
    gnn.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    from contracts_marl_aam_corridors_tpu_torch.models import nets
    src_T = nets._gnn_src_T(gnn, torch.tensor(node_obs))
    adj_T = torch.tensor(adj).permute(1, 2, 0).reshape(E * E, B).contiguous()
    out = gnn_trunk.gnn_trunk_forward(*dims(cfg, E, src_T), gnn.grad_params(), src_T, adj_T)
    assert _has_node(out.grad_fn, "GNNTrunk")
    loss = (out.reshape(E, cfg.gnn_hidden_size, B).permute(2, 0, 1) * torch.tensor(w)).sum()
    names = [n for n, _ in gnn.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(gnn.parameters()))))
    want = state_dict_from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(got) == set(want)
    for n in names:
        assert_grad_close(got[n].numpy(), want[n].numpy(), n)


def test_unpack_blob_inverts_param_blob():
    """Exact: the flat tuple of a seeded port ``GNNBase`` -> buffer -> back."""
    from contracts_marl_aam_corridors_tpu_torch.models import nets
    cfg = ModelConfig(max_edge_dist=MAX_EDGE)
    gnn = GNNBase(cfg, node_feat_dim=8, graph_aggr="node")
    gnn.init_(torch.Generator().manual_seed(6))
    flat = nets._flatten_gnn_params(gnn, cfg.embed_layer_n, cfg.gnn_layer_n)
    kp = gnn_trunk.param_blob(flat, cfg.embed_layer_n, cfg.gnn_layer_n)
    back = gnn_trunk.unpack_blob(kp, flat[0].shape[1], cfg.gnn_num_heads,
                                 cfg.gnn_hidden_size, cfg.embed_layer_n, cfg.gnn_layer_n)
    assert len(back) == len(flat)
    for a, b in zip(back, flat):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_gnn_trunk_grads_reach_weights_through_blob():
    """``GNNBase`` under grad goes through ``GNNTrunk`` with the
    differentiable buffer; its weight gradients (the entity embedding's
    through dsrc) must equal autograd through the flax-layout flat tuple,
    which catches any layout error in the buffer's gradient (rtol 1e-6,
    atol 1e-7: the same float32 arithmetic, associated differently).  On
    the CPU neither wrapper counts a launch."""
    E = 6
    _, params, node_obs, adj, aid, _, _ = make_case(E, False, B=24, seed=4)
    tcfg = ModelConfig(max_edge_dist=MAX_EDGE, embed_use_relu=False, gnn_use_relu=False)
    gnn = GNNBase(tcfg, node_feat_dim=8, graph_aggr="node")
    gnn.load_state_dict(state_dict_from_flax(jax.tree.map(np.asarray, params)))
    node, adj_t, aid_t = torch.tensor(node_obs), torch.tensor(adj), torch.tensor(aid)
    weights = list(gnn.parameters())
    launches = gnn_trunk.gnn_trunk_forward.launches, gnn_trunk.gnn_trunk_backward.launches
    out = gnn(node, adj_t, aid_t)
    assert _has_node(out.grad_fn, "GNNTrunk")
    got = torch.autograd.grad((out ** 2).sum(), weights)
    assert (gnn_trunk.gnn_trunk_forward.launches,
            gnn_trunk.gnn_trunk_backward.launches) == launches

    from contracts_marl_aam_corridors_tpu_torch.models import nets
    src_T = nets._gnn_src_T(gnn, node)
    adj_T = adj_t.permute(1, 2, 0).reshape(E * E, -1).contiguous()
    flat = nets._flatten_gnn_params(gnn, tcfg.embed_layer_n, tcfg.gnn_layer_n)
    ref = gnn_trunk.gnn_trunk_forward_plain(
        E, src_T.shape[0] // E, tcfg.gnn_num_heads, tcfg.gnn_hidden_size, tcfg.embed_layer_n,
        tcfg.gnn_layer_n, MAX_EDGE, (False, False), flat, src_T, adj_T)
    ref = nets._gnn_aggregate(ref, "node", aid_t, E, tcfg.gnn_hidden_size)
    want = torch.autograd.grad((ref ** 2).sum(), weights)
    names = [n for n, _ in gnn.named_parameters()]
    for n, a, b in zip(names, got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=n)
    assert got[names.index("embed_layer.entity_embed.weight")].abs().sum() > 0
