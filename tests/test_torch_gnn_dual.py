"""The torch port's dual trunk (``models.nets.gnn_transposed_apply_dual``
and ``ops.gnn_trunk.GNNTrunkDual``) against the JAX package's, on the CPU.

The JAX side is ``gnn_transposed_apply_dual`` with ``gnn_impl="pallas_fused"``,
which runs the Pallas kernels of ``make_gnn_fused_dual`` in interpret mode
here, as ``tests/test_models.py:615-650`` runs them.  Values are held at
rtol 1e-5 / atol 1e-6 and gradients at 1e-4 max|jax| + 1e-5 per leaf, tanh
(the bars of ``tests/test_models.py:609-613``).  Weights are drawn in the
flax layout and reach the port through ``models/convert.py``.

The values are held at the inputs of ``tests/test_models.py:585-597``
(E = 6, default depth, B = 64, graph 0 edgeless); the gradients, whose
interpreted backward is slower, are in ``tests/test_torch_gnn_dual_grads.py``.
The dual CUDA kernels run only on the card, where ``chip_smoke.py`` holds
them against the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from contracts_marl_aam_corridors_tpu.models.config import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models.nets import (
    gnn_transposed_apply_dual as jax_apply_dual,
)

from contracts_marl_aam_corridors_tpu_torch.models.config import ModelConfig
from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax
from contracts_marl_aam_corridors_tpu_torch.models.nets import (
    GNNBase,
    gnn_transposed_apply,
    gnn_transposed_apply_dual,
)
from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk

torch.set_num_threads(1)

VALUE_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5
MAX_EDGE = 3.0
F = 7  # node features, the last one the entity type


def configs(relu, embed_layer_n=1, gnn_layer_n=2):
    jcfg = JModelConfig(max_edge_dist=MAX_EDGE, compute_dtype="float32", embed_use_relu=relu,
                        gnn_use_relu=relu, gnn_impl="pallas_fused",
                        embed_layer_n=embed_layer_n, gnn_layer_n=gnn_layer_n)
    tcfg = ModelConfig(max_edge_dist=MAX_EDGE, embed_use_relu=relu, gnn_use_relu=relu,
                       embed_layer_n=embed_layer_n, gnn_layer_n=gnn_layer_n)
    return jcfg, tcfg


def inputs(E, B, seed=3):
    """As tests/test_models.py:585-597: graph 0 has no edges."""
    rng = np.random.RandomState(seed)
    node_obs = np.concatenate(
        [rng.randn(B, E, F - 1).astype(np.float32),
         rng.randint(0, 3, (B, E, 1)).astype(np.float32)], axis=-1)
    adj = (rng.rand(B, E, E) * 6.0).astype(np.float32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    adj[0] = 0.0
    aid = rng.randint(0, min(E, 3), (B, 1)).astype(np.int32)
    return node_obs, adj, aid


def flax_tree(tcfg, seed):
    """A GNNBase parameter tree in the flax layout (numpy leaves), drawn
    with the port's initializers."""
    gnn = GNNBase(tcfg, F, "node")
    gnn.init_(torch.Generator().manual_seed(seed))
    return jax.tree.map(lambda t: t.detach().numpy().copy(), gnn.flax_tree())


def port_gnn(tcfg, tree, aggr):
    gnn = GNNBase(tcfg, F, aggr)
    gnn.load_state_dict(state_dict_from_flax(tree))
    return gnn


def assert_grad_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
    assert np.abs(got - want).max() <= bar, (what, np.abs(got - want).max(), bar)


def test_dual_values_match_jax():
    """The inputs of tests/test_models.py:585-597 at the default depth,
    tanh, critic mean pool."""
    jcfg, tcfg = configs(relu=False)
    node_obs, adj, aid = inputs(6, 64)
    ta, tc = flax_tree(tcfg, 0), flax_tree(tcfg, 1)
    want_a, want_c = jax_apply_dual(jcfg, ta, tc, jnp.asarray(node_obs), jnp.asarray(adj),
                                    jnp.asarray(aid), "mean")
    with torch.no_grad():
        got_a, got_c = gnn_transposed_apply_dual(
            tcfg, port_gnn(tcfg, ta, "node"), port_gnn(tcfg, tc, "global"),
            torch.tensor(node_obs), torch.tensor(adj), torch.tensor(aid), "mean")
    assert got_a.shape == got_c.shape == (64, tcfg.gnn_hidden_size)
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **VALUE_TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **VALUE_TOL)


def test_dual_relu_values_ragged_batch_match_jax():
    """relu, a batch of 37 graphs (the JAX side pads it to its block of
    512), critic max pool, E = 3, no extra layers."""
    jcfg, tcfg = configs(relu=True, embed_layer_n=0, gnn_layer_n=0)
    node_obs, adj, aid = inputs(3, 37, seed=5)
    ta, tc = flax_tree(tcfg, 4), flax_tree(tcfg, 5)
    want_a, want_c = jax_apply_dual(jcfg, ta, tc, jnp.asarray(node_obs), jnp.asarray(adj),
                                    jnp.asarray(aid), "max")
    with torch.no_grad():
        got_a, got_c = gnn_transposed_apply_dual(
            tcfg, port_gnn(tcfg, ta, "node"), port_gnn(tcfg, tc, "global"),
            torch.tensor(node_obs), torch.tensor(adj), torch.tensor(aid), "max")
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), **VALUE_TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **VALUE_TOL)


def _dims(tcfg, E, Ds):
    return (E, Ds, tcfg.gnn_num_heads, tcfg.gnn_hidden_size, tcfg.embed_layer_n,
            tcfg.gnn_layer_n, MAX_EDGE, (tcfg.embed_use_relu, tcfg.gnn_use_relu))


def _flat(gnn, tcfg):
    return gnn_trunk.flatten_gnn_params(gnn.flax_tree(), tcfg.embed_layer_n, tcfg.gnn_layer_n)


def test_plain_dual_backward_matches_float64_two_trunks():
    """``gnn_trunk_dual_backward_plain`` (float32) against float64 autograd
    of two separate plain trunks on the same adjacency, whose distance
    gradients add: default depth, tanh, E = 6, 24 graphs with graph 0
    edgeless, at the JAX gradient bar per leaf."""
    E, B = 6, 24
    _, tcfg = configs(relu=False)
    ga = port_gnn(tcfg, flax_tree(tcfg, 6), "node")
    gc = port_gnn(tcfg, flax_tree(tcfg, 7), "global")
    node_obs, adj, _ = inputs(E, B, seed=6)
    from contracts_marl_aam_corridors_tpu_torch.models import nets
    with torch.no_grad():
        sa = nets._gnn_src_T(ga, torch.tensor(node_obs))
        sc = nets._gnn_src_T(gc, torch.tensor(node_obs))
    adj_T = nets._adj_T(torch.tensor(adj))
    d = _dims(tcfg, E, sa.shape[0] // E)
    fa, fc = _flat(ga, tcfg), _flat(gc, tcfg)
    rng = np.random.RandomState(8)
    g_a, g_c = (torch.tensor(rng.randn(E * tcfg.gnn_hidden_size, B).astype(np.float32))
                for _ in range(2))
    dpa, dpc, dsa, dsc, dadj = gnn_trunk.gnn_trunk_dual_backward_plain(
        *d, fa, fc, sa, sc, adj_T, g_a, g_c)
    want_a = gnn_trunk.gnn_trunk_backward_plain(*d, fa, sa, adj_T, g_a,
                                                compute_dtype=torch.float64)
    want_c = gnn_trunk.gnn_trunk_backward_plain(*d, fc, sc, adj_T, g_c,
                                                compute_dtype=torch.float64)
    for i, (a, b) in enumerate(zip(dpa, want_a[0])):
        assert_grad_close(a.numpy(), b.numpy(), f"actor param {i}")
    for i, (a, b) in enumerate(zip(dpc, want_c[0])):
        assert_grad_close(a.numpy(), b.numpy(), f"critic param {i}")
    assert_grad_close(dsa.numpy(), want_a[1].numpy(), "dsrc_a")
    assert_grad_close(dsc.numpy(), want_c[1].numpy(), "dsrc_c")
    assert_grad_close(dadj.numpy(), (want_a[2] + want_c[2]).numpy(), "dadj")
    assert np.all(dadj.numpy()[:, 0] == 0.0)


def test_dual_wrapper_takes_plain_path_on_cpu():
    """On CPU tensors the dual wrappers run the plain version and count no
    launch; with grad the call goes through ``GNNTrunkDual``, and values
    and weight gradients equal two ``gnn_transposed_apply`` calls (the same
    float32 arithmetic)."""
    _, tcfg = configs(relu=True)
    ga = port_gnn(tcfg, flax_tree(tcfg, 8), "node")
    gc = port_gnn(tcfg, flax_tree(tcfg, 9), "global")
    node_obs, adj, aid = inputs(6, 16, seed=9)
    node, adj_t, aid_t = torch.tensor(node_obs), torch.tensor(adj), torch.tensor(aid)
    counts = lambda: (gnn_trunk.gnn_trunk_dual_forward.launches,
                      gnn_trunk.gnn_trunk_dual_backward.launches)
    before = counts()
    na, nc = gnn_transposed_apply_dual(tcfg, ga, gc, node, adj_t, aid_t, "add")
    assert _reaches(na.grad_fn, "GNNTrunkDual") and _reaches(nc.grad_fn, "GNNTrunkDual")
    weights = list(ga.parameters()) + list(gc.parameters())
    got = torch.autograd.grad((na ** 2).sum() + (nc ** 3).sum(), weights)
    assert counts() == before
    ra = gnn_transposed_apply(tcfg, ga, node, adj_t, aid_t, "node")
    rc = gnn_transposed_apply(tcfg, gc, node, adj_t, None, "add")
    torch.testing.assert_close(na, ra, rtol=0, atol=0)
    torch.testing.assert_close(nc, rc, rtol=0, atol=0)
    want = torch.autograd.grad((ra ** 2).sum() + (rc ** 3).sum(), weights)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def _reaches(fn, name):
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
