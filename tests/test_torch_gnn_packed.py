"""The torch port's packed edge layout (``--gnn_edge_packed``:
``models/nets.py embed_conv_packed``) and fused actor and critic trunks
(``--fuse_gnn_trunks``: ``GRMAPPOPolicy._fused_trunks``,
``nets.gnn_dense_nodes_dual``) against the JAX package on the CPU.

* ``EmbedConv``: the port's packed layout against the JAX ``EmbedConv``
  with ``gnn_edge_packed=True`` (batched by ``nn.vmap``), one and two embed
  layers, relu and tanh, on parameters drawn away from their init (so the
  LayerNorm affine and the biases count).  Float32 at rtol 1e-5 / atol 1e-6
  (the JAX package's same-formulation bar) or, where float32 order moves an
  element near zero past it, the float64 criterion of
  tests/test_torch_gnn_dense.py (the port's relative L2 error from its
  float64 evaluation at most twice the JAX one's).  Bfloat16 at the bar of
  tests/test_torch_bf16.py (the port no farther from its float32 result
  than 2x the JAX bfloat16 distance + 2e-3), and at least 95% of the
  outputs bit-equal to the JAX ones: the port rounds where XLA's CPU rounds
  (``scripts/packed_bf16_rounding_probe.py`` finds 100%).
* ``GNNBase`` in the packed layout, every aggregation: forward as above,
  relu and tanh, the tanh parameter gradients at the JAX bar (1e-4 max +
  1e-5 per leaf), bfloat16 at that bar.  The JAX packed tree equals the
  dense one (names and initial values) and loads strictly into the port.
* ``evaluate_actions`` with ``fuse_gnn_trunks=True`` on the dense route
  against the JAX policy's (``time_major=True``; one conv layer: a
  full-depth jitted JAX policy gradient costs some 25 s of CPU): values,
  log-probs and entropy at rtol 1e-5 / atol 1e-5 and both networks'
  gradients of ``values.sum() + logp.sum() + entropy`` at rtol 5e-4 / atol
  1e-5, the bars of the JAX package's tests/test_packed_gnn.py:136-147.
* The port's fused path against its own unfused one at those bars (in
  bfloat16 within one bfloat16 unit), at full depth; each dense op runs
  once for both networks (the profiler's op counts), with no
  ``torch.func.vmap`` fallback; both sides' gradients populated.  Its
  side-batched product (``nets._SideLinear``) against per-side products
  in float64, its weight gradient split into padded chunks of rows.
* The kernel route ignores both flags: the same ``gnn_trunk_forward`` calls
  and outputs as without them, and no dual call.
"""
import copy
import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from contracts_marl_aam_corridors_tpu.models import GRMAPPOPolicy as JPolicy
from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models import PolicyDims as JDims
from contracts_marl_aam_corridors_tpu.models import nets as jnets

from contracts_marl_aam_corridors_tpu_torch.models import (
    GRMAPPOPolicy,
    ModelConfig,
    PolicyDims,
    nets,
    policy_params_from_flax,
)
from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax
from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk
from test_torch_gnn_dense import (
    AGGRS,
    BF16,
    BF16_ATOL,
    DIMS,
    F32,
    MED,
    RELU,
    SAME_TOL,
    TANH,
    assert_forward_matches,
    assert_leaf_close,
    graphs,
    policy_batch,
    port_evaluate,
    torch_batch,
    within_bf16_bar,
)

torch.set_num_threads(1)

# tests/test_packed_gnn.py:136-147
FUSED_TOL = dict(rtol=1e-5, atol=1e-5)
FUSED_GRAD_TOL = dict(rtol=5e-4, atol=1e-5)
# bfloat16, fused against unfused: one bfloat16 unit (the weight gradients'
# float32 sums run in another order fused, so a value near a rounding tie
# may round the other way)
BF16_UNIT_TOL = dict(rtol=2.0 ** -8, atol=1e-5)
BIT_EQUAL_SHARE = 0.95
B_GRAPHS = 16


def perturbed(params, key):
    """Every leaf moved by 0.1 of a standard normal, so that the LayerNorm
    scales and biases and the Dense biases are not their init's 1 and 0."""
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(tree, [v + 0.1 * jax.random.normal(k, v.shape, v.dtype)
                                     for v, k in zip(leaves, keys)])


def bit_equal_share(got, want) -> float:
    return float((np.asarray(got, np.float32) == np.asarray(want, np.float32)).mean())


# ------------------------------------------------------------ EmbedConv
def embed_inputs(seed):
    node, adj, _ = graphs(B_GRAPHS, 6, 8, seed)
    mask = (adj > 0) & (adj < MED)
    return node, mask, (adj * mask).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_embed_case(layers):
    """The JAX packed EmbedConv's outputs for (relu, dtype) in {relu, tanh}
    x {float32, bfloat16}, from one jit (the init inside it)."""
    node, mask, attr = embed_inputs(seed=10 + layers)
    mods = {(relu, dt): fnn.vmap(jnets.EmbedConv, in_axes=(0, 0, 0), out_axes=0,
                                 variable_axes={"params": None}, split_rngs={"params": False})(
        JModelConfig(embed_layer_n=layers, embed_use_relu=relu, compute_dtype=dt,
                     gnn_edge_packed=True))
        for relu in (True, False) for dt in (F32, BF16)}

    def run(key):
        p = perturbed(mods[(True, F32)].init(key, node, mask, attr)["params"], key)
        outs = {}
        for (relu, dt), m in mods.items():
            cdt = jnp.bfloat16 if dt == BF16 else jnp.float32
            outs[(relu, dt)] = m.apply({"params": p}, node.astype(cdt), mask,
                                       attr.astype(cdt)).astype(jnp.float32)
        return p, outs

    params, outs = jax.jit(run)(jax.random.PRNGKey(layers))
    return (node, mask, attr), jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, outs)


def port_embed(params, layers, relu, dtype=F32):
    cfg = ModelConfig(embed_layer_n=layers, embed_use_relu=relu, compute_dtype=dtype,
                      gnn_edge_packed=True)
    ec = nets.EmbedConvParams(cfg, 8)
    ec.load_state_dict(state_dict_from_flax(params))  # strict
    return cfg, ec


def run_embed(cfg, ec, inputs, dtype):
    node, mask, attr = (torch.tensor(x) for x in inputs)
    with torch.no_grad():
        return nets.embed_conv_packed(cfg, ec, node.to(dtype), mask, attr.to(dtype))


@pytest.mark.parametrize("relu", [True, False], ids=["relu", "tanh"])
@pytest.mark.parametrize("layers", [1, 2])
def test_packed_embed_conv_matches_jax(layers, relu):
    """Float32 at rtol 1e-5 / atol 1e-6 or the float64 criterion; bfloat16
    at the bfloat16 bar and mostly bit-equal."""
    inputs, params, outs = jax_embed_case(layers)
    cfg, ec = port_embed(params, layers, relu)
    got = run_embed(cfg, ec, inputs, torch.float32).numpy()
    want = outs[(relu, F32)]
    assert got.shape == want.shape == (B_GRAPHS, 6, 16)
    miss = np.abs(got - want) > SAME_TOL["atol"] + SAME_TOL["rtol"] * np.abs(want)
    if miss.any():
        exact = run_embed(cfg, copy.deepcopy(ec).double(), inputs, torch.float64).numpy()
        rel = lambda x: np.linalg.norm(x - exact) / np.linalg.norm(exact)
        assert rel(got) <= 2 * rel(want), (int(miss.sum()), rel(got), rel(want))
    cfg16, ec16 = port_embed(params, layers, relu, BF16)
    got16 = run_embed(cfg16, ec16, inputs, torch.bfloat16)
    assert got16.dtype == torch.bfloat16
    got16 = got16.float().numpy()
    within_bf16_bar(got16, outs[(relu, BF16)], got, BF16_ATOL, "bfloat16")
    assert bit_equal_share(got16, outs[(relu, BF16)]) >= BIT_EQUAL_SHARE


# ------------------------------------------------------------ GNNBase
def vmapped_gnn(cfg, aggr):
    return fnn.vmap(jnets.GNNBase, in_axes=(0, 0, 0), out_axes=0,
                    variable_axes={"params": None}, split_rngs={"params": False})(
        cfg, graph_aggr="node" if aggr == "node" else "global")


def packed_cfg(aggr, acts, dtype=F32, packed=True):
    return dict(max_edge_dist=MED, compute_dtype=dtype, gnn_edge_packed=packed,
                global_aggr_type="mean" if aggr == "node" else aggr, **acts)


@functools.lru_cache(maxsize=None)
def jax_gnn_case(seed=0):
    """The JAX packed GNNBase's outputs for every aggregation, relu and
    tanh in float32 and relu in bfloat16, each aggregation's tanh parameter
    gradient of sum(out * cotangent), and the init of the packed and the
    dense module from one key, from one jit."""
    node, adj, aid = graphs(B_GRAPHS, 6, 8, seed)
    pairs = ((True, F32), (False, F32), (True, BF16))
    mods = {(relu, dt, a): vmapped_gnn(JModelConfig(**packed_cfg(a, RELU if relu else TANH,
                                                                 dt)), a)
            for relu, dt in pairs for a in AGGRS}
    dense = vmapped_gnn(JModelConfig(**packed_cfg("node", RELU, packed=False)), "node")
    cots = {a: np.random.RandomState(seed + 1 + i).randn(B_GRAPHS, 16).astype(np.float32)
            for i, a in enumerate(AGGRS)}

    def run(key):
        init = mods[(True, F32, "node")].init(key, node, adj, aid)["params"]
        init_dense = dense.init(key, node, adj, aid)["params"]
        p = perturbed(init, key)
        outs = {k: m.apply({"params": p}, node, adj, aid).astype(jnp.float32)
                for k, m in mods.items()}
        g = {a: jax.grad(lambda q, a=a: jnp.sum(
            mods[(False, F32, a)].apply({"params": q}, node, adj, aid) * cots[a]))(p)
            for a in AGGRS}
        return init, init_dense, p, outs, g

    res = jax.jit(run)(jax.random.PRNGKey(seed))
    return (node, adj, aid), cots, *jax.tree.map(np.asarray, res)


def port_packed_gnn(params, aggr, relu, dtype=F32):
    cfg = ModelConfig(gnn_impl="dense", **packed_cfg(aggr, RELU if relu else TANH, dtype))
    gnn = nets.GNNBase(cfg, 8, "node" if aggr == "node" else "global")
    gnn.load_state_dict(state_dict_from_flax(params))  # strict
    return gnn


def port_out(gnn, inputs):
    node, adj, aid = (torch.tensor(x) for x in inputs)
    return gnn(node, adj, aid.to(torch.long))


@pytest.mark.parametrize("aggr", AGGRS)
def test_packed_gnn_base_matches_jax(aggr):
    """Forward (relu and tanh) at rtol 1e-5 / atol 1e-6 or the float64
    criterion, the tanh parameter gradients at the JAX bar, bfloat16 (relu)
    at the bfloat16 bar."""
    inputs, cots, _, _, params, outs, jgrads = jax_gnn_case()
    for relu in (True, False):
        gnn = port_packed_gnn(params, aggr, relu)
        assert not gnn.cfg.kernel_trunk and gnn.cfg.gnn_edge_packed
        out = port_out(gnn, inputs)
        assert out.shape == (B_GRAPHS, 16) and out.dtype == torch.float32
        assert_forward_matches(gnn, inputs, out.detach().numpy(), outs[(relu, F32, aggr)],
                               f"{aggr} relu={relu}")
        if relu:
            with torch.no_grad():
                got16 = port_out(port_packed_gnn(params, aggr, True, BF16), inputs)
            assert got16.dtype == torch.bfloat16
            within_bf16_bar(got16.float().numpy(), outs[(True, BF16, aggr)],
                            out.detach().numpy(), BF16_ATOL, f"{aggr} bfloat16")
            continue
        names = [n for n, _ in gnn.named_parameters()]
        got = torch.autograd.grad((out * torch.tensor(cots[aggr])).sum(),
                                  list(gnn.parameters()), allow_unused=True)
        want = state_dict_from_flax(jgrads[aggr])
        assert set(want) == set(names)
        for n, g in zip(names, got):
            g = torch.zeros_like(want[n]) if g is None else g
            assert_leaf_close(g.numpy(), want[n].numpy(), what=f"{aggr}.{n}")


def test_packed_parameter_tree_is_the_dense_one():
    """The JAX packed GNNBase's initial tree equals the dense one's, names
    and values, and loads strictly into the port's packed GNNBase, whose
    state dict has the dense one's names and shapes."""
    _, _, init, init_dense, _, _, _ = jax_gnn_case()
    flat = jax.tree_util.tree_flatten_with_path
    (leaves, _), (leaves_d, _) = flat(init), flat(init_dense)
    assert [k for k, _ in leaves] == [k for k, _ in leaves_d] and len(leaves) > 20
    for (k, a), (_, b) in zip(leaves, leaves_d):
        np.testing.assert_array_equal(a, b, err_msg=jax.tree_util.keystr(k))
    packed = port_packed_gnn(init, "node", True)
    dense = nets.GNNBase(ModelConfig(gnn_impl="dense", max_edge_dist=MED), 8, "node")
    assert {k: v.shape for k, v in packed.state_dict().items()} == {
        k: v.shape for k, v in dense.state_dict().items()}
    dense.load_state_dict(packed.state_dict())  # strict


# ------------------------------------------------------------ fused trunks
# one conv layer (the module tests above hold the full depth)
FUSED_ROUTES = {
    "dense": dict(gnn_impl="dense", embed_layer_n=0, gnn_layer_n=0),
    "concat_packed": dict(gnn_concat_heads=True, gnn_edge_packed=True, embed_layer_n=1,
                          gnn_layer_n=0),
}


@functools.lru_cache(maxsize=None)
def jax_fused_case(route):
    """The JAX policy with ``fuse_gnn_trunks=True`` (tanh): its parameters,
    its time-major ``evaluate_actions`` and the gradients of
    ``values.sum() + logp.sum() + entropy``, from one jit."""
    jcfg = JModelConfig(max_edge_dist=MED, **TANH, **FUSED_ROUTES[route])
    jpol = JPolicy(jcfg, JDims(*DIMS), fuse_gnn_trunks=True)
    assert not jpol._transposed_routable() and jpol.fuse_gnn_trunks
    inp = policy_batch(seed=6)

    def loss(params):
        v, lp, ent = jpol.evaluate_actions(
            params, inp["share_obs"], inp["obs"], inp["node_obs"], inp["adj"],
            inp["agent_id"], inp["agent_id"], inp["h_actor"], inp["h_critic"],
            inp["actions"], inp["masks"], inp["avail"], inp["active_masks"], time_major=True)
        return v.sum() + lp.sum() + ent, (v, lp, ent)

    def run(key):
        params = jpol.init_params(key, jnp.float32)
        (_, outs), g = jax.value_and_grad(loss, has_aux=True)(params)
        return params, outs, g

    jparams, outs, g = jax.jit(run)(jax.random.PRNGKey(3))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return inp, to_np(jparams), to_np(outs), to_np(g)


def port_policy(cfg_kw, fuse, jparams=None, seed=0):
    pol = GRMAPPOPolicy(ModelConfig(**cfg_kw), PolicyDims(*DIMS), device="cpu",
                        fuse_gnn_trunks=fuse)
    params = pol.init_params(seed)
    if jparams is not None:
        sd_a, sd_c = policy_params_from_flax(jparams.actor, jparams.critic)
        params.actor.load_state_dict(sd_a)  # strict
        params.critic.load_state_dict(sd_c)
    return pol, params


def fused_outputs(pol, params, b):
    """(values, logp, entropy) and both networks' gradients of their sum,
    by leaf name."""
    with warnings.catch_warnings():
        # a vmap batching-rule fallback would loop over the two sides
        warnings.filterwarnings("error", message=".*performance drop.*")
        values, logp, ent = port_evaluate(pol, params, b)
        grads = {}
        for side in ("actor", "critic"):
            module = getattr(params, side)
            got = torch.autograd.grad(values.sum() + logp.sum() + ent,
                                      list(module.parameters()), retain_graph=True,
                                      allow_unused=True)
            grads[side] = dict(zip([n for n, _ in module.named_parameters()], got))
    return (values.detach(), logp.detach(), ent.detach()), grads


@pytest.mark.parametrize("route", sorted(FUSED_ROUTES))
def test_fused_evaluate_actions_matches_jax(route):
    """Values, log-probs and entropy at rtol 1e-5 / atol 1e-5, every leaf's
    gradient of both networks at rtol 5e-4 / atol 1e-5, against the JAX
    policy's fused trunks."""
    inp, jparams, (jv, jlp, jent), jgrads = jax_fused_case(route)
    pol, params = port_policy(dict(max_edge_dist=MED, **TANH, **FUSED_ROUTES[route]), True,
                              jparams)
    assert pol._fused_routable()
    (v, lp, ent), grads = fused_outputs(pol, params, torch_batch(inp))
    np.testing.assert_allclose(v.numpy(), jv, **FUSED_TOL)
    np.testing.assert_allclose(lp.numpy(), jlp, **FUSED_TOL)
    np.testing.assert_allclose(ent.item(), float(jent), **FUSED_TOL)
    for side in ("actor", "critic"):
        want = state_dict_from_flax(getattr(jgrads, side))
        assert set(want) == set(grads[side])
        for n, g in grads[side].items():
            assert g is not None, (side, n)
            np.testing.assert_allclose(g.numpy(), want[n].numpy(), **FUSED_GRAD_TOL,
                                       err_msg=f"{route}.{side}.{n}")


PORT_FUSED = {
    "dense": dict(gnn_impl="dense"),
    "concat": dict(gnn_concat_heads=True),
    "packed_bf16": dict(gnn_impl="dense", gnn_edge_packed=True, compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("route", sorted(PORT_FUSED))
def test_fused_matches_unfused(route):
    """At full depth (tanh), the port's fused ``evaluate_actions`` against
    its two separate dense calls at the JAX package's fused bars (in
    bfloat16 within one bfloat16 unit), and every parameter of both
    networks with a gradient, the GNN leaves nonzero."""
    kw = dict(max_edge_dist=MED, **TANH, **PORT_FUSED[route])
    b = torch_batch(policy_batch(seed=8))
    res = {}
    for fuse in (False, True):
        pol, params = port_policy(kw, fuse)
        assert pol._fused_routable() == fuse
        res[fuse] = fused_outputs(pol, params, b)
    (outs_u, grads_u), (outs_f, grads_f) = res[False], res[True]
    bf16 = ModelConfig(**kw).bf16
    out_tol, grad_tol = (BF16_UNIT_TOL, BF16_UNIT_TOL) if bf16 else (FUSED_TOL, FUSED_GRAD_TOL)
    for a, c in zip(outs_u, outs_f):
        np.testing.assert_allclose(c.float().numpy(), a.float().numpy(), **out_tol)
    for side in ("actor", "critic"):
        for n, g in grads_f[side].items():
            assert g is not None and grads_u[side][n] is not None, (side, n)
            if n.startswith("gnn_base.") and "lin_key.bias" not in n:
                assert g.abs().max() > 0, (side, n)
            np.testing.assert_allclose(g.numpy(), grads_u[side][n].numpy(), **grad_tol,
                                       err_msg=f"{route}.{side}.{n}")


def test_fused_runs_each_dense_op_once(monkeypatch):
    """The fused update's forward calls ``gnn_dense_nodes`` once (mapped
    over the side axis) and runs each dense op once for both networks: as
    many softmaxes as the conv layers and half the unfused count of every
    op it shares with it; its products batched over the side axis."""
    calls = []
    real = nets.gnn_dense_nodes
    monkeypatch.setattr(nets, "gnn_dense_nodes",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    kw = dict(max_edge_dist=MED, gnn_impl="dense")
    b = torch_batch(policy_batch(seed=9))
    counts = {}
    for fuse in (False, True):
        pol, params = port_policy(kw, fuse)
        calls.clear()
        with torch.no_grad(), torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            port_evaluate(pol, params, b)
        counts[fuse] = {e.key: e.count for e in prof.key_averages()}
        assert len(calls) == (1 if fuse else 2), (fuse, calls)
    conv_layers = 1 + ModelConfig().gnn_layer_n
    assert counts[True]["aten::_softmax"] == conv_layers
    assert counts[False]["aten::_softmax"] == 2 * conv_layers
    # the tails and heads run once a side either way; each GNN op once
    for op in ("aten::layer_norm", "aten::rsqrt", "aten::masked_fill"):
        if op in counts[False]:
            assert counts[True].get(op, 0) < counts[False][op], op


@pytest.mark.parametrize("bias", [True, False], ids=["bias", "no_bias"])
def test_side_linear_matches_per_side_products(bias):
    """``nets._SideLinear`` (the fused pass's products of a per-side input)
    against each side's own product under autograd, in float64 at 1e-12:
    the forward, the input's, the weight's (its rows split into padded
    chunks: 20,001 rows) and the bias's gradients."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 6667, 16, generator=gen, dtype=torch.float64, requires_grad=True)
    w = torch.randn(2, 12, 16, generator=gen, dtype=torch.float64, requires_grad=True)
    b = torch.randn(2, 12, generator=gen, dtype=torch.float64, requires_grad=True)
    g = torch.randn(2, 3, 6667, 12, generator=gen, dtype=torch.float64)
    assert 3 * 6667 > nets._SPLIT_ROWS and (3 * 6667) % nets._SPLIT_ROWS
    leaves = (x, w, b) if bias else (x, w)
    got = nets._SideLinear.apply(x, w, b if bias else None)
    want = torch.stack([torch.nn.functional.linear(x[s], w[s], b[s] if bias else None)
                        for s in range(2)])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for a, c in zip(torch.autograd.grad((got * g).sum(), leaves),
                    torch.autograd.grad((want * g).sum(), leaves)):
        torch.testing.assert_close(a, c, rtol=0, atol=1e-12)


# ------------------------------------------------------------ kernel route
@pytest.mark.parametrize("flag", ["gnn_edge_packed", "fuse_gnn_trunks"])
def test_kernel_route_ignores_the_flags(flag, monkeypatch):
    """On the kernel trunk either flag leaves every policy call's
    ``gnn_trunk_forward`` calls (2, 1, 1, 2 as without it) and outputs as
    they are, and the dual trunk is never called."""
    calls = []
    for name in ("gnn_trunk_forward", "gnn_trunk_dual_forward"):
        real = getattr(gnn_trunk, name)
        monkeypatch.setattr(gnn_trunk, name, lambda *a, _r=real, _n=name, **k:
                            calls.append(_n) or _r(*a, **k))
    b = torch_batch(policy_batch(seed=11))
    one = {k: v[0] for k, v in b.items() if k not in ("h_actor", "h_critic")}
    results = {}
    for on in (False, True):
        cfg = ModelConfig(max_edge_dist=MED, **({"gnn_edge_packed": on}
                                                if flag == "gnn_edge_packed" else {}))
        pol = GRMAPPOPolicy(cfg, PolicyDims(*DIMS), device="cpu",
                            fuse_gnn_trunks=on and flag == "fuse_gnn_trunks")
        assert cfg.kernel_trunk and not pol._fused_routable()
        params = pol.init_params(0)
        counts, outs = [], []
        for call in (
            lambda: pol.get_actions(params, torch.Generator().manual_seed(0),
                                    one["share_obs"], one["obs"], one["node_obs"], one["adj"],
                                    one["agent_id"], b["h_actor"], b["h_critic"],
                                    one["masks"], one["avail"], deterministic=True),
            lambda: pol.get_values(params, one["share_obs"], one["node_obs"], one["adj"],
                                   b["h_critic"], one["masks"]),
            lambda: pol.act(params, None, one["obs"], one["node_obs"], one["adj"],
                            one["agent_id"], b["h_actor"], one["masks"], one["avail"],
                            deterministic=True),
            lambda: port_evaluate(pol, params, b),
        ):
            calls.clear()
            out = call()
            counts.append(len(calls))
            assert "gnn_trunk_dual_forward" not in calls
            outs.append(out)
        (v, lp, ent) = outs[-1]
        (lp.sum() + v.sum() + ent).backward()
        results[on] = (counts, outs, [p.grad for p in params.actor.parameters()])
    assert results[True][0] == results[False][0] == [2, 1, 1, 2]
    flat = lambda o: [t for x in o for t in (x if isinstance(x, tuple) else (x,))
                      if isinstance(t, torch.Tensor)]
    for a, c in zip(flat(results[False][1]), flat(results[True][1])):
        assert torch.equal(a, c)
    for a, c in zip(results[False][2], results[True][2]):
        assert (a is None and c is None) or torch.equal(a, c)
