"""The torch port's dense per-graph GNN (``models/nets.py`` ``EmbedConv``,
``TransformerConv`` and ``GNNBase`` on the dense route) against the JAX
package's flax modules, and the routing that sends a configuration to it,
on the CPU.

* Module level: the port's ``GNNBase`` with ``gnn_impl='dense'`` against the
  JAX ``GNNBase`` under ``nn.vmap`` (as ``actor_critic._make_gnn`` builds
  it), on the same parameters (the flax tree through ``models/convert.py``,
  loaded strict) and the same numpy graphs, among them a graph with no edge
  and one with an isolated node.  Averaged and concatenated heads, the
  'node' gather and the 'mean', 'max' and 'add' pools, relu and tanh, at
  E = 6 and once at E = 13.  The forward is held at rtol 1e-5 / atol 1e-6
  (the JAX package's same-formulation bar, tests/test_models.py:499, 610);
  an output that misses it must pass the float64 criterion the port's
  trunk checks use where float32 summation order alone moves elements
  near zero (ROADMAP.md, section C): the port's relative L2 error from
  a float64 evaluation of the same module at most twice the JAX module's.
  The two frameworks' float32 products round differently in about half
  their elements, and with concatenated relu heads, outputs up to 41 and
  four layers, one or two of 768 elements near zero land beyond 1e-6.
  The parameter gradients (tanh) are held at 1e-4 max + 1e-5 per leaf
  (tests/test_models.py:540-543, 611-613).  One jitted JAX function per
  configuration computes all four aggregations.
* The port's dense route against its own kernel trunk (the plain version
  here) at averaged heads: rtol 2e-4 / atol 2e-5, the bar of the JAX
  package's dense-vs-transposed test (tests/test_models.py:529-543).
* bfloat16 with concatenated heads against the JAX modules: the port no
  farther from its float32 result than 2x the JAX bfloat16 distance +
  2e-3 (the bar of tests/test_torch_bf16.py), every aggregation.
* Policy level, for ``--gnn_concat_heads``, ``--actor_graph_aggr global``
  and ``--gnn_impl dense``: the time-major ``evaluate_actions`` at rtol
  2e-4 / atol 2e-5 and the PPO loss's gradients of a ``num_mini_batch=1``
  update at the JAX gradient bar, against the JAX policy's, with one conv
  layer (the module tests hold the full depth).
* Routing: ``ops.gnn_trunk.gnn_trunk_forward`` is called on the default
  configuration by every policy call, and never on the three dense-routed
  ones.
"""
import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from contracts_marl_aam_corridors_tpu.config.physics import vehicle_config as jvehicle
from contracts_marl_aam_corridors_tpu.learner import mappo as jmappo
from contracts_marl_aam_corridors_tpu.learner import valuenorm as jvn
from contracts_marl_aam_corridors_tpu.models import GRMAPPOPolicy as JPolicy
from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig
from contracts_marl_aam_corridors_tpu.models import PolicyDims as JDims
from contracts_marl_aam_corridors_tpu.models import nets as jnets

from contracts_marl_aam_corridors_tpu_torch.learner import GRMAPPOTrainer, valuenorm
from contracts_marl_aam_corridors_tpu_torch.models import (
    GRMAPPOPolicy,
    ModelConfig,
    PolicyDims,
    nets,
    policy_params_from_flax,
)
from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax
from contracts_marl_aam_corridors_tpu_torch.ops import gnn_trunk

torch.set_num_threads(1)

MED = jvehicle("air_taxi").coordination_range
AGGRS = ("node", "mean", "max", "add")
TANH = dict(use_relu=False, embed_use_relu=False, gnn_use_relu=False)
RELU = dict(use_relu=True, embed_use_relu=True, gnn_use_relu=True)
SAME_TOL = dict(rtol=1e-5, atol=1e-6)  # tests/test_models.py:499, 610
NET_TOL = dict(rtol=2e-4, atol=2e-5)  # tests/test_models.py:529
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5  # tests/test_models.py:611-613
BF16_RATIO, BF16_ATOL = 2.0, 2e-3  # tests/test_torch_bf16.py


def assert_leaf_close(got, want, what=""):
    """|got - want| <= 1e-4 max|want| + 1e-5 over the leaf."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bar = GRAD_RTOL * np.abs(want).max() + GRAD_ATOL
    assert np.abs(got - want).max() <= bar, (what, np.abs(got - want).max(), bar)


def within_bf16_bar(got, jax_bf16, ref32, atol, what):
    """max|got - ref32| <= BF16_RATIO * max|jax_bf16 - ref32| + atol."""
    got, jb, ref = (np.asarray(x, np.float64) for x in (got, jax_bf16, ref32))
    d_port, d_jax = np.abs(got - ref).max(), np.abs(jb - ref).max()
    assert d_port <= BF16_RATIO * d_jax + atol, (what, d_port, d_jax, atol)
    return d_port


def assert_forward_matches(gnn, inputs, got, want, what):
    """``got`` (the port's float32 output of ``gnn`` on ``inputs``) against
    the JAX module's ``want`` at SAME_TOL, or where an element misses it,
    by the float64 criterion: the port's relative L2 error from ``gnn`` in
    float64 at most twice the JAX module's."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    miss = np.abs(got - want) > SAME_TOL["atol"] + SAME_TOL["rtol"] * np.abs(want)
    if not miss.any():
        return
    with torch.no_grad():
        g64 = copy.deepcopy(gnn).double()
        node, adj, aid = (torch.tensor(x) for x in inputs)
        exact = g64(node.double(), adj.double(), aid.to(torch.long)).numpy()
    rel = lambda x: np.linalg.norm(x - exact) / np.linalg.norm(exact)
    assert rel(got) <= 2 * rel(want), (what, int(miss.sum()), rel(got), rel(want))


def graphs(B, E, F, seed):
    """(B, E, F) nodes (the last column an entity type), a symmetric
    distance adjacency with about half its pairs inside the edge range,
    graph 0 without an edge, node 0 of graph 1 isolated; agent ids."""
    rng = np.random.RandomState(seed)
    node = rng.randn(B, E, F).astype(np.float32)
    node[..., -1] = rng.randint(0, 3, (B, E))
    a = rng.rand(B, E, E) * 2 * MED
    adj = ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    adj[0] = 0.0
    adj[1, 0, :] = adj[1, :, 0] = 0.0
    aid = rng.randint(0, min(E, 5), (B, 1)).astype(np.int32)
    return node, adj, aid


def jax_cfg(aggr, concat, acts, dtype="float32", **kw):
    return JModelConfig(max_edge_dist=MED, gnn_concat_heads=concat, compute_dtype=dtype,
                        gnn_impl="dense", global_aggr_type="mean" if aggr == "node" else aggr,
                        **acts, **kw)


def vmapped(cfg, aggr):
    """The JAX GNNBase batched as ``actor_critic._make_gnn`` batches it."""
    return fnn.vmap(jnets.GNNBase, in_axes=(0, 0, 0), out_axes=0,
                    variable_axes={"params": None}, split_rngs={"params": False})(
        cfg, graph_aggr="node" if aggr == "node" else "global")


F32, BF16 = "float32", "bfloat16"
# the JAX runs of one parameter draw: (relu, compute dtype) pairs; the
# parameters do not depend on either, so each case is one jit
CASES = {
    "averaged": (6, False, ((True, F32), (False, F32))),
    "concat": (6, True, ((True, F32), (False, F32), (True, BF16))),
    "concat_e13": (13, True, ((True, F32),)),
}


@functools.lru_cache(maxsize=None)
def jax_module_case(name, seed=0):
    """Graphs, the flax parameters, the JAX outputs of the four aggregations
    for each (relu, dtype) pair of the case, and at E = 6 each
    aggregation's parameter gradient of sum(out * cotangent) with tanh in
    float32, from one jitted function."""
    E, concat, pairs = CASES[name]
    node, adj, aid = graphs(16, E, 8, seed)
    mods = {(relu, dt, a): vmapped(jax_cfg(a, concat, RELU if relu else TANH, dt), a)
            for relu, dt in pairs for a in AGGRS}
    width = jax_cfg("node", concat, RELU).gnn_out_dim
    cots = {a: np.random.RandomState(seed + 1 + i).randn(16, width).astype(np.float32)
            for i, a in enumerate(AGGRS)}
    grads = E == 6

    def run(key):
        # the init inside the same jit: one compile a case
        p = mods[pairs[0] + ("node",)].init(key, node, adj, aid)["params"]
        outs = {k: m.apply({"params": p}, node, adj, aid) for k, m in mods.items()}
        if not grads:
            return p, outs, None
        g = {a: jax.grad(lambda q, a=a: jnp.sum(
            mods[(False, F32, a)].apply({"params": q}, node, adj, aid) * cots[a]))(p)
            for a in AGGRS}
        return p, outs, g

    params, outs, g = jax.jit(run)(jax.random.PRNGKey(seed))
    to_np = lambda t: jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), t)
    return (node, adj, aid), jax.tree.map(np.asarray, params), to_np(outs), cots, to_np(g)


def port_gnn(params, F, aggr, concat, relu, dtype="float32", gnn_impl="dense"):
    cfg = ModelConfig(max_edge_dist=MED, gnn_concat_heads=concat, compute_dtype=dtype,
                      gnn_impl=gnn_impl, global_aggr_type="mean" if aggr == "node" else aggr,
                      **(RELU if relu else TANH))
    gnn = nets.GNNBase(cfg, F, "node" if aggr == "node" else "global")
    gnn.load_state_dict(state_dict_from_flax(params))  # strict
    return gnn


def port_out(gnn, inputs):
    node, adj, aid = (torch.tensor(x) for x in inputs)
    return gnn(node, adj, aid.to(torch.long))


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("relu", [True, False], ids=["relu", "tanh"])
@pytest.mark.parametrize("concat", [False, True], ids=["averaged", "concat"])
def test_dense_gnn_base_matches_jax(concat, relu):
    """Forward of every aggregation at rtol 1e-5 / atol 1e-6, E = 6; with
    tanh each aggregation's parameter gradients at the JAX bar."""
    inputs, params, outs, cots, jgrads = jax_module_case("concat" if concat else "averaged")
    for aggr in AGGRS:
        gnn = port_gnn(params, 8, aggr, concat, relu)
        assert not gnn.cfg.kernel_trunk
        out = port_out(gnn, inputs)
        assert out.shape == (16, 48 if concat else 16) and out.dtype == torch.float32
        assert_forward_matches(gnn, inputs, out.detach().numpy(), outs[(relu, F32, aggr)], aggr)
        if relu:
            continue
        names = [n for n, _ in gnn.named_parameters()]
        got = torch.autograd.grad((out * torch.tensor(cots[aggr])).sum(),
                                  list(gnn.parameters()), allow_unused=True)
        want = state_dict_from_flax(jgrads[aggr])
        assert set(want) == set(names)
        for n, g in zip(names, got):
            g = torch.zeros_like(want[n]) if g is None else g
            assert_leaf_close(g.numpy(), want[n].numpy(), what=f"{aggr}.{n}")


def test_dense_gnn_base_matches_jax_at_e13():
    """BASELINE config 2's graph width (E = 13), concatenated heads, relu."""
    inputs, params, outs, _, _ = jax_module_case("concat_e13", seed=3)
    for aggr in AGGRS:
        gnn = port_gnn(params, 8, aggr, True, True)
        assert_forward_matches(gnn, inputs, port_out(gnn, inputs).detach().numpy(),
                               outs[(True, F32, aggr)], aggr)


def test_edgeless_graph_keeps_only_the_skip_terms():
    """A graph with no edge: EmbedConv gives zeros, each conv layer only its
    skip term (the masked softmax over lowest-finite logits is zeroed), in
    float32 and in bfloat16."""
    _, params, _, _, _ = jax_module_case("concat")
    node, adj, _ = graphs(2, 6, 8, 5)
    adj[:] = 0.0
    for dtype in (F32, BF16):
        gnn = port_gnn(params, 8, "node", True, True, dtype)
        cfg = gnn.cfg
        x_node, x_adj = torch.tensor(node), torch.tensor(adj)
        with torch.no_grad():
            nodes = nets.gnn_dense_nodes(cfg, gnn, x_node, x_adj)
            mask, attr = nets.adjacency_mask(x_adj, cfg.max_edge_dist)
            cdt = torch.bfloat16 if dtype == BF16 else torch.float32
            x = nets.embed_conv_dense(cfg, gnn.embed_layer, x_node.to(cdt), mask, attr.to(cdt))
            assert not x.any()
            for name in ["gnn1"] + [f"gnn2_{i}" for i in range(cfg.gnn_layer_n)]:
                x = torch.relu(nets._linear(getattr(gnn, name).lin_skip, x, cfg.bf16))
        assert torch.equal(nodes, x), dtype


def test_max_pool_splits_a_tied_gradient_as_jnp_max():
    """relu rows that tie at zero: the max pool's gradient goes evenly to
    the tied entries, as ``jnp.max``'s does (``torch.max(dim=)`` would give
    it all to one)."""
    x = np.maximum(np.random.RandomState(0).randn(4, 6, 5), 0.0).astype(np.float32)
    x[:, 2:] = 0.0
    x[0] = 0.0
    cot = np.random.RandomState(1).randn(4, 5).astype(np.float32)
    want = jax.grad(lambda v: jnp.sum(jnp.max(v, axis=1) * cot))(x)
    xt = torch.tensor(x, requires_grad=True)
    (nets.dense_aggregate(xt, "max", None) * torch.tensor(cot)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    assert (xt.grad[0] == torch.tensor(cot[0]) / 6).all()


@pytest.mark.parametrize("aggr", AGGRS)
def test_dense_route_matches_kernel_trunk(aggr):
    """At averaged heads the dense route and the kernel trunk (its plain
    version here) compute the same function: forward at rtol 2e-4 / atol
    2e-5, parameter gradients (tanh) at the JAX bar."""
    _, params, _, _, _ = jax_module_case("averaged")
    node, adj, aid = (torch.tensor(x) for x in graphs(64, 6, 8, 7))
    aid = aid.to(torch.long)
    outs, grads = {}, {}
    for impl in ("dense", "transposed"):
        gnn = port_gnn(params, 8, aggr, False, False, gnn_impl=impl)
        assert gnn.cfg.kernel_trunk == (impl == "transposed")
        out = gnn(node, adj, aid)
        outs[impl] = out.detach().numpy()
        grads[impl] = torch.autograd.grad((out ** 2).sum(), list(gnn.parameters()))
    np.testing.assert_allclose(outs["dense"], outs["transposed"], **NET_TOL)
    for g, w in zip(grads["dense"], grads["transposed"]):
        assert_leaf_close(g.numpy(), w.numpy())


def test_concat_heads_bf16_matches_jax():
    """bfloat16 with concatenated heads, every aggregation, relu: the port's
    distance from its float32 result within 2x the JAX bfloat16 one +
    2e-3."""
    inputs, params, outs, _, _ = jax_module_case("concat")
    moved = 0
    for aggr in AGGRS:
        got = port_out(port_gnn(params, 8, aggr, True, True, BF16), inputs)
        assert got.dtype == torch.bfloat16
        ref = port_out(port_gnn(params, 8, aggr, True, True), inputs).detach().numpy()
        moved += within_bf16_bar(got.float().detach().numpy(), outs[(True, BF16, aggr)], ref,
                                 BF16_ATOL, aggr) > 0
    assert moved == len(AGGRS)


def test_trunk_kernel_params_refuse_concatenated_heads():
    gnn = nets.GNNBase(ModelConfig(gnn_concat_heads=True), 8, "node")
    assert tuple(gnn.gnn1.lin_skip.weight.shape) == (48, 16)
    assert tuple(gnn.gnn2_0.lin_query.weight.shape) == (48, 48)
    for build in (gnn.grad_params, gnn.kernel_params):
        with pytest.raises(ValueError, match="average the heads"):
            build()


# ------------------------------------------------------------ policy
DIMS, L, R = (19, 57, 6, 8, 25), 4, 8
# the policy-level comparisons run one conv layer and no extra embed layer
# (the module tests above hold the full depth): a jitted JAX policy
# gradient at full depth costs some 25 s of CPU to compile
SHALLOW = dict(embed_layer_n=0, gnn_layer_n=0)
DENSE_ROUTES = {
    "concat_heads": dict(gnn_concat_heads=True),
    "actor_global": dict(actor_graph_aggr="global"),
    "gnn_impl_dense": dict(gnn_impl="dense"),
}


def policy_batch(seed):
    obs_dim, cent_dim, E, F, A = DIMS
    rng = np.random.RandomState(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    node, adj, _ = graphs(L * R, E, F, seed)
    avail = f32(rng.rand(L, R, A) > 0.2)
    avail[..., A // 2] = 1.0
    act = rng.randint(0, A, (L, R, 1))
    active = f32(rng.rand(L, R, 1) > 0.2)
    active[0] = 1.0
    return dict(
        share_obs=f32(rng.randn(L, R, cent_dim)), obs=f32(rng.randn(L, R, obs_dim)),
        node_obs=node.reshape(L, R, E, F), adj=adj.reshape(L, R, E, E),
        agent_id=rng.randint(0, 3, (L, R, 1)).astype(np.int32),
        h_actor=f32(rng.randn(R, 1, 64) * 0.5), h_critic=f32(rng.randn(R, 1, 64) * 0.5),
        actions=np.where(np.take_along_axis(avail, act, -1) > 0, act, A // 2).astype(np.float32),
        value_preds=f32(rng.randn(L, R, 1)), returns=f32(rng.randn(L, R, 1) * 2),
        masks=f32(rng.rand(L, R, 1) > 0.25), active_masks=active,
        old_logp=f32(-3.0 + 0.1 * rng.randn(L, R, 1)), adv=f32(rng.randn(L, R, 1)),
        avail=avail)


@functools.lru_cache(maxsize=None)
def jax_policy_case(route):
    """The JAX policy of the route (tanh, one conv layer): its parameters,
    its time-major ``evaluate_actions`` on the batch, and the PPO loss (the
    loss of tests/test_torch_train.py) with its gradients, from one jit."""
    jcfg = JModelConfig(max_edge_dist=MED, **TANH, **SHALLOW, **DENSE_ROUTES[route])
    jpol = JPolicy(jcfg, JDims(*DIMS))
    assert not jpol._transposed_routable()
    jtr = jmappo.GRMAPPOTrainer(jpol, data_chunk_length=L)
    inp = policy_batch(seed=4)

    def evaluate(params):
        return jpol.evaluate_actions(
            params, inp["share_obs"], inp["obs"], inp["node_obs"], inp["adj"],
            inp["agent_id"], inp["agent_id"], inp["h_actor"], inp["h_critic"],
            inp["actions"], inp["masks"], inp["avail"], inp["active_masks"], time_major=True)

    def loss(params):
        values, logp, ent = evaluate(params)
        ratio = jnp.exp(logp - inp["old_logp"])
        surr = jnp.minimum(ratio * inp["adv"], jnp.clip(
            ratio, 1.0 - jtr.clip_param, 1.0 + jtr.clip_param) * inp["adv"])
        am = inp["active_masks"]
        pl = -(surr.sum(-1, keepdims=True) * am).sum() / am.sum()
        vn = jvn.vn_update(jvn.vn_init(jnp.float32), inp["returns"].reshape(-1, 1))
        vl = jmappo.cal_value_loss(
            values, inp["value_preds"], inp["returns"], am, vn, clip_param=jtr.clip_param,
            use_huber_loss=True, huber_delta=jtr.huber_delta, use_clipped_value_loss=True,
            use_value_active_masks=True)
        return pl - ent * jtr.entropy_coef + vl * jtr.value_loss_coef, (values, logp, ent)

    def run(key):
        # the init inside the same jit: one compile a route
        params = jpol.init_params(key, jnp.float32)
        (total, outs), g = jax.value_and_grad(loss, has_aux=True)(params)
        return params, outs, total, g

    jparams, outs, total, g = jax.jit(run)(jax.random.PRNGKey(2))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return inp, to_np(jparams), to_np(outs), total, to_np(g)


def port_policy(route, jparams):
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=MED, **TANH, **SHALLOW,
                                    **DENSE_ROUTES[route]), PolicyDims(*DIMS), device="cpu")
    params = pol.init_params(0)
    sd_a, sd_c = policy_params_from_flax(jparams.actor, jparams.critic)
    params.actor.load_state_dict(sd_a)  # strict: every leaf's name and shape
    params.critic.load_state_dict(sd_c)
    return pol, params


def torch_batch(inp):
    b = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in inp.items()}
    b["agent_id"] = b["agent_id"].to(torch.long)
    return b


def port_evaluate(pol, params, b):
    return pol.evaluate_actions(
        params, b["share_obs"], b["obs"], b["node_obs"], b["adj"], b["agent_id"],
        b["h_actor"], b["h_critic"], b["actions"], b["masks"], b["avail"], b["active_masks"])


@pytest.mark.parametrize("route", sorted(DENSE_ROUTES))
def test_policy_dense_route_matches_jax(route):
    """Time-major ``evaluate_actions`` at rtol 2e-4 / atol 2e-5 and the PPO
    loss's gradients of every leaf of both networks (the first epoch of a
    num_mini_batch=1 update) at the JAX bar, E = 6, tanh, one conv layer."""
    inp, jparams, (jv, jlp, jent), jtotal, jgrads = jax_policy_case(route)
    pol, params = port_policy(route, jparams)
    assert not pol.cfg.kernel_trunk
    b = torch_batch(inp)
    values, logp, ent = port_evaluate(pol, params, b)
    np.testing.assert_allclose(values.detach().numpy(), jv, **NET_TOL)
    np.testing.assert_allclose(logp.detach().numpy(), jlp, **NET_TOL)
    np.testing.assert_allclose(ent.item(), float(jent), **NET_TOL)
    trainer = GRMAPPOTrainer(pol, data_chunk_length=L)
    vn = valuenorm.vn_update(valuenorm.vn_init(), b["returns"].reshape(-1, 1))
    total, _ = trainer.loss(params, vn, b)
    np.testing.assert_allclose(total.item(), float(jtotal), **NET_TOL)
    for side in ("actor", "critic"):
        module = getattr(params, side)
        names = [n for n, _ in module.named_parameters()]
        got = torch.autograd.grad(total, list(module.parameters()), retain_graph=True,
                                  allow_unused=True)
        want = state_dict_from_flax(getattr(jgrads, side))
        assert set(want) == set(names)
        for n, g in zip(names, got):
            g = torch.zeros_like(want[n]) if g is None else g
            assert_leaf_close(g.numpy(), want[n].numpy(), what=f"{route}.{side}.{n}")


# ------------------------------------------------------------ routing
@pytest.mark.parametrize("route", ["default"] + sorted(DENSE_ROUTES))
def test_routing_calls_the_kernel_trunk_only_on_the_default(route, monkeypatch):
    """Every policy call (``get_actions``, ``get_values``, ``act``,
    ``evaluate_actions`` and its backward) goes through
    ``gnn_trunk_forward`` on the default configuration, and never on a
    dense-routed one."""
    calls = []
    real = gnn_trunk.gnn_trunk_forward

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(gnn_trunk, "gnn_trunk_forward", counting)
    kw = {} if route == "default" else DENSE_ROUTES[route]
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=MED, **kw), PolicyDims(*DIMS), device="cpu")
    assert pol.cfg.kernel_trunk == (route == "default")
    params = pol.init_params(0)
    b = torch_batch(policy_batch(seed=9))
    one = {k: v[0] for k, v in b.items() if k not in ("h_actor", "h_critic")}
    counts = []
    for call in (
        lambda: pol.get_actions(params, torch.Generator().manual_seed(0), one["share_obs"],
                                one["obs"], one["node_obs"], one["adj"], one["agent_id"],
                                b["h_actor"], b["h_critic"], one["masks"], one["avail"]),
        lambda: pol.get_values(params, one["share_obs"], one["node_obs"], one["adj"],
                               b["h_critic"], one["masks"]),
        lambda: pol.act(params, None, one["obs"], one["node_obs"], one["adj"], one["agent_id"],
                        b["h_actor"], one["masks"], one["avail"], deterministic=True),
        lambda: port_evaluate(pol, params, b)[1].sum().backward(),
    ):
        calls.clear()
        call()
        counts.append(len(calls))
    assert counts == ([2, 1, 1, 2] if route == "default" else [0, 0, 0, 0]), counts
