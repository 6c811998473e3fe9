"""The torch port's bfloat16 compute (``ModelConfig.compute_dtype``) against
the JAX package's, on the CPU.

The semantics are the JAX package's under ``gnn_impl="pallas_fused"``: the
GNN trunk computes in float32 (its Pallas kernels run in interpret mode
here), and bfloat16 enters at the trunk output's cast and in the flax
``Dense``/``LayerNorm(dtype=bfloat16)`` tails, promoted back to float32 at
the GRU and the output layers.

* Module level, on the same parameters: ``_gnn_aggregate`` equals the JAX
  function bit for bit, and ``MLPBase`` is within one bfloat16 unit of the
  last place of flax's on every element, with the bit-equal share held at
  ``MLP_BIT_EQUAL``.  XLA keeps the float32 result of the upcast ``tanh``
  unrounded where it feeds the LayerNorm; the port does the same, and what
  is left apart is the float32 variance of the LayerNorm statistics (flax's
  E[x^2] - E[x]^2, torch's two passes, each in its own summation order).
* Policy level, ``evaluate_actions`` at E = 6 (32 graphs), and the PPO
  loss's gradients of a ``num_mini_batch=1`` update's first epoch at E = 3
  with no extra trunk layers (an interpreted Pallas backward at E = 6 and
  full depth takes tens of minutes): the port's bfloat16 result may be no
  farther from the float32 function (the port's float32 result, which
  ``tests/test_torch_train.py`` holds to the JAX package's at 2e-4 and
  1e-4) than ``BF16_RATIO`` times the JAX bfloat16 result's distance plus
  ``BF16_ATOL`` (values, log-probs and entropy) or ``BF16_GRAD_ATOL`` times
  the leaf's largest float32 entry plus ``GRAD_FLOOR``, the absolute term
  of the JAX package's gradient bar (gradients; the floor holds a leaf whose
  gradient is zero but for rounding, such as a key bias: the softmax over
  the sources takes its shift away).
"""
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
    policy_params_from_flax,
)
from contracts_marl_aam_corridors_tpu_torch.models import nets
from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax

torch.set_num_threads(1)

MED = jvehicle("air_taxi").coordination_range
TANH = dict(use_relu=False, embed_use_relu=False, gnn_use_relu=False)
# the bars, fixed on the CPU before the first card run (CHANGES.md)
MLP_BIT_EQUAL = 0.9996
BF16_RATIO = 2.0
BF16_ATOL = 2e-3
BF16_GRAD_ATOL = 2e-3
GRAD_FLOOR = 1e-5  # tests/test_models.py:611-613


def bf16_units(got, want) -> np.ndarray:
    """|got - want| in units of the last place of bfloat16 at the row's
    largest |want| (a LayerNorm output near zero carries the rounding of
    its row's scale, not of its own magnitude)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mag = np.maximum(np.abs(want).max(axis=-1, keepdims=True), np.finfo(np.float32).tiny)
    return np.abs(got - want) / 2.0 ** (np.floor(np.log2(mag)) - 7)


# ------------------------------------------------------------ modules
@pytest.mark.parametrize("aggr", ["node", "mean", "max", "add"])
def test_gnn_aggregate_bf16_equals_jax(aggr):
    E, C, B = 6, 16, 512
    rng = np.random.RandomState(1)
    out = (rng.randn(E * C, B) * 3).astype(np.float32)
    aid = rng.randint(0, E, (B, 1)).astype(np.int32)
    want = jax.jit(lambda o, a: jnets._gnn_aggregate(o, aggr, a, E, C, jnp.bfloat16))(out, aid)
    got = nets._gnn_aggregate(torch.tensor(out), aggr, torch.tensor(aid), E, C, torch.bfloat16)
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))


class _JaxMLP(fnn.Module):
    """The flax MLPBase on the actor's join (float32 obs beside the
    bfloat16 node feature) or the critic's (the bfloat16 pool alone)."""

    cfg: JModelConfig
    join: bool

    @fnn.compact
    def __call__(self, obs, nbd):
        x = jnp.concatenate([obs, nbd], axis=-1) if self.join else nbd
        return jnets.MLPBase(self.cfg, name="base")(x)


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("join", [True, False])
def test_mlp_base_bf16_matches_flax(relu, join):
    """Every element within one bfloat16 unit of flax's, the bit-equal share
    at least MLP_BIT_EQUAL (4,096 rows, the default widths)."""
    jcfg = JModelConfig(compute_dtype="bfloat16", use_relu=relu, gnn_impl="dense")
    rng = np.random.RandomState(2)
    obs = rng.randn(4096, 19).astype(np.float32)
    nbd = jnp.asarray(rng.randn(4096, 16) * 2, jnp.bfloat16)
    mod = _JaxMLP(jcfg, join)
    params = mod.init(jax.random.PRNGKey(3), obs, nbd)
    # off the initial point: LayerNorm scales and biases away from 1 and 0
    params = jax.tree.map(
        lambda v: v + 0.2 * jax.random.normal(jax.random.PRNGKey(4), v.shape), params)
    want = np.asarray(jax.jit(mod.apply)(params, obs, nbd).astype(jnp.float32))

    in_dim = (19 if join else 0) + 16
    base = nets.MLPBase(ModelConfig(compute_dtype="bfloat16", use_relu=relu), in_dim)
    sd = state_dict_from_flax(jax.tree.map(np.asarray, params["params"]["base"]))
    base.load_state_dict({k: v for k, v in sd.items()})
    nbd_t = torch.tensor(np.asarray(nbd, np.float32)).to(torch.bfloat16)
    x = torch.cat([torch.tensor(obs), nbd_t.float()], -1) if join else nbd_t
    with torch.no_grad():
        got = base(x)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    share = float((got == want).mean())
    units = bf16_units(got, want)
    print(f"MLPBase bf16 relu={relu} join={join}: bit-equal {share:.6f}, "
          f"max {np.abs(got - want).max():.3e} = {units.max():.3f} units")
    assert units.max() <= 1.0
    assert share >= MLP_BIT_EQUAL


# ------------------------------------------------------------ policy
def _batch(dims, L, R, seed):
    obs_dim, cent_dim, E, F, A = dims
    rng = np.random.RandomState(seed)
    f32 = lambda x: np.asarray(x, np.float32)
    node = f32(rng.randn(L, R, E, F))
    node[..., -1] = rng.randint(0, 3, (L, R, E))
    a = rng.rand(L, R, E, E) * 2 * MED
    adj = f32((a + a.transpose(0, 1, 3, 2)) / 2)
    adj[:, :, np.arange(E), np.arange(E)] = 0.0
    avail = f32(rng.rand(L, R, A) > 0.2)
    avail[..., A // 2] = 1.0
    act = rng.randint(0, A, (L, R, 1))
    active = f32(rng.rand(L, R, 1) > 0.2)
    active[0] = 1.0
    return dict(
        share_obs=f32(rng.randn(L, R, cent_dim)), obs=f32(rng.randn(L, R, obs_dim)),
        node_obs=node, adj=adj, agent_id=rng.randint(0, 3, (L, R, 1)).astype(np.int32),
        h_actor=f32(rng.randn(R, 1, 64) * 0.5), h_critic=f32(rng.randn(R, 1, 64) * 0.5),
        actions=np.where(np.take_along_axis(avail, act, -1) > 0, act, A // 2).astype(np.float32),
        value_preds=f32(rng.randn(L, R, 1)), returns=f32(rng.randn(L, R, 1) * 2),
        masks=f32(rng.rand(L, R, 1) > 0.25), active_masks=active,
        old_logp=f32(-3.0 + 0.1 * rng.randn(L, R, 1)), adv=f32(rng.randn(L, R, 1)),
        avail=avail)


def _jax_side(dims, L, cfg_kw, with_grads):
    """The JAX bfloat16 policy under ``pallas_fused``, its parameters, and a
    jitted function of the batch: ``evaluate_actions``, and with
    ``with_grads`` the PPO loss and its gradients (the loss of
    tests/test_torch_train.py)."""
    jcfg = JModelConfig(max_edge_dist=MED, gnn_impl="pallas_fused", compute_dtype="bfloat16",
                        **cfg_kw)
    jpol = JPolicy(jcfg, JDims(*dims))
    jtr = jmappo.GRMAPPOTrainer(jpol, data_chunk_length=L)
    jparams = jax.jit(lambda k: jpol.init_params(k, jnp.float32))(jax.random.PRNGKey(2))

    def evaluate(params, inp):
        return jpol.evaluate_actions(
            params, inp["share_obs"], inp["obs"], inp["node_obs"], inp["adj"],
            inp["agent_id"], inp["agent_id"], inp["h_actor"], inp["h_critic"],
            inp["actions"], inp["masks"], inp["avail"], inp["active_masks"], time_major=True)

    def loss(params, inp):
        values, logp, ent = evaluate(params, inp)
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

    fn = jax.value_and_grad(loss, has_aux=True) if with_grads else evaluate
    return jparams, jax.jit(fn)


def _port_side(dims, L, cfg_kw, jparams, dtype):
    pol = GRMAPPOPolicy(ModelConfig(max_edge_dist=MED, compute_dtype=dtype, **cfg_kw),
                        PolicyDims(*dims), device="cpu")
    params = pol.init_params(0)
    sd_a, sd_c = policy_params_from_flax(jax.tree.map(np.asarray, jparams.actor),
                                         jax.tree.map(np.asarray, jparams.critic))
    params.actor.load_state_dict(sd_a)
    params.critic.load_state_dict(sd_c)
    return pol, params, GRMAPPOTrainer(pol, data_chunk_length=L)


def _torch_batch(inp):
    batch = {k: torch.tensor(np.ascontiguousarray(v)) for k, v in inp.items()}
    batch["agent_id"] = batch["agent_id"].to(torch.long)
    return batch


def _evaluate(pol, params, b):
    return pol.evaluate_actions(
        params, b["share_obs"], b["obs"], b["node_obs"], b["adj"], b["agent_id"],
        b["h_actor"], b["h_critic"], b["actions"], b["masks"], b["avail"], b["active_masks"])


def _within_bar(got, jax_bf16, ref32, atol, what):
    """max|got - ref32| <= BF16_RATIO * max|jax_bf16 - ref32| + atol."""
    got, jb, ref = (np.asarray(x, np.float64) for x in (got, jax_bf16, ref32))
    d_port, d_jax = np.abs(got - ref).max(), np.abs(jb - ref).max()
    print(f"{what}: port {d_port:.3e}  jax {d_jax:.3e}  bar {BF16_RATIO * d_jax + atol:.3e}")
    assert d_port <= BF16_RATIO * d_jax + atol, (what, d_port, d_jax, atol)
    return d_port, d_jax


EVAL_DIMS, EVAL_L, EVAL_R = (19, 57, 6, 8, 25), 4, 8


@functools.lru_cache(maxsize=None)
def eval_case():
    inp = _batch(EVAL_DIMS, EVAL_L, EVAL_R, seed=5)
    jparams, jeval = _jax_side(EVAL_DIMS, EVAL_L, {}, with_grads=False)
    return inp, jparams, jax.tree.map(np.asarray, jeval(jparams, inp))


def test_evaluate_actions_bf16_matches_jax_pallas_fused():
    """Values, log-probs and entropy at E = 6, 32 graphs, relu."""
    inp, jparams, (jv, jlp, jent) = eval_case()
    b = _torch_batch(inp)
    out = {}
    for dtype in ("float32", "bfloat16"):
        pol, params, _ = _port_side(EVAL_DIMS, EVAL_L, {}, jparams, dtype)
        with torch.no_grad():
            out[dtype] = [x.numpy() for x in _evaluate(pol, params, b)]
    assert all(x.dtype == np.float32 for x in out["bfloat16"])
    for i, (name, want) in enumerate((("values", jv), ("log-probs", jlp), ("entropy", jent))):
        _within_bar(out["bfloat16"][i], want, out["float32"][i], BF16_ATOL, name)
    # bfloat16 moved the result: the comparison is not of two float32 runs
    assert np.abs(out["bfloat16"][1] - out["float32"][1]).max() > 1e-5


GRAD_DIMS, GRAD_L, GRAD_R = (19, 38, 3, 8, 25), 4, 8
SHALLOW = dict(embed_layer_n=0, gnn_layer_n=0, **TANH)


def test_update_gradients_bf16_match_jax_pallas_fused():
    """The PPO loss's gradient of every leaf of both networks, the first
    epoch of a num_mini_batch=1 update (the whole batch at the starting
    weights), tanh, E = 3, no extra trunk layers."""
    inp = _batch(GRAD_DIMS, GRAD_L, GRAD_R, seed=6)
    jparams, jgrad = _jax_side(GRAD_DIMS, GRAD_L, SHALLOW, with_grads=True)
    (jtotal, _), jgrads = jgrad(jparams, inp)
    b = _torch_batch(inp)
    grads, totals = {}, {}
    for dtype in ("float32", "bfloat16"):
        pol, params, trainer = _port_side(GRAD_DIMS, GRAD_L, SHALLOW, jparams, dtype)
        vn = valuenorm.vn_update(valuenorm.vn_init(), b["returns"].reshape(-1, 1))
        total, _ = trainer.loss(params, vn, b)
        totals[dtype] = total.item()
        grads[dtype] = {}
        for side in ("actor", "critic"):
            module = getattr(params, side)
            gs = torch.autograd.grad(total, list(module.parameters()), retain_graph=True,
                                     allow_unused=True)
            for (n, p), g in zip(module.named_parameters(), gs):
                grads[dtype][f"{side}.{n}"] = (torch.zeros_like(p) if g is None else g).numpy()
    _within_bar(totals["bfloat16"], float(jtotal), totals["float32"], BF16_ATOL, "loss")
    want = {f"{side}.{k}": v.numpy() for side in ("actor", "critic") for k, v in
            state_dict_from_flax(jax.tree.map(np.asarray, getattr(jgrads, side))).items()}
    assert set(want) == set(grads["bfloat16"])
    moved = 0
    for k, ref in grads["float32"].items():
        atol = BF16_GRAD_ATOL * np.abs(ref).max() + GRAD_FLOOR
        d_port, _ = _within_bar(grads["bfloat16"][k], want[k], ref, atol, k)
        moved += d_port > 0
    assert moved > len(want) // 2
