"""Where XLA rounds the packed ``EmbedConv`` (``gnn_edge_packed=True``) in
bfloat16 on the CPU.

    JAX_PLATFORMS=cpu python scripts/packed_bf16_rounding_probe.py

The JAX package's packed layout normalises with ``_group_ln``
(``models/nets.py:183-195``): the mean and the variance as products with a
constant block matrix in the compute dtype, then ``rsqrt`` and the affine
step, after the activation in the compute dtype.  This script jits
``_group_ln(act(m))`` on 2,048 graphs (E = 6, 16 features; a bfloat16
pre-activation ``m``) and a torch mirror of it with each candidate rounding
point on or off, and prints the share of outputs each mirror gets
bit-equal.  The four questions it answers:

1. is the activation's result rounded to bfloat16 before the mean product?
2. is ``(m - mu) ** 2`` rounded before the variance product?
3. is each product accumulated in float32 and rounded once (or kept in
   float32, or accumulated in bfloat16)?
4. is the normalise-and-affine step one float32 pass (or rounded after
   each operation)?

It then asks the same of the extra embed layer (``m @ kron(I_E, W) +
tile(b)``, the activation, ``_group_ln``): whether the product and the
bias sum round.  Last, it holds the torch port's ``embed_conv_packed``
against the JAX ``EmbedConv(gnn_edge_packed=True)`` in bfloat16 (relu and
tanh, one and two embed layers): the share of bit-equal outputs and the
largest difference in bfloat16 units.  Needs JAX and flax (the JAX
package's environment); about 20 s.
"""
import itertools
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from contracts_marl_aam_corridors_tpu.models import ModelConfig as JModelConfig  # noqa: E402
from contracts_marl_aam_corridors_tpu.models import nets as jnets  # noqa: E402

BF = torch.bfloat16
B, E, F = 2048, 6, 16


def rnd(x, on):
    return x.to(BF).float() if on else x


def group_sum(x, prod):
    """The sum over each group's F lanes of ``x`` (float32 values of
    bfloat16 products with 1/F): 'round' accumulates in float32 and rounds
    once, 'keep' keeps the float32 sum, 'bf16' rounds every partial sum."""
    g = x.reshape(x.shape[:-1] + (E, F))
    if prod == "bf16":
        acc = torch.zeros_like(g[..., 0])
        for f in range(F):
            acc = rnd(acc + g[..., f], True)
        s = acc
    else:
        s = rnd(g.sum(-1), prod == "round")
    return s.repeat_interleave(F, dim=-1)


def mirror(m, act, scale, bias, r_act, prod, r_sq, fused):
    """``_group_ln(act(m))`` in float32 with the chosen rounding points."""
    inv = 1.0 / F
    a = rnd(act(m), r_act)
    mu = group_sum(a * inv, prod)
    d = a - mu
    var = group_sum(rnd(rnd(d, not fused) ** 2, r_sq) * inv, prod)
    s, b = scale.repeat(E), bias.repeat(E)
    if fused:
        return (d * torch.rsqrt(var + 1e-5) * s + b).to(BF).float()
    y = rnd(rnd(d, True) * rnd(torch.rsqrt(rnd(var + 1e-5, True)), True), True)
    return rnd(rnd(y * s, True) + b, True)


def share(got, want):
    return float((got.numpy() == want).mean())


def group_ln_questions(rng):
    m = rng.randn(B, E, E * F).astype(np.float32)
    scale = (1.0 + 0.3 * rng.randn(F)).astype(np.float32)
    bias = (0.2 * rng.randn(F)).astype(np.float32)
    m_b = jnp.asarray(m).astype(jnp.bfloat16)
    sb, bb = jnp.asarray(scale).astype(jnp.bfloat16), jnp.asarray(bias).astype(jnp.bfloat16)
    mt = torch.tensor(m).to(BF).float()
    st, bt = torch.tensor(scale).to(BF).float(), torch.tensor(bias).to(BF).float()
    rows = []
    for name, jact, tact in (("tanh", jnp.tanh, torch.tanh), ("relu", jax.nn.relu, torch.relu)):
        fn = jax.jit(jax.vmap(lambda x, jact=jact: jnets._group_ln(jact(x), E, F, sb, bb)))
        want = np.asarray(fn(m_b).astype(jnp.float32))
        print(f"_group_ln({name}(m)), bfloat16 m: bit-equal share by "
              "(activation rounded, products, square rounded, one float32 pass)")
        for r_act, prod, r_sq, fused in itertools.product(
                (True, False), ("round", "keep", "bf16"), (True, False), (True, False)):
            s = share(mirror(mt, tact, st, bt, r_act, prod, r_sq, fused), want)
            rows.append((name, r_act, prod, r_sq, fused, s))
            print(f"  ({r_act:d}, {prod:5s}, {r_sq:d}, {fused:d}): {s:.4f}")
    return rows


def extra_layer_questions(rng, best):
    """act(m @ kron(I_E, W) + tile(b)) -> _group_ln, m a bfloat16 LayerNorm
    output: is the product rounded, is the bias sum rounded."""
    _, r_act, prod, r_sq, fused = best
    m = rng.randn(B, E, E * F).astype(np.float32)
    w = (rng.randn(F, F) / 4).astype(np.float32)
    bvec = (0.1 * rng.randn(F)).astype(np.float32)
    dt = jnp.bfloat16
    jw, jb = jnp.asarray(w).astype(dt), jnp.asarray(bvec).astype(dt)

    def jfn(x):
        y = jnp.tanh(x @ jnp.kron(jnp.eye(E, dtype=dt), jw) + jnp.tile(jb, (E,)))
        return jnets._group_ln(y, E, F, jnp.ones((F,), dt), jnp.zeros((F,), dt))

    want = np.asarray(jax.jit(jax.vmap(jfn))(jnp.asarray(m).astype(dt)).astype(jnp.float32))
    mt = torch.tensor(m).to(BF).float()
    wt, bt = torch.tensor(w).to(BF).float(), torch.tensor(bvec).to(BF).float()
    print("extra layer, tanh: bit-equal share by (product rounded, bias sum rounded)")
    for r_dot, r_bias in itertools.product((True, False), repeat=2):
        pre = mt.reshape(B, E, E, F) @ wt
        pre = rnd(rnd(pre, r_dot) + bt, r_bias).reshape(B, E, E * F)
        got = mirror(pre, torch.tanh, torch.ones(F), torch.zeros(F), r_act, prod, r_sq, fused)
        print(f"  ({r_dot:d}, {r_bias:d}): {share(got, want):.4f}")


def port_against_jax(rng):
    """The port's embed_conv_packed against the JAX packed EmbedConv."""
    from flax import linen as fnn

    from contracts_marl_aam_corridors_tpu_torch.models import ModelConfig, nets
    from contracts_marl_aam_corridors_tpu_torch.models.convert import state_dict_from_flax

    node = rng.randn(B, E, 8).astype(np.float32)
    node[..., -1] = rng.randint(0, 3, (B, E))
    a = rng.rand(B, E, E) * 2.0
    adj = ((a + a.transpose(0, 2, 1)) / 2).astype(np.float32)
    adj[:, np.arange(E), np.arange(E)] = 0.0
    print("port embed_conv_packed vs JAX EmbedConv(gnn_edge_packed=True), bfloat16: "
          "bit-equal share, largest difference in bfloat16 units of the JAX output")
    for layers, relu in itertools.product((1, 2), (True, False)):
        kw = dict(embed_layer_n=layers, embed_use_relu=relu, gnn_edge_packed=True,
                  max_edge_dist=1.5)
        jcfg = JModelConfig(compute_dtype="bfloat16", **kw)
        mod = fnn.vmap(jnets.EmbedConv, in_axes=(0, 0, 0), out_axes=0,
                       variable_axes={"params": None}, split_rngs={"params": False})(jcfg)
        mask = (adj > 0) & (adj < 1.5)
        attr = (adj * mask).astype(np.float32)
        xb = jnp.asarray(node).astype(jnp.bfloat16)
        ab = jnp.asarray(attr).astype(jnp.bfloat16)
        params = mod.init(jax.random.PRNGKey(layers), xb, mask, ab)
        want = np.asarray(jax.jit(mod.apply)(params, xb, mask, ab).astype(jnp.float32))
        cfg = ModelConfig(compute_dtype="bfloat16", **kw)
        gnn = nets.GNNBase(cfg, 8, "node")
        sd = state_dict_from_flax({"embed_layer": jax.tree.map(np.asarray, params["params"])})
        gnn.embed_layer.load_state_dict({k[len("embed_layer."):]: v for k, v in sd.items()})
        with torch.no_grad():
            got = nets.embed_conv_packed(
                cfg, gnn.embed_layer, torch.tensor(node).to(BF), torch.tensor(mask),
                torch.tensor(attr).to(BF)).float()
        ulp = np.abs(got.numpy() - want) / np.maximum(
            2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7), 2.0 ** -133)
        print(f"  embed_layer_n {layers}, {'relu' if relu else 'tanh'}: "
              f"{share(got, want):.4f}, {ulp.max():.1f}")


def main():
    torch.set_num_threads(1)
    rng = np.random.RandomState(0)
    rows = group_ln_questions(rng)
    tanh_rows = [r for r in rows if r[0] == "tanh"]
    best = max(tanh_rows, key=lambda r: r[-1])
    print(f"best tanh mirror: activation rounded {best[1]}, products {best[2]!r}, "
          f"square rounded {best[3]}, one float32 pass {best[4]} ({best[5]:.4f})")
    extra_layer_questions(rng, best[:5])
    port_against_jax(rng)


if __name__ == "__main__":
    main()
