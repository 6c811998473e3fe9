"""Where XLA rounds a flax bfloat16 MLP block on the CPU.

    JAX_PLATFORMS=cpu python scripts/bf16_rounding_probe.py

Runs the chain flax ``LayerNorm(dtype=bfloat16)`` -> ``Dense(64,
dtype=bfloat16)`` -> ``tanh`` -> ``LayerNorm(dtype=bfloat16)`` jitted on
4,096 x 83 random inputs, then a torch mirror of it with each of the four
intermediates (the first LayerNorm's output, the product, the bias sum, the
tanh) rounded to bfloat16 or kept in float32, and prints the share of the
outputs each mirror gets bit-equal to flax's.  The mirror that rounds where
XLA rounds is the one ``models/nets.py`` of the torch port follows.  Needs
JAX and flax (the JAX package's environment); about 10 s.
"""
import itertools
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

BF = jnp.bfloat16


class Chain(nn.Module):
    @nn.compact
    def __call__(self, x):
        a = nn.LayerNorm(epsilon=1e-5, dtype=BF, name="ln0")(x)
        d = nn.Dense(64, dtype=BF, name="fc")(a)
        return nn.LayerNorm(epsilon=1e-5, dtype=BF, name="ln1")(nn.tanh(d))


def layer_norm(x, scale, bias):
    """flax's statistics (float32, E[x^2] - E[x]^2), float32 output."""
    mu = x.mean(-1, keepdim=True)
    var = torch.clamp((x * x).mean(-1, keepdim=True) - mu * mu, min=0.0)
    return (x - mu) * (torch.rsqrt(var + 1e-5) * scale) + bias


def main():
    torch.set_num_threads(1)
    x = np.random.RandomState(0).randn(4096, 83).astype(np.float32)
    chain = Chain()
    params = chain.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(
        lambda v: v + 0.1 * jax.random.normal(jax.random.PRNGKey(1), v.shape), params)
    want = np.asarray(jax.jit(chain.apply)(params, jnp.asarray(x)).astype(jnp.float32))
    p = jax.tree.map(lambda v: torch.tensor(np.asarray(v)), params)["params"]
    w = p["fc"]["kernel"].to(torch.bfloat16).float()
    b = p["fc"]["bias"].to(torch.bfloat16).float()
    xt = torch.tensor(x)
    rnd = lambda v, on: v.to(torch.bfloat16).float() if on else v
    print("rounded to bfloat16 at (ln0 output, product, bias sum, tanh): bit-equal share")
    for r_ln, r_dot, r_bias, r_tanh in itertools.product([1, 0], repeat=4):
        a = rnd(layer_norm(xt, p["ln0"]["scale"], p["ln0"]["bias"]), r_ln)
        d = rnd(rnd(a @ w, r_dot) + b, r_bias)
        y = layer_norm(rnd(torch.tanh(d), r_tanh), p["ln1"]["scale"], p["ln1"]["bias"])
        share = float((y.to(torch.bfloat16).float().numpy() == want).mean())
        print(f"  ({r_ln}, {r_dot}, {r_bias}, {r_tanh}): {share:.4f}")


if __name__ == "__main__":
    main()
