"""Network building blocks: MLP trunk, GRU, and the graph trunk (port of
``models/nets.py``).

Module and parameter names follow the JAX package's flax tree
(``base.mlp.fc0``, ``rnn.gru0.w_ih``, ``gnn_base.embed_layer.lin1`` ...), so
``models/convert.py`` maps a flax tree onto a state dict by renaming leaves
(``kernel`` -> ``weight`` transposed, ``scale`` -> ``weight``,
``embedding`` -> ``weight``) and transposing the GRU weights.

The GNN has two formulations here, routed by ``ModelConfig.kernel_trunk``
as the JAX package's policy routes them (policy.py:237-247):

* the transposed trunk of ``gnn_transposed_apply`` (nets.py:527): rows
  are entity x feature, the batch is the minor axis, and the whole trunk
  is one call of ``ops.gnn_trunk.gnn_trunk_forward`` (the CUDA kernel on
  the card, the plain version on the CPU); under grad it goes through
  ``GNNTrunk``, whose backward is the ``gnn_trunk_bwd`` kernel on the
  card.  ``gnn_transposed_apply_dual`` runs the actor's and the critic's
  trunks in one call of the dual kernels; the policy does not route it;
* the dense per-graph ``EmbedConv`` / ``TransformerConv`` / ``GNNBase``
  forward (nets.py:143-402), batched over a leading graph axis instead of
  ``nn.vmap``: ``gnn_dense_apply``, with ``EmbedConv`` in the dense edge
  layout or, under ``gnn_edge_packed``, the packed one
  (``embed_conv_packed``), and ``gnn_dense_nodes_dual`` for the actor's
  and the critic's GNN in one pass over stacked parameters.  It is plain
  torch on the card and the CPU alike, as the JAX package's flax modules
  are plain XLA, and it alone serves concatenated heads (``lin_skip`` and
  the extra conv layers H*C wide), the actor's global pool and
  ``gnn_impl='dense'``.  Its bfloat16 rounds at the flax modules' sites
  (the Dense and LayerNorm rules below, the message sum, the q/k/v
  product and the masked softmax), with the reductions of bfloat16
  (the head mean, the pools, the message and attention sums) accumulated
  in float32 and rounded once, as ``jnp.mean``/``jnp.sum`` and XLA's CPU
  dots do.  It computes in the parameters' dtype otherwise (float64 for a
  module cast with ``.double()``).

All LayerNorms use eps=1e-5 (torch's default, as in the JAX package).

Under ``compute_dtype='bfloat16'`` the tails round where the JAX package's
flax modules round as XLA compiles them (on the kernel trunk the trunk
itself stays float32, as under the JAX package's ``pallas_fused`` trunk):

* the trunk output is cast to bfloat16 before the gather or the pool (the
  critic's mean and sum accumulate in float32, as ``jnp.mean`` does);
* a ``Dense(dtype=bfloat16)`` rounds its input, kernel and bias, its
  product and then the bias sum, each to bfloat16;
* the activation takes the bfloat16 pre-activation and its float32 result
  feeds the LayerNorm unrounded (XLA keeps the excess precision of the
  upcast ``tanh``; relu is exact either way);
* a ``LayerNorm(dtype=bfloat16)`` takes float32 statistics and rounds its
  output to bfloat16 (torch's two-pass variance where flax takes
  E[x^2] - E[x]^2: they differ in float32's last place, which with the
  summation order moves a few outputs in 10,000 by one bfloat16 unit);
* the float32 ``obs`` beside the actor's bfloat16 node feature, the GRU and
  the output layers promote to float32.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops import gnn_trunk
from .config import ModelConfig

Tensor = torch.Tensor

RELU_GAIN = math.sqrt(2.0)  # nn.init.calculate_gain('relu')
TANH_GAIN = 5.0 / 3.0
LN_EPS = 1e-5
BF16 = torch.bfloat16


def dense_init_(w: Tensor, cfg: ModelConfig, gain: float, gen: torch.Generator) -> None:
    """Reference ``init_`` helper (mlp.py:22-24): orthogonal or xavier."""
    if cfg.use_orthogonal:
        nn.init.orthogonal_(w, gain=gain, generator=gen)
    else:
        nn.init.xavier_uniform_(w, generator=gen)


def _init_linear(lin: nn.Linear, cfg: ModelConfig, gain: float, gen: torch.Generator) -> None:
    dense_init_(lin.weight, cfg, gain, gen)
    nn.init.zeros_(lin.bias)


def _init_ln(ln: nn.LayerNorm) -> None:
    nn.init.ones_(ln.weight)
    nn.init.zeros_(ln.bias)


def _dense_bf16(lin: nn.Linear, x: Tensor) -> Tensor:
    """flax ``Dense(dtype=bfloat16)``: the product of the bfloat16 input and
    kernel rounded to bfloat16, then the bfloat16 bias added and rounded."""
    return torch.matmul(x.to(BF16), lin.weight.to(BF16).T) + lin.bias.to(BF16)


def _layer_norm_bf16(ln: nn.LayerNorm, x: Tensor) -> Tensor:
    """flax ``LayerNorm(dtype=bfloat16)``: float32 statistics, the output
    rounded to bfloat16."""
    return ln(x.to(torch.float32)).to(BF16)


def _linear(lin: nn.Linear, x: Tensor, bf16: bool) -> Tensor:
    return _dense_bf16(lin, x) if bf16 else lin(x)


def _act_norm(ln: nn.LayerNorm, x: Tensor, act, bf16: bool) -> Tensor:
    """act -> LayerNorm; in bfloat16 the activation's float32 result feeds
    the LayerNorm unrounded (see the module docstring)."""
    return _layer_norm_bf16(ln, act(x.to(torch.float32))) if bf16 else ln(act(x))


def _sum_rounded(x: Tensor, dim: int, mean: bool = False) -> Tensor:
    """A sum (or mean) over ``dim``; of bfloat16, accumulated in float32 and
    rounded once, as ``jnp.sum``/``jnp.mean`` do."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    red = acc.mean(dim=dim) if mean else acc.sum(dim=dim)
    return red.to(x.dtype)


class MLPLayer(nn.Module):
    """fc0 + layer_N hidden blocks, each Linear -> act -> LayerNorm (mlp.py:8-41)."""

    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        self.cfg = cfg
        dims = [in_dim] + [cfg.hidden_size] * (1 + cfg.layer_N)
        for i in range(1 + cfg.layer_N):
            setattr(self, f"fc{i}", nn.Linear(dims[i], dims[i + 1]))
            setattr(self, f"ln{i}", nn.LayerNorm(cfg.hidden_size, eps=LN_EPS))

    def init_(self, gen: torch.Generator) -> None:
        gain = RELU_GAIN if self.cfg.use_relu else TANH_GAIN
        for i in range(1 + self.cfg.layer_N):
            _init_linear(getattr(self, f"fc{i}"), self.cfg, gain, gen)
            _init_ln(getattr(self, f"ln{i}"))

    def forward(self, x: Tensor) -> Tensor:
        act = torch.relu if self.cfg.use_relu else torch.tanh
        for i in range(1 + self.cfg.layer_N):
            fc, ln = getattr(self, f"fc{i}"), getattr(self, f"ln{i}")
            x = _act_norm(ln, _linear(fc, x, self.cfg.bf16), act, self.cfg.bf16)
        return x


class MLPBase(nn.Module):
    """Optional feature LayerNorm, then MLPLayer (mlp.py:44-75)."""

    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        self.cfg = cfg
        if cfg.use_feature_normalization:
            self.feature_norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.mlp = MLPLayer(cfg, in_dim)

    def init_(self, gen: torch.Generator) -> None:
        if hasattr(self, "feature_norm"):
            _init_ln(self.feature_norm)
        self.mlp.init_(gen)

    def forward(self, x: Tensor) -> Tensor:
        if hasattr(self, "feature_norm"):
            x = _layer_norm_bf16(self.feature_norm, x) if self.cfg.bf16 else self.feature_norm(x)
        return self.mlp(x)


class GRULayer(nn.Module):
    """One torch-semantics GRU layer (r/z/n gates, hidden bias inside the
    reset product):
        r = sigmoid(x W_ir + b_ir + h W_hr + b_hr)
        z = sigmoid(x W_iz + b_iz + h W_hz + b_hz)
        n = tanh(x W_in + b_in + r * (h W_hn + b_hn))
        h' = (1 - z) * n + z * h
    Weights are stored (3H, in) as torch stores them; the flax tree holds
    their transposes (nets.py:99-103).
    """

    def __init__(self, in_dim: int, hidden_size: int, use_orthogonal: bool = True):
        super().__init__()
        H = hidden_size
        self.use_orthogonal = use_orthogonal
        self.w_ih = nn.Parameter(torch.empty(3 * H, in_dim))
        self.w_hh = nn.Parameter(torch.empty(3 * H, H))
        self.b_ih = nn.Parameter(torch.empty(3 * H))
        self.b_hh = nn.Parameter(torch.empty(3 * H))

    def init_(self, gen: torch.Generator) -> None:
        for w in (self.w_ih, self.w_hh):
            if self.use_orthogonal:
                nn.init.orthogonal_(w, generator=gen)
            else:
                nn.init.xavier_uniform_(w, generator=gen)
        nn.init.zeros_(self.b_ih)
        nn.init.zeros_(self.b_hh)

    def forward(self, x: Tensor, h: Tensor) -> Tensor:
        gi = nn.functional.linear(x, self.w_ih, self.b_ih)
        gh = nn.functional.linear(h, self.w_hh, self.b_hh)
        i_r, i_z, i_n = gi.chunk(3, dim=-1)
        h_r, h_z, h_n = gh.chunk(3, dim=-1)
        r = torch.sigmoid(i_r + h_r)
        z = torch.sigmoid(i_z + h_z)
        n = torch.tanh(i_n + r * h_n)
        return (1.0 - z) * n + z * h


class RNNLayer(nn.Module):
    """GRU stack + LayerNorm with mask-gated hidden-state resets
    (rnn.py:6-79), single step: ``x`` (B, in), ``hxs`` (B, recurrent_N, H),
    ``masks`` (B, 1) with 0 at episode starts."""

    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        self.cfg = cfg
        for l in range(cfg.recurrent_n):
            d = in_dim if l == 0 else cfg.hidden_size
            setattr(self, f"gru{l}", GRULayer(d, cfg.hidden_size, cfg.use_orthogonal))
        self.norm = nn.LayerNorm(cfg.hidden_size, eps=LN_EPS)

    def init_(self, gen: torch.Generator) -> None:
        for l in range(self.cfg.recurrent_n):
            getattr(self, f"gru{l}").init_(gen)
        _init_ln(self.norm)

    def forward(self, x: Tensor, hxs: Tensor, masks: Tensor):
        new_h = []
        inp = x
        for l in range(self.cfg.recurrent_n):
            h = hxs[:, l, :] * masks
            inp = getattr(self, f"gru{l}")(inp, h)
            new_h.append(inp)
        return self.norm(inp), torch.stack(new_h, dim=1)


class EmbedConvParams(nn.Module):
    """Parameters of the reference ``EmbedConv`` (gnn_new.py:21-145) under
    the flax names: per-edge input [src features, Embed(type), distance]."""

    def __init__(self, cfg: ModelConfig, node_feat_dim: int):
        super().__init__()
        self.cfg = cfg
        F1 = cfg.embed_hidden_size
        Ds = node_feat_dim - 1 + cfg.embedding_size
        self.entity_embed = nn.Embedding(cfg.num_embeddings, cfg.embedding_size)
        self.lin1 = nn.Linear(Ds, F1)
        self.lin1_edge = nn.Parameter(torch.empty(1, F1))
        self.ln1 = nn.LayerNorm(F1, eps=LN_EPS)
        for i in range(cfg.embed_layer_n):
            setattr(self, f"lin{i + 2}", nn.Linear(F1, F1))
            setattr(self, f"ln{i + 2}", nn.LayerNorm(F1, eps=LN_EPS))

    def init_(self, gen: torch.Generator) -> None:
        cfg = self.cfg
        gain = RELU_GAIN if cfg.embed_use_relu else TANH_GAIN
        # flax's default Embed init scale
        nn.init.normal_(self.entity_embed.weight, std=1.0 / math.sqrt(cfg.num_embeddings),
                        generator=gen)
        _init_linear(self.lin1, cfg, gain, gen)
        dense_init_(self.lin1_edge, cfg, gain, gen)
        _init_ln(self.ln1)
        for i in range(cfg.embed_layer_n):
            _init_linear(getattr(self, f"lin{i + 2}"), cfg, gain, gen)
            _init_ln(getattr(self, f"ln{i + 2}"))


class TransformerConvParams(nn.Module):
    """Parameters of PyG ``TransformerConv`` (gnn_new.py:247-269; beta=False,
    root_weight=True, edge_dim=1) under the flax names."""

    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        HC = cfg.gnn_num_heads * cfg.gnn_hidden_size
        self.lin_query = nn.Linear(in_dim, HC)
        self.lin_key = nn.Linear(in_dim, HC)
        self.lin_value = nn.Linear(in_dim, HC)
        self.lin_edge = nn.Parameter(torch.empty(1, HC))
        # the skip is added after the heads are averaged or concatenated
        self.lin_skip = nn.Linear(in_dim, cfg.gnn_out_dim)

    def init_(self, gen: torch.Generator) -> None:
        # PyG's Linear init is glorot; only fresh (untrained) weights use it
        for lin in (self.lin_query, self.lin_key, self.lin_value, self.lin_skip):
            nn.init.xavier_uniform_(lin.weight, generator=gen)
            nn.init.zeros_(lin.bias)
        nn.init.xavier_uniform_(self.lin_edge, generator=gen)


class GNNBase(nn.Module):
    """EmbedConv -> TransformerConv x (1 + gnn_layer_N) -> ego-node gather
    ('node') or global pool ('global'), gnn_new.py:148-301, 420-510, over a
    batch of graphs: the transposed kernel trunk where
    ``cfg.kernel_trunk``, else the dense modules."""

    def __init__(self, cfg: ModelConfig, node_feat_dim: int, graph_aggr: str):
        super().__init__()
        self.cfg = cfg
        self.graph_aggr = graph_aggr
        self.embed_layer = EmbedConvParams(cfg, node_feat_dim)
        self.gnn1 = TransformerConvParams(cfg, cfg.embed_hidden_size)
        for i in range(cfg.gnn_layer_n):
            setattr(self, f"gnn2_{i}", TransformerConvParams(cfg, cfg.gnn_out_dim))
        self._kernel_key = None
        self._kernel_params = None

    def init_(self, gen: torch.Generator) -> None:
        self.embed_layer.init_(gen)
        self.gnn1.init_(gen)
        for i in range(self.cfg.gnn_layer_n):
            getattr(self, f"gnn2_{i}").init_(gen)

    def flax_tree(self) -> dict:
        """The parameters as the flax tree lays them out (Dense kernels
        (in, out)), as views of this module's tensors."""
        dense = lambda lin: {"kernel": lin.weight.T, "bias": lin.bias}
        ln = lambda m: {"scale": m.weight, "bias": m.bias}
        ec = self.embed_layer
        tree = {"embed_layer": {
            "entity_embed": {"embedding": ec.entity_embed.weight},
            "lin1": dense(ec.lin1), "lin1_edge": ec.lin1_edge, "ln1": ln(ec.ln1),
        }}
        for i in range(self.cfg.embed_layer_n):
            tree["embed_layer"][f"lin{i + 2}"] = dense(getattr(ec, f"lin{i + 2}"))
            tree["embed_layer"][f"ln{i + 2}"] = ln(getattr(ec, f"ln{i + 2}"))
        for name in ["gnn1"] + [f"gnn2_{i}" for i in range(self.cfg.gnn_layer_n)]:
            tc = getattr(self, name)
            tree[name] = {k: dense(getattr(tc, k))
                          for k in ("lin_query", "lin_key", "lin_value", "lin_skip")}
            tree[name]["lin_edge"] = tc.lin_edge
        return tree

    def grad_params(self) -> gnn_trunk.KernelParams:
        """The trunk kernels' parameter buffer, built straight from these
        weights (stored (out, in), so one transpose each).  Built per call
        and differentiable where grad is enabled, so the buffer's gradient
        reaches every weight.  The kernels average the heads: concatenated
        heads have no buffer."""
        if self.cfg.gnn_concat_heads:
            raise ValueError("the trunk kernels average the heads: a GNNBase with "
                             "gnn_concat_heads runs only the dense modules")
        ec = self.embed_layer
        parts = [ec.lin1.weight.T, ec.lin1.bias, ec.lin1_edge, ec.ln1.weight, ec.ln1.bias]
        for i in range(self.cfg.embed_layer_n):
            lin, ln = getattr(ec, f"lin{i + 2}"), getattr(ec, f"ln{i + 2}")
            parts += [lin.weight.T, lin.bias, ln.weight, ln.bias]
        for name in ["gnn1"] + [f"gnn2_{i}" for i in range(self.cfg.gnn_layer_n)]:
            tc = getattr(self, name)
            qkv = (tc.lin_query, tc.lin_key, tc.lin_value)
            parts += [torch.cat([l.weight for l in qkv]).T,
                      torch.cat([l.bias for l in qkv]), tc.lin_edge,
                      tc.lin_skip.weight.T, tc.lin_skip.bias]
        blob = torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)
        return gnn_trunk.KernelParams(blob, ec.lin1.weight.shape[0])

    def kernel_params(self) -> gnn_trunk.KernelParams:
        """The buffer for calls without a gradient, built under no_grad and
        kept until a weight changes: an in-place update or a load bumps a
        tensor's version, and a move gives it new storage."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._kernel_key:
            with torch.no_grad():
                self._kernel_params = self.grad_params()
            self._kernel_key = key
        return self._kernel_params

    def forward(self, node_obs: Tensor, adj: Tensor, agent_id: Tensor | None) -> Tensor:
        aggr = "node" if self.graph_aggr == "node" else self.cfg.global_aggr_type
        if self.cfg.kernel_trunk:
            return gnn_transposed_apply(self.cfg, self, node_obs, adj, agent_id, aggr)
        return gnn_dense_apply(self.cfg, self, node_obs, adj, agent_id, aggr)


# ---------------------------------------------------------------- dense route
_SPLIT_ROWS, _MAX_CHUNKS = 8192, 256


class _SideLinear(torch.autograd.Function):
    """``x @ w^T + b`` for S sides at once: ``w`` (S, out, in), ``b`` (S,
    out) or None, ``x`` (S, ..., in), each side its own input.  One batched
    product forward and for the input's gradient; the weight's gradient is
    one batched product too, split over the rows into chunks of at most
    ``_SPLIT_ROWS`` that are summed after (in float32).  cuBLAS runs a
    batched (out x in) product over millions of rows on one CTA a side, a
    hundred times the time of the single product's split-K kernel."""

    @staticmethod
    def forward(x, w, b):
        S, n_in = w.shape[0], w.shape[-1]
        out = torch.bmm(x.reshape(S, -1, n_in), w.transpose(1, 2))
        if b is not None:
            out = out + b[:, None, :]
        return out.reshape(x.shape[:-1] + (w.shape[1],))

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        S, n_out, n_in = w.shape
        g2 = g.reshape(S, -1, n_out)
        x2 = x.reshape(S, -1, n_in)
        dx = torch.bmm(g2, w).reshape(x.shape)
        R = g2.shape[1]
        chunks = max(1, min(_MAX_CHUNKS, -(-R // _SPLIT_ROWS)))
        per = -(-R // chunks)
        acc = torch.promote_types(w.dtype, torch.float32)
        g2, x2 = g2.to(acc), x2.to(acc)
        if per * chunks != R:
            g2 = nn.functional.pad(g2, (0, 0, 0, per * chunks - R))
            x2 = nn.functional.pad(x2, (0, 0, 0, per * chunks - R))
        dw = torch.bmm(g2.reshape(S * chunks, per, n_out).transpose(1, 2),
                       x2.reshape(S * chunks, per, n_in))
        dw = dw.reshape(S, chunks, n_out, n_in).sum(dim=1).to(w.dtype)
        db = g2.sum(dim=1).to(w.dtype) if ctx.has_bias else None
        return dx, dw, db


class _Linear(torch.autograd.Function):
    """``nn.functional.linear(x, w, b)`` (``b`` may be None), with the
    gradients autograd gives it, and a ``torch.func.vmap`` rule for
    ``gnn_dense_nodes_dual``'s side axis: a shared input takes the sides'
    weights as one (S*out, in) product, a per-side input the side-batched
    :class:`_SideLinear`."""

    @staticmethod
    def forward(x, w, b):
        return nn.functional.linear(x, w, b)

    @staticmethod
    def setup_context(ctx, inputs, output):
        x, w, b = inputs
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        dw = g2.T @ x.reshape(-1, x.shape[-1])
        return g @ w, dw, g2.sum(dim=0) if ctx.has_bias else None

    @staticmethod
    def vmap(info, in_dims, x, w, b):
        # every weight and bias is stacked over the sides
        x_dim, w_dim, b_dim = in_dims
        S = info.batch_size
        w = w.movedim(w_dim, 0)
        b = None if b is None else b.movedim(b_dim, 0)
        if x_dim is None:
            out = nn.functional.linear(x, w.reshape(-1, w.shape[-1]),
                                       None if b is None else b.reshape(-1))
            return out.unflatten(-1, (S, -1)).movedim(-2, 0), 0
        return _SideLinear.apply(x.movedim(x_dim, 0), w, b), 0


def _gnn_linear(w: Tensor, b: Tensor, x: Tensor, bf16: bool) -> Tensor:
    """The dense GNN's ``Dense`` layers, ``x @ w^T + b`` in the parameters'
    dtype, or in bfloat16 as :func:`_dense_bf16` rounds (the product, then
    the bias sum), through :class:`_Linear`."""
    if bf16:
        return _Linear.apply(x.to(BF16), w.to(BF16), None) + b.to(BF16)
    return _Linear.apply(x, w, b)


def adjacency_mask(adj: Tensor, max_edge_dist: float) -> tuple[Tensor, Tensor]:
    """Edge mask and weights of a distance adjacency (nets.py:143-151;
    reference ``process_adj``, gnn_new.py:328-358): an edge s -> t where
    ``0 < adj[s, t] < max_edge_dist``, its attribute the distance."""
    mask = (adj > 0) & (adj < max_edge_dist)
    return mask, adj * mask


def embed_conv_dense(cfg: ModelConfig, ec: EmbedConvParams, node_obs: Tensor,
                     edge_mask: Tensor, edge_attr: Tensor) -> Tensor:
    """The dense ``EmbedConv`` (nets.py:198-282, the dense layout) on (B, E,
    F) nodes: the message s -> t is the MLP of [features_s, Embed(type_s),
    d_st], its first layer split into ``lin1`` on the node part and
    ``lin1_edge`` (no bias) on the distance, summed before the activation;
    each target sums its in-messages.  No self loop and no skip, so an
    isolated node comes out zero.  Returns (B, E, embed_hidden)."""
    act = torch.relu if cfg.embed_use_relu else torch.tanh
    bf16 = cfg.bf16
    h_src = _gnn_linear(ec.lin1.weight, ec.lin1.bias, _embed_src(ec, node_obs), bf16)
    # msg[b, s, t] = h_src[b, s] + d[b, s, t] * w_edge
    msg = h_src[:, :, None, :] + edge_attr[..., None] * ec.lin1_edge[0].to(h_src.dtype)
    msg = _act_norm(ec.ln1, msg, act, bf16)
    for i in range(cfg.embed_layer_n):
        lin = getattr(ec, f"lin{i + 2}")
        msg = _act_norm(getattr(ec, f"ln{i + 2}"),
                        _gnn_linear(lin.weight, lin.bias, msg, bf16), act, bf16)
    # out[b, t] = sum_s mask[b, s, t] * msg[b, s, t]
    return _sum_rounded(msg * edge_mask[..., None].to(msg.dtype), dim=1)


def _group_mean(x: Tensor, inv: Tensor) -> Tensor:
    """The mean over the last axis as the JAX package's ``_group_ln`` takes
    it, a product with 1/F in ``x``'s dtype (``inv``): the exact products
    accumulated in float32 (or float64) and rounded once to ``x``'s
    dtype."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    return (acc * inv.to(acc.dtype)).sum(dim=-1, keepdim=True).to(x.dtype)


def _group_ln(ln: nn.LayerNorm, x: Tensor) -> Tensor:
    """The packed layout's LayerNorm (nets.py:183-195) in ``x``'s dtype:
    the mean, then the variance around it (two passes), each by
    :func:`_group_mean`; then ``(x - mu) * rsqrt(var + eps) * scale +
    bias``, every operation rounded to that dtype (in bfloat16 XLA's CPU
    rounds there: ``scripts/packed_bf16_rounding_probe.py``)."""
    dt = x.dtype
    inv = torch.tensor(1.0 / x.shape[-1], dtype=dt)
    d = x - _group_mean(x, inv)
    var = _group_mean(d * d, inv)
    r = torch.rsqrt(var + torch.tensor(LN_EPS, dtype=dt))
    return d * r * ln.weight.to(dt) + ln.bias.to(dt)


def embed_conv_packed(cfg: ModelConfig, ec: EmbedConvParams, node_obs: Tensor,
                      edge_mask: Tensor, edge_attr: Tensor) -> Tensor:
    """``EmbedConv`` in the packed edge layout (nets.py:248-267,
    ``gnn_edge_packed=True``), on the (B, E_s, E_t, F) message tensor of
    :func:`embed_conv_dense`: the TPU layout's tiles, ``kron(I_E, W)``
    products and repeated mask add only zero blocks, so one F x F product a
    layer computes them.  What the layout changes is kept: the activation's
    result and every step of :func:`_group_ln` in the compute dtype, where
    the dense layout takes float32 LayerNorm statistics.  The same
    parameters; returns (B, E, embed_hidden)."""
    act = torch.relu if cfg.embed_use_relu else torch.tanh
    bf16 = cfg.bf16
    h_src = _gnn_linear(ec.lin1.weight, ec.lin1.bias, _embed_src(ec, node_obs), bf16)
    msg = h_src[:, :, None, :] + edge_attr[..., None] * ec.lin1_edge[0].to(h_src.dtype)
    msg = _group_ln(ec.ln1, act(msg))
    for i in range(cfg.embed_layer_n):
        lin = getattr(ec, f"lin{i + 2}")
        msg = _group_ln(getattr(ec, f"ln{i + 2}"),
                        act(_gnn_linear(lin.weight, lin.bias, msg, bf16)))
    return _sum_rounded(msg * edge_mask[..., None].to(msg.dtype), dim=1)


def transformer_conv_dense(cfg: ModelConfig, tc: TransformerConvParams, x: Tensor,
                           edge_mask: Tensor, edge_attr: Tensor) -> Tensor:
    """The dense PyG ``TransformerConv`` (nets.py:285-352; beta=False,
    root_weight=True, edge_dim=1) on (B, E, in) nodes.  For edge s -> t and
    head h, with the rank-1 edge feature e_st = d_st * w_edge:
        alpha_st = softmax_s(q_t . (k_s + e_st) / sqrt(C))
        out_t = sum_s alpha_st (v_s + e_st)
    the logits of non-edges filled with the dtype's lowest finite value, so
    a target with no in-edge gets a uniform softmax that is then zeroed and
    keeps only its skip term.  The heads are averaged, or concatenated at
    index h*C + c; the skip ``lin_skip(x)`` is added after.  Returns (B, E,
    C) or (B, E, H*C)."""
    H, C = cfg.gnn_num_heads, cfg.gnn_hidden_size
    B, E, _ = x.shape
    bf16 = cfg.bf16
    qkv_w = torch.cat([tc.lin_query.weight, tc.lin_key.weight, tc.lin_value.weight])
    qkv_b = torch.cat([tc.lin_query.bias, tc.lin_key.bias, tc.lin_value.bias])
    qkv = _gnn_linear(qkv_w, qkv_b, x, bf16)
    # head-major (B, H, E, C)
    qh, kh, vh = (t.reshape(B, E, H, C).transpose(1, 2) for t in qkv.split(H * C, dim=-1))
    w = tc.lin_edge.reshape(H, C).to(qh.dtype)
    d_ts = edge_attr.transpose(1, 2).to(qh.dtype)  # (B, T, S)
    qw = _sum_rounded(qh * w[:, None, :], dim=-1)  # (B, H, T)
    scale = torch.tensor(float(C), dtype=qh.dtype).sqrt().item()
    logits = (qh @ kh.transpose(-1, -2) + qw[..., None] * d_ts[:, None]) / scale
    mask_ts = edge_mask.transpose(1, 2)
    logits = logits.masked_fill(~mask_ts[:, None], torch.finfo(logits.dtype).min)
    alpha = torch.softmax(logits, dim=-1)
    has_edge = mask_ts.any(dim=-1)  # (B, T)
    alpha = alpha.masked_fill(~has_edge[:, None, :, None], 0.0)
    out = alpha @ vh + _sum_rounded(alpha * d_ts[:, None], dim=-1)[..., None] * w[:, None, :]
    if cfg.gnn_concat_heads:
        out = out.transpose(1, 2).reshape(B, E, H * C)
    else:
        out = _sum_rounded(out, dim=1, mean=True)
    return out + _gnn_linear(tc.lin_skip.weight, tc.lin_skip.bias, x, bf16)


def gnn_dense_nodes(cfg: ModelConfig, gnn: GNNBase, node_obs: Tensor, adj: Tensor) -> Tensor:
    """The per-node output of the dense GNNBase (nets.py:355-386): (B, E, F)
    nodes and (B, E, E) adjacency -> (B, E, gnn_out_dim), in bfloat16 under
    ``compute_dtype='bfloat16'``, else in the parameters' dtype."""
    act = torch.relu if cfg.gnn_use_relu else torch.tanh
    cdt = BF16 if cfg.bf16 else gnn.embed_layer.lin1.weight.dtype
    edge_mask, edge_attr = adjacency_mask(adj, cfg.max_edge_dist)
    node_obs, edge_attr = node_obs.to(cdt), edge_attr.to(cdt)
    embed = embed_conv_packed if cfg.gnn_edge_packed else embed_conv_dense
    x = embed(cfg, gnn.embed_layer, node_obs, edge_mask, edge_attr)
    for name in ["gnn1"] + [f"gnn2_{i}" for i in range(cfg.gnn_layer_n)]:
        x = act(transformer_conv_dense(cfg, getattr(gnn, name), x, edge_mask, edge_attr))
    return x


class _DenseNodes(nn.Module):
    """``gnn_dense_nodes`` of one ``GNNBase`` as a module call, for
    ``torch.func.functional_call``."""

    def __init__(self, gnn: GNNBase):
        super().__init__()
        self.gnn = gnn

    def forward(self, node_obs: Tensor, adj: Tensor) -> Tensor:
        return gnn_dense_nodes(self.gnn.cfg, self.gnn, node_obs, adj)


def gnn_dense_nodes_dual(gnn_a: GNNBase, gnn_c: GNNBase, node_obs: Tensor,
                         adj: Tensor) -> tuple[Tensor, Tensor]:
    """The per-node outputs of two dense GNNBases of one structure (the
    actor's and the critic's) on the same graphs in one pass, as the JAX
    package's ``_fused_trunks`` (policy.py:169-208) vmaps one GNNBase over
    their stacked parameters.  Each parameter pair is stacked on a leading
    axis of 2 inside the autograd graph (``torch.stack``), so each side's
    gradient reaches its own module, and ``torch.func.vmap`` maps
    :func:`gnn_dense_nodes` over that axis: each op runs once for both
    networks, its products batched over the side axis.  Returns the two
    (B, E, gnn_out_dim) outputs."""
    pc = dict(gnn_c.named_parameters())
    stacked = {f"gnn.{n}": torch.stack([p, pc[n]]) for n, p in gnn_a.named_parameters()}
    nodes = torch.func.vmap(
        lambda p: torch.func.functional_call(_DenseNodes(gnn_a), p, (node_obs, adj)))(stacked)
    return nodes[0], nodes[1]


def dense_aggregate(x: Tensor, aggr: str, agent_id: Tensor | None) -> Tensor:
    """(B, E, D) node outputs -> (B, D): 'node' gathers the row of
    ``agent_id`` as an exact one-hot product (nets.py:380-389), 'mean',
    'max' and 'add' pool the graph (nets.py:390-396; ``amax`` splits a tied
    maximum's gradient evenly, as ``jnp.max`` does)."""
    if aggr == "node":
        E = x.shape[1]
        onehot = agent_id.reshape(-1, 1).to(torch.long) == torch.arange(E, device=x.device)
        return _sum_rounded(onehot[..., None].to(x.dtype) * x, dim=1)
    if aggr == "mean":
        return _sum_rounded(x, dim=1, mean=True)
    if aggr == "max":
        return x.amax(dim=1)
    if aggr == "add":
        return _sum_rounded(x, dim=1)
    raise ValueError(f"bad aggr {aggr!r}")


def gnn_dense_apply(cfg: ModelConfig, gnn: GNNBase, node_obs: Tensor, adj: Tensor,
                    agent_id: Tensor | None, aggr: str) -> Tensor:
    """GNNBase forward through the dense modules: ``aggr`` 'node' (the row of
    ``agent_id``) or a global pool ('mean'/'max'/'add', which ignores
    ``agent_id``).  Returns (B, gnn_out_dim)."""
    return dense_aggregate(gnn_dense_nodes(cfg, gnn, node_obs, adj), aggr, agent_id)


def _embed_src(ec: EmbedConvParams, node_obs: Tensor) -> Tensor:
    """(B, E, F) node_obs -> (B, E, Ds) EmbedConv input [features,
    Embed(type)] in the table's dtype."""
    table = ec.entity_embed.weight
    etype = node_obs[..., -1].to(torch.long)
    # the embedding lookup as an exact one-hot product: its backward is a
    # reduction, where the gather's backward scatters B*E rows into the
    # table's few rows (on the card that scatter took most of a PPO epoch)
    onehot = (etype[..., None] == torch.arange(table.shape[0], device=etype.device))
    emb = (onehot[..., None].to(table.dtype) * table).sum(dim=-2)
    return torch.cat([node_obs[..., :-1].to(table.dtype), emb], dim=-1)


def _gnn_src_T(gnn: GNNBase, node_obs: Tensor) -> Tensor:
    """(B, E, F) node_obs -> transposed (E*Ds, B) EmbedConv input."""
    B, E, _ = node_obs.shape
    src = _embed_src(gnn.embed_layer, node_obs)
    return src.permute(1, 2, 0).reshape(E * src.shape[-1], B).contiguous()


def _gnn_aggregate(out: Tensor, aggr: str, agent_id: Tensor | None, E: int, C: int,
                   dtype=None) -> Tensor:
    """Transposed (E*C, B) trunk output -> (B, C) per the aggregation, in
    ``dtype`` (the output's own where None): the output is cast first, and
    a mean or sum of bfloat16 accumulates in float32 and rounds once, as
    ``jnp.mean`` and ``jnp.sum`` do."""
    stack = out.reshape(E, C, -1).to(dtype or out.dtype)
    if aggr == "node":
        idx = agent_id.reshape(1, 1, -1).to(torch.long).expand(1, C, stack.shape[-1])
        return torch.gather(stack, 0, idx)[0].T
    if aggr == "mean":
        return _sum_rounded(stack, 0, mean=True).T
    if aggr == "max":
        return stack.amax(dim=0).T
    if aggr == "add":
        return _sum_rounded(stack, 0).T
    raise ValueError(f"bad aggr {aggr!r}")


def _aggr_dtype(cfg: ModelConfig):
    return BF16 if cfg.bf16 else None


def _flatten_gnn_params(gnn: GNNBase, embed_layer_n: int, gnn_layer_n: int) -> tuple:
    """GNNBase parameters -> the flat tuple of the transposed trunk."""
    return gnn_trunk.flatten_gnn_params(gnn.flax_tree(), embed_layer_n, gnn_layer_n)


def _trunk_params(cfg: ModelConfig, gnn: GNNBase, on_card: bool):
    """The trunk parameters in the form the call needs.  With grad: the
    differentiable buffer, whose gradient (the backward kernel's on the card)
    reaches the weights, and the entity embedding's through dsrc.  Without:
    the card's kernel takes the buffer kept across calls, the CPU's plain
    version the flat tuple.  The trunk averages the heads, so concatenated
    heads are refused."""
    if cfg.gnn_concat_heads:
        raise ValueError("the transposed trunk averages the heads: gnn_concat_heads runs "
                         "only the dense modules (gnn_dense_apply)")
    if torch.is_grad_enabled() and gnn.embed_layer.lin1.weight.requires_grad:
        return gnn.grad_params()
    if on_card:
        return gnn.kernel_params()
    return _flatten_gnn_params(gnn, cfg.embed_layer_n, cfg.gnn_layer_n)


def _trunk_dims(cfg: ModelConfig, E: int, Ds: int) -> tuple:
    return (E, Ds, cfg.gnn_num_heads, cfg.gnn_hidden_size, cfg.embed_layer_n, cfg.gnn_layer_n,
            cfg.max_edge_dist, (cfg.embed_use_relu, cfg.gnn_use_relu))


def _adj_T(adj: Tensor) -> Tensor:
    B, E = adj.shape[:2]
    return adj.to(torch.float32).permute(1, 2, 0).reshape(E * E, B).contiguous()


def gnn_transposed_apply(cfg: ModelConfig, gnn: GNNBase, node_obs: Tensor, adj: Tensor,
                         agent_id: Tensor | None, aggr: str) -> Tensor:
    """GNNBase forward in the transposed (entity x feature, batch) layout.

    ``aggr``: 'node' (ego gather via ``agent_id``) or a global pool
    ('mean'/'max'/'add').  Returns (B, C) float32.
    """
    E = node_obs.shape[1]
    src_T = _gnn_src_T(gnn, node_obs)
    out = gnn_trunk.gnn_trunk_forward(
        *_trunk_dims(cfg, E, src_T.shape[0] // E), _trunk_params(cfg, gnn, src_T.is_cuda),
        src_T, _adj_T(adj))
    return _gnn_aggregate(out, aggr, agent_id, E, cfg.gnn_hidden_size, _aggr_dtype(cfg))


def gnn_transposed_apply_dual(cfg: ModelConfig, gnn_actor: GNNBase, gnn_critic: GNNBase,
                              node_obs: Tensor, adj: Tensor, agent_id: Tensor,
                              critic_aggr: str) -> tuple[Tensor, Tensor]:
    """The actor's ('node') and the critic's (global pool ``critic_aggr``)
    GNN trunks on the same graphs in one call of
    ``ops.gnn_trunk.gnn_trunk_dual_forward``: one kernel launch on the card
    for both forwards, and under grad one for both backwards.  Counterpart
    of the JAX package's ``gnn_transposed_apply_dual`` (nets.py:499-525);
    computes what two :func:`gnn_transposed_apply` calls compute.  Returns
    ``(nbd_a, nbd_c)``, each (B, C) float32.  The policy does not call it,
    as the JAX package's policy does not (policy.py:216-219)."""
    E, C = node_obs.shape[1], cfg.gnn_hidden_size
    src_a = _gnn_src_T(gnn_actor, node_obs)
    src_c = _gnn_src_T(gnn_critic, node_obs)
    out_a, out_c = gnn_trunk.gnn_trunk_dual_forward(
        *_trunk_dims(cfg, E, src_a.shape[0] // E), _trunk_params(cfg, gnn_actor, src_a.is_cuda),
        _trunk_params(cfg, gnn_critic, src_a.is_cuda), src_a, src_c, _adj_T(adj))
    dt = _aggr_dtype(cfg)
    return (_gnn_aggregate(out_a, "node", agent_id, E, C, dt),
            _gnn_aggregate(out_c, critic_aggr, None, E, C, dt))
