"""Network building blocks: MLP trunk, GRU, and the graph trunk (port of
``models/nets.py``).

Module and parameter names follow the JAX package's flax tree
(``base.mlp.fc0``, ``rnn.gru0.w_ih``, ``gnn_base.embed_layer.lin1`` ...), so
``models/convert.py`` maps a flax tree onto a state dict by renaming leaves
(``kernel`` -> ``weight`` transposed, ``scale`` -> ``weight``,
``embedding`` -> ``weight``) and transposing the GRU weights.

The GNN has one formulation here, the transposed trunk of
``gnn_transposed_apply`` (nets.py:527): rows are entity x feature, the batch
is the minor axis, and the whole trunk is one call of
``ops.gnn_trunk.gnn_trunk_forward`` (the CUDA kernel on the card, the plain
version on the CPU).  The JAX package's dense per-graph ``EmbedConv`` /
``TransformerConv`` modules compute the same function and are not ported.

All LayerNorms use eps=1e-5 (torch's default, as in the JAX package).
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
            x = getattr(self, f"ln{i}")(act(getattr(self, f"fc{i}")(x)))
        return x


class MLPBase(nn.Module):
    """Optional feature LayerNorm, then MLPLayer (mlp.py:44-75)."""

    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        if cfg.use_feature_normalization:
            self.feature_norm = nn.LayerNorm(in_dim, eps=LN_EPS)
        self.mlp = MLPLayer(cfg, in_dim)

    def init_(self, gen: torch.Generator) -> None:
        if hasattr(self, "feature_norm"):
            _init_ln(self.feature_norm)
        self.mlp.init_(gen)

    def forward(self, x: Tensor) -> Tensor:
        if hasattr(self, "feature_norm"):
            x = self.feature_norm(x)
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
        HC, C = cfg.gnn_num_heads * cfg.gnn_hidden_size, cfg.gnn_hidden_size
        self.lin_query = nn.Linear(in_dim, HC)
        self.lin_key = nn.Linear(in_dim, HC)
        self.lin_value = nn.Linear(in_dim, HC)
        self.lin_edge = nn.Parameter(torch.empty(1, HC))
        self.lin_skip = nn.Linear(in_dim, C)

    def init_(self, gen: torch.Generator) -> None:
        # PyG's Linear init is glorot; only fresh (untrained) weights use it
        for lin in (self.lin_query, self.lin_key, self.lin_value, self.lin_skip):
            nn.init.xavier_uniform_(lin.weight, generator=gen)
            nn.init.zeros_(lin.bias)
        nn.init.xavier_uniform_(self.lin_edge, generator=gen)


class GNNBase(nn.Module):
    """EmbedConv -> TransformerConv x (1 + gnn_layer_N) -> ego-node gather
    ('node', actor) or global pool ('global', critic), gnn_new.py:148-301,
    420-510, run as the transposed trunk over a batch of graphs."""

    def __init__(self, cfg: ModelConfig, node_feat_dim: int, graph_aggr: str):
        super().__init__()
        self.cfg = cfg
        self.graph_aggr = graph_aggr
        self.embed_layer = EmbedConvParams(cfg, node_feat_dim)
        self.gnn1 = TransformerConvParams(cfg, cfg.embed_hidden_size)
        for i in range(cfg.gnn_layer_n):
            setattr(self, f"gnn2_{i}", TransformerConvParams(cfg, cfg.gnn_hidden_size))
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

    def kernel_params(self) -> gnn_trunk.KernelParams:
        """The trunk kernel's parameter buffer, built straight from these
        weights (stored (out, in), so one transpose each) and kept until one
        of them changes: an in-place update or a load bumps a tensor's
        version, and a move gives it new storage."""
        key = tuple((p.data_ptr(), p._version) for p in self.parameters())
        if key != self._kernel_key:
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
            with torch.no_grad():
                blob = torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)
            self._kernel_params = gnn_trunk.KernelParams(blob, ec.lin1.weight.shape[0])
            self._kernel_key = key
        return self._kernel_params

    def forward(self, node_obs: Tensor, adj: Tensor, agent_id: Tensor | None) -> Tensor:
        aggr = "node" if self.graph_aggr == "node" else self.cfg.global_aggr_type
        return gnn_transposed_apply(self.cfg, self, node_obs, adj, agent_id, aggr)


def _gnn_src_T(gnn: GNNBase, node_obs: Tensor) -> Tensor:
    """(B, E, F) node_obs -> transposed (E*Ds, B) EmbedConv input."""
    B, E, _ = node_obs.shape
    feat = node_obs[..., :-1].to(torch.float32)
    etype = node_obs[..., -1].to(torch.long)
    emb = gnn.embed_layer.entity_embed.weight[etype]
    src = torch.cat([feat, emb], dim=-1)
    return src.permute(1, 2, 0).reshape(E * src.shape[-1], B).contiguous()


def _gnn_aggregate(out: Tensor, aggr: str, agent_id: Tensor | None, E: int, C: int) -> Tensor:
    """Transposed (E*C, B) trunk output -> (B, C) per the aggregation."""
    stack = out.reshape(E, C, -1)
    if aggr == "node":
        idx = agent_id.reshape(1, 1, -1).to(torch.long).expand(1, C, stack.shape[-1])
        return torch.gather(stack, 0, idx)[0].T
    if aggr == "mean":
        return stack.mean(dim=0).T
    if aggr == "max":
        return stack.amax(dim=0).T
    if aggr == "add":
        return stack.sum(dim=0).T
    raise ValueError(f"bad aggr {aggr!r}")


def _flatten_gnn_params(gnn: GNNBase, embed_layer_n: int, gnn_layer_n: int) -> tuple:
    """GNNBase parameters -> the flat tuple of the transposed trunk."""
    return gnn_trunk.flatten_gnn_params(gnn.flax_tree(), embed_layer_n, gnn_layer_n)


def gnn_transposed_apply(cfg: ModelConfig, gnn: GNNBase, node_obs: Tensor, adj: Tensor,
                         agent_id: Tensor | None, aggr: str) -> Tensor:
    """GNNBase forward in the transposed (entity x feature, batch) layout.

    ``aggr``: 'node' (ego gather via ``agent_id``) or a global pool
    ('mean'/'max'/'add').  Returns (B, C) float32.
    """
    B, E, _ = node_obs.shape
    C = cfg.gnn_hidden_size
    src_T = _gnn_src_T(gnn, node_obs)
    Ds = src_T.shape[0] // E
    adj_T = adj.to(torch.float32).permute(1, 2, 0).reshape(E * E, B).contiguous()
    # on the card the kernel takes its buffer, kept across calls; the plain
    # version takes the flat tuple, rebuilt so gradients reach the weights
    params = (gnn.kernel_params() if src_T.is_cuda
              else _flatten_gnn_params(gnn, cfg.embed_layer_n, cfg.gnn_layer_n))
    out = gnn_trunk.gnn_trunk_forward(
        E, Ds, cfg.gnn_num_heads, C, cfg.embed_layer_n, cfg.gnn_layer_n,
        cfg.max_edge_dist, (cfg.embed_use_relu, cfg.gnn_use_relu), params, src_T, adj_T,
    )
    return _gnn_aggregate(out, aggr, agent_id, E, C)
