"""Model hyperparameters, mirroring the reference's network flags (port of
``models/config.py``).

Defaults match ``onpolicy/config.py`` ``get_config`` (hidden_size 64, layer_N
1, ReLU, orthogonal init, gain 0.01, recurrent_N 1) and ``graph_config``
(:409-484: 4 entity-type embeddings of size 2, embed hidden 16, gnn hidden
16, 3 averaged heads, 2 extra conv layers, actor aggr 'node', critic aggr
'global'/mean, use_cent_obs False).

Two GNN formulations compute the trunk, chosen as the JAX package's
policy chooses (``_transposed_routable``, policy.py:237-247; the property
:attr:`ModelConfig.kernel_trunk`):

* the transposed trunk (``gnn_impl`` 'auto', 'transposed' or
  'pallas_fused', which all name it here; 'auto' is recorded as
  'transposed', what the JAX package resolves it to off a TPU): one call of
  ``ops.gnn_trunk.gnn_trunk_forward``, the CUDA kernels on the card and
  their plain versions on the CPU.  It averages the heads, gathers the
  actor's own node and pools the critic's graph, so it serves only actor
  'node', critic 'global' and averaged heads;
* the dense per-graph modules (``gnn_impl='dense'``, or any other
  aggregation or ``gnn_concat_heads``): plain torch on either device,
  as the JAX package's flax modules are plain XLA (``models/nets.py``).
  ``gnn_edge_packed`` selects the dense route's packed edge layout (the
  JAX package's ``EmbedConv`` with ``gnn_edge_packed=True``); the kernel
  trunk ignores it, as the JAX package's transposed route does.

The JAX package's ``resolve_gnn_impl`` and ``apply_entity_envelope`` are
not ported: they choose between TPU implementations.  The critic's 'node'
aggregation is refused: the runner hands the critic N agent ids a row, on
which the JAX package's critic stops at its first collect.

``compute_dtype`` 'bfloat16' is the JAX package's compute dtype.  On the
kernel trunk it takes the semantics of the JAX package's
``gnn_impl='pallas_fused'``: the trunk runs in float32 (the port's kernels
as the JAX package's Pallas kernels), and bfloat16 enters at the trunk
output and in the MLP tails.  On the dense route the trunk itself computes
in bfloat16, as the JAX package's flax modules do (``models/nets.py``).
Parameters stay float32.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    hidden_size: int = 64
    layer_N: int = 1
    use_relu: bool = True
    use_feature_normalization: bool = True
    use_orthogonal: bool = True
    gain: float = 0.01
    use_recurrent_policy: bool = True
    recurrent_n: int = 1
    # EmbedConv follows embed_use_ReLU and the TransformerConv stack follows
    # gnn_use_ReLU (gnn_new.py:66,227,270), independent of the MLP's use_ReLU.
    embed_use_relu: bool = True
    gnn_use_relu: bool = True
    num_embeddings: int = 4
    embedding_size: int = 2
    embed_hidden_size: int = 16
    embed_layer_n: int = 1
    gnn_hidden_size: int = 16
    gnn_num_heads: int = 3
    # heads concatenated (H*C wide) rather than averaged: dense route only
    gnn_concat_heads: bool = False
    gnn_layer_n: int = 2
    # 'node' gathers the agent's own node, 'global' pools the graph by
    # global_aggr_type
    actor_graph_aggr: str = "node"
    critic_graph_aggr: str = "global"
    global_aggr_type: str = "mean"
    use_cent_obs: bool = False
    max_edge_dist: float = 1.0
    # 'float32' or 'bfloat16' (the JAX package's models/config.py:115-119)
    compute_dtype: str = "float32"
    # 'dense' takes the dense per-graph modules; 'auto' (recorded as
    # 'transposed'), 'transposed' and 'pallas_fused' the kernel trunk
    gnn_impl: str = "auto"
    # the packed edge layout of the JAX package's EmbedConv (its group
    # LayerNorm): read by the dense route only, the same parameter tree
    gnn_edge_packed: bool = False

    def __post_init__(self):
        if self.gnn_impl not in ("auto", "dense", "transposed", "pallas_fused"):
            raise ValueError(f"bad gnn_impl {self.gnn_impl!r}")
        if self.gnn_impl == "auto":
            object.__setattr__(self, "gnn_impl", "transposed")
        if self.actor_graph_aggr not in ("node", "global"):
            raise ValueError(f"bad actor_graph_aggr {self.actor_graph_aggr!r}")
        if self.critic_graph_aggr != "global":
            raise ValueError(
                f"critic_graph_aggr={self.critic_graph_aggr!r}: the critic's 'node' "
                "aggregation would take N agent ids a row (the runner gives the critic "
                "every agent's id, the JAX package's share_agent_id of shape (B*N, N)), "
                "and the JAX package's critic stops on them at its first collect "
                "(TypeError: cannot reshape array of shape (N,) into shape ())")
        if self.global_aggr_type not in ("mean", "max", "add"):
            raise ValueError(f"bad global_aggr_type {self.global_aggr_type!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad compute_dtype {self.compute_dtype!r}")

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == "bfloat16"

    @property
    def kernel_trunk(self) -> bool:
        """Whether both GNN trunks run as the transposed kernel trunk (the
        JAX package's ``_transposed_routable``), else the dense modules."""
        return (self.gnn_impl != "dense" and self.actor_graph_aggr == "node"
                and self.critic_graph_aggr == "global" and not self.gnn_concat_heads)

    @property
    def gnn_out_dim(self) -> int:
        return self.gnn_hidden_size * (self.gnn_num_heads if self.gnn_concat_heads else 1)
