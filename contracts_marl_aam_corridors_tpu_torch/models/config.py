"""Model hyperparameters, mirroring the reference's network flags (port of
``models/config.py``).

Defaults match ``onpolicy/config.py`` ``get_config`` (hidden_size 64, layer_N
1, ReLU, orthogonal init, gain 0.01, recurrent_N 1) and ``graph_config``
(:409-484: 4 entity-type embeddings of size 2, embed hidden 16, gnn hidden
16, 3 averaged heads, 2 extra conv layers, actor aggr 'node', critic aggr
'global'/mean, use_cent_obs False).

There is no trunk-implementation switch: the port has one trunk
formulation, the transposed one, and the device of its tensors decides
between the CUDA kernel and the plain version (``ops/gnn_trunk.py``).  That
formulation averages the heads, gathers the actor's own node and pools the
critic's graph, so the JAX package's ``gnn_concat_heads`` and
``actor/critic_graph_aggr`` fields, which select the dense per-graph GNN,
are absent.

``compute_dtype`` 'bfloat16' is the JAX package's compute dtype under its
``gnn_impl='pallas_fused'`` trunk: the trunk runs in float32 whatever the
compute dtype (the port's kernels as the JAX package's Pallas kernels), and
bfloat16 enters at the trunk output and in the MLP tails
(``models/nets.py``).  Parameters stay float32.
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
    gnn_layer_n: int = 2
    # the critic's pool over nodes; the actor gathers its own node
    global_aggr_type: str = "mean"
    use_cent_obs: bool = False
    max_edge_dist: float = 1.0
    # 'float32' or 'bfloat16' (the JAX package's models/config.py:115-119)
    compute_dtype: str = "float32"

    def __post_init__(self):
        if self.global_aggr_type not in ("mean", "max", "add"):
            raise ValueError(f"bad global_aggr_type {self.global_aggr_type!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"bad compute_dtype {self.compute_dtype!r}")

    @property
    def bf16(self) -> bool:
        return self.compute_dtype == "bfloat16"

    @property
    def gnn_out_dim(self) -> int:
        return self.gnn_hidden_size
