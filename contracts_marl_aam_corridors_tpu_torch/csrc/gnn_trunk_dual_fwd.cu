// Both GNN trunks (the actor's and the critic's) forward in one launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:703 make_gnn_fused_dual
//   (fwd_kernel, pallas_call at :745)
// and computes what it computes: the pair function f_pair (gnn_pallas.py:694),
// two evaluations of the trunk of csrc/gnn_trunk_fwd.cu that share the
// adjacency and differ in their parameters and EmbedConv inputs.  The plain
// torch version is ops/gnn_trunk.py gnn_trunk_dual_forward_plain.
//
// What bounds it on this card: FP32 arithmetic, as for the single trunk: two
// trunks' operations (ops/gnn_trunk.py dual_work) against two src inputs, one
// adjacency and two outputs, far above the H100's 20 FP32 operations per
// byte.
//
// What the design does about it: each graph is one warp's job and a CTA takes
// G consecutive graphs, with both trunks' parameters staged once per CTA in
// shared memory.  Per tile of graphs the
// CTA reads the adjacency once and keeps the edge mask, the masked distances
// and each target's any-edge factor in shared memory, computed once per graph
// for both trunks (the TPU kernel gets the same sharing from Mosaic's CSE of
// the two trunks' identical mask rows, gnn_pallas.py:686-690).  It then runs
// the actor's trunk and the critic's trunk one after the other on the same
// per-graph scratch, loading each trunk's src and storing each trunk's (E*C)
// output in turn.  Nothing but the inputs and the two outputs touches device
// memory.  The kernel is gnn_trunk_fwd.cuh's template, instantiated for two
// trunks (gnn_trunk_fwd_kernel<2, ...>); the single trunk's forward
// kernel (csrc/gnn_trunk_fwd.cu) is another design, the panel code it
// shares with the backward.
//
// Interface: plain C functions, loaded with ctypes; the launch goes on the
// caller's stream, allocates nothing and returns cudaGetLastError() (or a
// negative code for a configuration it cannot run).

#include "gnn_trunk_fwd.cuh"

extern "C" int gnn_trunk_dual_fwd_config(int E, int Ds, int H, int F1, int C, int n_embed,
                                         int n_tc, int* graphs_per_cta, int* smem_bytes,
                                         int* n_params) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  return configure<2>(d, F1, C, graphs_per_cta, smem_bytes, n_params);
}

extern "C" int gnn_trunk_dual_fwd(const float* src_a_T, const float* src_c_T,
                                  const float* adj_T, const float* params_a,
                                  const float* params_c, float* out_a, float* out_c,
                                  long long B, int E, int Ds, int H, int F1, int C, int n_embed,
                                  int n_tc, float max_edge_dist, int embed_relu, int gnn_relu,
                                  int n_params, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  const TrunkPtrs<2> t{{src_a_T, src_c_T}, {params_a, params_c}, {out_a, out_c}};
  return launch_forward<2>(t, adj_T, B, d, F1, C, max_edge_dist, embed_relu, gnn_relu,
                           n_params, stream);
}
