// GNN trunk forward (EmbedConv + TransformerConv stack) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:299 make_gnn_forward
// and computes what it computes (the function of xla_transposed_forward,
// gnn_pallas.py:487): per graph, the edge mask 0 < d < max_edge_dist, the
// EmbedConv edge messages act(W1 src_s + b1 + d w_e) -> LN -> embed_layer_n x
// (Linear -> act -> LN) summed over masked sources, then 1 + gnn_layer_n
// TransformerConv layers (fused QKV, logits q.(k + d w_e)/sqrt(C) masked to
// -FLT_MAX, softmax over sources with zero weight for a node without
// in-edges, sum a v + (sum a d) w_e, mean over heads, skip Linear, act).
// The plain torch version is ops/gnn_trunk.py gnn_trunk_forward_plain.
//
// What bounds it on this card: operations.  At the default widths (E = 6
// entities, Ds = 9, F1 = C = 16, H = 3, one embed layer, three conv layers)
// a rollout graph (24 unmasked edges) needs about 143K floating-point
// operations (ops/gnn_trunk.py trunk_work) against 744 bytes of inputs and
// output: some 190 operations a byte, far above the H100's 20 FP32
// operations a byte.  The q/k/v projections are about 60% of them.
//
// What the design does about it: it runs the panel code it shares with the
// dual forward and the backward kernels (csrc/gnn_trunk_panel.cuh, which
// describes the layout and holds the CTA loop, forward_ctas, and the plan,
// forward_plan; this file is the entry points, one trunk a launch).
// - Graphs as the panel dimension.  A CTA owns NB consecutive graphs and
//   row m = e*NB + b entity e of graph b; the q/k/v projection is a product
//   with M = E*NB rows, warp-tiled m16n8k8 mma.sync in 3xTF32 on the tensor
//   cores (prod_qkv).  The skip Linear is each thread's own FP32 dot
//   products on the CUDA cores: in 3xTF32 the output lay up to 2.3x as far
//   from a float64 evaluation as the plain version's, over the forward bar
//   of 2x (PERF.md §2, §6), since the skip reaches the output directly
//   where q/k/v errors pass through the softmax's average.  The EmbedConv
//   edge chains, the masked softmax with its any-edge factor and the
//   weighted values are per-row loops over the graph's entities.
// - Its own shared-memory plan: the weights of one layer at a time (the
//   EmbedConv's, then each conv layer's, 11.6 KB at the defaults), staged
//   by cp.async so a thread's copies do not wait for one another, the
//   masked distances and the attention weights (one E x E plane each), two
//   x panels used in turn (layer l reads one and writes the other) and the
//   q/k/v scratch of one head; the backward's gradient planes and its n_tc
//   kept inputs are not needed.  About 2.3 KB a graph at E = 6.  Staging
//   the whole blob once per CTA instead was slower (PERF.md §6): its 37 KB
//   cost graphs an SM.
// - The launch plan (forward_plan): NB is whatever puts the most graphs on
//   an SM by shared memory, threads (at most 256 a CTA) and registers at the
//   launch bound (128 a thread, two CTAs of 256 threads an SM).  Where a
//   batch has fewer tiles than the card holds CTAs (the evaluation's 768
//   and 3,072 graphs), one tile's latency, not the card's throughput, sets
//   the time: the plan then spreads tiles of about B / SMs graphs, one CTA
//   an SM, and splits each row over the most threads S (8, 4 or 2; the
//   kernel's template parameter) that fit a CTA of 512, each with its
//   share of the channels and of the per-source loops.  No graph's result
//   depends on its tile, NB or S (every sum keeps the order of S = 1), so
//   all plans give the same bits.  The grid is persistent: all the CTAs
//   the card holds at once, or one a tile where there are fewer tiles.
//
// Interface: plain C functions, loaded with ctypes; the launch goes on the
// caller's stream, allocates nothing and returns cudaGetLastError() (or a
// negative code for a configuration it cannot run: embed and gnn widths
// other than 16, more than 32 entities, or more shared memory than a CTA
// may take).

#include "gnn_trunk_panel.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(S == 1 ? kFwdThreads : kSplitThreads, S == 1 ? kFwdMinCtas : 1)
    gnn_trunk_fwd_panel_kernel(const float* __restrict__ src_T, const float* __restrict__ adj_T,
                               const float* __restrict__ params, float* __restrict__ out,
                               long long B, Dims d, float max_edge_dist, int embed_relu,
                               int gnn_relu, int nb) {
  const FwdTrunks<1> tr{{{src_T, params, out}}};
  forward_ctas<S, 1>(tr, adj_T, B, d, max_edge_dist, embed_relu, gnn_relu, nb, 1);
}

using FwdKernel = decltype(&gnn_trunk_fwd_panel_kernel<1>);

// The kernel of a plan's split.
FwdKernel fwd_kernel(int split) {
  return split == 8   ? gnn_trunk_fwd_panel_kernel<8>
         : split == 4 ? gnn_trunk_fwd_panel_kernel<4>
         : split == 2 ? gnn_trunk_fwd_panel_kernel<2>
                      : gnn_trunk_fwd_panel_kernel<1>;
}

}  // namespace

// Graphs per CTA, threads a row, dynamic shared memory, parameter count,
// and the CTAs a launch over B graphs uses.
extern "C" int gnn_trunk_fwd_config(int E, int Ds, int H, int F1, int C, int n_embed, int n_tc,
                                    long long B, int* graphs_per_cta, int* threads_per_row,
                                    int* smem_bytes, int* n_params, int* grid) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  const int rc = forward_plan(fwd_kernel, 1, d, F1, C, B, &plan, grid);
  if (rc != 0) return rc;
  *graphs_per_cta = plan.nb;
  *threads_per_row = plan.split;
  *smem_bytes = plan.smem;
  *n_params = ParamLayout(d).total;
  return 0;
}

// Threads a CTA, registers and local memory a thread, the CTAs an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor) and the CTAs an SM the
// plan of a launch over B graphs counts (by shared memory, threads and
// registers), for the kernel that plan launches.
extern "C" int gnn_trunk_fwd_attributes(int E, int Ds, int H, int F1, int C, int n_embed,
                                        int n_tc, long long B, int* threads, int* regs,
                                        int* local_bytes, int* ctas_per_sm,
                                        int* planned_per_sm) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  int grid = 0;
  const int rc = forward_plan(fwd_kernel, 1, d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  return kernel_attributes(fwd_kernel(plan.split), plan, threads, regs, local_bytes,
                           ctas_per_sm, planned_per_sm);
}

extern "C" int gnn_trunk_fwd(const float* src_T, const float* adj_T, const float* params,
                             float* out, long long B, int E, int Ds, int H, int F1, int C,
                             int n_embed, int n_tc, float max_edge_dist, int embed_relu,
                             int gnn_relu, int n_params, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  int grid = 0;
  const int rc = forward_plan(fwd_kernel, 1, d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  if (ParamLayout(d).total != n_params) return -5;
  fwd_kernel(plan.split)<<<grid, plan.threads, plan.smem, static_cast<cudaStream_t>(stream)>>>(
      src_T, adj_T, params, out, B, d, max_edge_dist, embed_relu, gnn_relu, plan.nb);
  return (int)cudaGetLastError();
}
