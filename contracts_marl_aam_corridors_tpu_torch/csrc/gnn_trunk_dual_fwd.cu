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
// What bounds it on this card: operations, as for the single trunk: two
// trunks' (ops/gnn_trunk.py dual_work) against two src inputs, one
// adjacency and two outputs, far above the H100's 20 FP32 operations a
// byte.
//
// What the design does about it: it runs the one-trunk forward's body
// (forward_ctas of csrc/gnn_trunk_panel.cuh, with NT = 2) and its plan
// (forward_plan): the same tiles of graphs, shared memory, threads a row
// and q/k/v products on the tensor cores as a launch of
// csrc/gnn_trunk_fwd.cu.  The plan chooses, from B and the card, how the
// two trunks meet the grid (PERF.md §6 has both ways measured):
// - In turn (the update's 76,800 graphs): a CTA reads each of its tiles'
//   adjacency and masks it into the distance plane once, then runs the
//   actor's trunk and the critic's, each staging its own weights, loading
//   its own src and storing its own output.  The TPU kernel gets the same
//   sharing from Mosaic's CSE of the two trunks' identical mask rows
//   (gnn_pallas.py:686-690).
// - On the grid: CTA c runs trunk c % 2 of its tiles, masking them itself.
//   Where the tiles fill a little more than one round of the card's CTAs
//   (the rollout's 12,288 graphs: 293 tiles of 42 on 264 CTAs) this takes
//   3 rounds of one trunk where in turn takes 2 of both.  Where the batch
//   has fewer tiles than the card holds CTAs (the evaluation's 768 and
//   3,072 graphs) one tile's latency sets the time, and the two trunks then
//   run at once, two CTAs an SM, each row split over the threads that fit
//   half an SM's 512.
// Each trunk runs exactly the device code of a one-trunk launch, and no
// graph's result depends on its tile, NB or the split, so each trunk's
// output equals a launch of csrc/gnn_trunk_fwd.cu on it, bit for bit.  The
// kernel has a name of its own, gnn_trunk_dual_fwd_panel_kernel<S>.
//
// Interface: plain C functions, loaded with ctypes; the launch goes on the
// caller's stream, allocates nothing and returns cudaGetLastError() (or a
// negative code for a configuration it cannot run).

#include "gnn_trunk_panel.cuh"

namespace {

template <int S>
__global__ void __launch_bounds__(S == 1 ? kFwdThreads : kSplitThreads, S == 1 ? kFwdMinCtas : 1)
    gnn_trunk_dual_fwd_panel_kernel(const FwdTrunks<2> tr,
                                    const float* __restrict__ adj_T, long long B, Dims d,
                                    float max_edge_dist, int embed_relu, int gnn_relu, int nb,
                                    int grid_trunks) {
  forward_ctas<S, 2>(tr, adj_T, B, d, max_edge_dist, embed_relu, gnn_relu, nb, grid_trunks);
}

using DualFwdKernel = decltype(&gnn_trunk_dual_fwd_panel_kernel<1>);

// The kernel of a plan's split.
DualFwdKernel dual_fwd_kernel(int split) {
  return split == 8   ? gnn_trunk_dual_fwd_panel_kernel<8>
         : split == 4 ? gnn_trunk_dual_fwd_panel_kernel<4>
         : split == 2 ? gnn_trunk_dual_fwd_panel_kernel<2>
                      : gnn_trunk_dual_fwd_panel_kernel<1>;
}

}  // namespace

// As gnn_trunk_fwd_config (parameter count of one trunk), and whether the
// plan puts the trunk on the grid (1) or runs both trunks of a tile in one
// CTA (0).
extern "C" int gnn_trunk_dual_fwd_config(int E, int Ds, int H, int F1, int C, int n_embed,
                                         int n_tc, long long B, int* graphs_per_cta,
                                         int* threads_per_row, int* smem_bytes, int* n_params,
                                         int* grid, int* trunk_on_grid) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  const int rc = forward_plan(dual_fwd_kernel, 2, d, F1, C, B, &plan, grid);
  if (rc != 0) return rc;
  *graphs_per_cta = plan.nb;
  *threads_per_row = plan.split;
  *smem_bytes = plan.smem;
  *n_params = ParamLayout(d).total;
  *trunk_on_grid = plan.grid_trunks > 1;
  return 0;
}

// As gnn_trunk_fwd_attributes, for this kernel.
extern "C" int gnn_trunk_dual_fwd_attributes(int E, int Ds, int H, int F1, int C, int n_embed,
                                             int n_tc, long long B, int* threads, int* regs,
                                             int* local_bytes, int* ctas_per_sm,
                                             int* planned_per_sm) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  int grid = 0;
  const int rc = forward_plan(dual_fwd_kernel, 2, d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  return kernel_attributes(dual_fwd_kernel(plan.split), plan, threads, regs, local_bytes,
                           ctas_per_sm, planned_per_sm);
}

extern "C" int gnn_trunk_dual_fwd(const float* src_a_T, const float* src_c_T,
                                  const float* adj_T, const float* params_a,
                                  const float* params_c, float* out_a, float* out_c,
                                  long long B, int E, int Ds, int H, int F1, int C, int n_embed,
                                  int n_tc, float max_edge_dist, int embed_relu, int gnn_relu,
                                  int n_params, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  int grid = 0;
  const int rc = forward_plan(dual_fwd_kernel, 2, d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  if (ParamLayout(d).total != n_params) return -5;
  dual_fwd_kernel(plan.split)<<<grid, plan.threads, plan.smem,
                                static_cast<cudaStream_t>(stream)>>>(
      FwdTrunks<2>{{{src_a_T, params_a, out_a}, {src_c_T, params_c, out_c}}}, adj_T, B, d,
      max_edge_dist, embed_relu, gnn_relu, plan.nb, plan.grid_trunks);
  return (int)cudaGetLastError();
}
