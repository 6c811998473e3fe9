// Both GNN trunks (the actor's and the critic's) backward in one launch, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py:712 make_gnn_fused_dual
//   (bwd_kernel, pallas_call at :768)
// and computes what it computes: for the cotangents ga and gc of the two
// (E*C, B) outputs, the vjp of the pair function f_pair (gnn_pallas.py:694)
// with respect to both parameter sets (summed over the batch), both EmbedConv
// inputs and the shared adjacency, whose gradient is the sum of the two
// trunks'.  The plain torch version is ops/gnn_trunk.py
// gnn_trunk_dual_backward_plain (torch.autograd.grad of the plain pair).
//
// What bounds it on this card: operations, as for the single backward
// (ops/gnn_trunk.py dual_bwd_work: two trunks' recomputed forward and vjp,
// 58.5 GFLOP at the update's 76,800 graphs, 0.873 ms at the FP32 peak of 67
// TFLOP/s, against about 2.2 KB of inputs and outputs a graph); the q/k/v,
// dX and dW products run on the tensor cores in 3xTF32.
//
// What the design does about it: it runs the single backward's device code
// (csrc/gnn_trunk_bwd.cuh; csrc/gnn_trunk_bwd.cu's note gives the layout,
// the shared memory, the graphs a CTA and the CTAs an SM at E = 6, 10 and
// 20, which are this kernel's too) for each trunk in turn, compiled once
// out of line: 255 registers and no spills on the H100, where the inlined
// code spilled 420 bytes and the launch took about 17% longer.  Per tile of
// graphs the CTA reads the adjacency once, keeps the masked distances for
// both trunks, and runs the actor's backward and then the critic's in the
// same panels; the distance gradient accumulates across both, actor first.
// The tile plan depends on the dimensions and the device only, so this
// kernel tiles a batch as the single backward does, and each trunk's
// parameter gradients (in the CTA's row of the (CTAs, 2 n_params) scratch
// buffer, actor then critic) and dsrc equal two single launches' bit for
// bit.  A second small kernel sums the rows in row order, so the
// gradients are the same from run to run.
//
// Interface: plain C functions, loaded with ctypes; they launch on the
// caller's stream, allocate nothing and return cudaGetLastError() (or a
// negative code for a configuration they cannot run).

#include "gnn_trunk_bwd.cuh"

namespace {

__global__ void __launch_bounds__(kMaxThreads)
    gnn_trunk_dual_bwd_kernel(const float* __restrict__ src_a_T,
                              const float* __restrict__ src_c_T,
                              const float* __restrict__ adj_T, const float* __restrict__ g_a_T,
                              const float* __restrict__ g_c_T,
                              const float* __restrict__ params_a,
                              const float* __restrict__ params_c,
                              float* __restrict__ dsrc_a_T, float* __restrict__ dsrc_c_T,
                              float* __restrict__ dadj_T, float* partial, long long B, Dims d,
                              float max_edge_dist, int embed_relu, int gnn_relu, int nb) {
  Trunks<2> tr;
  tr.t[0] = {src_a_T, g_a_T, params_a, dsrc_a_T};
  tr.t[1] = {src_c_T, g_c_T, params_c, dsrc_c_T};
  backward_ctas<2>(tr, adj_T, dadj_T, partial, B, d, max_edge_dist, embed_relu, gnn_relu, nb);
}

}  // namespace

// Graphs per CTA, dynamic shared memory, parameter count of one trunk, and
// the CTAs a launch over B graphs uses (the rows of the (CTAs, 2 n_params)
// scratch buffer it needs).
extern "C" int gnn_trunk_dual_bwd_config(int E, int Ds, int H, int F1, int C, int n_embed,
                                         int n_tc, long long B, int* graphs_per_cta,
                                         int* smem_bytes, int* n_params, int* grid) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  Plan plan;
  const int rc = grid_for(gnn_trunk_dual_bwd_kernel, d, F1, C, B, &plan, grid);
  if (rc != 0) return rc;
  *graphs_per_cta = plan.nb;
  *smem_bytes = plan.smem;
  *n_params = ParamLayout(d).total;
  return 0;
}

// As gnn_trunk_bwd_attributes, for this kernel.
extern "C" int gnn_trunk_dual_bwd_attributes(int E, int Ds, int H, int F1, int C, int n_embed,
                                             int n_tc, int* threads, int* regs,
                                             int* local_bytes, int* ctas_per_sm,
                                             int* planned_per_sm) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  return kernel_attributes(gnn_trunk_dual_bwd_kernel, d, F1, C, threads, regs, local_bytes,
                           ctas_per_sm, planned_per_sm);
}

// dparams gets 2 n_params floats: the actor's gradient, then the critic's.
extern "C" int gnn_trunk_dual_bwd(const float* src_a_T, const float* src_c_T, const float* adj_T,
                                  const float* g_a_T, const float* g_c_T, const float* params_a,
                                  const float* params_c, float* dsrc_a_T, float* dsrc_c_T,
                                  float* dadj_T, float* dparams, float* partial, long long B,
                                  int E, int Ds, int H, int F1, int C, int n_embed, int n_tc,
                                  float max_edge_dist, int embed_relu, int gnn_relu,
                                  int n_params, int partial_rows, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  if (B < 1) return -8;
  Plan plan;
  int grid = 0;
  const int rc = grid_for(gnn_trunk_dual_bwd_kernel, d, F1, C, B, &plan, &grid);
  if (rc != 0) return rc;
  const int np = ParamLayout(d).total;
  if (np != n_params) return -5;
  if (grid > partial_rows) return -7;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  gnn_trunk_dual_bwd_kernel<<<grid, plan.threads, plan.smem, st>>>(
      src_a_T, src_c_T, adj_T, g_a_T, g_c_T, params_a, params_c, dsrc_a_T, dsrc_c_T, dadj_T,
      partial, B, d, max_edge_dist, embed_relu, gnn_relu, plan.nb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_rows_kernel<<<(2 * np + 255) / 256, 256, 0, st>>>(partial, dparams, grid, 2 * np);
  return (int)cudaGetLastError();
}
