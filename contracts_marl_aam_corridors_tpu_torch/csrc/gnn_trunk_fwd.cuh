// Device code of the dual-trunk forward, csrc/gnn_trunk_dual_fwd.cu (the
// actor and critic trunks in one launch): the per-graph shared-memory
// layout, the parameter count, the one-warp forward of one graph, the
// per-device launch plan, and the kernel, its configuration and its launch,
// each a template over the number of trunks that share one adjacency.  It
// serves the dual forward alone: the single trunk's forward
// (csrc/gnn_trunk_fwd.cu) runs the panel code of csrc/gnn_trunk_panel.cuh,
// and this header stays until the dual forward moves onto that code too
// (ROADMAP B7).
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <mutex>

namespace {

constexpr int kWarp = 32;
// The one (embed hidden, gnn hidden) width pair instantiated: every model
// configuration of the repo uses 16/16.
constexpr int kWidth = 16;
constexpr int kMaxEntities = 32;
constexpr int kMaxEmbedLayers = 4;
constexpr int kMaxTcLayers = 8;
constexpr int kMaxGraphsPerCta = 8;
constexpr int kSmemLimit = 232448;  // 227 KB a block can request on sm_90
constexpr float kNeg = -FLT_MAX;    // finfo(float32).min
constexpr float kLnEps = 1e-5f;

struct Dims {
  int E, Ds, H, n_embed, n_tc;
};

// Per-graph scratch in shared memory, in floats.
struct Layout {
  int dm, mk, ae, src, hsrc, x, work, logit, obuf, size;
  __host__ __device__ Layout(const Dims& d, int F1, int C) {
    const int XW = F1 > C ? F1 : C;
    const int qkv = d.E * 3 * d.H * C;
    const int stage = kWarp * (F1 + 1);
    int w = qkv > stage ? qkv : stage;
    w = w > d.E * C ? w : d.E * C;
    dm = 0;
    mk = dm + d.E * d.E;
    ae = mk + d.E * d.E;
    src = ae + d.E;
    hsrc = src + d.E * d.Ds;
    x = hsrc + d.E * F1;
    work = x + d.E * XW;
    logit = work + w;
    obuf = logit + d.E * d.H * d.E;
    size = obuf + d.E * d.H * C;
    size += (size & 1) ? 0 : 1;  // odd stride: warps' tiles start on different banks
  }
};

__host__ __device__ int param_count(const Dims& d, int F1, int C) {
  const int QKV = 3 * d.H * C;
  int n = d.Ds * F1 + 4 * F1 + d.n_embed * (F1 * F1 + 3 * F1);
  int cin = F1;
  for (int l = 0; l < d.n_tc; ++l) {
    n += cin * QKV + QKV + d.H * C + cin * C + C;
    cin = C;
  }
  return n;
}

__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : tanhf(v);
}

// LayerNorm over one lane's F values (mean, then mean of squared deviations).
template <int F>
__device__ __forceinline__ void layer_norm(float (&m)[F], const float* scale,
                                           const float* bias) {
  float mu = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) mu += m[f];
  mu = mu / F;
  float var = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float dv = m[f] - mu;
    var += dv * dv;
  }
  var = var / F;
  const float r = 1.f / sqrtf(var + kLnEps);
#pragma unroll
  for (int f = 0; f < F; ++f) m[f] = (m[f] - mu) * r * scale[f] + bias[f];
}

// The any-edge factor of each target of one graph (1 where the target has an
// in-edge, else 0), from the graph's edge mask; one warp.
__device__ __forceinline__ void any_edge_rows(float* g, const Layout& L, const Dims& d,
                                              int lane) {
  const float* mk = g + L.mk;
  for (int t = lane; t < d.E; t += kWarp) {
    float a = 0.f;
    for (int s = 0; s < d.E; ++s) a = fmaxf(a, mk[s * d.E + t]);
    g[L.ae + t] = a;
  }
  __syncwarp();
}

// One graph, one warp.  `g` holds the graph's src, masked adjacency and
// any-edge rows on entry and its output rows in `x` on exit.
template <int F1, int C>
__device__ void graph_forward(float* g, const float* P, const Layout& L, const Dims& d,
                              int embed_relu, int gnn_relu, int lane) {
  constexpr int XW = F1 > C ? F1 : C;
  const int E = d.E, Ds = d.Ds, H = d.H;
  const float* dm = g + L.dm;
  const float* mk = g + L.mk;
  const float* ae = g + L.ae;
  const float* src = g + L.src;
  float* hsrc = g + L.hsrc;
  float* x = g + L.x;
  float* work = g + L.work;
  float* lg = g + L.logit;
  float* ob = g + L.obuf;

  const float* cur = P;
  const float* W1T = cur;
  cur += Ds * F1;
  const float* b1 = cur;
  cur += F1;
  const float* we1 = cur;
  cur += F1;
  const float* ln1s = cur;
  cur += F1;
  const float* ln1b = cur;
  cur += F1;
  const float* embed_params = cur;
  cur += d.n_embed * (F1 * F1 + 3 * F1);

  // lin1 of every source entity
  for (int i = lane; i < E * F1; i += kWarp) {
    const int s = i / F1, f = i % F1;
    float acc = 0.f;
    for (int k = 0; k < Ds; ++k) acc = fmaf(W1T[k * F1 + f], src[s * Ds + k], acc);
    hsrc[i] = acc + b1[f];
  }
  __syncwarp();

  // EmbedConv: lane = (target in this round, source), one edge message each
  const int tpr = kWarp / E;
  for (int t0 = 0; t0 < E; t0 += tpr) {
    const int tl = lane / E, s = lane % E, t = t0 + tl;
    if (tl < tpr && t < E) {
      const float dv = dm[s * E + t], mv = mk[s * E + t];
      float m[F1];
#pragma unroll
      for (int f = 0; f < F1; ++f) m[f] = act(hsrc[s * F1 + f] + dv * we1[f], embed_relu);
      layer_norm<F1>(m, ln1s, ln1b);
      const float* lp = embed_params;
      for (int l = 0; l < d.n_embed; ++l) {
        const float* WT = lp;
        const float* bb = WT + F1 * F1;
        const float* lns = bb + F1;
        const float* lnb = lns + F1;
        float nm[F1];
#pragma unroll
        for (int f = 0; f < F1; ++f) {
          float acc = 0.f;
#pragma unroll
          for (int k = 0; k < F1; ++k) acc = fmaf(WT[k * F1 + f], m[k], acc);
          nm[f] = act(acc + bb[f], embed_relu);
        }
        layer_norm<F1>(nm, lns, lnb);
#pragma unroll
        for (int f = 0; f < F1; ++f) m[f] = nm[f];
        lp += F1 * F1 + 3 * F1;
      }
      float* row = work + lane * (F1 + 1);
#pragma unroll
      for (int f = 0; f < F1; ++f) row[f] = mv * m[f];
    }
    __syncwarp();
    const int nt = min(tpr, E - t0);
    for (int i = lane; i < nt * F1; i += kWarp) {
      const int tt = i / F1, f = i % F1;
      float acc = 0.f;
      for (int s2 = 0; s2 < E; ++s2) acc += work[(tt * E + s2) * (F1 + 1) + f];
      x[(t0 + tt) * XW + f] = acc;
    }
    __syncwarp();
  }

  // TransformerConv stack
  const int HC = H * C, QKV = 3 * HC;
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  int cin = F1;
  for (int l = 0; l < d.n_tc; ++l) {
    const float* WqkvT = cur;
    cur += cin * QKV;
    const float* bqkv = cur;
    cur += QKV;
    const float* we = cur;
    cur += HC;
    const float* WskT = cur;
    cur += cin * C;
    const float* bsk = cur;
    cur += C;

    for (int i = lane; i < E * QKV; i += kWarp) {
      const int e = i / QKV, j = i % QKV;
      float acc = 0.f;
      for (int k = 0; k < cin; ++k) acc = fmaf(WqkvT[k * QKV + j], x[e * XW + k], acc);
      work[i] = acc + bqkv[j];
    }
    __syncwarp();

    // lane = (target, head): masked softmax over sources, weighted values
    for (int i = lane; i < E * H; i += kWarp) {
      const int t = i / H, h = i % H;
      const float* q = work + t * QKV + h * C;
      const float* weh = we + h * C;
      float* li = lg + i * E;
      float mx = -INFINITY;
      for (int s = 0; s < E; ++s) {
        const float* kk = work + s * QKV + HC + h * C;
        const float dv = dm[s * E + t];
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) acc = fmaf(q[c], kk[c] + dv * weh[c], acc);
        const float mv = mk[s * E + t];
        const float lv = mv > 0.f ? acc * inv_sqrt_c : kNeg;
        li[s] = lv;
        mx = fmaxf(mx, lv);
      }
      float sum = 0.f;
      for (int s = 0; s < E; ++s) {
        const float ex = expf(li[s] - mx);
        li[s] = ex;
        sum += ex;
      }
      float o[C];
#pragma unroll
      for (int c = 0; c < C; ++c) o[c] = 0.f;
      float ad = 0.f;
      for (int s = 0; s < E; ++s) {
        const float a = li[s] / sum * ae[t];
        const float* vv = work + s * QKV + 2 * HC + h * C;
#pragma unroll
        for (int c = 0; c < C; ++c) o[c] = fmaf(a, vv[c], o[c]);
        ad = fmaf(a, dm[s * E + t], ad);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) ob[i * C + c] = o[c] + ad * weh[c];
    }
    __syncwarp();

    // mean over heads + skip Linear + act; old x is read, so write to work
    for (int i = lane; i < E * C; i += kWarp) {
      const int t = i / C, c = i % C;
      float hs = 0.f;
      for (int h = 0; h < H; ++h) hs += ob[(t * H + h) * C + c];
      float sk = 0.f;
      for (int k = 0; k < cin; ++k) sk = fmaf(WskT[k * C + c], x[t * XW + k], sk);
      work[i] = act(hs / (float)H + sk + bsk[c], gnn_relu);
    }
    __syncwarp();
    for (int i = lane; i < E * C; i += kWarp) x[(i / C) * XW + i % C] = work[i];
    __syncwarp();
    cin = C;
  }
}

// Resident CTAs on the whole card for one (threads, shared memory) launch
// shape, worked out at a device's first launch of that shape and kept, so a
// launch costs no attribute call or occupancy query after the first.
struct LaunchPlan {
  int threads = 0, smem = 0;
  long long ctas = 0;
};
constexpr int kMaxDevices = 64;
LaunchPlan g_plans[kMaxDevices];
std::mutex g_plans_mutex;

template <typename Kernel>
int plan_launch(Kernel kernel, int threads, int smem, long long* ctas) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return -6;
  std::lock_guard<std::mutex> lock(g_plans_mutex);
  LaunchPlan& plan = g_plans[dev];
  if (plan.threads == threads && plan.smem == smem) {
    *ctas = plan.ctas;
    return 0;
  }
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) !=
      cudaSuccess)
    return (int)err;
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  plan = {threads, smem, (long long)sms * (per_sm > 0 ? per_sm : 1)};
  *ctas = plan.ctas;
  return 0;
}


// Per-trunk pointers of a launch over NETS trunks that share one adjacency.
template <int NETS>
struct TrunkPtrs {
  const float* src_T[NETS];
  const float* params[NETS];
  float* out[NETS];
};

// NETS trunks' forward over tiles of G consecutive graphs, one warp a graph.
// Each trunk's parameters are staged once per CTA in shared memory.  Per tile
// the CTA reads the adjacency once and keeps the edge mask, the masked
// distances and each target's any-edge factor for every trunk; it then runs
// the trunks one after the other on the same per-graph scratch, loading each
// trunk's src and storing each trunk's (E*C) output in turn.
template <int NETS, int F1, int C>
__global__ void __launch_bounds__(kWarp* kMaxGraphsPerCta)
    gnn_trunk_fwd_kernel(TrunkPtrs<NETS> t, const float* __restrict__ adj_T, long long B,
                         Dims d, float max_edge_dist, int embed_relu, int gnn_relu,
                         int n_params, int G) {
  constexpr int XW = F1 > C ? F1 : C;
  extern __shared__ float smem[];
  const Layout L(d, F1, C);
  const int npad = (n_params + 31) & ~31;
  float* tiles = smem + NETS * npad;
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) {
#pragma unroll
    for (int net = 0; net < NETS; ++net) smem[net * npad + i] = __ldg(t.params[net] + i);
  }
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int E = d.E, n_src = E * d.Ds, n_adj = E * E, n_out = E * C;
  for (long long b0 = (long long)blockIdx.x * G; b0 < B; b0 += (long long)gridDim.x * G) {
    // G consecutive graphs per row: whole sectors of the batch-minor inputs
    for (int i = threadIdx.x; i < n_adj * G; i += blockDim.x) {
      const int r = i / G, k = i % G;
      const long long b = b0 + k;
      const float dv = b < B ? adj_T[r * B + b] : 0.f;
      const float mv = (dv > 0.f && dv < max_edge_dist) ? 1.f : 0.f;
      tiles[k * L.size + L.mk + r] = mv;
      tiles[k * L.size + L.dm + r] = dv * mv;
    }
    for (int net = 0; net < NETS; ++net) {
      for (int i = threadIdx.x; i < n_src * G; i += blockDim.x) {
        const int r = i / G, k = i % G;
        const long long b = b0 + k;
        tiles[k * L.size + L.src + r] = b < B ? __ldg(t.src_T[net] + r * B + b) : 0.f;
      }
      __syncthreads();
      if (b0 + warp < B) {
        if (net == 0) any_edge_rows(tiles + warp * L.size, L, d, lane);
        graph_forward<F1, C>(tiles + warp * L.size, smem + net * npad, L, d, embed_relu,
                             gnn_relu, lane);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < n_out * G; i += blockDim.x) {
        const int r = i / G, k = i % G;
        const long long b = b0 + k;
        if (b < B) t.out[net][r * B + b] = tiles[k * L.size + L.x + (r / C) * XW + r % C];
      }
      __syncthreads();
    }
  }
}

// Graphs per CTA and dynamic shared memory of a NETS-trunk launch: every
// trunk's parameters stay in shared memory beside the graphs' scratch.
template <int NETS>
int configure(const Dims& d, int F1, int C, int* graphs_per_cta, int* smem_bytes,
              int* n_params) {
  if (F1 != kWidth || C != kWidth) return -1;
  if (d.E < 1 || d.E > kMaxEntities || d.Ds < 1 || d.H < 1) return -2;
  if (d.n_embed < 0 || d.n_embed > kMaxEmbedLayers || d.n_tc < 1 || d.n_tc > kMaxTcLayers)
    return -4;
  const int np = param_count(d, F1, C);
  const int per_graph = Layout(d, F1, C).size * (int)sizeof(float);
  const int fixed = NETS * ((np + 31) & ~31) * (int)sizeof(float);
  int G = (kSmemLimit - fixed) / per_graph;
  if (G < 1) return -3;
  G = G < kMaxGraphsPerCta ? G : kMaxGraphsPerCta;
  *graphs_per_cta = G;
  *smem_bytes = fixed + G * per_graph;
  *n_params = np;
  return 0;
}

// Launches the NETS-trunk forward over B graphs on `stream`.
template <int NETS>
int launch_forward(const TrunkPtrs<NETS>& t, const float* adj_T, long long B, const Dims& d,
                   int F1, int C, float max_edge_dist, int embed_relu, int gnn_relu,
                   int n_params, void* stream) {
  int G = 0, smem = 0, np = 0;
  const int rc = configure<NETS>(d, F1, C, &G, &smem, &np);
  if (rc != 0) return rc;
  if (np != n_params) return -5;
  auto kernel = gnn_trunk_fwd_kernel<NETS, kWidth, kWidth>;
  const int threads = kWarp * G;
  long long grid = 0;
  const int prc = plan_launch(kernel, threads, smem, &grid);
  if (prc != 0) return prc;
  const long long tiles = (B + G - 1) / G;
  grid = grid < tiles ? grid : tiles;
  kernel<<<(unsigned)grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      t, adj_T, B, d, max_edge_dist, embed_relu, gnn_relu, n_params, G);
  return (int)cudaGetLastError();
}

}  // namespace
