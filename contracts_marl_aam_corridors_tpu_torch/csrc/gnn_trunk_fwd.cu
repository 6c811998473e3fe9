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
// What bounds it on this card: FP32 arithmetic.  At the default widths
// (E = 6 entities, Ds = 9, F1 = C = 16, H = 3, one embed layer, three conv
// layers) a rollout graph (24 unmasked edges) needs about 143K floating-point
// operations (ops/gnn_trunk.py trunk_work) and moves 744 bytes (inputs read
// once, output written once): some 190 operations per byte, far above the
// H100's 67 TFLOP/s / 3.35 TB/s = 20 FP32 operations per byte.  The products
// are 16 wide per graph and FP32, so no tensor core takes them here; the
// bound is the FP32 pipe.
//
// What the design does about it: each graph is one warp's job, and all of a
// graph's intermediates (masks, messages, QKV, logits) stay in shared memory
// and registers; nothing but the inputs and the (E*C) output touches device
// memory.  The ~35 KB of flattened parameters are staged once per CTA in
// shared memory, stored (in, out) so the lanes of a warp read consecutive
// words or one broadcast word.  A CTA of G warps takes G consecutive graphs
// at a time, so the loads of the batch-minor inputs and the store of the
// output move whole 32-byte sectors; a grid-stride loop over graph tiles
// takes any batch size without padding.  Edge messages are computed one edge
// per lane in registers (LayerNorm over a lane's own 16 values needs no
// shuffles) and summed over sources in source order, as the plain version
// does.  Masked logits use -FLT_MAX, not -INFINITY, so a fully masked row
// gives a uniform softmax that the any-edge factor zeroes instead of NaN.
//
// Interface: a plain C function, loaded with ctypes; it launches on the
// caller's stream, allocates nothing and returns cudaGetLastError() (or a
// negative code for a configuration it cannot run: embed and gnn widths other
// than 16, more than 32 entities, or more shared memory than a CTA may take).

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
  int dm, mk, src, hsrc, x, work, logit, obuf, size;
  __host__ __device__ Layout(const Dims& d, int F1, int C) {
    const int XW = F1 > C ? F1 : C;
    const int qkv = d.E * 3 * d.H * C;
    const int stage = kWarp * (F1 + 1);
    int w = qkv > stage ? qkv : stage;
    w = w > d.E * C ? w : d.E * C;
    dm = 0;
    mk = dm + d.E * d.E;
    src = mk + d.E * d.E;
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

// One graph, one warp.  `g` holds the graph's src and masked adjacency on
// entry and its output rows in `x` on exit.
template <int F1, int C>
__device__ void graph_forward(float* g, const float* P, const Layout& L, const Dims& d,
                              int embed_relu, int gnn_relu, int lane) {
  constexpr int XW = F1 > C ? F1 : C;
  const int E = d.E, Ds = d.Ds, H = d.H;
  const float* dm = g + L.dm;
  const float* mk = g + L.mk;
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
      float mx = -INFINITY, any_edge = 0.f;
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
        any_edge = fmaxf(any_edge, mv);
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
        const float a = li[s] / sum * any_edge;
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

template <int F1, int C>
__global__ void __launch_bounds__(kWarp* kMaxGraphsPerCta)
    gnn_trunk_fwd_kernel(const float* __restrict__ src_T, const float* __restrict__ adj_T,
                         const float* __restrict__ params, float* __restrict__ out,
                         long long B, Dims d, float max_edge_dist, int embed_relu,
                         int gnn_relu, int n_params, int G) {
  constexpr int XW = F1 > C ? F1 : C;
  extern __shared__ float smem[];
  const Layout L(d, F1, C);
  float* P = smem;
  float* tiles = smem + ((n_params + 31) & ~31);
  for (int i = threadIdx.x; i < n_params; i += blockDim.x) P[i] = params[i];
  __syncthreads();

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int E = d.E, n_src = E * d.Ds, n_adj = E * E, n_out = E * C;
  for (long long b0 = (long long)blockIdx.x * G; b0 < B; b0 += (long long)gridDim.x * G) {
    // G consecutive graphs per row: whole sectors of the batch-minor inputs
    for (int i = threadIdx.x; i < n_src * G; i += blockDim.x) {
      const int r = i / G, k = i % G;
      const long long b = b0 + k;
      tiles[k * L.size + L.src + r] = b < B ? src_T[r * B + b] : 0.f;
    }
    for (int i = threadIdx.x; i < n_adj * G; i += blockDim.x) {
      const int r = i / G, k = i % G;
      const long long b = b0 + k;
      const float dv = b < B ? adj_T[r * B + b] : 0.f;
      const float mv = (dv > 0.f && dv < max_edge_dist) ? 1.f : 0.f;
      tiles[k * L.size + L.mk + r] = mv;
      tiles[k * L.size + L.dm + r] = dv * mv;
    }
    __syncthreads();
    if (b0 + warp < B)
      graph_forward<F1, C>(tiles + warp * L.size, P, L, d, embed_relu, gnn_relu, lane);
    __syncthreads();
    for (int i = threadIdx.x; i < n_out * G; i += blockDim.x) {
      const int r = i / G, k = i % G;
      const long long b = b0 + k;
      if (b < B) out[r * B + b] = tiles[k * L.size + L.x + (r / C) * XW + r % C];
    }
    __syncthreads();
  }
}

int configure(const Dims& d, int F1, int C, int* graphs_per_cta, int* smem_bytes,
              int* n_params) {
  if (F1 != kWidth || C != kWidth) return -1;
  if (d.E < 1 || d.E > kMaxEntities || d.Ds < 1 || d.H < 1) return -2;
  if (d.n_embed < 0 || d.n_embed > kMaxEmbedLayers || d.n_tc < 1 || d.n_tc > kMaxTcLayers)
    return -4;
  const int np = param_count(d, F1, C);
  const int per_graph = Layout(d, F1, C).size * (int)sizeof(float);
  const int fixed = ((np + 31) & ~31) * (int)sizeof(float);
  int G = (kSmemLimit - fixed) / per_graph;
  if (G < 1) return -3;
  G = G < kMaxGraphsPerCta ? G : kMaxGraphsPerCta;
  *graphs_per_cta = G;
  *smem_bytes = fixed + G * per_graph;
  *n_params = np;
  return 0;
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

}  // namespace

extern "C" int gnn_trunk_fwd_config(int E, int Ds, int H, int F1, int C, int n_embed,
                                    int n_tc, int* graphs_per_cta, int* smem_bytes,
                                    int* n_params) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  return configure(d, F1, C, graphs_per_cta, smem_bytes, n_params);
}

extern "C" int gnn_trunk_fwd(const float* src_T, const float* adj_T, const float* params,
                             float* out, long long B, int E, int Ds, int H, int F1, int C,
                             int n_embed, int n_tc, float max_edge_dist, int embed_relu,
                             int gnn_relu, int n_params, void* stream) {
  const Dims d{E, Ds, H, n_embed, n_tc};
  int G = 0, smem = 0, np = 0;
  const int rc = configure(d, F1, C, &G, &smem, &np);
  if (rc != 0) return rc;
  if (np != n_params) return -5;
  auto kernel = gnn_trunk_fwd_kernel<kWidth, kWidth>;
  const int threads = kWarp * G;
  long long grid = 0;
  const int prc = plan_launch(kernel, threads, smem, &grid);
  if (prc != 0) return prc;
  const long long tiles = (B + G - 1) / G;
  grid = grid < tiles ? grid : tiles;
  kernel<<<(unsigned)grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      src_T, adj_T, params, out, B, d, max_edge_dist, embed_relu, gnn_relu, n_params, G);
  return (int)cudaGetLastError();
}
