// Device and host code of the GNN trunk's panel kernels, shared by the
// forwards (csrc/gnn_trunk_fwd.cu, one trunk a launch, and
// csrc/gnn_trunk_dual_fwd.cu, the actor's and the critic's trunks in one
// launch: rows 1 and 3 of PERF.md's kernel table) and the backwards
// (csrc/gnn_trunk_bwd.cuh, under csrc/gnn_trunk_bwd.cu and
// gnn_trunk_dual_bwd.cu, which recompute the forward): the parameter
// layout, the tile geometry, the 3xTF32 tensor-core product over a tile's
// panels, the EmbedConv forward, one conv layer's forward, the forwards'
// CTA loop over NT trunks and their launch plan, and the plan search.
//
// A tile is NB consecutive graphs.  Every per-graph quantity lives in a
// panel: feature row k holds that feature for all M = E*NB (entity, graph)
// pairs of the tile, m = e*NB + b, so a panel is a column-major (M x rows)
// matrix with leading dimension LD, and thread m owns column m (in the
// forward's small batches, S threads share it: see "the forward").  A conv
// layer's products are then products with M rows: q/k/v = X W_h (M x 16 by
// 16 x 48 per head) and the skip X Wskip (16 x 16), and the backward's dX
// and dW products have M or K = M.  The E x E per-graph arrays (masked
// distances, attention weights) are planes [s][t*NB + b], one plane per
// source s.  No graph's result depends on its tile or on NB: the products'
// K is the feature width, every other step is thread m's own loop over its
// graph's entities, and padded rows are zero.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
// The one width instantiated (embed hidden = gnn hidden = 16): every model
// configuration of the repo uses 16/16.
constexpr int W = 16;
constexpr int kMaxEntities = 32;
constexpr int kMaxEmbedLayers = 4;
constexpr int kMaxTcLayers = 8;
constexpr int kSmemLimit = 232448;  // 227 KB a block can request on sm_90
constexpr int kMaxThreadsPerSm = 2048;
constexpr int kMaxCtasPerSm = 32;
constexpr int kRegsPerSm = 65536;
constexpr float kNeg = -FLT_MAX;  // finfo(float32).min
constexpr float kLnEps = 1e-5f;

struct Dims {
  int E, Ds, H, n_embed, n_tc;
};

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }
__host__ __device__ inline int imin(int a, int b) { return a < b ? a : b; }
__host__ __device__ inline int round_up(int a, int b) { return (a + b - 1) / b * b; }

// Offsets into the parameter blob (ops/gnn_trunk.py param_blob order):
// W1 (Ds, W), b1, w_e1, ln1 scale, ln1 bias, n_embed x [W (W, W), b, ln
// scale, ln bias], n_tc x [Wqkv (W, 3HW), bqkv, w_e (HW), Wskip (W, W),
// bskip]; weights stored (in, out).
struct ParamLayout {
  int b1, we1, ln1s, ln1b, embed0, embed_stride, embed_size, tc0, tc_stride, total;
  __host__ __device__ explicit ParamLayout(const Dims& d) {
    const int QKV = 3 * d.H * W;
    b1 = d.Ds * W;
    we1 = b1 + W;
    ln1s = we1 + W;
    ln1b = ln1s + W;
    embed0 = ln1b + W;
    embed_stride = W * W + 3 * W;
    embed_size = embed0 + d.n_embed * embed_stride;
    tc0 = embed_size;
    tc_stride = W * QKV + QKV + d.H * W + W * W + W;
    total = tc0 + d.n_tc * tc_stride;
  }
  // LayerNorm scale / bias of EmbedConv stage l (0: ln1, l >= 1: ln{l+1})
  __device__ int ln_scale(int l) const {
    return l == 0 ? ln1s : embed0 + (l - 1) * embed_stride + W * W + W;
  }
  __device__ int ln_bias(int l) const {
    return l == 0 ? ln1b : embed0 + (l - 1) * embed_stride + W * W + 2 * W;
  }
};

// The tile geometry both kernels share, and the offsets (in floats) of the
// regions of shared memory the shared code reads; each kernel's own
// geometry places those regions and its others.
struct PanelGeom {
  // split: the threads that share one (entity, graph) row (the forward's
  // small batches; 1 elsewhere), thread tid = m*split + j
  int NB, M, split, Mp, T, nw, LD, LDA, HC, QKV, ldw;
  // a staged conv layer's weights, from its base: Wqkv (W rows of ldw),
  // bqkv, w_e, Wskip (W x W), bskip; the EmbedConv's are staged at their
  // blob offsets
  int wq, bq, we, wsk, bsk;
  // the staged weights, the masked distance and attention weight planes,
  // the scratch panels (src in rows [0, Ds) and h_src from row hsrc during
  // the EmbedConv, one head's q, k, v in rows [0, 3W) in a conv layer), and
  // the CTA's total; with split > 1 the EmbedConv's edge outputs, split
  // slots of W rows, es floats apart, at ebuf
  int w, dm, alpha, scr, hsrc, ebuf, es, size;
  __host__ __device__ PanelGeom(const Dims& d, int nb, int split = 1) {
    NB = nb;
    M = d.E * nb;
    this->split = split;
    Mp = round_up(M, 16);
    T = round_up(M * split, kWarp);
    nw = T / kWarp;
    // LD = 8 (mod 32): a fragment's rows (stride 1) and columns (stride LD)
    // fall on distinct banks
    LD = Mp + (40 - Mp % 32) % 32;
    // a plane's stride = NB (mod 32): where a warp spans several sources,
    // their rows of one target fall on distinct banks
    LDA = M + (NB % 32 - M % 32 + 32) % 32;
    HC = d.H * W;
    QKV = 3 * HC;
    ldw = QKV + 8;  // = 8 or 24 (mod 32)
    wq = 0;
    bq = W * ldw;
    we = bq + QKV;
    wsk = we + HC;
    bsk = wsk + W * W;
    w = dm = alpha = scr = ebuf = es = size = 0;
    hsrc = d.Ds * LD;
  }
  // floats of one staged conv layer
  __host__ __device__ int tc_floats() const { return bsk + W; }
};

__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : tanhf(v);
}

__device__ __forceinline__ void ln_stats(const float (&m)[W], float& mu, float& r) {
  mu = 0.f;
#pragma unroll
  for (int f = 0; f < W; ++f) mu += m[f];
  mu = mu / W;
  float var = 0.f;
#pragma unroll
  for (int f = 0; f < W; ++f) {
    const float dv = m[f] - mu;
    var += dv * dv;
  }
  var = var / W;
  r = 1.f / sqrtf(var + kLnEps);
}

__device__ __forceinline__ void layer_norm(float (&m)[W], const float* scale,
                                           const float* bias) {
  float mu, r;
  ln_stats(m, mu, r);
#pragma unroll
  for (int f = 0; f < W; ++f) m[f] = (m[f] - mu) * r * scale[f] + bias[f];
}

// One edge's EmbedConv chain up to stage l, from its source's h_src `hs` and
// its masked distance: `a` gets stage l's activation output (its LayerNorm's
// input), `yp` stage l's Linear input (stage l-1's LayerNorm output; zero
// for l = 0).  P holds the EmbedConv's parameters at their blob offsets.
__device__ void edge_upto(int l, const float (&hs)[W], float dv, const float* P,
                          const ParamLayout& pl, int relu, float (&a)[W], float (&yp)[W]) {
#pragma unroll
  for (int f = 0; f < W; ++f) {
    a[f] = act(hs[f] + dv * P[pl.we1 + f], relu);
    yp[f] = 0.f;
  }
  for (int j = 1; j <= l; ++j) {
#pragma unroll
    for (int f = 0; f < W; ++f) yp[f] = a[f];
    layer_norm(yp, P + pl.ln_scale(j - 1), P + pl.ln_bias(j - 1));
    const float* WT = P + pl.embed0 + (j - 1) * pl.embed_stride;
    const float* bb = WT + W * W;
#pragma unroll
    for (int f = 0; f < W; ++f) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < W; ++k) acc = fmaf(WT[k * W + f], yp[k], acc);
      a[f] = act(acc + bb[f], relu);
    }
  }
}

// ---------------------------------------------------------------- 3xTF32

// x = hi + lo, both TF32 (10-bit mantissa); hi * hi + hi * lo + lo * hi
// keeps about FP32's precision.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(lo) : "f"(rest));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += A B for one 16 x 8 x 8 step in 3xTF32.  Fragments (g = lane / 4,
// q = lane % 4): a = A(g, q), A(g + 8, q), A(g, q + 4), A(g + 8, q + 4);
// b = B(q, g), B(q + 4, g); d = D(g, 2q), D(g, 2q + 1), D(g + 8, 2q),
// D(g + 8, 2q + 1).
__device__ __forceinline__ void mma3(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ah[4], al[4], bh[2], bl[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) split_tf32(a[i], ah[i], al[i]);
#pragma unroll
  for (int i = 0; i < 2; ++i) split_tf32(b[i], bh[i], bl[i]);
  mma_tf32(d, al, bh);
  mma_tf32(d, ah, bl);
  mma_tf32(d, ah, bh);
}

// out[n][m] (=, or += with `accumulate`) sum_k A[k][m] B(k, n) + bias(n) for
// the tile's M rows: A a panel of K rows, `bw(k, n)` and `bias(n)` read the
// staged weights, out a panel of N rows.  The warps share the 16 x 8 output
// tiles in a fixed order.
template <class BW, class Bias>
__device__ __forceinline__ void prod_panel(const float* A, int K, BW bw, int N, Bias bias,
                                           float* out, bool accumulate, const PanelGeom& G,
                                           int warp, int lane) {
  const int g = lane >> 2, q = lane & 3;
  const int nts = N / 8, tiles = (G.Mp / 16) * nts;
  for (int t = warp; t < tiles; t += G.nw) {
    const int r0 = (t / nts) * 16 + g, r1 = r0 + 8, c0 = (t % nts) * 8 + 2 * q;
    const bool ok0 = r0 < G.M, ok1 = r1 < G.M;
    float d[4] = {0.f, 0.f, 0.f, 0.f};
    if (accumulate) {
      if (ok0) d[0] = out[c0 * G.LD + r0], d[1] = out[(c0 + 1) * G.LD + r0];
      if (ok1) d[2] = out[c0 * G.LD + r1], d[3] = out[(c0 + 1) * G.LD + r1];
    }
    const int n = (t % nts) * 8 + g;
    for (int k0 = 0; k0 < K; k0 += 8) {
      const float* a0 = A + (k0 + q) * G.LD;
      const float* a4 = a0 + 4 * G.LD;
      const float a[4] = {ok0 ? a0[r0] : 0.f, ok1 ? a0[r1] : 0.f, ok0 ? a4[r0] : 0.f,
                          ok1 ? a4[r1] : 0.f};
      const float b[2] = {bw(k0 + q, n), bw(k0 + q + 4, n)};
      mma3(d, a, b);
    }
    if (ok0) {
      out[c0 * G.LD + r0] = d[0] + bias(c0);
      out[(c0 + 1) * G.LD + r0] = d[1] + bias(c0 + 1);
    }
    if (ok1) {
      out[c0 * G.LD + r1] = d[2] + bias(c0);
      out[(c0 + 1) * G.LD + r1] = d[3] + bias(c0 + 1);
    }
  }
}

// ---------------------------------------------------------------- the forward
//
// With split S > 1 (template parameter, = G.split) the S threads of row m
// are lanes m*S .. m*S + S-1 of one warp; thread j of them owns channels c
// = j + S*i (chan) and the sources s = j, j + S, ... of the per-source
// loops, and they exchange through shared memory under __syncwarp(rows),
// rows the warp's lanes that own a row.  Every sum keeps S = 1's order, so
// each value is the same bit for bit whatever S.

// Channel i of thread j's share of W.
template <int S>
__device__ __forceinline__ int chan(int j, int i) {
  return S == 1 ? i : j + S * i;
}

// Loads the tile's src into scr rows [0, Ds) and computes h_src = W1 src +
// b1 into rows [hsrc, hsrc + W) (the EmbedConv's parameters staged in w).
// Ends synchronised.
template <int S = 1>
__device__ void load_src_hsrc(float* sm, const PanelGeom& G, const Dims& d,
                              const ParamLayout& pl, const float* __restrict__ src_T,
                              long long B, long long b0, bool valid, int m, int j = 0) {
  float* scr = sm + G.scr;
  for (int i = threadIdx.x; i < d.E * d.Ds * G.NB; i += blockDim.x) {
    const int r = i / G.NB, b = i - r * G.NB;  // r = e*Ds + k
    const int e = r / d.Ds, k = r - e * d.Ds;
    const long long gb = b0 + b;
    scr[k * G.LD + e * G.NB + b] = gb < B ? src_T[r * B + gb] : 0.f;
  }
  __syncthreads();
  if (valid) {
    const float* P = sm + G.w;
    float h[W / S];
#pragma unroll
    for (int i = 0; i < W / S; ++i) h[i] = P[pl.b1 + chan<S>(j, i)];
    for (int k = 0; k < d.Ds; ++k) {
      const float s = scr[k * G.LD + m];
#pragma unroll
      for (int i = 0; i < W / S; ++i) h[i] = fmaf(P[k * W + chan<S>(j, i)], s, h[i]);
    }
#pragma unroll
    for (int i = 0; i < W / S; ++i) scr[G.hsrc + chan<S>(j, i) * G.LD + m] = h[i];
  }
  __syncthreads();
}

// One float from global to shared memory with cp.async: the copy holds no
// register and the thread goes on without waiting for it (cp_async_wait
// then __syncthreads before the copies are read).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Stages conv layer l's weights (blob order) at `w`, Wqkv rows padded to
// ldw; with kAsync by cp.async (the caller waits).
template <bool kAsync = false>
__device__ void stage_tc(float* w, const PanelGeom& G, const ParamLayout& pl,
                         const float* __restrict__ params, int l) {
  const float* src = params + pl.tc0 + l * pl.tc_stride;
  for (int i = threadIdx.x; i < W * G.QKV; i += blockDim.x) {
    const int k = i / G.QKV, j = i - k * G.QKV;
    if (kAsync)
      cp_async4(w + G.wq + k * G.ldw + j, src + i);
    else
      w[G.wq + k * G.ldw + j] = src[i];
  }
  // bqkv, w_e, Wskip, bskip lie in the same order in the blob and in w
  for (int i = threadIdx.x; i < pl.tc_stride - W * G.QKV; i += blockDim.x) {
    if (kAsync)
      cp_async4(w + G.bq + i, src + W * G.QKV + i);
    else
      w[G.bq + i] = src[W * G.QKV + i];
  }
}

// Head h's column j < 3W of the q/k/v stack (q | k | v, each H*W wide).
__device__ __forceinline__ int qkv_col(const PanelGeom& G, int h, int j) {
  return (j / W) * G.HC + h * W + (j % W);
}

// Head h's q, k, v of the tile into scr rows [0, 3W): X W_h + b_h, from the
// conv layer's weights staged at w.
__device__ __forceinline__ void prod_qkv(float* sm, const PanelGeom& G, const float* w,
                                         const float* X, int h, int warp, int lane) {
  prod_panel(
      X, W, [&](int k, int n) { return w[G.wq + k * G.ldw + qkv_col(G, h, n)]; }, 3 * W,
      [&](int n) { return w[G.bq + qkv_col(G, h, n)]; }, sm + G.scr, false, G, warp, lane);
}

// Row m = (t, b): head h's attention weights of target t over the sources
// s, alpha[s][m] (the any-edge factor applied), from its query q (and q .
// w_e).  Masked logits are finfo.min, so a masked source's weight is
// exactly zero; a target with no in-edge gets zero weights.  With S > 1
// thread j computes its sources' logits and weights, and each of the S
// the row's maximum and sum over all of them.
template <int S = 1>
__device__ __forceinline__ void attention_weights(float* sm, const PanelGeom& G, const Dims& d,
                                                  const float (&q)[W], float qwe, int m, int b,
                                                  int j = 0, unsigned rows = kFull) {
  const float* K = sm + G.scr + W * G.LD;
  const float* dm = sm + G.dm;
  float* al = sm + G.alpha;
  const float inv_sqrt_c = 1.f / sqrtf((float)W);
  float mx = -INFINITY, any_edge = 0.f;
  for (int s = S == 1 ? 0 : j; s < d.E; s += S) {
    const float dv = dm[s * G.LDA + m];
    const int col = s * G.NB + b;
    float acc = 0.f;
#pragma unroll
    for (int c = 0; c < W; ++c) acc = fmaf(q[c], K[c * G.LD + col], acc);
    const float lv = dv > 0.f ? (acc + dv * qwe) * inv_sqrt_c : kNeg;
    al[s * G.LDA + m] = lv;
    if (S == 1) {
      mx = fmaxf(mx, lv);
      any_edge = dv > 0.f ? 1.f : any_edge;
    }
  }
  if (S == 1) {
    float sum = 0.f;
    for (int s = 0; s < d.E; ++s) {
      const float ex = expf(al[s * G.LDA + m] - mx);
      al[s * G.LDA + m] = ex;
      sum += ex;
    }
    const float scale = any_edge / sum;
    for (int s = 0; s < d.E; ++s) al[s * G.LDA + m] *= scale;
  } else {
    __syncwarp(rows);
    for (int s = 0; s < d.E; ++s) {
      mx = fmaxf(mx, al[s * G.LDA + m]);
      any_edge = dm[s * G.LDA + m] > 0.f ? 1.f : any_edge;
    }
    float sum = 0.f;
    for (int s = 0; s < d.E; ++s) sum += expf(al[s * G.LDA + m] - mx);
    const float scale = any_edge / sum;
    __syncwarp(rows);
    for (int s = j; s < d.E; s += S) al[s * G.LDA + m] = expf(al[s * G.LDA + m] - mx) * scale;
    __syncwarp(rows);
  }
}

// The EmbedConv forward of target t = m / NB: x_0[t] = sum over masked
// sources of the edge chain's LayerNorm output, into the panel X0.  With S
// > 1 the row's threads run S sources' chains at a time into the edge
// buffer, then add them in source order, each its own channels.
template <int S = 1>
__device__ void embed_forward(float* sm, const PanelGeom& G, const Dims& d,
                              const ParamLayout& pl, int relu, bool valid, int m, int b,
                              float* X0, int j = 0, unsigned rows = kFull) {
  const float* P = sm + G.w;
  const float* hsrc = sm + G.scr + G.hsrc;
  const float* dm = sm + G.dm;
  float x0[W / S];
#pragma unroll
  for (int i = 0; i < W / S; ++i) x0[i] = 0.f;
  if (S == 1) {
    for (int s = 0; s < d.E; ++s) {
      const float dv = valid ? dm[s * G.LDA + m] : 0.f;
      if (!__any_sync(kFull, dv > 0.f)) continue;
      float hs[W], a[W], yp[W];
      const int col = s * G.NB + b;
#pragma unroll
      for (int f = 0; f < W; ++f) hs[f] = valid ? hsrc[f * G.LD + col] : 0.f;
      edge_upto(d.n_embed, hs, dv, P, pl, relu, a, yp);
      layer_norm(a, P + pl.ln_scale(d.n_embed), P + pl.ln_bias(d.n_embed));
      const float mv = dv > 0.f ? 1.f : 0.f;
#pragma unroll
      for (int f = 0; f < W; ++f) x0[f] = fmaf(mv, a[f], x0[f]);
    }
  } else if (valid) {
    float* buf = sm + G.ebuf;
    for (int s0 = 0; s0 < d.E; s0 += S) {
      const int s = s0 + j;
      const float dv = s < d.E ? dm[s * G.LDA + m] : 0.f;
      float a[W];
      if (dv > 0.f) {
        float hs[W], yp[W];
        const int col = s * G.NB + b;
#pragma unroll
        for (int f = 0; f < W; ++f) hs[f] = hsrc[f * G.LD + col];
        edge_upto(d.n_embed, hs, dv, P, pl, relu, a, yp);
        layer_norm(a, P + pl.ln_scale(d.n_embed), P + pl.ln_bias(d.n_embed));
      } else {
#pragma unroll
        for (int f = 0; f < W; ++f) a[f] = 0.f;
      }
#pragma unroll
      for (int f = 0; f < W; ++f) buf[j * G.es + f * G.LD + m] = a[f];
      __syncwarp(rows);
      for (int u = 0; u < S && s0 + u < d.E; ++u) {
        const float mv = dm[(s0 + u) * G.LDA + m] > 0.f ? 1.f : 0.f;
#pragma unroll
        for (int i = 0; i < W / S; ++i)
          x0[i] = fmaf(mv, buf[u * G.es + chan<S>(j, i) * G.LD + m], x0[i]);
      }
      __syncwarp(rows);
    }
  }
  if (valid) {
#pragma unroll
    for (int i = 0; i < W / S; ++i) X0[chan<S>(j, i) * G.LD + m] = x0[i];
  }
}

// One conv layer's forward over the tile, its weights staged at w (and
// synchronised): head by head the q/k/v product on the tensor cores in
// 3xTF32 (prod_qkv), the attention weights and the weighted values.  Thread
// j of row m gets the pre-activation of its channels in acc: skip + bskip,
// then each head's (sum_s alpha v_s + (sum_s alpha d) w_e) / H added in
// turn.  kSkipTc chooses where the skip product runs: on the tensor cores in
// 3xTF32 (prod_panel, into the panel `skip`, W rows outside scr), or as
// each thread's own FP32 dot products on the CUDA cores.  Ends
// unsynchronised.
template <bool kSkipTc, int S = 1>
__device__ __forceinline__ void conv_forward(float* sm, const PanelGeom& G, const Dims& d,
                                             const float* w, const float* X, float* skip,
                                             bool valid, int m, int b, int warp, int lane,
                                             float (&acc)[W / S], int j = 0,
                                             unsigned rows = kFull) {
  const float inv_h = 1.f / (float)d.H;
  const float* scr = sm + G.scr;
  const float* dm = sm + G.dm;
  const float* alpha = sm + G.alpha;
  if (kSkipTc)
    prod_panel(
        X, W, [&](int k, int n) { return w[G.wsk + k * W + n]; }, W, [](int) { return 0.f; },
        skip, false, G, warp, lane);
  for (int h = 0; h < d.H; ++h) {
    if (h > 0) __syncthreads();
    prod_qkv(sm, G, w, X, h, warp, lane);
    __syncthreads();
    if (valid) {
      const float* Q = scr;
      const float* V = scr + 2 * W * G.LD;
      // skip + bskip of channel c
      auto skip_init = [&](int c) {
        if (kSkipTc) return skip[c * G.LD + m] + w[G.bsk + c];
        float sk = 0.f;
#pragma unroll
        for (int k = 0; k < W; ++k) sk = fmaf(X[k * G.LD + m], w[G.wsk + k * W + c], sk);
        return sk + w[G.bsk + c];
      };
      float q[W], we[W];
      float qwe = 0.f;
#pragma unroll
      for (int c = 0; c < W; ++c) {
        q[c] = Q[c * G.LD + m];
        we[c] = w[G.we + h * W + c];
        qwe = fmaf(q[c], we[c], qwe);
        // with S = 1 thread m owns every channel: acc[c]
        if (S == 1 && h == 0) acc[S == 1 ? c : 0] = skip_init(c);
      }
      if (S > 1 && h == 0) {
#pragma unroll
        for (int i = 0; i < W / S; ++i) acc[i] = skip_init(chan<S>(j, i));
      }
      attention_weights<S>(sm, G, d, q, qwe, m, b, j, rows);
      float o[W / S];
#pragma unroll
      for (int i = 0; i < W / S; ++i) o[i] = 0.f;
      float ad = 0.f;
      for (int s = 0; s < d.E; ++s) {
        const float a = alpha[s * G.LDA + m];
        ad = fmaf(a, dm[s * G.LDA + m], ad);
        const int col = s * G.NB + b;
#pragma unroll
        for (int i = 0; i < W / S; ++i) o[i] = fmaf(a, V[chan<S>(j, i) * G.LD + col], o[i]);
      }
#pragma unroll
      for (int i = 0; i < W / S; ++i) {
        // a register of we where the channel is known at compile time
        const float wc = S == 1 ? we[i] : w[G.we + h * W + chan<S>(j, i)];
        acc[i] += (o[i] + ad * wc) * inv_h;
      }
    }
  }
}

// ---------------------------------------------------------------- the forward kernels
//
// Rows 1 and 3 run one body, forward_ctas, over NT trunks that share one
// adjacency (NT = 1 and 2).

// The launch bound: CTAs of at most 256 threads, two an SM, so at most 128
// registers a thread (16 warps an SM); a kernel that splits rows takes
// CTAs of up to 512 threads, one an SM, at the same 128 registers.
constexpr int kFwdThreads = 256;
constexpr int kFwdMinCtas = 2;
constexpr int kFwdRegs = kRegsPerSm / (kFwdThreads * kFwdMinCtas);
constexpr int kSplitThreads = 512;
// The largest split of a row over threads (a power of two dividing W).
constexpr int kMaxSplit = 8;

// The forward's shared-memory plan, in floats, beside the panel geometry.
struct FwdGeom : PanelGeom {
  int xa, xb;  // the two x panels
  __host__ __device__ FwdGeom(const Dims& d, const ParamLayout& pl, int nb, int split)
      : PanelGeom(d, nb, split) {
    int o = 0;
    w = o;
    o += round_up(imax(tc_floats(), pl.embed_size), 32);
    const int plane = round_up(d.E * LDA, 32);
    dm = o;
    o += plane;
    alpha = o;
    o += plane;
    xa = o;
    o += W * LD;
    xb = o;
    o += W * LD;
    // src and h_src (and with split > 1 the edge buffer) in the EmbedConv,
    // one head's q, k, v in a conv layer
    scr = o;
    int embed = hsrc + W * LD;
    if (split > 1) {
      // a slot stride of 32 / split (mod 32): a warp's split slots and
      // 32 / split rows fall on distinct banks
      es = round_up(W * LD, 32) + kWarp / split;
      ebuf = o + round_up(embed, 32);
      embed = round_up(embed, 32) + split * es;
    }
    o += imax(embed, 3 * W * LD);
    size = o;
  }
};

// The tile's adjacency from b0 into the dm plane as masked distances (0
// where 0 < d < max_edge_dist fails, and past the batch's end).
__device__ __forceinline__ void load_masked_distances(float* sm, const PanelGeom& G,
                                                      const Dims& d,
                                                      const float* __restrict__ adj_T,
                                                      long long B, long long b0,
                                                      float max_edge_dist) {
  for (int i = threadIdx.x; i < d.E * d.E * G.NB; i += blockDim.x) {
    const int r = i / G.NB, b = i - r * G.NB;  // r = s*E + t
    const int s = r / d.E, t = r - s * d.E;
    const long long gb = b0 + b;
    const float dv = gb < B ? adj_T[r * B + gb] : 0.f;
    sm[G.dm + s * G.LDA + t * G.NB + b] = (dv > 0.f && dv < max_edge_dist) ? dv : 0.f;
  }
}

// One trunk's pointers in a forward launch.
struct FwdTrunk {
  const float* src_T;   // (E*Ds, B) EmbedConv input
  const float* params;  // blob
  float* out;           // (E*C, B)
};

template <int NT>
struct FwdTrunks {
  FwdTrunk t[NT];
};

// Trunk k's pointers, by selection (an indexed read would copy the
// kernel's parameters to local memory).
template <int NT>
__device__ __forceinline__ FwdTrunk trunk_of(const FwdTrunks<NT>& tr, int k) {
  FwdTrunk io = tr.t[0];
#pragma unroll
  for (int i = 1; i < NT; ++i)
    if (k == i) io = tr.t[i];
  return io;
}

// One trunk's forward over the tile from b0 (the CTA loop's body): its
// EmbedConv weights, src and h_src, the EmbedConv into panel xa, and the
// conv layers from one x panel into the other, each layer's weights staged
// in w; the last layer's output goes from registers to `out`.  With
// `first` it also masks the tile's distances into the dm plane.  It starts
// with the barrier that ends the previous trunk's last layer, which read
// w, the x panels and scr.  The trunk's pointers come as __restrict__
// arguments, as a one-trunk kernel's parameters were.
template <int S>
__device__ __forceinline__ void trunk_tile_forward(float* sm, const FwdGeom& G, const Dims& d,
                                                   const ParamLayout& pl,
                                                   const float* __restrict__ src_T,
                                                   const float* __restrict__ params,
                                                   float* __restrict__ out,
                                                   const float* __restrict__ adj_T, long long B,
                                                   long long b0, bool first, float max_edge_dist,
                                                   int embed_relu, int gnn_relu, bool valid,
                                                   int m, int e, int b, int j, unsigned rows) {
  const int tid = threadIdx.x, lane = tid % kWarp, warp = tid / kWarp;
  float* w = sm + G.w;
  __syncthreads();
  for (int i = tid; i < pl.embed_size; i += blockDim.x) cp_async4(w + i, params + i);
  if (first) load_masked_distances(sm, G, d, adj_T, B, b0, max_edge_dist);
  cp_async_wait();
  load_src_hsrc<S>(sm, G, d, pl, src_T, B, b0, valid, m, j);
  embed_forward<S>(sm, G, d, pl, embed_relu, valid, m, b, sm + G.xa, j, rows);
  for (int l = 0; l < d.n_tc; ++l) {
    __syncthreads();
    stage_tc<true>(w, G, pl, params, l);
    cp_async_wait();
    __syncthreads();
    const float* X = sm + ((l & 1) ? G.xb : G.xa);
    float* Y = sm + ((l & 1) ? G.xa : G.xb);
    float acc[W / S];
    conv_forward<false, S>(sm, G, d, w, X, nullptr, valid, m, b, warp, lane, acc, j, rows);
    if (valid) {
      if (l + 1 < d.n_tc) {
#pragma unroll
        for (int i = 0; i < W / S; ++i) Y[chan<S>(j, i) * G.LD + m] = act(acc[i], gnn_relu);
      } else {
        const long long gb = b0 + b;
        if (gb < B) {
#pragma unroll
          for (int i = 0; i < W / S; ++i)
            out[(long long)(e * W + chan<S>(j, i)) * B + gb] = act(acc[i], gnn_relu);
        }
      }
    }
  }
}

// The CTA's loop over its tiles, for NT trunks on one adjacency: tile i of
// the grid's CTA c is graphs (c + i * CTAs) * NB ...  With the trunks in
// turn (the plan's grid_trunks = 1) the CTA masks each tile's distances
// once and runs the NT trunks on it one after the other; with the trunk on
// the grid (grid_trunks = NT, the plan making the CTAs a multiple of NT)
// CTA c runs trunk c % NT of tiles c / NT, c / NT + CTAs / NT, ...  One
// loop steps over (tile, trunk) pairs, as row 1's steps over tiles: with a
// loop over trunks inside the loop over tiles the compiler kept the conv
// layers' shared-memory addresses live through the EmbedConv, whose
// accumulators then spilled, and the launch took 2-5% longer than two
// one-trunk launches (PERF.md §6).  Only the first trunk of a tile writes
// the dm plane.  Each trunk runs the code of a one-trunk launch and no
// graph's result depends on its tile, NB or S, so each trunk's output
// equals a launch of it alone, bit for bit.  Thread tid is thread j = tid
// % S of row m = tid / S.
template <int S, int NT>
__device__ __forceinline__ void forward_ctas(const FwdTrunks<NT>& tr,
                                             const float* __restrict__ adj_T, long long B,
                                             const Dims& d, float max_edge_dist, int embed_relu,
                                             int gnn_relu, int nb, int grid_trunks) {
  extern __shared__ float sm[];
  const ParamLayout pl(d);
  const FwdGeom G(d, pl, nb, S);
  const int m = threadIdx.x / S, j = threadIdx.x - m * S;
  const bool valid = m < G.M;
  const int e = valid ? m / nb : 0, b = valid ? m - e * nb : 0;
  // the lanes of this warp that own a row
  const unsigned rows = __ballot_sync(kFull, valid);
  if constexpr (NT == 1) {
    for (long long b0 = (long long)blockIdx.x * nb; b0 < B; b0 += (long long)gridDim.x * nb)
      trunk_tile_forward<S>(sm, G, d, pl, tr.t[0].src_T, tr.t[0].params, tr.t[0].out, adj_T, B,
                            b0, true, max_edge_dist, embed_relu, gnn_relu, valid, m, e, b, j,
                            rows);
  } else {
    const bool on_grid = grid_trunks > 1;
    const int ctas = on_grid ? gridDim.x / NT : gridDim.x;
    const int k0 = on_grid ? blockIdx.x % NT : 0, k1 = on_grid ? k0 + 1 : NT;
    int k = k0;
    for (long long b0 = (long long)(on_grid ? blockIdx.x / NT : blockIdx.x) * nb; b0 < B;) {
      const FwdTrunk io = trunk_of(tr, k);
      trunk_tile_forward<S>(sm, G, d, pl, io.src_T, io.params, io.out, adj_T, B, b0, k == k0,
                            max_edge_dist, embed_relu, gnn_relu, valid, m, e, b, j, rows);
      if (++k == k1) {
        k = k0;
        b0 += (long long)ctas * nb;
      }
    }
  }
}

// ---------------------------------------------------------------- host side

// A device's SM count and shared memory per SM and reserved per CTA, read
// at its first launch and kept.
struct DeviceInfo {
  int sms = 0, smem_sm = 0, reserved = 0;
};
constexpr int kMaxDevices = 64;
DeviceInfo g_devices[kMaxDevices];
// the dynamic shared memory each of the library's panel kernels may use,
// per device
constexpr int kMaxKernels = 4;
struct SmemSet {
  const void* kernel = nullptr;
  int smem = 0;
};
SmemSet g_smem_set[kMaxDevices][kMaxKernels];
std::mutex g_devices_mutex;

int device_info(int* dev, DeviceInfo* info) {
  cudaError_t err = cudaGetDevice(dev);
  if (err != cudaSuccess) return (int)err;
  if (*dev >= kMaxDevices) return -6;
  std::lock_guard<std::mutex> lock(g_devices_mutex);
  DeviceInfo& di = g_devices[*dev];
  if (di.sms == 0) {
    if ((err = cudaDeviceGetAttribute(&di.smem_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                                      *dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&di.reserved, cudaDevAttrReservedSharedMemoryPerBlock,
                                      *dev)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(&di.sms, cudaDevAttrMultiProcessorCount, *dev)) !=
            cudaSuccess) {
      di.sms = 0;
      return (int)err;
    }
  }
  *info = di;
  return 0;
}

// Lets `kernel` take `smem` bytes of dynamic shared memory on device dev.
template <typename Kernel>
int allow_smem(Kernel kernel, int dev, int smem) {
  std::lock_guard<std::mutex> lock(g_devices_mutex);
  const void* key = reinterpret_cast<const void*>(kernel);
  int i = 0;
  while (i < kMaxKernels && g_smem_set[dev][i].kernel && g_smem_set[dev][i].kernel != key) ++i;
  if (i == kMaxKernels) return -9;
  SmemSet& set = g_smem_set[dev][i];
  if (set.kernel != key || set.smem < smem) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    set.kernel = key;
    set.smem = smem;
  }
  return 0;
}

// The launch shape: graphs per CTA, threads, dynamic shared memory, the
// CTAs an SM holds by shared memory, threads and registers, threads a row,
// and (the forwards') the trunks on the grid.
struct Plan {
  int nb = 0, threads = 0, smem = 0, per_sm = 0, split = 1, grid_trunks = 1;
};

int check_dims(const Dims& d, int F1, int C) {
  if (F1 != W || C != W) return -1;
  if (d.E < 1 || d.E > kMaxEntities || d.Ds < 1 || d.H < 1) return -2;
  if (d.n_embed < 0 || d.n_embed > kMaxEmbedLayers || d.n_tc < 1 || d.n_tc > kMaxTcLayers)
    return -4;
  return 0;
}

// The plan of tiles of nb graphs for a kernel of geometry Geo, at most
// max_threads a CTA and `regs` registers a thread (the launch bound's, so
// the plan does not depend on the build and never counts more CTAs an SM
// than fit); per_sm 0 where such a CTA does not fit.
template <class Geo, class... Split>
Plan plan_for(const Dims& d, const ParamLayout& pl, const DeviceInfo& di, int nb,
              int max_threads, int regs, Split... split) {
  const Geo G(d, pl, nb, split...);
  const long long smem = (long long)G.size * (long long)sizeof(float);
  if (G.T > max_threads || smem > kSmemLimit) return Plan{nb, G.T, (int)smem, 0, G.split};
  // registers are allocated a warp at a time, 256 at the bound of 255
  const int regs_warp = round_up(regs, 8) * kWarp;
  const int per_sm = imin(imin(di.smem_sm / ((int)smem + di.reserved), kMaxThreadsPerSm / G.T),
                          imin(kRegsPerSm / (regs_warp * G.nw), kMaxCtasPerSm));
  return Plan{nb, G.T, (int)smem, per_sm, G.split};
}

// The nb up to max_nb that puts the most graphs on an SM, the larger nb on
// a tie.
template <class Geo, class... Split>
int best_plan(const Dims& d, const DeviceInfo& di, int max_nb, int max_threads, int regs,
              Plan* plan, Split... split) {
  const ParamLayout pl(d);
  Plan best;
  for (int nb = max_nb; nb >= 1; --nb) {
    const Plan p = plan_for<Geo>(d, pl, di, nb, max_threads, regs, split...);
    if (p.per_sm >= 1 && nb * p.per_sm > best.nb * best.per_sm) best = p;
  }
  if (best.nb == 0) return -3;
  *plan = best;
  return 0;
}

// What the compiler and the card make of `kernel` under `plan`: threads a
// CTA, registers and local memory a thread, and the CTAs an SM actually
// holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor) beside the CTAs an
// SM the plan counts.
template <typename Kernel>
int kernel_attributes(Kernel kernel, const Plan& plan, int* threads, int* regs,
                      int* local_bytes, int* ctas_per_sm, int* planned_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas_per_sm, kernel, plan.threads,
                                                           plan.smem)) != cudaSuccess)
    return (int)err;
  *threads = plan.threads;
  *regs = attr.numRegs;
  *local_bytes = (int)attr.localSizeBytes;
  *planned_per_sm = plan.per_sm;
  return 0;
}

// The plan of a forward launch of NT trunks over B graphs and its grid;
// kernel_of(split) is the launch's kernel.  NB is whatever puts the most
// graphs on an SM (by shared memory, threads and registers at the launch
// bound).  Each CTA runs all NT trunks of its tiles in turn, unless the
// trunk on the grid takes fewer rounds: ceil(NT tiles / CTAs) against NT
// ceil(tiles / CTAs) (at 12,288 graphs and E = 6, 3 against 4).  Where the
// batch has fewer such tiles than the card holds CTAs, one tile's latency,
// not the card's throughput, sets the time: the plan then takes tiles of
// about B / SMs graphs, puts each of a tile's NT trunks on a CTA of its own
// (NT CTAs an SM share its 512 threads at 128 registers), and splits each
// row over the most threads S (8, 4 or 2) that fit.  All plans give the
// same bits (forward_ctas).  The grid is persistent: all the CTAs the card
// holds at once, or one a work item (a tile, or a trunk of one) where
// there are fewer items.
template <class KernelOf>
int forward_plan(KernelOf kernel_of, int NT, const Dims& d, int F1, int C, long long B,
                 Plan* plan, int* grid) {
  int rc = check_dims(d, F1, C);
  if (rc != 0) return rc;
  if (B < 1) return -8;
  int dev = 0;
  DeviceInfo di;
  if ((rc = device_info(&dev, &di)) != 0) return rc;
  // no tile of more than kFwdThreads / (E * split) graphs fits a CTA
  if ((rc = best_plan<FwdGeom>(d, di, imax(kFwdThreads / d.E, 1), kFwdThreads, kFwdRegs, plan,
                               1)) != 0)
    return rc;
  if ((B + plan->nb - 1) / plan->nb < (long long)di.sms * plan->per_sm) {
    const long long per_sm_graphs = (B + di.sms - 1) / di.sms;
    const int max_threads = kSplitThreads / NT;
    const ParamLayout pl(d);
    Plan p;
    for (int split = kMaxSplit; split > 1 && p.per_sm == 0; split /= 2)
      if (per_sm_graphs * d.E * split <= max_threads)
        p = plan_for<FwdGeom>(d, pl, di, (int)per_sm_graphs, max_threads, kFwdRegs, split);
    if (p.per_sm == 0) {
      const int nb = (int)(per_sm_graphs < plan->nb ? per_sm_graphs : plan->nb);
      p = plan_for<FwdGeom>(d, pl, di, nb, kFwdThreads, kFwdRegs, 1);
    }
    p.grid_trunks = NT;
    *plan = p;
  } else if (NT > 1) {
    // a CTA runs ceil(tiles / CTAs) tiles of NT trunks in turn, or
    // ceil(NT tiles / CTAs) trunks of tiles on the grid
    const long long tiles = (B + plan->nb - 1) / plan->nb;
    const long long ctas = (long long)di.sms * plan->per_sm;
    const long long grid_ctas = ctas - ctas % NT;
    const long long rounds_in_turn = NT * ((tiles + ctas - 1) / ctas);
    if (grid_ctas > 0 && (NT * tiles + grid_ctas - 1) / grid_ctas < rounds_in_turn)
      plan->grid_trunks = NT;
  }
  if ((rc = allow_smem(kernel_of(plan->split), dev, plan->smem)) != 0) return rc;
  // with the trunk on the grid, a multiple of NT CTAs (forward_ctas)
  const long long items = (B + plan->nb - 1) / plan->nb * plan->grid_trunks;
  long long ctas = (long long)di.sms * plan->per_sm;
  ctas = ctas < plan->grid_trunks ? plan->grid_trunks : ctas - ctas % plan->grid_trunks;
  *grid = (int)(ctas < items ? ctas : items);
  return 0;
}

}  // namespace
