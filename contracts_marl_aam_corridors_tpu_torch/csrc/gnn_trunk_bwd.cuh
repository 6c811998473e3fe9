// Device code of the GNN trunk backward, shared by csrc/gnn_trunk_bwd.cu (one
// trunk per launch) and csrc/gnn_trunk_dual_bwd.cu (the actor and critic
// trunks in one launch): the parameter and per-graph shared-memory layouts,
// the one-warp recompute forward and vjp of one graph, the CTA-wide
// parameter-gradient sums, one trunk's backward over a tile of graphs, the
// in-order row sum, the per-device launch plan and the launch configuration.
#pragma once

#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <mutex>

namespace {

constexpr int kWarp = 32;
// The one width instantiated (embed hidden = gnn hidden = 16), as in the
// forward kernel.
constexpr int W = 16;
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

__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

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

// Per-graph residuals and scratch in shared memory, in floats.
struct Layout {
  int dm, mk, src, hsrc, xs, qkv, alpha, dx, dpre, scr, u, adw, ddm, dwe, dadj, dhsrc, dsrc,
      size;
  __host__ __device__ Layout(const Dims& d, const ParamLayout& pl) {
    const int E = d.E, H = d.H, QKV = 3 * H * W;
    int o = 0;
    dm = o;
    o += E * E;
    mk = o;
    o += E * E;
    src = o;
    o += E * d.Ds;
    hsrc = o;
    o += E * W;
    xs = o;  // x_0 (EmbedConv output) ... x_{n_tc} (trunk output)
    o += (d.n_tc + 1) * E * W;
    qkv = o;  // per conv layer; the EmbedConv's gradients once those are done
    o += imax(d.n_tc * E * QKV, pl.embed_size);
    alpha = o;  // per conv layer, [t][h][s]
    o += d.n_tc * E * H * E;
    dx = o;
    o += E * W;
    dpre = o;
    o += E * W;
    scr = o;  // dqkv; the forward's head outputs and edge rows; lane rows
    o += imax(E * QKV, imax(kWarp * (2 * W + 1), E * H * W));
    u = o;
    o += E * H * E;
    adw = o;
    o += 2 * E * H;
    ddm = o;
    o += E * E * H;
    dwe = o;
    o += H * W;
    dadj = o;
    o += E * E;
    dhsrc = o;
    o += E * W;
    dsrc = o;
    o += E * d.Ds;
    size = o + ((o & 1) ? 0 : 1);  // odd stride: warps' tiles start on different banks
  }
};

__device__ __forceinline__ float act(float v, int relu) {
  return relu ? fmaxf(v, 0.f) : tanhf(v);
}

// The activation's derivative, from its output.
__device__ __forceinline__ float act_grad(float y, int relu) {
  return relu ? (y > 0.f ? 1.f : 0.f) : 1.f - y * y;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
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

// One edge's EmbedConv chain up to stage l: `a` gets stage l's activation
// output (its LayerNorm's input), `yp` stage l's Linear input (stage l-1's
// LayerNorm output; zero for l = 0).
__device__ void edge_upto(int l, const float* hs, float dv, const float* P,
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

// The forward of one graph by one warp, keeping the residuals: `g` holds
// the graph's src and masked adjacency on entry.
__device__ void graph_forward(float* g, const float* P, const ParamLayout& pl, const Layout& L,
                              const Dims& d, int embed_relu, int gnn_relu, int lane) {
  const int E = d.E, Ds = d.Ds, H = d.H, HC = H * W, QKV = 3 * HC;
  const float* dm = g + L.dm;
  const float* mk = g + L.mk;
  const float* src = g + L.src;
  float* hsrc = g + L.hsrc;
  float* work = g + L.scr;

  for (int i = lane; i < E * W; i += kWarp) {
    const int s = i / W, f = i % W;
    float acc = 0.f;
    for (int k = 0; k < Ds; ++k) acc = fmaf(P[k * W + f], src[s * Ds + k], acc);
    hsrc[i] = acc + P[pl.b1 + f];
  }
  __syncwarp();

  // EmbedConv: lane = (target in this round, source), one edge message each
  float* x0 = g + L.xs;
  const int tpr = kWarp / E;
  for (int t0 = 0; t0 < E; t0 += tpr) {
    const int tl = lane / E, s = lane % E, t = t0 + tl;
    if (tl < tpr && t < E) {
      float a[W], yp[W];
      edge_upto(d.n_embed, hsrc + s * W, dm[s * E + t], P, pl, embed_relu, a, yp);
      layer_norm(a, P + pl.ln_scale(d.n_embed), P + pl.ln_bias(d.n_embed));
      const float mv = mk[s * E + t];
      float* row = work + lane * (W + 1);
#pragma unroll
      for (int f = 0; f < W; ++f) row[f] = mv * a[f];
    }
    __syncwarp();
    const int nt = min(tpr, E - t0);
    for (int i = lane; i < nt * W; i += kWarp) {
      const int tt = i / W, f = i % W;
      float acc = 0.f;
      for (int s2 = 0; s2 < E; ++s2) acc += work[(tt * E + s2) * (W + 1) + f];
      x0[(t0 + tt) * W + f] = acc;
    }
    __syncwarp();
  }

  const float inv_sqrt_c = 1.f / sqrtf((float)W);
  for (int l = 0; l < d.n_tc; ++l) {
    const float* WqkvT = P + pl.tc0 + l * pl.tc_stride;
    const float* bqkv = WqkvT + W * QKV;
    const float* we = bqkv + QKV;
    const float* WskT = we + HC;
    const float* bsk = WskT + W * W;
    const float* X = g + L.xs + l * E * W;
    float* Y = g + L.xs + (l + 1) * E * W;
    float* Q = g + L.qkv + l * E * QKV;
    float* A = g + L.alpha + l * E * H * E;
    float* ob = g + L.scr;

    for (int i = lane; i < E * QKV; i += kWarp) {
      const int e = i / QKV, j = i % QKV;
      float acc = 0.f;
      for (int k = 0; k < W; ++k) acc = fmaf(WqkvT[k * QKV + j], X[e * W + k], acc);
      Q[i] = acc + bqkv[j];
    }
    __syncwarp();

    // lane = (target, head): masked softmax over sources, weighted values
    for (int i = lane; i < E * H; i += kWarp) {
      const int t = i / H, h = i % H;
      const float* q = Q + t * QKV + h * W;
      const float* weh = we + h * W;
      float* li = A + i * E;
      float mx = -INFINITY, any_edge = 0.f;
      for (int s = 0; s < E; ++s) {
        const float* kk = Q + s * QKV + HC + h * W;
        const float dv = dm[s * E + t];
        float acc = 0.f;
#pragma unroll
        for (int c = 0; c < W; ++c) acc = fmaf(q[c], kk[c] + dv * weh[c], acc);
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
      float o[W];
#pragma unroll
      for (int c = 0; c < W; ++c) o[c] = 0.f;
      float ad = 0.f;
      for (int s = 0; s < E; ++s) {
        const float a = li[s] / sum * any_edge;
        li[s] = a;
        const float* vv = Q + s * QKV + 2 * HC + h * W;
#pragma unroll
        for (int c = 0; c < W; ++c) o[c] = fmaf(a, vv[c], o[c]);
        ad = fmaf(a, dm[s * E + t], ad);
      }
#pragma unroll
      for (int c = 0; c < W; ++c) ob[i * W + c] = o[c] + ad * weh[c];
    }
    __syncwarp();

    for (int i = lane; i < E * W; i += kWarp) {
      const int t = i / W, c = i % W;
      float hs = 0.f;
      for (int h = 0; h < H; ++h) hs += ob[(t * H + h) * W + c];
      float sk = 0.f;
      for (int k = 0; k < W; ++k) sk = fmaf(WskT[k * W + c], X[t * W + k], sk);
      Y[i] = act(hs / (float)H + sk + bsk[c], gnn_relu);
    }
    __syncwarp();
  }
}

// The backward of conv layer l of one graph: takes dx (the gradient of the
// layer's output), leaves dx = the gradient of its input, dqkv in scr, dpre,
// this graph's w_e gradient in dwe, and adds the distance gradient to dadj.
__device__ void tc_backward(float* g, const float* P, const ParamLayout& pl, const Layout& L,
                            const Dims& d, int gnn_relu, int lane, int l) {
  const int E = d.E, H = d.H, HC = H * W, QKV = 3 * HC;
  const float* WqkvT = P + pl.tc0 + l * pl.tc_stride;
  const float* we = WqkvT + W * QKV + QKV;
  const float* WskT = we + HC;
  const float* dm = g + L.dm;
  const float* mk = g + L.mk;
  const float* Y = g + L.xs + (l + 1) * E * W;
  const float* Q = g + L.qkv + l * E * QKV;
  const float* A = g + L.alpha + l * E * H * E;
  float* dx = g + L.dx;
  float* dpre = g + L.dpre;
  float* dq = g + L.scr;
  float* u = g + L.u;
  float* adw = g + L.adw;
  float* ddm = g + L.ddm;
  float* dwe = g + L.dwe;
  float* dadj = g + L.dadj;
  const float inv_h = 1.f / (float)H;
  const float inv_sqrt_c = 1.f / sqrtf((float)W);

  for (int i = lane; i < E * W; i += kWarp) dpre[i] = dx[i] * act_grad(Y[i], gnn_relu);
  __syncwarp();

  // lane = (target, head): softmax backward, query gradient, distance terms
  for (int i = lane; i < E * H; i += kWarp) {
    const int t = i / H, h = i % H;
    const float* q = Q + t * QKV + h * W;
    const float* weh = we + h * W;
    const float* al = A + i * E;
    const float* dp = dpre + t * W;
    float* ui = u + i * E;
    float qwe = 0.f, dpwe = 0.f;
#pragma unroll
    for (int c = 0; c < W; ++c) {
      qwe = fmaf(q[c], weh[c], qwe);
      dpwe = fmaf(dp[c], weh[c], dpwe);
    }
    dpwe *= inv_h;
    float S = 0.f;
    for (int s = 0; s < E; ++s) {
      const float* vv = Q + s * QKV + 2 * HC + h * W;
      float acc = 0.f;
#pragma unroll
      for (int c = 0; c < W; ++c) acc = fmaf(dp[c], vv[c], acc);
      const float da = acc * inv_h + dm[s * E + t] * dpwe;
      ui[s] = da;
      S = fmaf(al[s], da, S);
    }
    float ad = 0.f, w = 0.f;
    float dqc[W];
#pragma unroll
    for (int c = 0; c < W; ++c) dqc[c] = 0.f;
    for (int s = 0; s < E; ++s) {
      const float dv = dm[s * E + t];
      const float us = al[s] * (ui[s] - S) * inv_sqrt_c * mk[s * E + t];
      ui[s] = us;
      ad = fmaf(al[s], dv, ad);
      w = fmaf(us, dv, w);
      ddm[(s * E + t) * H + h] = us * qwe + al[s] * dpwe;
      const float* kk = Q + s * QKV + HC + h * W;
#pragma unroll
      for (int c = 0; c < W; ++c) dqc[c] = fmaf(us, kk[c], dqc[c]);
    }
    adw[i] = ad;
    adw[E * H + i] = w;
#pragma unroll
    for (int c = 0; c < W; ++c) dq[t * QKV + h * W + c] = dqc[c] + w * weh[c];
  }
  __syncwarp();

  // lane = (source, key or value column)
  for (int i = lane; i < E * 2 * HC; i += kWarp) {
    const int s = i / (2 * HC), j = i % (2 * HC);
    const int jj = j < HC ? j : j - HC, h = jj / W, c = jj % W;
    float acc = 0.f;
    if (j < HC) {
      for (int t = 0; t < E; ++t) acc = fmaf(u[(t * H + h) * E + s], Q[t * QKV + h * W + c], acc);
    } else {
      for (int t = 0; t < E; ++t) acc = fmaf(A[(t * H + h) * E + s], dpre[t * W + c], acc);
      acc *= inv_h;
    }
    dq[s * QKV + HC + j] = acc;
  }
  for (int i = lane; i < HC; i += kWarp) {
    const int h = i / W, c = i % W;
    float acc = 0.f;
    for (int t = 0; t < E; ++t) {
      acc = fmaf(adw[t * H + h] * inv_h, dpre[t * W + c], acc);
      acc = fmaf(Q[t * QKV + h * W + c], adw[E * H + t * H + h], acc);
    }
    dwe[i] = acc;
  }
  for (int i = lane; i < E * E; i += kWarp) {
    float acc = 0.f;
    for (int h = 0; h < H; ++h) acc += ddm[i * H + h];
    dadj[i] += acc;
  }
  __syncwarp();

  for (int i = lane; i < E * W; i += kWarp) {
    const int e = i / W, k = i % W;
    float acc = 0.f;
    for (int j = 0; j < QKV; ++j) acc = fmaf(WqkvT[k * QKV + j], dq[e * QKV + j], acc);
    for (int c = 0; c < W; ++c) acc = fmaf(WskT[k * W + c], dpre[e * W + c], acc);
    dx[i] = acc;
  }
  __syncwarp();
}

// Conv layer l's parameter gradients, summed over the CTA's first `n`
// graphs, added to the CTA's accumulator; each thread owns its words.
__device__ void tc_reduce(float* acc, const float* tiles, const ParamLayout& pl,
                          const Layout& L, const Dims& d, int l, int n) {
  const int E = d.E, HC = d.H * W, QKV = 3 * HC;
  for (int i = threadIdx.x; i < pl.tc_stride; i += blockDim.x) {
    float sum = 0.f;
    for (int gi = 0; gi < n; ++gi) {
      const float* g = tiles + gi * L.size;
      const float* X = g + L.xs + l * E * W;
      const float* dq = g + L.scr;
      const float* dpre = g + L.dpre;
      if (i < W * QKV) {
        const int k = i / QKV, j = i % QKV;
        for (int e = 0; e < E; ++e) sum = fmaf(X[e * W + k], dq[e * QKV + j], sum);
      } else if (i < W * QKV + QKV) {
        const int j = i - W * QKV;
        for (int e = 0; e < E; ++e) sum += dq[e * QKV + j];
      } else if (i < W * QKV + QKV + HC) {
        sum += g[L.dwe + i - W * QKV - QKV];
      } else if (i < W * QKV + QKV + HC + W * W) {
        const int r = i - W * QKV - QKV - HC, k = r / W, c = r % W;
        for (int e = 0; e < E; ++e) sum = fmaf(X[e * W + k], dpre[e * W + c], sum);
      } else {
        const int c = i - W * QKV - QKV - HC - W * W;
        for (int e = 0; e < E; ++e) sum += dpre[e * W + c];
      }
    }
    acc[pl.tc0 + l * pl.tc_stride + i] += sum;
  }
}

// The EmbedConv backward of one graph: takes dx = the gradient of x_0 and
// leaves this graph's EmbedConv parameter gradients in its qkv region (blob
// order), dsrc, and the distance gradient added to dadj.
__device__ void embed_backward(float* g, const float* P, const ParamLayout& pl, const Layout& L,
                               const Dims& d, int relu, int lane) {
  const int E = d.E, Ds = d.Ds;
  const float* dm = g + L.dm;
  const float* mk = g + L.mk;
  const float* src = g + L.src;
  const float* hsrc = g + L.hsrc;
  const float* dx = g + L.dx;
  float* scr = g + L.scr;
  float* gE = g + L.qkv;
  float* dhsrc = g + L.dhsrc;
  float* dadj = g + L.dadj;
  float* dsrc = g + L.dsrc;
  constexpr int RS = 2 * W + 1;

  for (int i = lane; i < pl.embed_size; i += kWarp) gE[i] = 0.f;
  for (int i = lane; i < E * W; i += kWarp) dhsrc[i] = 0.f;
  __syncwarp();

  const int tpr = kWarp / E;
  float* row = scr + lane * RS;
  for (int t0 = 0; t0 < E; t0 += tpr) {
    const int tl = lane / E, s = lane % E, t = t0 + tl;
    const bool active = tl < tpr && t < E;
    const float dv = active ? dm[s * E + t] : 0.f;
    const float mv = active ? mk[s * E + t] : 0.f;
    float dy[W];
#pragma unroll
    for (int f = 0; f < W; ++f) dy[f] = active ? mv * dx[t * W + f] : 0.f;
    for (int l = d.n_embed; l >= 0; --l) {
      float a[W], yp[W];
      edge_upto(l, hsrc + s * W, dv, P, pl, relu, a, yp);
      float mu, r;
      ln_stats(a, mu, r);
      const float* sc = P + pl.ln_scale(l);
      float m1 = 0.f, m2 = 0.f;
#pragma unroll
      for (int f = 0; f < W; ++f) {
        const float xh = (a[f] - mu) * r;
        const float dxh = dy[f] * sc[f];
        m1 += dxh;
        m2 = fmaf(dxh, xh, m2);
        const float gsc = warp_sum(dy[f] * xh);
        const float gbi = warp_sum(dy[f]);
        if (lane == 0) {
          gE[pl.ln_scale(l) + f] += gsc;
          gE[pl.ln_bias(l) + f] += gbi;
        }
      }
      m1 /= W;
      m2 /= W;
      float dz[W];
#pragma unroll
      for (int f = 0; f < W; ++f) {
        const float xh = (a[f] - mu) * r;
        dz[f] = r * (dy[f] * sc[f] - m1 - xh * m2) * act_grad(a[f], relu);
      }
      if (l >= 1) {
        const int woff = pl.embed0 + (l - 1) * pl.embed_stride;
        const float* WT = P + woff;
#pragma unroll
        for (int f = 0; f < W; ++f) {
          const float tot = warp_sum(dz[f]);
          if (lane == 0) gE[woff + W * W + f] += tot;
          row[f] = dz[f];
          row[W + f] = yp[f];
        }
        __syncwarp();
        for (int i = lane; i < W * W; i += kWarp) {
          const int k = i / W, f = i % W;
          float acc = 0.f;
          for (int ln = 0; ln < kWarp; ++ln) acc = fmaf(scr[ln * RS + W + k], scr[ln * RS + f], acc);
          gE[woff + i] += acc;
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < W; ++k) {
          float acc = 0.f;
#pragma unroll
          for (int f = 0; f < W; ++f) acc = fmaf(WT[k * W + f], dz[f], acc);
          dy[k] = acc;
        }
      } else {
        float ddv = 0.f;
#pragma unroll
        for (int f = 0; f < W; ++f) {
          const float tot = warp_sum(dz[f] * dv);
          if (lane == 0) gE[pl.we1 + f] += tot;
          ddv = fmaf(dz[f], P[pl.we1 + f], ddv);
          row[f] = dz[f];
        }
        if (active) dadj[s * E + t] += ddv;
        __syncwarp();
        const int nt = min(tpr, E - t0);
        for (int i = lane; i < E * W; i += kWarp) {
          const int s2 = i / W, f = i % W;
          float acc = 0.f;
          for (int tt = 0; tt < nt; ++tt) acc += scr[(tt * E + s2) * RS + f];
          dhsrc[i] += acc;
        }
        __syncwarp();
      }
    }
  }

  // lin1: h_src = W1 src + b1 per source entity
  for (int i = lane; i < E * Ds; i += kWarp) {
    const int s = i / Ds, k = i % Ds;
    float acc = 0.f;
    for (int f = 0; f < W; ++f) acc = fmaf(P[k * W + f], dhsrc[s * W + f], acc);
    dsrc[i] = acc;
  }
  for (int i = lane; i < Ds * W; i += kWarp) {
    const int k = i / W, f = i % W;
    float acc = 0.f;
    for (int s = 0; s < E; ++s) acc = fmaf(src[s * Ds + k], dhsrc[s * W + f], acc);
    gE[i] += acc;
  }
  for (int f = lane; f < W; f += kWarp) {
    float acc = 0.f;
    for (int s = 0; s < E; ++s) acc += dhsrc[s * W + f];
    gE[pl.b1 + f] += acc;
  }
  __syncwarp();
}

// Loads the adjacency of the graphs b0 .. b0+G-1 into their tiles (edge
// mask and masked distance) and zeroes their distance gradients.
__device__ void load_adjacency(float* tiles, const float* __restrict__ adj_T, long long B,
                               long long b0, int G, const Layout& L, const Dims& d,
                               float max_edge_dist) {
  const int n_adj = d.E * d.E;
  for (int i = threadIdx.x; i < n_adj * G; i += blockDim.x) {
    const int r = i / G, k = i % G;
    const long long b = b0 + k;
    const float dv = b < B ? adj_T[r * B + b] : 0.f;
    const float mv = (dv > 0.f && dv < max_edge_dist) ? 1.f : 0.f;
    tiles[k * L.size + L.mk + r] = mv;
    tiles[k * L.size + L.dm + r] = dv * mv;
    tiles[k * L.size + L.dadj + r] = 0.f;
  }
}

// One trunk's backward over a tile of G graphs (the first n of them real)
// whose adjacency is loaded: loads the trunk's src and output cotangent,
// recomputes its forward, runs its vjp in reverse layer order, adds its
// parameter gradients summed over the n graphs to `acc` (in blob order, each
// word by the one thread that owns it), adds its distance gradients to the
// tiles' dadj and stores its dsrc.  G consecutive graphs per row, so the
// batch-minor arrays move in whole sectors.  Ends with the CTA synchronised.
__device__ void trunk_tile_backward(float* tiles, const float* __restrict__ src_T,
                                    const float* __restrict__ g_T, const float* P, float* acc,
                                    float* __restrict__ dsrc_T, long long B, long long b0, int n,
                                    int G, const ParamLayout& pl, const Layout& L, const Dims& d,
                                    int embed_relu, int gnn_relu) {
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  float* gw = tiles + warp * L.size;
  const int n_src = d.E * d.Ds, n_out = d.E * W;
  for (int i = threadIdx.x; i < n_src * G; i += blockDim.x) {
    const int r = i / G, k = i % G;
    const long long b = b0 + k;
    tiles[k * L.size + L.src + r] = b < B ? src_T[r * B + b] : 0.f;
  }
  for (int i = threadIdx.x; i < n_out * G; i += blockDim.x) {
    const int r = i / G, k = i % G;
    const long long b = b0 + k;
    tiles[k * L.size + L.dx + r] = b < B ? g_T[r * B + b] : 0.f;
  }
  __syncthreads();
  if (warp < n) graph_forward(gw, P, pl, L, d, embed_relu, gnn_relu, lane);
  for (int l = d.n_tc - 1; l >= 0; --l) {
    if (warp < n) tc_backward(gw, P, pl, L, d, gnn_relu, lane, l);
    __syncthreads();
    tc_reduce(acc, tiles, pl, L, d, l, n);
    __syncthreads();
  }
  if (warp < n) embed_backward(gw, P, pl, L, d, embed_relu, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < pl.embed_size; i += blockDim.x) {
    float sum = 0.f;
    for (int gi = 0; gi < n; ++gi) sum += tiles[gi * L.size + L.qkv + i];
    acc[i] += sum;
  }
  for (int i = threadIdx.x; i < n_src * G; i += blockDim.x) {
    const int r = i / G, k = i % G;
    const long long b = b0 + k;
    if (b < B) dsrc_T[r * B + b] = tiles[k * L.size + L.dsrc + r];
  }
  __syncthreads();
}

// Stores the tiles' distance gradients, zero where the edge mask is.
__device__ void store_dadj(const float* tiles, float* __restrict__ dadj_T, long long B,
                           long long b0, int G, const Layout& L, const Dims& d) {
  const int n_adj = d.E * d.E;
  for (int i = threadIdx.x; i < n_adj * G; i += blockDim.x) {
    const int r = i / G, k = i % G;
    const long long b = b0 + k;
    if (b < B) dadj_T[r * B + b] = tiles[k * L.size + L.mk + r] * tiles[k * L.size + L.dadj + r];
  }
}

// dparams[i] = sum over rows r of partial[r, i], rows in order.
__global__ void sum_rows_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                int rows, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int r = 0; r < rows; ++r) s += partial[(long long)r * n + i];
  out[i] = s;
}

// Resident CTAs on the whole card for one (threads, shared memory) launch
// shape, worked out at a device's first launch of that shape and kept.
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


// Graphs per CTA and dynamic shared memory of a backward launch.  Two
// parameter-sized blocks stay in shared memory beside the graphs' scratch:
// the single backward's parameters and gradient accumulator, or the dual
// backward's two trunks' parameters.
int configure(const Dims& d, int F1, int C, int* graphs_per_cta, int* smem_bytes,
              int* n_params) {
  if (F1 != W || C != W) return -1;
  if (d.E < 1 || d.E > kMaxEntities || d.Ds < 1 || d.H < 1) return -2;
  if (d.n_embed < 0 || d.n_embed > kMaxEmbedLayers || d.n_tc < 1 || d.n_tc > kMaxTcLayers)
    return -4;
  const ParamLayout pl(d);
  const int per_graph = Layout(d, pl).size * (int)sizeof(float);
  const int fixed = 2 * ((pl.total + 31) & ~31) * (int)sizeof(float);
  int G = (kSmemLimit - fixed) / per_graph;
  if (G < 1) return -3;
  G = G < kMaxGraphsPerCta ? G : kMaxGraphsPerCta;
  *graphs_per_cta = G;
  *smem_bytes = fixed + G * per_graph;
  *n_params = pl.total;
  return 0;
}

// The configuration of `kernel` over B graphs and the CTAs it launches (the
// rows of the scratch buffer it needs).
template <typename Kernel>
int grid_for(Kernel kernel, const Dims& d, int F1, int C, long long B, int* G, int* smem,
             int* np, int* grid) {
  const int rc = configure(d, F1, C, G, smem, np);
  if (rc != 0) return rc;
  long long ctas = 0;
  const int prc = plan_launch(kernel, kWarp * *G, *smem, &ctas);
  if (prc != 0) return prc;
  const long long tiles = (B + *G - 1) / *G;
  *grid = (int)(ctas < tiles ? ctas : tiles);
  return 0;
}

}  // namespace
