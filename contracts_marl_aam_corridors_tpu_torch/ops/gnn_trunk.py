"""The GNN trunk (EmbedConv + TransformerConv stack) in the transposed
layout, forward and backward: plain torch versions and hand-written Hopper
kernels.

Counterpart of ``contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py``:
``flatten_gnn_params`` (:450), ``xla_transposed_forward`` (:487-591, ported
as :func:`gnn_trunk_forward_plain`), the Pallas TPU kernels
``make_gnn_forward`` (:299-447, replaced by ``csrc/gnn_trunk_fwd.cu`` behind
:func:`gnn_trunk_forward`) and ``make_gnn_bwd`` (:594-667, replaced by
``csrc/gnn_trunk_bwd.cu`` behind :func:`gnn_trunk_backward`), and the
``custom_vjp`` ``make_gnn_fused`` (:811) that joins them, here the
``torch.autograd.Function`` :class:`GNNTrunk`; and the pair of trunks in one
launch, ``make_gnn_fused_dual`` (:676-808: its Pallas kernels ``fwd_kernel``
:703 and ``bwd_kernel`` :712, replaced by ``csrc/gnn_trunk_dual_fwd.cu``
behind :func:`gnn_trunk_dual_forward` and ``csrc/gnn_trunk_dual_bwd.cu``
behind :func:`gnn_trunk_dual_backward`, joined by :class:`GNNTrunkDual`).

Layout contract (float32), as in the JAX package:
  src_aug_T:  (E*Ds, B)  per-entity EmbedConv input [feat, Embed(etype)],
                         entity-major rows
  adj_T:      (E*E, B)   distance adjacency, row s*E+t = d(s -> t)
  output:     (E*C, B)   per-node embeddings, entity-major rows

Both wrappers run the plain version for tensors on the CPU and the kernel
for tensors on the card; on the card they launch the kernel or raise.  The
kernels are compiled with ``nvcc`` at first use, each from its source in the
package, into ``build/kernels/`` at the repository root, under a name that
hashes the source and every header it reaches (``source_tag``).  The four
trunk kernels run on the panel code of ``csrc/gnn_trunk_panel.cuh``: the
single and dual forwards one body (each trunk of a dual launch equals a
single launch bit for bit), the backwards also ``csrc/gnn_trunk_bwd.cuh``.
``build_all`` also builds the v2 formulation's kernel of
``ops/gnn_trunk_v2.py``, the same forward body staging its weights from the
v2 tuple.
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

Tensor = torch.Tensor

NEG_F32 = float(torch.finfo(torch.float32).min)
LN_EPS = 1e-5
# the trunk shapes the kernels are built for (csrc/gnn_trunk_panel.cuh: W,
# kMaxEmbedLayers, kMaxTcLayers = 1 + gnn_layer_n, kMaxEntities); the plain
# versions take any
KERNEL_WIDTH = 16
MAX_EMBED_LAYERS = 4
MAX_GNN_LAYERS = 7
MAX_ENTITIES = 32

KERNELS = ("gnn_trunk_fwd", "gnn_trunk_bwd", "gnn_trunk_dual_fwd", "gnn_trunk_dual_bwd",
           "gnn_forward_v2")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"


def _relu_flags(use_relu) -> tuple[bool, bool]:
    """(embed_relu, gnn_relu) from a bool (both) or an (embed, gnn) pair.

    EmbedConv follows embed_use_ReLU and the TransformerConv stack follows
    gnn_use_ReLU (reference gnn_new.py:66,227,270)."""
    if isinstance(use_relu, tuple):
        return bool(use_relu[0]), bool(use_relu[1])
    return bool(use_relu), bool(use_relu)


def _act(relu: bool):
    return torch.relu if relu else torch.tanh


def flatten_gnn_params(params: dict, embed_layer_n: int, gnn_layer_n: int) -> tuple:
    """GNNBase parameter tree in the flax layout -> the flat tuple both trunk
    versions take.

    ``params`` is nested like the flax tree (``embed_layer``/``lin1``/
    ``kernel`` ...), with numpy arrays or tensors as leaves; Dense kernels are
    (in, out).  Vectors become (dim, 1) columns, dense kernels are transposed
    to (out, in), and the q/k/v kernels are concatenated (q|k|v).  On tensors
    the result stays differentiable.
    """
    as_t = lambda v: (v if isinstance(v, Tensor) else torch.tensor(np.asarray(v))).to(
        torch.float32)
    col = lambda v: as_t(v).reshape(-1, 1)
    tr = lambda w: as_t(w).T
    ec = params["embed_layer"]
    flat = [
        tr(ec["lin1"]["kernel"]), col(ec["lin1"]["bias"]), col(ec["lin1_edge"]),
        col(ec["ln1"]["scale"]), col(ec["ln1"]["bias"]),
    ]
    for i in range(embed_layer_n):
        flat += [
            tr(ec[f"lin{i + 2}"]["kernel"]), col(ec[f"lin{i + 2}"]["bias"]),
            col(ec[f"ln{i + 2}"]["scale"]), col(ec[f"ln{i + 2}"]["bias"]),
        ]
    for name in ["gnn1"] + [f"gnn2_{i}" for i in range(gnn_layer_n)]:
        tc = params[name]
        wqkv = torch.cat(
            [as_t(tc[k]["kernel"]) for k in ("lin_query", "lin_key", "lin_value")], dim=1
        )
        bqkv = torch.cat([as_t(tc[k]["bias"]) for k in ("lin_query", "lin_key", "lin_value")])
        flat += [
            wqkv.T, col(bqkv), col(tc["lin_edge"]),
            tr(tc["lin_skip"]["kernel"]), col(tc["lin_skip"]["bias"]),
        ]
    return tuple(flat)


def _split_flat(params_flat, embed_layer_n: int, gnn_layer_n: int):
    p = list(params_flat)
    head = p[:5]
    embed = [p[5 + 4 * k : 9 + 4 * k] for k in range(embed_layer_n)]
    o = 5 + 4 * embed_layer_n
    tcs = [p[o + 5 * k : o + 5 * k + 5] for k in range(1 + gnn_layer_n)]
    if len(p) != o + 5 * (1 + gnn_layer_n):
        raise ValueError(f"{len(p)} flat params for {embed_layer_n}/{gnn_layer_n} layers")
    return head, embed, tcs


def gnn_trunk_forward_plain(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_flat, src_aug_T, adj_T, compute_dtype=torch.float32,
) -> Tensor:
    """The trunk as plain torch on the transposed layout, computed in
    ``compute_dtype`` and returned in float32.

    Port of ``xla_transposed_forward`` (gnn_pallas.py:487-591), with the
    entity loops written as batched tensor ops over (source, target).
      edge mask m = 0 < d < max_edge_dist, masked distance dm = d*m;
      EmbedConv: per edge act(W1 src_s + b1 + dm*w_e) -> LN, then
        embed_layer_n x (Linear -> act -> LN), summed over masked sources;
      1 + gnn_layer_n TransformerConv layers: logits q_t.(k_s + dm*w_e)/sqrt(C)
        masked to finfo(f32).min, softmax over sources (zero for a target
        with no in-edges), sum_s a v_s + (sum_s a dm) w_e, mean over heads,
        plus the skip Linear, then act.
    """
    embed_act, gnn_act = (_act(r) for r in _relu_flags(use_relu))
    cdt = compute_dtype
    (W1, b1, w_e1, ln1_s, ln1_b), embed_layers, tc_params = _split_flat(
        [p.to(cdt) for p in params_flat], embed_layer_n, gnn_layer_n
    )
    inv_sqrt_c = float(1.0 / (C ** 0.5))
    B = src_aug_T.shape[-1]
    src = src_aug_T.to(cdt).reshape(E, Ds, B)
    # the edge mask is decided on the float32 distances, as the kernel does
    d32 = adj_T.to(torch.float32).reshape(E, E, B)  # [s, t, b]
    m = ((d32 > 0.0) & (d32 < max_edge_dist)).to(cdt)
    dm = d32.to(cdt) * m

    def ln(x, scale, bias):  # normalize over the feature axis (-2)
        mu = x.mean(dim=-2, keepdim=True)
        dd = x - mu
        var = (dd * dd).mean(dim=-2, keepdim=True)
        return dd * torch.rsqrt(var + LN_EPS) * scale + bias

    h_src = torch.einsum("fk,skb->sfb", W1, src) + b1  # (S, F1, B)
    msg = ln(embed_act(h_src[:, None] + dm[:, :, None, :] * w_e1), ln1_s, ln1_b)
    for Wl, bl, lns, lnb in embed_layers:
        msg = ln(embed_act(torch.einsum("gf,stfb->stgb", Wl, msg) + bl), lns, lnb)
    x = (m[:, :, None, :] * msg).sum(dim=0)  # (T, F1, B)

    HC = H * C
    mask = m[:, :, None, :] > 0  # (S, T, 1, B)
    any_edge = m.amax(dim=0)[:, None, :]  # (T, 1, B)
    for Wqkv, bqkv, w_e, Wskip, bskip in tc_params:
        qkv = torch.einsum("jk,ekb->ejb", Wqkv, x) + bqkv  # (E, 3HC, B)
        q = qkv[:, :HC].reshape(E, H, C, B)
        k = qkv[:, HC : 2 * HC].reshape(E, H, C, B)
        v = qkv[:, 2 * HC :].reshape(E, H, C, B)
        we = w_e.reshape(H, C, 1)
        kd = k[:, None] + dm[:, :, None, None, :] * we  # (S, T, H, C, B)
        logits = (q[None] * kd).sum(dim=3) * inv_sqrt_c  # (S, T, H, B)
        logits = torch.where(mask, logits, NEG_F32)
        ex = torch.exp(logits - logits.amax(dim=0, keepdim=True))
        alpha = ex / ex.sum(dim=0, keepdim=True) * any_edge
        o = (alpha[:, :, :, None, :] * v[:, None]).sum(dim=0)  # (T, H, C, B)
        ad = (alpha * dm[:, :, None, :]).sum(dim=0)  # (T, H, B)
        o = o + ad[:, :, None, :] * we
        x = gnn_act(o.sum(dim=1) / H + torch.einsum("ck,tkb->tcb", Wskip, x) + bskip)
    return x.reshape(E * C, B).to(torch.float32)



def gnn_trunk_backward_plain(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_flat, src_aug_T, adj_T, g, compute_dtype=torch.float32,
) -> tuple[tuple, Tensor, Tensor]:
    """The vjp of :func:`gnn_trunk_forward_plain` for the output cotangent
    ``g`` (E*C, B): ``(dparams_flat, dsrc_aug_T, dadj_T)``, taken with
    ``torch.autograd.grad`` in ``compute_dtype``.

    Counterpart of what ``make_gnn_bwd`` traces inside its body
    (gnn_pallas.py:618-624): ``jax.vjp`` of ``xla_transposed_forward``.
    Parameter gradients are summed over the batch and come in the flat
    layout; the distance gradient is zero where the edge mask is.
    """
    cdt = compute_dtype
    with torch.enable_grad():
        ps = [p.detach().to(cdt).requires_grad_(True) for p in params_flat]
        src = src_aug_T.detach().to(cdt).requires_grad_(True)
        adj = adj_T.detach().to(cdt).requires_grad_(True)
        out = gnn_trunk_forward_plain(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist,
                                      use_relu, ps, src, adj, compute_dtype=cdt)
        grads = torch.autograd.grad(out, ps + [src, adj], grad_outputs=g.to(out.dtype))
    return tuple(grads[:-2]), grads[-2], grads[-1]


def gnn_trunk_backward_layerwise_plain(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_flat, src_aug_T, adj_T, g, compute_dtype=torch.float32,
) -> tuple[tuple, Tensor, Tensor]:
    """The vjp of :func:`gnn_trunk_forward_plain`, as
    :func:`gnn_trunk_backward_plain` returns it, written out by hand in the
    backward kernel's order of work (``csrc/gnn_trunk_bwd.cuh``) over the
    whole batch: a CPU rehearsal of the kernel's arithmetic.

    The forward keeps only the conv layers' inputs x_0 .. x_{n-1} and turns
    the last layer's output into its pre-activation gradient.  Each conv
    layer's backward, last layer first, recomputes its q/k/v and attention
    weights head by head from x_l and runs the softmax backward with the
    any-edge factor, the distance terms and the q/k/v products.  The
    EmbedConv backward recomputes each edge's chain from its input, stage by
    stage, and runs the LayerNorm and Linear backwards per edge.
    """
    embed_relu, gnn_relu = _relu_flags(use_relu)
    embed_act, gnn_act = _act(embed_relu), _act(gnn_relu)
    cdt = compute_dtype
    (W1, b1, w_e1, ln1_s, ln1_b), embed_layers, tc_params = _split_flat(
        [p.to(cdt) for p in params_flat], embed_layer_n, gnn_layer_n)
    lns = [(ln1_s, ln1_b)] + [(s, b) for _, _, s, b in embed_layers]
    inv_sqrt_c, inv_h = float(1.0 / (C ** 0.5)), 1.0 / H
    B = src_aug_T.shape[-1]
    src = src_aug_T.to(cdt).reshape(E, Ds, B)
    d32 = adj_T.to(torch.float32).reshape(E, E, B)  # [s, t, b]
    m = ((d32 > 0.0) & (d32 < max_edge_dist)).to(cdt)
    dm = d32.to(cdt) * m
    any_edge = m.amax(dim=0)  # (T, B)

    def grad_from_out(y, relu):  # the activation's derivative, from its output
        return (y > 0).to(y.dtype) if relu else 1.0 - y * y

    def ln_stats(a):  # over the feature axis (-2)
        mu = a.mean(dim=-2, keepdim=True)
        d = a - mu
        return mu, torch.rsqrt((d * d).mean(dim=-2, keepdim=True) + LN_EPS)

    h_src = torch.einsum("fk,skb->sfb", W1, src) + b1  # (S, F1, B)

    def chain(l):
        """Every edge's stage-l activation output and stage-l Linear input
        (stage l-1's LayerNorm output; None for l = 0), (S, T, F1, B)."""
        a = embed_act(h_src[:, None] + dm[:, :, None, :] * w_e1)
        yp = None
        for j in range(1, l + 1):
            mu, r = ln_stats(a)
            yp = (a - mu) * r * lns[j - 1][0] + lns[j - 1][1]
            Wj, bj = embed_layers[j - 1][:2]
            a = embed_act(torch.einsum("gf,stfb->stgb", Wj, yp) + bj)
        return a, yp

    def heads(Wqkv, bqkv, w_e, x, h):
        """Head h's q, k, v (E, C, B), its w_e column (C, 1) and attention
        weights (S, T, B), the any-edge factor applied."""
        HC = H * C
        rows = [slice(o + h * C, o + (h + 1) * C) for o in (0, HC, 2 * HC)]
        q, k, v = (torch.einsum("jk,ekb->ejb", Wqkv[r], x) + bqkv[r] for r in rows)
        we = w_e[h * C:(h + 1) * C]
        qwe = (q * we).sum(dim=1)  # (T, B)
        logits = ((q[None] * k[:, None]).sum(dim=2) + dm * qwe[None]) * inv_sqrt_c
        logits = torch.where(m > 0, logits, NEG_F32)
        ex = torch.exp(logits - logits.amax(dim=0, keepdim=True))
        return q, k, v, we, qwe, ex / ex.sum(dim=0, keepdim=True) * any_edge, rows

    # the forward, keeping the conv layers' inputs
    a, _ = chain(embed_layer_n)
    mu, r = ln_stats(a)
    x = (m[:, :, None, :] * ((a - mu) * r * lns[-1][0] + lns[-1][1])).sum(dim=0)  # (T, F1, B)
    xs = []
    for Wqkv, bqkv, w_e, Wskip, bskip in tc_params:
        xs.append(x)
        acc = torch.einsum("ck,tkb->tcb", Wskip, x)
        for h in range(H):
            q, k, v, we, qwe, alpha, _ = heads(Wqkv, bqkv, w_e, x, h)
            o = (alpha[:, :, None, :] * v[:, None]).sum(dim=0) + (alpha * dm).sum(dim=0)[:, None] * we
            acc = acc + o * inv_h
        x = gnn_act(acc + bskip)
    # the output leaves the trunk in float32, and so does its cotangent
    dpre = g.to(torch.float32).to(cdt).reshape(E, C, B) * grad_from_out(x, gnn_relu)

    # the conv layers' backward, last layer first
    dadj = torch.zeros_like(dm)
    dtcs = []
    for l in range(len(tc_params) - 1, -1, -1):
        Wqkv, bqkv, w_e, Wskip, bskip = tc_params[l]
        X = xs[l]
        if l < len(tc_params) - 1:
            dpre = dx * grad_from_out(xs[l + 1], gnn_relu)
        dx = torch.einsum("ck,tcb->tkb", Wskip, dpre)
        dWqkv, dbqkv, dwe = (torch.zeros_like(t) for t in (Wqkv, bqkv, w_e))
        for h in range(H):
            q, k, v, we, qwe, alpha, rows = heads(Wqkv, bqkv, w_e, X, h)
            dpwe = (dpre * we).sum(dim=1) * inv_h  # (T, B)
            da = (dpre[None] * v[:, None]).sum(dim=2) * inv_h + dm * dpwe[None]  # (S, T, B)
            u = alpha * (da - (alpha * da).sum(dim=0, keepdim=True)) * inv_sqrt_c * m
            ad, w = (alpha * dm).sum(dim=0), (u * dm).sum(dim=0)  # (T, B)
            dadj = dadj + u * qwe[None] + alpha * dpwe[None]
            dq = torch.einsum("stb,scb->tcb", u, k) + w[:, None] * we
            dk = torch.einsum("stb,tcb->scb", u, q)
            dv = torch.einsum("stb,tcb->scb", alpha, dpre) * inv_h
            dwe[h * C:(h + 1) * C] = (ad[:, None] * inv_h * dpre + w[:, None] * q).sum(
                dim=(0, 2))[:, None]
            for rr, dd in zip(rows, (dq, dk, dv)):
                dx = dx + torch.einsum("jk,ejb->ekb", Wqkv[rr], dd)
                dWqkv[rr] = torch.einsum("ejb,ekb->jk", dd, X)
                dbqkv[rr] = dd.sum(dim=(0, 2))[:, None]
        dWskip = torch.einsum("tcb,tkb->ck", dpre, X)
        dtcs.append([dWqkv, dbqkv, dwe, dWskip, dpre.sum(dim=(0, 2))[:, None]])

    # the EmbedConv backward, per edge, stage by stage from the last
    dembed = [None] * embed_layer_n
    dlns = [None] * (embed_layer_n + 1)
    dy = m[:, :, None, :] * dx[None]  # (S, T, F1, B)
    for l in range(embed_layer_n, -1, -1):
        a, yp = chain(l)
        mu, r = ln_stats(a)
        xh = (a - mu) * r
        dlns[l] = [(dy * xh).sum(dim=(0, 1, 3))[:, None], dy.sum(dim=(0, 1, 3))[:, None]]
        dxh = dy * lns[l][0]
        dz = r * (dxh - dxh.mean(dim=2, keepdim=True)
                  - xh * (dxh * xh).mean(dim=2, keepdim=True)) * grad_from_out(a, embed_relu)
        if l >= 1:
            Wl = embed_layers[l - 1][0]
            dembed[l - 1] = [torch.einsum("stgb,stfb->gf", dz, yp),
                             dz.sum(dim=(0, 1, 3))[:, None]]
            dy = torch.einsum("gf,stgb->stfb", Wl, dz)
    dwe1 = (dz * dm[:, :, None, :]).sum(dim=(0, 1, 3))[:, None]
    dadj = dadj + (dz * w_e1).sum(dim=2)
    dhsrc = dz.sum(dim=1)  # (S, F1, B)
    dsrc = torch.einsum("fk,sfb->skb", W1, dhsrc).reshape(E * Ds, B)
    dflat = [torch.einsum("sfb,skb->fk", dhsrc, src), dhsrc.sum(dim=(0, 2))[:, None], dwe1]
    dflat += dlns[0]
    for (dW, db), (dls, dlb) in zip(dembed, dlns[1:]):
        dflat += [dW, db, dls, dlb]
    for d in reversed(dtcs):
        dflat += d
    # the distances reach the trunk through a float32 cast, as in the forward
    dadj = (m * dadj).to(torch.float32).to(cdt).reshape(E * E, B)
    return tuple(dflat), dsrc, dadj


def gnn_trunk_dual_forward_plain(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_a, params_c, src_a_T, src_c_T, adj_T, compute_dtype=torch.float32,
) -> tuple[Tensor, Tensor]:
    """Both trunks on one adjacency: ``(out_a, out_c)``, each (E*C, B).

    The pair function ``f_pair`` of ``make_gnn_fused_dual``
    (gnn_pallas.py:694-701), as two calls of :func:`gnn_trunk_forward_plain`
    that differ in their flat parameters and EmbedConv inputs."""
    dims = (E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu)
    return (gnn_trunk_forward_plain(*dims, params_a, src_a_T, adj_T, compute_dtype),
            gnn_trunk_forward_plain(*dims, params_c, src_c_T, adj_T, compute_dtype))


def gnn_trunk_dual_backward_plain(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_a, params_c, src_a_T, src_c_T, adj_T, g_a, g_c, compute_dtype=torch.float32,
) -> tuple[tuple, tuple, Tensor, Tensor, Tensor]:
    """The vjp of :func:`gnn_trunk_dual_forward_plain` for the cotangents
    ``g_a`` and ``g_c``: ``(dparams_a, dparams_c, dsrc_a_T, dsrc_c_T,
    dadj_T)``, taken with ``torch.autograd.grad`` of the pair in
    ``compute_dtype``; ``dadj_T`` is the sum of both trunks' distance
    gradients.  Counterpart of what ``make_gnn_fused_dual``'s backward
    kernel traces (gnn_pallas.py:719-720)."""
    cdt = compute_dtype
    with torch.enable_grad():
        pa = [p.detach().to(cdt).requires_grad_(True) for p in params_a]
        pc = [p.detach().to(cdt).requires_grad_(True) for p in params_c]
        sa, sc, adj = (t.detach().to(cdt).requires_grad_(True) for t in (src_a_T, src_c_T, adj_T))
        out_a, out_c = gnn_trunk_dual_forward_plain(
            E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu, pa, pc, sa, sc,
            adj, compute_dtype=cdt)
        grads = torch.autograd.grad((out_a, out_c), pa + pc + [sa, sc, adj],
                                    grad_outputs=(g_a.to(out_a.dtype), g_c.to(out_c.dtype)))
    n = len(pa)
    return tuple(grads[:n]), tuple(grads[n:2 * n]), grads[-3], grads[-2], grads[-1]


# --------------------------------------------------------------------------
# The CUDA kernels: build, load, launch.
# --------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the trunk kernels cannot be built")


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', flags=re.M)


def include_closure(name: str, csrc: Path = CSRC) -> list[str]:
    """The headers ``csrc/<name>.cu`` reaches through quoted includes,
    nested ones too, in the order first reached (paths relative to
    ``csrc``)."""
    seen, todo = [], [f"{name}.cu"]
    while todo:
        text = (csrc / todo.pop(0)).read_bytes()
        for inc in _INCLUDE.findall(text):
            header = inc.decode()
            if header not in seen:
                seen.append(header)
                todo.append(header)
    return seen


def source_tag(name: str, csrc: Path = CSRC) -> str:
    """The hash that names ``csrc/<name>.cu``'s library: the source and every
    header it reaches, so a change to any of them builds anew."""
    h = hashlib.sha256()
    for f in [f"{name}.cu"] + include_closure(name, csrc):
        h.update(f.encode() + b"\0" + (csrc / f).read_bytes() + b"\0")
    return h.hexdigest()[:12]


def compile_kernel(source: Path, lib: Path) -> dict:
    """``nvcc`` for sm_90a: ``source`` into the shared library ``lib`` with
    a plain C interface.  Returns the library path, the compile seconds and
    the ptxas register, spill and shared-memory lines."""
    lib.parent.mkdir(parents=True, exist_ok=True)
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(lib) + ".tmp", str(source),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source.name} ({proc.returncode}):\n{proc.stderr}")
    os.replace(str(lib) + ".tmp", lib)
    ptxas = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    return {"library": str(lib), "seconds": seconds, "ptxas": ptxas}


@functools.lru_cache(maxsize=None)
def build(name: str) -> dict:
    """Compile ``csrc/<name>.cu`` for sm_90a into a shared library with a
    plain C interface (once per process; the file name carries
    :func:`source_tag`).  Returns :func:`compile_kernel`'s record."""
    if name not in KERNELS:
        raise ValueError(f"no kernel {name!r}; the kernels are {KERNELS}")
    return compile_kernel(CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}_{source_tag(name)}.so")


def build_all() -> dict:
    """Build every kernel, one ``nvcc`` per source, all started together."""
    with concurrent.futures.ThreadPoolExecutor(len(KERNELS)) as pool:
        return dict(zip(KERNELS, pool.map(build, KERNELS)))


_p, _i, _f, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_ip = ctypes.POINTER(_i)
# argument types of each library's C functions (all return int)
_SIGNATURES = {
    "gnn_trunk_fwd": {
        "gnn_trunk_fwd": [_p, _p, _p, _p, _ll] + [_i] * 7 + [_f, _i, _i, _i, _p],
        "gnn_trunk_fwd_config": [_i] * 7 + [_ll] + [_ip] * 5,
        "gnn_trunk_fwd_attributes": [_i] * 7 + [_ll] + [_ip] * 5,
    },
    "gnn_trunk_bwd": {
        "gnn_trunk_bwd": [_p] * 8 + [_ll] + [_i] * 7 + [_f] + [_i] * 4 + [_p],
        "gnn_trunk_bwd_config": [_i] * 7 + [_ll] + [_ip] * 4,
        "gnn_trunk_bwd_attributes": [_i] * 7 + [_ip] * 5,
    },
    "gnn_trunk_dual_fwd": {
        "gnn_trunk_dual_fwd": [_p] * 7 + [_ll] + [_i] * 7 + [_f, _i, _i, _i, _p],
        "gnn_trunk_dual_fwd_config": [_i] * 7 + [_ll] + [_ip] * 6,
        "gnn_trunk_dual_fwd_attributes": [_i] * 7 + [_ll] + [_ip] * 5,
    },
    "gnn_trunk_dual_bwd": {
        "gnn_trunk_dual_bwd": [_p] * 12 + [_ll] + [_i] * 7 + [_f] + [_i] * 4 + [_p],
        "gnn_trunk_dual_bwd_config": [_i] * 7 + [_ll] + [_ip] * 4,
        "gnn_trunk_dual_bwd_attributes": [_i] * 7 + [_ip] * 5,
    },
    "gnn_forward_v2": {
        "gnn_forward_v2": [_p, _p, _p, _i, _p, _ll] + [_i] * 6 + [_f, _i, _i, _p],
        "gnn_forward_v2_config": [_i] * 6 + [_ll] + [_ip] * 5,
        "gnn_forward_v2_attributes": [_i] * 6 + [_ll] + [_ip] * 5,
    },
}


@functools.lru_cache(maxsize=None)
def _library(name: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(build(name)["library"])
    for fn, argtypes in _SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _i
    return lib


_CONFIG_ERRORS = {
    -1: "the kernel is instantiated for embed and gnn hidden widths of 16 only",
    -2: "entity count out of the kernel's range",
    -3: "per-CTA shared memory would exceed what the kernel can request",
    -4: "layer counts out of the kernel's range",
    -5: "parameter count does not match the dimensions",
    -6: "device ordinal beyond the kernel's launch-plan table",
    -7: "the scratch buffer has fewer rows than the launch has CTAs",
    -8: "empty batch",
    -9: "more panel kernels on one device than the library's table holds",
}


def _check_rc(name: str, rc: int) -> None:
    if rc == 0:
        return
    if rc < 0:
        raise ValueError(f"{name}: {_CONFIG_ERRORS.get(rc, rc)}")
    raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def kernel_config(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B) -> dict:
    """The forward kernel's plan for a batch of B graphs: graphs per CTA,
    threads per (entity, graph) row, dynamic shared memory bytes, parameter
    floats and CTAs (raises where it cannot run these dimensions)."""
    out = [ctypes.c_int() for _ in range(5)]
    _check_rc("gnn_trunk_fwd", _library("gnn_trunk_fwd").gnn_trunk_fwd_config(
        E, Ds, H, F1, C, embed_layer_n, 1 + gnn_layer_n, B, *(ctypes.byref(o) for o in out)))
    keys = ("graphs_per_cta", "threads_per_row", "smem_bytes", "n_params", "ctas")
    return dict(zip(keys, (o.value for o in out)))


def backward_config(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B) -> dict:
    """The backward kernel's graphs per CTA, dynamic shared memory bytes,
    parameter floats and CTAs for a batch of B graphs (the rows of its
    scratch buffer); raises where it cannot run these dimensions."""
    g, smem, npar, grid = (ctypes.c_int() for _ in range(4))
    _check_rc("gnn_trunk_bwd", _library("gnn_trunk_bwd").gnn_trunk_bwd_config(
        E, Ds, H, F1, C, embed_layer_n, 1 + gnn_layer_n, B,
        ctypes.byref(g), ctypes.byref(smem), ctypes.byref(npar), ctypes.byref(grid)))
    return {"graphs_per_cta": g.value, "smem_bytes": smem.value, "n_params": npar.value,
            "ctas": grid.value}


def dual_kernel_config(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B) -> dict:
    """The dual forward kernel's plan for a batch of B graphs, as
    :func:`kernel_config` gives row 1's (parameter floats of one trunk), and
    ``trunk_on_grid``: whether each trunk of a tile is a CTA of its own (the
    plan's choice at small batches) or a CTA runs both in turn."""
    out = [ctypes.c_int() for _ in range(6)]
    _check_rc("gnn_trunk_dual_fwd", _library("gnn_trunk_dual_fwd").gnn_trunk_dual_fwd_config(
        E, Ds, H, F1, C, embed_layer_n, 1 + gnn_layer_n, B, *(ctypes.byref(o) for o in out)))
    keys = ("graphs_per_cta", "threads_per_row", "smem_bytes", "n_params", "ctas",
            "trunk_on_grid")
    conf = dict(zip(keys, (o.value for o in out)))
    conf["trunk_on_grid"] = bool(conf["trunk_on_grid"])
    return conf


def dual_backward_config(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B) -> dict:
    """The dual backward kernel's graphs per CTA, dynamic shared memory
    bytes, parameter floats of one trunk and CTAs for a batch of B graphs
    (the rows of its (CTAs, 2 n_params) scratch buffer)."""
    g, smem, npar, grid = (ctypes.c_int() for _ in range(4))
    _check_rc("gnn_trunk_dual_bwd", _library("gnn_trunk_dual_bwd").gnn_trunk_dual_bwd_config(
        E, Ds, H, F1, C, embed_layer_n, 1 + gnn_layer_n, B,
        ctypes.byref(g), ctypes.byref(smem), ctypes.byref(npar), ctypes.byref(grid)))
    return {"graphs_per_cta": g.value, "smem_bytes": smem.value, "n_params": npar.value,
            "ctas": grid.value}


def backward_attributes(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, dual=False) -> dict:
    """What the compiler and the card make of the backward kernel (``dual``:
    the dual backward) at these dimensions: threads a CTA, registers and
    local memory bytes a thread, the CTAs an SM holds
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``) and the CTAs an SM
    its launch plans for (by shared memory, threads and registers)."""
    name = "gnn_trunk_dual_bwd" if dual else "gnn_trunk_bwd"
    out = [ctypes.c_int() for _ in range(5)]
    _check_rc(name, getattr(_library(name), f"{name}_attributes")(
        E, Ds, H, F1, C, embed_layer_n, 1 + gnn_layer_n, *(ctypes.byref(o) for o in out)))
    keys = ("threads", "registers", "local_bytes", "ctas_per_sm", "planned_ctas_per_sm")
    return dict(zip(keys, (o.value for o in out)))


def forward_attributes(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, dual=False) -> dict:
    """What the compiler and the card make of the forward kernel (``dual``:
    the dual forward) under its plan for a batch of B graphs, as
    :func:`backward_attributes` gives them: threads a CTA, registers and
    local memory bytes a thread, the CTAs an SM holds and the CTAs an SM the
    plan counts."""
    name = "gnn_trunk_dual_fwd" if dual else "gnn_trunk_fwd"
    out = [ctypes.c_int() for _ in range(5)]
    _check_rc(name, getattr(_library(name), f"{name}_attributes")(
        E, Ds, H, F1, C, embed_layer_n, 1 + gnn_layer_n, B, *(ctypes.byref(o) for o in out)))
    keys = ("threads", "registers", "local_bytes", "ctas_per_sm", "planned_ctas_per_sm")
    return dict(zip(keys, (o.value for o in out)))


class KernelParams(NamedTuple):
    """The kernels' parameters: one contiguous float32 buffer in their
    order, weights stored (in, out) so a warp's lanes read consecutive words,
    and the embed width ``F1`` it was laid out for."""
    blob: Tensor
    F1: int


def param_blob(params_flat, embed_layer_n: int, gnn_layer_n: int) -> KernelParams:
    """Flat params (:func:`flatten_gnn_params`) -> the kernels' buffer.
    Differentiable: a gradient in the flat layout maps to one in the
    buffer's by the same call."""
    head, embed, tcs = _split_flat(params_flat, embed_layer_n, gnn_layer_n)
    parts = [head[0].T] + list(head[1:])
    for W, *vecs in embed:
        parts += [W.T] + vecs
    for Wqkv, bqkv, w_e, Wskip, bskip in tcs:
        parts += [Wqkv.T, bqkv, w_e, Wskip.T, bskip]
    blob = torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)
    return KernelParams(blob, head[0].shape[0])


def unpack_blob(kp: KernelParams, Ds, H, C, embed_layer_n, gnn_layer_n) -> tuple:
    """The inverse of :func:`param_blob`: the buffer -> the flat tuple, as
    views of the buffer."""
    blob, F1 = kp.blob, kp.F1
    QKV = 3 * H * C
    cur = 0

    def take(n):
        nonlocal cur
        cur += n
        return blob[cur - n : cur]

    weight = lambda n_in, n_out: take(n_in * n_out).reshape(n_in, n_out).T
    col = lambda n: take(n).reshape(n, 1)
    flat = [weight(Ds, F1), col(F1), col(F1), col(F1), col(F1)]
    for _ in range(embed_layer_n):
        flat += [weight(F1, F1), col(F1), col(F1), col(F1)]
    cin = F1
    for _ in range(1 + gnn_layer_n):
        flat += [weight(cin, QKV), col(QKV), col(H * C), weight(cin, C), col(C)]
        cin = C
    if cur != blob.numel():
        raise ValueError(f"a buffer of {blob.numel()} floats for {cur} parameters")
    return tuple(flat)


def _check_inputs(name, E, Ds, C, tensors) -> None:
    """The kernels' contract on CUDA inputs: contiguous float32 of the
    transposed shapes (``src*`` (E*Ds, B), ``adj*`` (E*E, B), ``g*``
    (E*C, B)), all on one device."""
    first = next(iter(tensors.values()))
    dev, B = first.device, first.shape[-1]
    rows = {"src": E * Ds, "adj": E * E, "g": E * C}
    for key, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous float32 tensor on {dev}")
        if tuple(t.shape) != (rows[key.split("_")[0]], B):
            raise ValueError(f"{name}: {key} has shape {tuple(t.shape)}, "
                             f"expected {(rows[key.split('_')[0]], B)}")


def gnn_trunk_forward(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params, src_aug_T, adj_T,
) -> Tensor:
    """The trunk forward: the plain version for CPU tensors, the
    ``gnn_trunk_fwd`` CUDA kernel for tensors on the card.

    ``params`` is :func:`flatten_gnn_params`'s tuple or a
    :class:`KernelParams` buffer (``GNNBase.kernel_params``, which spares
    packing the buffer per call).  Where a gradient is needed (grad enabled
    and an input that requires it) the call goes through :class:`GNNTrunk`,
    whose backward is the ``gnn_trunk_bwd`` kernel on the card.  Without one
    the CPU path takes only the flat tuple.  ``gnn_trunk_forward.launches``
    counts forward kernel launches.
    """
    dims = (E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu)
    dev = src_aug_T.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gnn_trunk_forward: no path for device {dev}")
    kp = params if isinstance(params, KernelParams) else None
    leaves = (kp.blob,) if kp is not None else tuple(params)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves + (src_aug_T, adj_T)):
        if kp is None:
            kp = param_blob(params, embed_layer_n, gnn_layer_n)
        return GNNTrunk.apply(dims, kp.F1, kp.blob, src_aug_T, adj_T)
    if dev.type == "cpu":
        if kp is not None:
            raise ValueError("gnn_trunk_forward: the plain version takes the flat params")
        return gnn_trunk_forward_plain(*dims, params, src_aug_T, adj_T)
    if kp is None:
        kp = param_blob(params, embed_layer_n, gnn_layer_n)
    return _forward_kernel(dims, kp, src_aug_T, adj_T)


gnn_trunk_forward.launches = 0


def _forward_kernel(dims, kp: KernelParams, src_aug_T, adj_T) -> Tensor:
    """Check, allocate, launch and count one forward on the card."""
    E, Ds, H, C = dims[:4]
    _check_inputs("gnn_trunk_fwd", E, Ds, C, {"src_aug_T": src_aug_T, "adj_T": adj_T})
    dev = src_aug_T.device
    if kp.blob.device != dev:
        raise ValueError(f"the trunk's parameters must lie on {dev}")
    B = src_aug_T.shape[-1]
    out = torch.empty((E * C, B), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    launch_kernel(*dims, kp, src_aug_T, adj_T, out)
    gnn_trunk_forward.launches += 1
    return out


def launch_kernel(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
                  kp: KernelParams, src_aug_T, adj_T, out) -> None:
    """One launch of the forward kernel on tensors the caller has checked,
    on the current stream.  It does not count: :func:`gnn_trunk_forward` is
    the path the model takes, and this entry lets a measurement time the
    kernel alone."""
    embed_relu, gnn_relu = _relu_flags(use_relu)
    dev = src_aug_T.device
    with torch.cuda.device(dev):
        rc = _library("gnn_trunk_fwd").gnn_trunk_fwd(
            src_aug_T.data_ptr(), adj_T.data_ptr(), kp.blob.data_ptr(), out.data_ptr(),
            src_aug_T.shape[-1], E, Ds, H, kp.F1, C, embed_layer_n, 1 + gnn_layer_n,
            float(max_edge_dist), int(embed_relu), int(gnn_relu), kp.blob.numel(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_rc("gnn_trunk_fwd", rc)


def gnn_trunk_backward(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    kp: KernelParams, src_aug_T, adj_T, g,
) -> tuple[Tensor, Tensor, Tensor]:
    """The trunk's vjp for the output cotangent ``g``: ``(dblob, dsrc_aug_T,
    dadj_T)``, the parameter gradient in the buffer's layout.  The plain
    version for CPU tensors, the ``gnn_trunk_bwd`` CUDA kernel for tensors
    on the card.  ``gnn_trunk_backward.launches`` counts kernel launches."""
    dims = (E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu)
    dev = src_aug_T.device
    if dev.type == "cpu":
        flat = unpack_blob(kp, Ds, H, C, embed_layer_n, gnn_layer_n)
        dflat, dsrc, dadj = gnn_trunk_backward_plain(*dims, flat, src_aug_T, adj_T, g)
        return param_blob(dflat, embed_layer_n, gnn_layer_n).blob, dsrc, dadj
    if dev.type != "cuda":
        raise ValueError(f"gnn_trunk_backward: no path for device {dev}")
    _check_inputs("gnn_trunk_bwd", E, Ds, C, {"src_aug_T": src_aug_T, "adj_T": adj_T, "g": g})
    blob = kp.blob
    if blob.device != dev or blob.dtype != torch.float32 or not blob.is_contiguous():
        raise ValueError(f"the trunk's parameters must be a contiguous float32 buffer on {dev}")
    B = src_aug_T.shape[-1]
    dsrc = torch.empty_like(src_aug_T)
    dadj = torch.empty_like(adj_T)
    if B == 0:
        return torch.zeros_like(blob), dsrc, dadj
    dblob = torch.empty_like(blob)
    with torch.cuda.device(dev):
        conf = backward_config(E, Ds, H, kp.F1, C, embed_layer_n, gnn_layer_n, B)
    partial = torch.empty((conf["ctas"], blob.numel()), dtype=torch.float32, device=dev)
    launch_backward_kernel(*dims, kp, src_aug_T, adj_T, g, dsrc, dadj, dblob, partial)
    gnn_trunk_backward.launches += 1
    return dblob, dsrc, dadj


gnn_trunk_backward.launches = 0


def launch_backward_kernel(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
                           kp: KernelParams, src_aug_T, adj_T, g, dsrc, dadj, dblob,
                           partial) -> None:
    """One launch of the backward kernel (and its row sum) on tensors the
    caller has checked, on the current stream; ``partial`` is the
    (CTAs, n_params) scratch buffer.  It does not count, like
    :func:`launch_kernel`."""
    embed_relu, gnn_relu = _relu_flags(use_relu)
    dev = src_aug_T.device
    with torch.cuda.device(dev):
        rc = _library("gnn_trunk_bwd").gnn_trunk_bwd(
            src_aug_T.data_ptr(), adj_T.data_ptr(), g.data_ptr(), kp.blob.data_ptr(),
            dsrc.data_ptr(), dadj.data_ptr(), dblob.data_ptr(), partial.data_ptr(),
            src_aug_T.shape[-1], E, Ds, H, kp.F1, C, embed_layer_n, 1 + gnn_layer_n,
            float(max_edge_dist), int(embed_relu), int(gnn_relu), kp.blob.numel(),
            partial.shape[0], torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_rc("gnn_trunk_bwd", rc)


class GNNTrunk(torch.autograd.Function):
    """The differentiable trunk, counterpart of ``make_gnn_fused``
    (gnn_pallas.py:811): the forward kernel (plain version on the CPU),
    saving only its inputs, and a backward that recomputes the forward inside
    the backward kernel (plain vjp on the CPU).

    ``GNNTrunk.apply(dims, F1, blob, src_aug_T, adj_T)`` with ``dims`` the
    leading eight arguments of :func:`gnn_trunk_forward`."""

    @staticmethod
    def forward(ctx, dims, F1, blob, src_aug_T, adj_T):
        kp = KernelParams(blob, F1)
        ctx.dims, ctx.F1 = dims, F1
        ctx.save_for_backward(blob, src_aug_T, adj_T)
        if src_aug_T.device.type == "cpu":
            E, Ds, H, C, embed_layer_n, gnn_layer_n = dims[:6]
            flat = unpack_blob(kp, Ds, H, C, embed_layer_n, gnn_layer_n)
            return gnn_trunk_forward_plain(*dims, flat, src_aug_T, adj_T)
        return _forward_kernel(dims, kp, src_aug_T, adj_T)

    @staticmethod
    def backward(ctx, g):
        blob, src_aug_T, adj_T = ctx.saved_tensors
        dblob, dsrc, dadj = gnn_trunk_backward(
            *ctx.dims, KernelParams(blob, ctx.F1), src_aug_T, adj_T,
            g.to(torch.float32).contiguous())
        return None, None, dblob, dsrc, dadj


def trunk_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params) -> dict:
    """Floating-point operations and bytes one trunk forward needs.

    Operations count the forward's arithmetic (a multiply-add is two, an
    exp or rsqrt one) with the per-edge work taken over the ``n_edges``
    unmasked (source, target) pairs this input holds; bytes count each input
    read once and the output written once (float32)."""
    HC = H * C
    ln = 7 * F1
    ops = B * E * F1 * (2 * Ds + 1)  # lin1 per source
    ops += n_edges * (3 * F1 + ln + embed_layer_n * (2 * F1 * F1 + 2 * F1 + ln) + 2 * F1)
    cin = F1
    for _ in range(1 + gnn_layer_n):
        ops += B * E * 3 * HC * (2 * cin + 1)  # qkv
        ops += n_edges * H * (4 * C + 1)  # logits
        ops += n_edges * H * 4 + B * E * H  # softmax
        ops += n_edges * H * (2 * C + 2) + B * E * H * 2 * C  # values + edge term
        ops += B * E * C * (H + 2 * cin + 4)  # head mean, skip, bias, act
        cin = C
    nbytes = 4 * (B * (E * Ds + E * E + E * C) + n_params)
    return {"flops": int(ops), "bytes": int(nbytes)}


def trunk_bwd_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params) -> dict:
    """Floating-point operations and bytes one trunk backward needs: the
    recomputed forward plus its vjp.

    The vjp is counted at twice the forward's operations (every product of
    the forward has two in its vjp, one for the input's gradient and one for
    the weight's, and every elementwise step about twice its own), so the
    call needs three forwards' operations.  Bytes count each input (src,
    adjacency, cotangent, parameters) read once and each output (dsrc,
    dadj, dparams) written once (float32)."""
    fwd = trunk_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params)
    nbytes = 4 * (B * (E * Ds + E * E + E * C) + n_params)  # inputs
    nbytes += 4 * (B * (E * Ds + E * E) + n_params)  # outputs
    return {"flops": 3 * fwd["flops"], "bytes": int(nbytes)}


# --------------------------------------------------------------------------
# Both trunks in one launch (make_gnn_fused_dual).
# --------------------------------------------------------------------------


def _check_blob(name, blob, dev) -> None:
    if blob.device != dev or blob.dtype != torch.float32 or not blob.is_contiguous():
        raise ValueError(f"{name}: the trunks' parameters must be contiguous float32 "
                         f"buffers on {dev}")


def gnn_trunk_dual_forward(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_a, params_c, src_a_T, src_c_T, adj_T,
) -> tuple[Tensor, Tensor]:
    """Both trunks' forward on one adjacency, ``(out_a, out_c)``: the plain
    version for CPU tensors, the ``gnn_trunk_dual_fwd`` CUDA kernel (one
    launch for both) for tensors on the card.

    ``params_a`` and ``params_c`` are both :func:`flatten_gnn_params` tuples
    or both :class:`KernelParams` buffers.  Where a gradient is needed the
    call goes through :class:`GNNTrunkDual`, whose backward is the
    ``gnn_trunk_dual_bwd`` kernel on the card; without one the CPU path
    takes only the flat tuples.  ``gnn_trunk_dual_forward.launches`` counts
    kernel launches."""
    dims = (E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu)
    dev = src_a_T.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"gnn_trunk_dual_forward: no path for device {dev}")
    kernel_params = isinstance(params_a, KernelParams)
    if kernel_params != isinstance(params_c, KernelParams):
        raise ValueError("gnn_trunk_dual_forward: give both trunks' parameters in one layout")
    leaves = ((params_a.blob, params_c.blob) if kernel_params
              else tuple(params_a) + tuple(params_c))
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in leaves + (src_a_T, src_c_T, adj_T)):
        kp_a, kp_c = ((params_a, params_c) if kernel_params else
                      (param_blob(p, embed_layer_n, gnn_layer_n) for p in (params_a, params_c)))
        return GNNTrunkDual.apply(dims, kp_a.F1, kp_a.blob, kp_c.blob, src_a_T, src_c_T, adj_T)
    if dev.type == "cpu":
        if kernel_params:
            raise ValueError("gnn_trunk_dual_forward: the plain version takes the flat params")
        return gnn_trunk_dual_forward_plain(*dims, params_a, params_c, src_a_T, src_c_T, adj_T)
    if not kernel_params:
        params_a, params_c = (param_blob(p, embed_layer_n, gnn_layer_n)
                              for p in (params_a, params_c))
    return _dual_forward_kernel(dims, params_a, params_c, src_a_T, src_c_T, adj_T)


gnn_trunk_dual_forward.launches = 0


def _dual_forward_kernel(dims, kp_a: KernelParams, kp_c: KernelParams, src_a_T, src_c_T,
                         adj_T) -> tuple[Tensor, Tensor]:
    """Check, allocate, launch and count one dual forward on the card."""
    E, Ds, H, C = dims[:4]
    _check_inputs("gnn_trunk_dual_fwd", E, Ds, C,
                  {"src_a_T": src_a_T, "src_c_T": src_c_T, "adj_T": adj_T})
    dev = src_a_T.device
    for kp in (kp_a, kp_c):
        _check_blob("gnn_trunk_dual_fwd", kp.blob, dev)
    if kp_a.F1 != kp_c.F1 or kp_a.blob.numel() != kp_c.blob.numel():
        raise ValueError("gnn_trunk_dual_fwd: the two trunks' parameters differ in shape")
    B = src_a_T.shape[-1]
    out_a = torch.empty((E * C, B), dtype=torch.float32, device=dev)
    out_c = torch.empty_like(out_a)
    if B == 0:
        return out_a, out_c
    launch_dual_kernel(*dims, kp_a, kp_c, src_a_T, src_c_T, adj_T, out_a, out_c)
    gnn_trunk_dual_forward.launches += 1
    return out_a, out_c


def launch_dual_kernel(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
                       kp_a: KernelParams, kp_c: KernelParams, src_a_T, src_c_T, adj_T,
                       out_a, out_c) -> None:
    """One launch of the dual forward kernel on tensors the caller has
    checked, on the current stream.  It does not count, like
    :func:`launch_kernel`."""
    embed_relu, gnn_relu = _relu_flags(use_relu)
    dev = src_a_T.device
    with torch.cuda.device(dev):
        rc = _library("gnn_trunk_dual_fwd").gnn_trunk_dual_fwd(
            src_a_T.data_ptr(), src_c_T.data_ptr(), adj_T.data_ptr(), kp_a.blob.data_ptr(),
            kp_c.blob.data_ptr(), out_a.data_ptr(), out_c.data_ptr(), src_a_T.shape[-1],
            E, Ds, H, kp_a.F1, C, embed_layer_n, 1 + gnn_layer_n, float(max_edge_dist),
            int(embed_relu), int(gnn_relu), kp_a.blob.numel(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_rc("gnn_trunk_dual_fwd", rc)


def gnn_trunk_dual_backward(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    kp_a: KernelParams, kp_c: KernelParams, src_a_T, src_c_T, adj_T, g_a, g_c,
) -> tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Both trunks' vjp for the cotangents ``g_a`` and ``g_c``: ``(dblob_a,
    dblob_c, dsrc_a_T, dsrc_c_T, dadj_T)``, the parameter gradients in the
    buffers' layout and ``dadj_T`` the sum of both trunks' (actor, then
    critic).  The plain version for CPU tensors, the ``gnn_trunk_dual_bwd``
    CUDA kernel (one launch for both, then its row sum) for tensors on the
    card.  ``gnn_trunk_dual_backward.launches`` counts kernel launches."""
    dims = (E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu)
    dev = src_a_T.device
    if dev.type == "cpu":
        unpack = lambda kp: unpack_blob(kp, Ds, H, C, embed_layer_n, gnn_layer_n)
        dfa, dfc, dsa, dsc, dadj = gnn_trunk_dual_backward_plain(
            *dims, unpack(kp_a), unpack(kp_c), src_a_T, src_c_T, adj_T, g_a, g_c)
        return (param_blob(dfa, embed_layer_n, gnn_layer_n).blob,
                param_blob(dfc, embed_layer_n, gnn_layer_n).blob, dsa, dsc, dadj)
    if dev.type != "cuda":
        raise ValueError(f"gnn_trunk_dual_backward: no path for device {dev}")
    _check_inputs("gnn_trunk_dual_bwd", E, Ds, C, {
        "src_a_T": src_a_T, "src_c_T": src_c_T, "adj_T": adj_T, "g_a": g_a, "g_c": g_c})
    for kp in (kp_a, kp_c):
        _check_blob("gnn_trunk_dual_bwd", kp.blob, dev)
    if kp_a.F1 != kp_c.F1 or kp_a.blob.numel() != kp_c.blob.numel():
        raise ValueError("gnn_trunk_dual_bwd: the two trunks' parameters differ in shape")
    B, n = src_a_T.shape[-1], kp_a.blob.numel()
    dsrc_a, dsrc_c = torch.empty_like(src_a_T), torch.empty_like(src_c_T)
    dadj = torch.empty_like(adj_T)
    if B == 0:
        return torch.zeros_like(kp_a.blob), torch.zeros_like(kp_c.blob), dsrc_a, dsrc_c, dadj
    dblobs = torch.empty((2 * n,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        conf = dual_backward_config(E, Ds, H, kp_a.F1, C, embed_layer_n, gnn_layer_n, B)
    partial = torch.empty((conf["ctas"], 2 * n), dtype=torch.float32, device=dev)
    launch_dual_backward_kernel(*dims, kp_a, kp_c, src_a_T, src_c_T, adj_T, g_a, g_c,
                                dsrc_a, dsrc_c, dadj, dblobs, partial)
    gnn_trunk_dual_backward.launches += 1
    return dblobs[:n], dblobs[n:], dsrc_a, dsrc_c, dadj


gnn_trunk_dual_backward.launches = 0


def launch_dual_backward_kernel(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist,
                                use_relu, kp_a: KernelParams, kp_c: KernelParams, src_a_T,
                                src_c_T, adj_T, g_a, g_c, dsrc_a, dsrc_c, dadj, dblobs,
                                partial) -> None:
    """One launch of the dual backward kernel (and its row sum) on tensors
    the caller has checked, on the current stream; ``dblobs`` takes both
    parameter gradients (actor, then critic) and ``partial`` is the (CTAs,
    2 n_params) scratch buffer.  It does not count, like
    :func:`launch_kernel`."""
    embed_relu, gnn_relu = _relu_flags(use_relu)
    dev = src_a_T.device
    with torch.cuda.device(dev):
        rc = _library("gnn_trunk_dual_bwd").gnn_trunk_dual_bwd(
            src_a_T.data_ptr(), src_c_T.data_ptr(), adj_T.data_ptr(), g_a.data_ptr(),
            g_c.data_ptr(), kp_a.blob.data_ptr(), kp_c.blob.data_ptr(), dsrc_a.data_ptr(),
            dsrc_c.data_ptr(), dadj.data_ptr(), dblobs.data_ptr(), partial.data_ptr(),
            src_a_T.shape[-1], E, Ds, H, kp_a.F1, C, embed_layer_n, 1 + gnn_layer_n,
            float(max_edge_dist), int(embed_relu), int(gnn_relu), kp_a.blob.numel(),
            partial.shape[0], torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_rc("gnn_trunk_dual_bwd", rc)


class GNNTrunkDual(torch.autograd.Function):
    """Both differentiable trunks on one adjacency, counterpart of
    ``make_gnn_fused_dual``'s ``apply``, ``apply_fwd`` and ``apply_bwd``
    (gnn_pallas.py:784-808): the dual forward kernel (plain version on the
    CPU), saving only its inputs, and a backward that recomputes both
    forwards inside the dual backward kernel (plain vjp on the CPU) and
    returns ``(dpa, dpc, dsa, dsc, dadj)``.

    ``GNNTrunkDual.apply(dims, F1, blob_a, blob_c, src_a_T, src_c_T, adj_T)``
    with ``dims`` the leading eight arguments of
    :func:`gnn_trunk_dual_forward`."""

    @staticmethod
    def forward(ctx, dims, F1, blob_a, blob_c, src_a_T, src_c_T, adj_T):
        kp_a, kp_c = KernelParams(blob_a, F1), KernelParams(blob_c, F1)
        ctx.dims, ctx.F1 = dims, F1
        ctx.save_for_backward(blob_a, blob_c, src_a_T, src_c_T, adj_T)
        if src_a_T.device.type == "cpu":
            E, Ds, H, C, embed_layer_n, gnn_layer_n = dims[:6]
            unpack = lambda kp: unpack_blob(kp, Ds, H, C, embed_layer_n, gnn_layer_n)
            return gnn_trunk_dual_forward_plain(*dims, unpack(kp_a), unpack(kp_c), src_a_T,
                                                src_c_T, adj_T)
        return _dual_forward_kernel(dims, kp_a, kp_c, src_a_T, src_c_T, adj_T)

    @staticmethod
    def backward(ctx, g_a, g_c):
        blob_a, blob_c, src_a_T, src_c_T, adj_T = ctx.saved_tensors
        f32 = lambda g: g.to(torch.float32).contiguous()
        grads = gnn_trunk_dual_backward(
            *ctx.dims, KernelParams(blob_a, ctx.F1), KernelParams(blob_c, ctx.F1), src_a_T,
            src_c_T, adj_T, f32(g_a), f32(g_c))
        return (None, None) + tuple(grads)


def dual_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params) -> dict:
    """Floating-point operations and bytes one dual forward needs: two
    trunks' operations (:func:`trunk_work`) on ``n_edges`` unmasked edges;
    bytes count both src inputs, the one adjacency and both parameter sets
    read once and both outputs written once (float32)."""
    fwd = trunk_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params)
    nbytes = 4 * (B * (2 * E * Ds + E * E + 2 * E * C) + 2 * n_params)
    return {"flops": 2 * fwd["flops"], "bytes": int(nbytes)}


def dual_bwd_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params) -> dict:
    """Floating-point operations and bytes one dual backward needs: two
    trunks' recomputed forward and vjp (:func:`trunk_bwd_work`); bytes count
    each input (two src, the adjacency, two cotangents, two parameter sets)
    read once and each output (two dsrc, dadj, two parameter gradients)
    written once (float32)."""
    bwd = trunk_bwd_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params)
    nbytes = 4 * (B * (2 * E * Ds + E * E + 2 * E * C) + 2 * n_params)  # inputs
    nbytes += 4 * (B * (2 * E * Ds + E * E) + 2 * n_params)  # outputs
    return {"flops": 2 * bwd["flops"], "bytes": int(nbytes)}
