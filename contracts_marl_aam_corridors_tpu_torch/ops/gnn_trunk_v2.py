"""The GNN trunk forward in the v2 formulation: dense products over
block-diagonal weights, a plain torch version and a hand-written Hopper
kernel.

Counterpart of ``contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py``
``make_gnn_forward_v2`` (:72-210, the Pallas TPU kernel replaced by
``csrc/gnn_forward_v2.cu`` behind :func:`gnn_forward_v2`), ``_constants``
(:213) and ``flatten_gnn_params_v2`` (:226-279).  It computes the function
of ``make_gnn_forward`` (``ops/gnn_trunk.py``), restated as the TPU kernel
restates it: each per-entity weight becomes a block-diagonal kron(I_E, W^T)
matrix, each vector is tiled E times, the q/k/v projection of every entity
and head is one row-permuted matrix ``Wbig``, and the group work goes
through five 0/1 selection matrices.  As there, the EmbedConv hidden width
must equal the gnn hidden width C.  Nothing in the policy routes to it, as
nothing in the JAX package does.

Layout contract (float32), as in the JAX package:
  src_aug_T:  (E*Ds, B)  per-entity EmbedConv input, entity-major rows
  adj_T:      (E*E, B)   distance adjacency, row s*E+t = d(s -> t)
  output:     (E*C, B)   per-node embeddings, entity-major rows

The wrapper runs the plain version for tensors on the CPU and the kernel
for tensors on the card, where it launches the kernel or raises.  The
kernel is built with the other trunk kernels (``gnn_trunk.build_all``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import gnn_trunk
from .gnn_trunk import LN_EPS, NEG_F32, _act, _check_inputs, _check_rc, _library, _relu_flags

Tensor = torch.Tensor

KERNEL = "gnn_forward_v2"


def constants(E: int, C: int, device=None, dtype=torch.float32) -> tuple:
    """The selection matrices of the group work, ``(Gm, Gs, U, K, T)``:
    group mean (E, E*C), group sum (E, E*C), broadcast a group value up
    (E*C, E), sum across source groups (C, E*C) and tile a (C, B) block E
    times (E*C, C)."""
    kw = dict(device=device, dtype=dtype)
    I_E, I_C = torch.eye(E, **kw), torch.eye(C, **kw)
    ones_C = torch.ones((1, C), **kw)
    Gm = torch.kron(I_E, ones_C) / C
    Gs = torch.kron(I_E, ones_C)
    U = torch.kron(I_E, torch.ones((C, 1), **kw))
    K = torch.kron(torch.ones((1, E), **kw), I_C)
    T = torch.kron(torch.ones((E, 1), **kw), I_C)
    return Gm, Gs, U, K, T


def n_flat(embed_layer_n: int, gnn_layer_n: int) -> int:
    """Arrays in the v2 tuple."""
    return 5 + 4 * embed_layer_n + 5 * (1 + gnn_layer_n)


def flatten_gnn_params_v2(params: dict, E: int, H: int, C: int, embed_layer_n: int,
                          gnn_layer_n: int) -> tuple:
    """GNNBase parameter tree in the flax layout (as
    ``gnn_trunk.flatten_gnn_params`` takes it) -> the v2 tuple of float32
    tensors: block-diagonal kron(I_E, W^T) weights, vectors tiled to
    (E*C, 1) columns, and per conv layer ``Wbig`` (3*E*H*C, E*C) with Q rows
    t*H*C + h*C + c, K rows E*H*C + h*E*C + s*C + c and V rows
    2*E*H*C + h*E*C + s*C + c, its bias ``bbig``, the edge weight tiled per
    head (H*E*C, 1), and lin_skip.  Pure layout: equal to the JAX function's
    arrays."""
    as_t = lambda v: (v if isinstance(v, Tensor) else torch.tensor(np.asarray(v))).to(
        torch.float32)
    ec = params["embed_layer"]
    F1 = as_t(ec["lin1"]["kernel"]).shape[1]
    if F1 != C:
        raise ValueError(f"the v2 trunk takes the EmbedConv hidden width ({F1}) to be the gnn "
                         f"hidden width C ({C}): embed_hidden_size must equal gnn_hidden_size")
    dev = as_t(ec["lin1"]["bias"]).device
    I_E = torch.eye(E, dtype=torch.float32, device=dev)
    tile = lambda v: as_t(v).reshape(-1, 1).repeat(E, 1)
    blockdiag = lambda w: torch.kron(I_E, as_t(w).T.contiguous())
    flat = [
        blockdiag(ec["lin1"]["kernel"]), tile(ec["lin1"]["bias"]),
        tile(as_t(ec["lin1_edge"]).reshape(-1)),
        tile(ec["ln1"]["scale"]), tile(ec["ln1"]["bias"]),
    ]
    for i in range(embed_layer_n):
        flat += [
            blockdiag(ec[f"lin{i + 2}"]["kernel"]), tile(ec[f"lin{i + 2}"]["bias"]),
            tile(ec[f"ln{i + 2}"]["scale"]), tile(ec[f"ln{i + 2}"]["bias"]),
        ]
    EHC, EC = E * H * C, E * C
    for name in ["gnn1"] + [f"gnn2_{i}" for i in range(gnn_layer_n)]:
        tc = params[name]
        Wq, Wk, Wv = (as_t(tc[k]["kernel"]) for k in ("lin_query", "lin_key", "lin_value"))
        bq, bk, bv = (as_t(tc[k]["bias"]) for k in ("lin_query", "lin_key", "lin_value"))
        Wbig = torch.zeros((3 * EHC, EC), dtype=torch.float32, device=dev)
        bbig = torch.zeros((3 * EHC, 1), dtype=torch.float32, device=dev)
        for e in range(E):
            cols = slice(e * C, (e + 1) * C)
            Wbig[e * H * C:(e + 1) * H * C, cols] = Wq.T
            bbig[e * H * C:(e + 1) * H * C, 0] = bq
            for h in range(H):
                heads = slice(h * C, (h + 1) * C)
                for r0, W, b in ((EHC, Wk, bk), (2 * EHC, Wv, bv)):
                    r = r0 + h * EC + e * C
                    Wbig[r:r + C, cols] = W[:, heads].T
                    bbig[r:r + C, 0] = b[heads]
        w_e = as_t(tc["lin_edge"]).reshape(H, C)
        w_e_tiled = torch.cat([w_e[h].reshape(-1, 1).repeat(E, 1) for h in range(H)])
        flat += [Wbig, bbig, w_e_tiled, blockdiag(tc["lin_skip"]["kernel"]),
                 tile(tc["lin_skip"]["bias"])]
    return tuple(flat)


def _v2_shapes(E, Ds, H, C, embed_layer_n, gnn_layer_n) -> list:
    """The shape of each array of the v2 tuple, as ``flatten_gnn_params_v2``
    gives it, named for the error message."""
    EC, EHC, col = E * C, E * H * C, (E * C, 1)
    shapes = [("lin1", (EC, E * Ds)), ("lin1 bias", col), ("lin1_edge", col),
              ("ln1 scale", col), ("ln1 bias", col)]
    for i in range(embed_layer_n):
        shapes += [(f"lin{i + 2}", (EC, EC)), (f"lin{i + 2} bias", col),
                   (f"ln{i + 2} scale", col), (f"ln{i + 2} bias", col)]
    for k in range(1 + gnn_layer_n):
        shapes += [(f"Wbig of conv layer {k}", (3 * EHC, EC)),
                   (f"bbig of conv layer {k}", (3 * EHC, 1)),
                   (f"lin_edge of conv layer {k}", (EHC, 1)),
                   (f"lin_skip of conv layer {k}", (EC, EC)),
                   (f"lin_skip bias of conv layer {k}", col)]
    return shapes


def _check_params(name, E, Ds, H, C, embed_layer_n, gnn_layer_n, params_flat) -> None:
    """Every array of the v2 tuple has the shape the kernel indexes it by."""
    shapes = _v2_shapes(E, Ds, H, C, embed_layer_n, gnn_layer_n)
    if len(params_flat) != len(shapes):
        raise ValueError(f"{name}: {len(params_flat)} arrays for {embed_layer_n} embed and "
                         f"{gnn_layer_n} extra conv layers")
    for (what, want), a in zip(shapes, params_flat):
        if tuple(a.shape) != want:
            hint = ("; the v2 trunk takes the EmbedConv hidden width to be the gnn hidden "
                    "width C (embed_hidden_size must equal gnn_hidden_size)"
                    if what == "lin1" else "")
            raise ValueError(f"{name}: {what} is {tuple(a.shape)}, expected {want}{hint}")


def gnn_forward_v2_plain(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_flat, src_aug_T, adj_T, compute_dtype=torch.float32,
) -> Tensor:
    """The v2 trunk as plain torch over the whole batch, computed in
    ``compute_dtype`` and returned in float32: a transcription of the TPU
    kernel's body (gnn_pallas.py:95-185), the products with the block-diagonal
    weights and with the selection matrices included.  The edge mask is
    decided on the float32 distances, as the kernel does."""
    embed_act, gnn_act = (_act(r) for r in _relu_flags(use_relu))
    cdt = compute_dtype
    _check_params("gnn_forward_v2_plain", E, Ds, H, C, embed_layer_n, gnn_layer_n, params_flat)
    p = [t.to(cdt) for t in params_flat]
    Gm, Gs, U, K, T = constants(E, C, src_aug_T.device, cdt)
    n_tc = 1 + gnn_layer_n
    inv_sqrt_c = 1.0 / (C ** 0.5)
    EC, EHC = E * C, E * H * C
    W1, b1, w_e1, ln1_s, ln1_b = p[:5]
    embed_layers = [p[5 + 4 * k:9 + 4 * k] for k in range(embed_layer_n)]
    o = 5 + 4 * embed_layer_n
    tc_params = [p[o + 5 * k:o + 5 * k + 5] for k in range(n_tc)]

    def group_ln(M, scale_t, bias_t):
        mu = U @ (Gm @ M)
        d = M - mu
        var = U @ (Gm @ (d * d))
        return d * torch.rsqrt(var + LN_EPS) * scale_t + bias_t

    B = src_aug_T.shape[-1]
    adj = adj_T.to(torch.float32)
    d_cols = [adj[t::E] for t in range(E)]  # rows s*E + t, s = 0..E-1: (E, B)
    m_cols = [((d > 0.0) & (d < max_edge_dist)).to(cdt) for d in d_cols]
    dm_cols = [d.to(cdt) * m for d, m in zip(d_cols, m_cols)]

    h_src = W1 @ src_aug_T.to(cdt) + b1
    x = []
    for t in range(E):
        dw = (U @ dm_cols[t]) * w_e1
        msg = group_ln(embed_act(h_src + dw), ln1_s, ln1_b)
        for Wl, bl, lns, lnb in embed_layers:
            msg = group_ln(embed_act(Wl @ msg + bl), lns, lnb)
        x.append(K @ (msg * (U @ m_cols[t])))

    for Wbig, bbig, w_e_t, Wskip, bskip in tc_params:
        X = torch.cat(x, dim=0)
        QKV = Wbig @ X + bbig
        new_x = []
        for t in range(E):
            dm_up = U @ dm_cols[t]
            head_sum = torch.zeros((C, B), dtype=cdt, device=X.device)
            for h in range(H):
                weh_up = w_e_t[h * EC:(h + 1) * EC]
                q = QKV[t * H * C + h * C:t * H * C + (h + 1) * C]
                Kh = QKV[EHC + h * EC:EHC + (h + 1) * EC]
                Vh = QKV[2 * EHC + h * EC:2 * EHC + (h + 1) * EC]
                edge_term = dm_up * weh_up
                logits = (Gs @ ((T @ q) * (Kh + edge_term))) * inv_sqrt_c
                logits = torch.where(m_cols[t] > 0, logits, NEG_F32)
                ex = torch.exp(logits - logits.amax(dim=0, keepdim=True))
                alpha = ex / ex.sum(dim=0, keepdim=True)
                alpha = alpha * m_cols[t].amax(dim=0, keepdim=True)
                head_sum = head_sum + K @ ((U @ alpha) * (Vh + edge_term))
            new_x.append(head_sum / H)
        skip = Wskip @ X + bskip
        x = [gnn_act(new_x[t] + skip[t * C:(t + 1) * C]) for t in range(E)]
    return torch.cat(x, dim=0).to(torch.float32)


def v2_config(E, Ds, H, C, embed_layer_n, gnn_layer_n) -> dict:
    """Graphs per CTA, threads and dynamic shared memory bytes the v2 kernel
    uses for these dimensions (raises where it cannot run them)."""
    g, threads, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check_rc(KERNEL, _library(KERNEL).gnn_forward_v2_config(
        E, Ds, H, C, embed_layer_n, 1 + gnn_layer_n, ctypes.byref(g), ctypes.byref(threads),
        ctypes.byref(smem)))
    return {"graphs_per_cta": g.value, "threads": threads.value, "smem_bytes": smem.value}


def gnn_forward_v2(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params_flat, src_aug_T, adj_T,
) -> Tensor:
    """The v2 trunk forward: the plain version for CPU tensors, the
    ``gnn_forward_v2`` CUDA kernel for tensors on the card.  ``params_flat``
    is :func:`flatten_gnn_params_v2`'s tuple.  Forward only, as the JAX
    function is: on the card a gradient cannot flow through it.
    ``gnn_forward_v2.launches`` counts kernel launches."""
    dims = (E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu)
    dev = src_aug_T.device
    if dev.type == "cpu":
        return gnn_forward_v2_plain(*dims, params_flat, src_aug_T, adj_T)
    if dev.type != "cuda":
        raise ValueError(f"gnn_forward_v2: no path for device {dev}")
    _check_params(KERNEL, E, Ds, H, C, embed_layer_n, gnn_layer_n, params_flat)
    _check_inputs(KERNEL, E, Ds, C, {"src_aug_T": src_aug_T, "adj_T": adj_T})
    for t in params_flat:
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{KERNEL}: the v2 parameters must be contiguous float32 tensors "
                             f"on {dev}")
        if t.data_ptr() % 16:
            raise ValueError(f"{KERNEL}: the v2 parameters must start on 16-byte boundaries")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tuple(params_flat) + (src_aug_T, adj_T)):
        raise ValueError(f"{KERNEL}: the kernel has no backward; call it under no_grad")
    B = src_aug_T.shape[-1]
    out = torch.empty((E * C, B), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    launch_v2_kernel(*dims, params_flat, src_aug_T, adj_T, out)
    gnn_forward_v2.launches += 1
    return out


gnn_forward_v2.launches = 0


def launch_v2_kernel(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
                     params_flat, src_aug_T, adj_T, out) -> None:
    """One launch of the v2 kernel on tensors the caller has checked, on the
    current stream.  It does not count: :func:`gnn_forward_v2` is the path a
    caller takes, and this entry lets a measurement time the kernel alone."""
    embed_relu, gnn_relu = _relu_flags(use_relu)
    dev = src_aug_T.device
    ptrs = (ctypes.c_void_p * len(params_flat))(*(t.data_ptr() for t in params_flat))
    with torch.cuda.device(dev):
        rc = _library(KERNEL).gnn_forward_v2(
            src_aug_T.data_ptr(), adj_T.data_ptr(), ptrs, len(params_flat), out.data_ptr(),
            src_aug_T.shape[-1], E, Ds, H, C, embed_layer_n, 1 + gnn_layer_n,
            float(max_edge_dist), int(embed_relu), int(gnn_relu),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_rc(KERNEL, rc)


def make_gnn_forward_v2(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu):
    """``fwd(params_flat, src_aug_T, adj_T) -> (E*C, B)``, the contract of
    the JAX ``make_gnn_forward_v2`` (without its ``blk`` and ``interpret``:
    any B >= 1 is taken)."""
    dims = (E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu)
    return lambda params_flat, src_aug_T, adj_T: gnn_forward_v2(
        *dims, params_flat, src_aug_T, adj_T)


def v2_work(E, Ds, H, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params) -> dict:
    """Operations and bytes of one v2 forward.

    ``flops`` is the function's (``gnn_trunk.trunk_work`` on the ``n_edges``
    unmasked edges, so rows 1 and 5 of the kernel table share one bound);
    ``dense_flops`` the v2 formulation's products as the TPU kernel writes
    them (two per multiply-add, zeros of the block-diagonal and selection
    matrices included).  Bytes count each input (src, adjacency and the
    ``n_params`` floats of the v2 tuple) read once and the output written
    once (float32)."""
    EC, EHC = E * C, E * H * C
    mm = lambda m, k: 2 * m * k * B  # an (m, k) matrix times a (k, B) panel
    ln = 2 * (mm(E, EC) + mm(EC, E))  # group mean and variance, each down then up
    dense = mm(EC, E * Ds)  # lin1
    per_target = mm(EC, E) + ln + embed_layer_n * (mm(EC, EC) + ln) + mm(EC, E) + mm(C, EC)
    dense += E * per_target
    per_head = mm(EC, C) + mm(E, EC) + mm(EC, E) + mm(C, EC)  # tile q, logits, alpha up, sum
    dense += (1 + gnn_layer_n) * (mm(3 * EHC, EC) + mm(EC, EC)
                                  + E * (mm(EC, E) + H * per_head))
    fn = gnn_trunk.trunk_work(E, Ds, H, C, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params)
    return {"flops": fn["flops"], "dense_flops": int(dense), "bytes": fn["bytes"]}
