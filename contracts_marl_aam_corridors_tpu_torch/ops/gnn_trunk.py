"""The GNN trunk forward (EmbedConv + TransformerConv stack) in the
transposed layout: a plain torch version and a hand-written Hopper kernel.

Counterpart of ``contracts_marl_aam_corridors_tpu/ops/gnn_pallas.py``:
``flatten_gnn_params`` (:450), ``xla_transposed_forward`` (:487-591, ported
as :func:`gnn_trunk_forward_plain`) and the Pallas TPU kernel
``make_gnn_forward`` (:299-447, replaced by the CUDA kernel in
``csrc/gnn_trunk_fwd.cu`` behind :func:`gnn_trunk_forward`).

Layout contract (float32), as in the JAX package:
  src_aug_T:  (E*Ds, B)  per-entity EmbedConv input [feat, Embed(etype)],
                         entity-major rows
  adj_T:      (E*E, B)   distance adjacency, row s*E+t = d(s -> t)
  output:     (E*C, B)   per-node embeddings, entity-major rows

``gnn_trunk_forward`` runs the plain version for tensors on the CPU and the
kernel for tensors on the card; on the card it launches the kernel or
raises.  The kernel is compiled with ``nvcc`` at first use, from the source
in the package, into ``build/kernels/`` at the repository root.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
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

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gnn_trunk_fwd.cu"
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


# --------------------------------------------------------------------------
# The CUDA kernel: build, load, launch.
# --------------------------------------------------------------------------


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the gnn_trunk_fwd kernel cannot be built")


@functools.lru_cache(maxsize=None)
def build() -> dict:
    """Compile ``csrc/gnn_trunk_fwd.cu`` for sm_90a into a shared library
    with a plain C interface (once per process; the file name carries the
    source's hash).  Returns the library path, the compile seconds and the
    ptxas register/spill lines."""
    src = SOURCE.read_bytes()
    tag = hashlib.sha256(src).hexdigest()[:12]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib = BUILD_DIR / f"libgnn_trunk_fwd_{tag}.so"
    cmd = [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-o", str(lib) + ".tmp", str(SOURCE),
    ]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(str(lib) + ".tmp", lib)
    ptxas = [ln.strip() for ln in proc.stderr.splitlines()
             if "registers" in ln or "spill" in ln]
    return {"library": str(lib), "seconds": seconds, "ptxas": ptxas}


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build()["library"])
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.gnn_trunk_fwd.argtypes = [
        p, p, p, p, ctypes.c_longlong, i, i, i, i, i, i, i, ctypes.c_float, i, i, i, p,
    ]
    lib.gnn_trunk_fwd.restype = i
    lib.gnn_trunk_fwd_config.argtypes = [
        i, i, i, i, i, i, i, ctypes.POINTER(i), ctypes.POINTER(i), ctypes.POINTER(i),
    ]
    lib.gnn_trunk_fwd_config.restype = i
    return lib


_CONFIG_ERRORS = {
    -1: "the kernel is instantiated for embed and gnn hidden widths of 16 only",
    -2: "entity count out of the kernel's range",
    -3: "per-CTA shared memory would exceed what the kernel can request",
    -4: "layer counts out of the kernel's range",
    -5: "parameter count does not match the dimensions",
    -6: "device ordinal beyond the kernel's launch-plan table",
}


def _check_rc(rc: int) -> None:
    if rc == 0:
        return
    if rc < 0:
        raise ValueError(f"gnn_trunk_fwd: {_CONFIG_ERRORS.get(rc, rc)}")
    raise RuntimeError(f"gnn_trunk_fwd: CUDA error {rc} at launch")


def kernel_config(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n) -> dict:
    """Graphs per CTA, dynamic shared memory bytes and parameter floats the
    kernel uses for these dimensions (raises where it cannot run them)."""
    g, smem, npar = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    _check_rc(_library().gnn_trunk_fwd_config(
        E, Ds, H, F1, C, embed_layer_n, 1 + gnn_layer_n,
        ctypes.byref(g), ctypes.byref(smem), ctypes.byref(npar)))
    return {"graphs_per_cta": g.value, "smem_bytes": smem.value, "n_params": npar.value}


class KernelParams(NamedTuple):
    """The kernel's parameters: one contiguous float32 buffer in its order,
    weights stored (in, out) so a warp's lanes read consecutive words, and
    the embed width ``F1`` it was laid out for."""
    blob: Tensor
    F1: int


def param_blob(params_flat, embed_layer_n: int, gnn_layer_n: int) -> KernelParams:
    """Flat params (:func:`flatten_gnn_params`) -> the kernel's buffer."""
    head, embed, tcs = _split_flat(params_flat, embed_layer_n, gnn_layer_n)
    parts = [head[0].T] + list(head[1:])
    for W, *vecs in embed:
        parts += [W.T] + vecs
    for Wqkv, bqkv, w_e, Wskip, bskip in tcs:
        parts += [Wqkv.T, bqkv, w_e, Wskip.T, bskip]
    blob = torch.cat([p.reshape(-1) for p in parts]).to(torch.float32)
    return KernelParams(blob, head[0].shape[0])


def gnn_trunk_forward(
    E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
    params, src_aug_T, adj_T,
) -> Tensor:
    """The trunk forward: the plain version for CPU tensors, the
    ``gnn_trunk_fwd`` CUDA kernel for tensors on the card.

    ``params`` is :func:`flatten_gnn_params`'s tuple; for tensors on the card
    it may also be a :class:`KernelParams` prepared once
    (``GNNBase.kernel_params``), which spares packing the buffer per call.
    The kernel has no backward yet, so on the card it refuses inputs that
    need a gradient.  ``gnn_trunk_forward.launches`` counts kernel launches.
    """
    dev = src_aug_T.device
    if dev.type == "cpu":
        if isinstance(params, KernelParams):
            raise ValueError("gnn_trunk_forward: the plain version takes the flat params")
        return gnn_trunk_forward_plain(
            E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
            params, src_aug_T, adj_T,
        )
    if dev.type != "cuda":
        raise ValueError(f"gnn_trunk_forward: no path for device {dev}")
    B = src_aug_T.shape[-1]
    for name, t, rows in (("src_aug_T", src_aug_T, E * Ds), ("adj_T", adj_T, E * E)):
        if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 tensor on {dev}")
        if tuple(t.shape) != (rows, B):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(rows, B)}")
    kp = params if isinstance(params, KernelParams) else param_blob(
        params, embed_layer_n, gnn_layer_n)
    if kp.blob.device != dev:
        raise ValueError(f"the trunk's parameters must lie on {dev}")
    if torch.is_grad_enabled() and (src_aug_T.requires_grad or kp.blob.requires_grad):
        raise NotImplementedError("gnn_trunk_fwd has no backward kernel yet; "
                                  "run the trunk on the card under torch.no_grad()")
    out = torch.empty((E * C, B), dtype=torch.float32, device=dev)
    if B == 0:
        return out
    launch_kernel(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
                  kp, src_aug_T, adj_T, out)
    gnn_trunk_forward.launches += 1
    return out


gnn_trunk_forward.launches = 0


def launch_kernel(E, Ds, H, C, embed_layer_n, gnn_layer_n, max_edge_dist, use_relu,
                  kp: KernelParams, src_aug_T, adj_T, out) -> None:
    """One launch of the kernel on tensors the caller has checked, on the
    current stream.  It does not count: :func:`gnn_trunk_forward` is the path
    the model takes, and this entry lets a measurement time the kernel
    alone."""
    embed_relu, gnn_relu = _relu_flags(use_relu)
    dev = src_aug_T.device
    with torch.cuda.device(dev):
        rc = _library().gnn_trunk_fwd(
            src_aug_T.data_ptr(), adj_T.data_ptr(), kp.blob.data_ptr(), out.data_ptr(),
            src_aug_T.shape[-1], E, Ds, H, kp.F1, C, embed_layer_n, 1 + gnn_layer_n,
            float(max_edge_dist), int(embed_relu), int(gnn_relu), kp.blob.numel(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _check_rc(rc)


def trunk_work(E, Ds, H, F1, C, embed_layer_n, gnn_layer_n, B, n_edges, n_params) -> dict:
    """Floating-point operations and bytes one trunk call needs.

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
