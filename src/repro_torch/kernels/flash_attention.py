"""Blocked online-softmax (flash) attention, causal or full, with GQA.

Every layer of the server model's full-sequence forward is causal
self-attention over (B, S, H, hd) queries and (B, S, KV, hd) keys and
values; the vfl-zoo step runs three such forwards (h, h_bar, h_hat) per
step. The CUDA kernels (csrc/flash_attention.cu) replace the reference's
Pallas ``flash_attention_pallas`` and the GQA expansion of its
``ops.flash_attention``: they read q, k and v where the QKV projection
and RoPE left them, map query head h to kv head h // (H / KV), keep m, l
and acc in f32, and never build the (S, S) score matrix. bf16 runs on
Hopper's tensor cores (TMA loads, ``wgmma`` for q.k and for p.v with p
split into two bf16 halves, so the outputs stay as close to the f32
result as with p in f32); f32 runs on the CUDA cores.
``flash_attention_plain`` is their plain torch version (the reference's
``ref.flash_attention_ref`` math, GQA by repeat), which the wrapper takes
for CPU tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

_LIB_FN = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
HEAD_DIMS = (64, 128)
NEG_INF = -1e30


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True) -> torch.Tensor:
    """The full softmax in f32: s = q.k / sqrt(hd), the causal mask at
    -1e30, softmax, then p @ v, cast back to q's dtype. GQA repeats each
    kv head over its H / KV query heads."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kx = k.repeat_interleave(G, dim=2) if G > 1 else k
    vx = v.repeat_interleave(G, dim=2) if G > 1 else v
    sqrt_hd = torch.tensor(np.sqrt(hd), dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) / sqrt_hd
    if causal:
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = torch.where(mask, s, torch.full((), NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, vx.float()).to(q.dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) with KV dividing H; one dtype,
    f32 or bf16; hd 64 or 128; all three contiguous, the layout the QKV
    projection and RoPE produce (a view is refused, not copied). Returns
    (B, S, H, hd) contiguous in q's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything the kernel does
    not take raises."""
    tensors = (q, k, v)
    if any(t.dim() != 4 for t in tensors):
        raise ValueError("flash_attention takes q (B, S, H, hd) and k, v "
                         "(B, S, KV, hd)")
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if k.shape != v.shape or k.shape[:2] != (B, S) or k.shape[3] != hd \
            or KV == 0 or H % KV:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("flash_attention takes contiguous q, k and v")
    if all(t.device.type == "cpu" for t in tensors):
        return flash_attention_plain(q, k, v, causal)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(f"flash_attention: q on {q.device}, k on {k.device},"
                         f" v on {v.device}; all must be on one CUDA device "
                         "(or the CPU)")
    if q.dtype not in _LIB_FN or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v all f32 or all bf16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd}; the kernel takes "
                         f"{HEAD_DIMS}")
    if B * H > 65535 or S >= 1 << 31:
        raise ValueError(f"flash_attention: B*H = {B * H}, S = {S} too large")
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    if B == 0 or S == 0:
        return out
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    fn = getattr(build.load("flash_attention"), _LIB_FN[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, KV, hd, scale, int(bool(causal)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
