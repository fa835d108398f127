"""Blocked online-softmax (flash) attention, causal or full, with GQA.

Every layer of the server model's full-sequence forward is causal
self-attention over (B, S, H, hd) queries and (B, S, KV, hd) keys and
values; the vfl-zoo step runs three such forwards (h, h_bar, h_hat) per
step. The CUDA kernels (csrc/flash_attention.cu) replace the reference's
Pallas ``flash_attention_pallas`` and the GQA expansion of its
``ops.flash_attention``: they read q, k and v where the QKV projection
and RoPE left them, map query head h to kv head h // (H / KV), keep m, l
and acc in f32, and never build the (S, S) score matrix. Both types run
on Hopper's tensor cores. bf16: TMA loads, ``wgmma`` for q.k and for p.v
with p split into two bf16 halves, so the outputs stay as close to the
f32 result as with p in f32. f32: 3xTF32 on ``wgmma``, every operand
split into tf32 hi + lo and each product hi.hi + hi.lo + lo.hi, with the
tensor cores' truncating sums kept short (32-deep chunks of q.k, fresh
p.v accumulators per kv tile, both added into f32 totals).
``flash_attention_plain`` is their plain torch version (the reference's
``ref.flash_attention_ref`` math, GQA by repeat), which the wrapper takes
for CPU tensors only.

Explicit positions (B, S) replace the causal index mask, as the
reference's ``blocked_attention(q_positions=, kv_positions=)`` masks: a
key is seen where its position is at most the query's. The model passes
one positions tensor as both; with kv positions of their own, a row can
see no key: it keeps the -1e30 sentinel on every score, as the reference
does, and so attends to all S keys alike.

The gradient (csrc/flash_attention_bwd.cu) is the port's counterpart of
XLA's autodiff of the reference's ``blocked_attention``: the reference
trains through pure jnp attention and never differentiates its Pallas
kernel. ``FlashAttentionFn`` runs the forward kernel, which also writes
each row's logsumexp (lse), and the backward kernel from the saved q, k,
v, out and lse; ``flash_attention_bwd_plain`` is the backward's plain
version. The wrapper goes through the Function whenever grad mode is on
and q, k or v requires grad, so an output on the card is never cut off
from the graph; otherwise it makes today's forward-only launch.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

# today's forward-only launch; the forward with lse and/or positions; the
# backward
_LIB_FN = {torch.float32: "flash_attention_f32",
           torch.bfloat16: "flash_attention_bf16"}
_FWD_FN = {torch.float32: "flash_attention_fwd_f32",
           torch.bfloat16: "flash_attention_fwd_bf16"}
_BWD_FN = {torch.float32: "flash_attention_bwd_f32",
           torch.bfloat16: "flash_attention_bwd_bf16"}
HEAD_DIMS = (64, 128)
NEG_INF = -1e30
# a row whose lse lies below this saw no key (every score at the -1e30
# sentinel, in the kernel's units or the plain version's): no real score
# comes near it
MASKED_LSE = -1e20


def _scores(q, k, v, causal, positions, kv_positions=None):
    """(s, keep, k and v with each kv head repeated over its query
    heads): s (B, H, S, S) = q.k / sqrt(hd) in f32 with the mask at -1e30,
    keep the mask (None when nothing is masked). The mask is causal by
    index, or by ``positions`` (B, S) of the queries and ``kv_positions``
    of the keys (default: ``positions``) where given; without ``causal``
    no key is masked, whatever the positions (the reference's rule)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    kx = k.repeat_interleave(G, dim=2) if G > 1 else k
    vx = v.repeat_interleave(G, dim=2) if G > 1 else v
    sqrt_hd = torch.tensor(np.sqrt(hd), dtype=torch.float32, device=q.device)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kx.float()) / sqrt_hd
    keep = None
    if causal:
        if positions is None:
            keep = torch.ones((S, S), dtype=torch.bool,
                              device=q.device).tril()
        else:
            qp = positions.to(q.device)
            kp = qp if kv_positions is None else kv_positions.to(q.device)
            keep = (kp[:, None, :] <= qp[:, :, None])[:, None]
        s = torch.where(keep, s, torch.full((), NEG_INF, device=q.device))
    return s, keep, kx, vx


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          causal: bool = True, positions=None,
                          return_lse: bool = False, kv_positions=None):
    """The full softmax in f32: s = q.k / sqrt(hd), the mask at -1e30,
    softmax, then p @ v, cast back to q's dtype. GQA repeats each kv head
    over its H / KV query heads. With ``return_lse`` also each row's
    logsumexp of s, (B, H, S) f32, what the backward reads."""
    s, _, _, vx = _scores(q, k, v, causal, positions, kv_positions)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vx.float()).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_attention_bwd_plain(q, k, v, o, do, lse, causal: bool = True,
                              positions=None, kv_positions=None):
    """The gradient of ``flash_attention`` in f32 from the forward's
    output ``o`` and row logsumexp ``lse``: D = rowsum(dO * o), p =
    exp(s - lse), dv = p^T dO, ds = p * (dO v^T - D), dq = ds k / sqrt(hd),
    dk = ds^T q / sqrt(hd); each kv head's dk and dv sum over its query
    heads. A row that saw no key (lse below ``MASKED_LSE``) has p = 1/S on
    every key and no ds: its scores are the constant sentinel, as in the
    reference's autodiff. Returns (dq, dk, dv) in the inputs' dtypes."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    s, keep, kx, vx = _scores(q, k, v, causal, positions, kv_positions)
    lse = lse.float()
    p = torch.exp(s - lse[..., None])
    p = torch.where((lse < MASKED_LSE)[..., None],
                    torch.full((), 1.0, device=q.device)
                    / torch.full((), float(S), device=q.device), p)
    dof = do.float()
    D = torch.sum(dof * o.float(), dim=-1).transpose(1, 2)      # (B, H, S)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vx.float())
    ds = p * (dp - D[..., None])
    if keep is not None:
        ds = torch.where(keep, ds, torch.zeros((), device=q.device))
    sqrt_hd = torch.tensor(np.sqrt(hd), dtype=torch.float32, device=q.device)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kx.float()) / sqrt_hd
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float()) / sqrt_hd
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    if KV != H:
        dk = dk.reshape(B, S, KV, H // KV, hd).sum(3)
        dv = dv.reshape(B, S, KV, H // KV, hd).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check(q, k, v, positions, kv_positions=None):
    """The checks every path shares: shapes, contiguity, and, on CUDA,
    one device, one dtype the kernels take and a head dim they take."""
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
    for pos in (positions, kv_positions):
        if pos is not None and tuple(pos.shape) != (B, S):
            raise ValueError(f"flash_attention: positions "
                             f"{tuple(pos.shape)}, not (B, S) = {(B, S)}")
    if kv_positions is not None and positions is None:
        raise ValueError("flash_attention: kv_positions without positions")
    if all(t.device.type == "cpu" for t in tensors):
        return
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


def _device_positions(positions, q):
    """positions as the kernels read them: int32, contiguous, on q's
    device (None stays None)."""
    if positions is None:
        return None
    if positions.device != q.device:
        raise ValueError(f"flash_attention: positions on {positions.device},"
                         f" q on {q.device}")
    return positions.to(torch.int32).contiguous()


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _launch_fwd(q, k, v, causal, positions, want_lse, kv_positions=None):
    """The forward kernel on CUDA tensors: (out, lse or None). Without lse
    and positions it is today's launch; with either, the entry that also
    writes lse (B, H, S) f32 and masks by the q and kv positions."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    out = torch.empty((B, S, H, hd), dtype=q.dtype, device=q.device)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if B == 0 or S == 0:
        return out, lse
    pos = _device_positions(positions, q)
    kv_pos = pos if kv_positions is None else \
        _device_positions(kv_positions, q)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    lib = build.load("flash_attention")
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        if lse is None and pos is None:
            err = getattr(lib, _LIB_FN[q.dtype])(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                B, S, H, KV, hd, scale, int(bool(causal)), stream)
        else:
            err = getattr(lib, _FWD_FN[q.dtype])(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                _ptr(lse), _ptr(pos), _ptr(kv_pos), B, S, H, KV, hd, scale,
                int(bool(causal)), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, o, do, lse, causal: bool = True,
                        positions=None, kv_positions=None):
    """(dq, dk, dv) of the forward on CUDA tensors from its output ``o``,
    the output's gradient ``do`` and the row logsumexp ``lse`` (B, H, S)
    f32: the backward kernel, two passes without atomics (csrc/
    flash_attention_bwd.cu), so two calls give the same bits, both types on
    the tensor cores: bf16 on ``wgmma`` and TMA, p and ds rounded once to
    bf16 for the second-stage products; f32 as 3xTF32 on ``wgmma``, every
    operand split into tf32 hi + lo. CPU tensors take
    ``flash_attention_bwd_plain``; anything the kernel does not take, and
    a launch it refuses (a misaligned operand among them), raises."""
    _check(q, k, v, positions, kv_positions)
    if all(t.device.type == "cpu" for t in (q, k, v, o, do, lse)):
        return flash_attention_bwd_plain(q, k, v, o, do, lse, causal,
                                         positions, kv_positions)
    B, S, H, hd = q.shape
    KV = k.shape[2]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype \
            or do.dtype != q.dtype or not o.is_contiguous() \
            or not do.is_contiguous() or o.device != q.device \
            or do.device != q.device:
        raise ValueError("flash_attention_bwd: o and do must be contiguous "
                         "(B, S, H, hd) of q's dtype on q's device")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 \
            or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError("flash_attention_bwd: lse must be contiguous "
                         "(B, H, S) f32 on q's device")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if B == 0 or S == 0:
        return dq, dk, dv
    pos = _device_positions(positions, q)
    kv_pos = pos if kv_positions is None else \
        _device_positions(kv_positions, q)
    scale = float(np.float32(1.0 / np.sqrt(hd)))
    # each q row's record (-lse log2 e; D, or 1/S for a row that saw no
    # key; its q position), written by the dq pass for the dk/dv pass
    scratch = torch.empty((B, H, S, 4), dtype=torch.float32,
                          device=q.device)
    ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            do.data_ptr(), lse.data_ptr(), _ptr(pos), _ptr(kv_pos),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), scratch.data_ptr()]
    fn = getattr(build.load("flash_attention_bwd"), _BWD_FN[q.dtype])
    with torch.cuda.device(q.device):
        err = fn(*ptrs, B, S, H, KV, hd, scale, int(bool(causal)),
                 torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """flash_attention with its gradient: the forward saves q, k, v, out
    and the row logsumexp; the backward runs the backward kernel on the
    autograd engine's current stream (plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, positions, kv_positions):
        if q.device.type == "cpu":
            out, lse = flash_attention_plain(q, k, v, causal, positions,
                                             True, kv_positions)
        else:
            out, lse = _launch_fwd(q, k, v, causal, positions, True,
                                   kv_positions)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, out, lse, positions, kv_positions)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, positions, kv_positions = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, do.contiguous(), lse,
                                         ctx.causal, positions, kv_positions)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, positions=None,
                    kv_positions=None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, KV, hd) with KV dividing H; one dtype,
    f32 or bf16; hd 64 or 128; all three contiguous, the layout the QKV
    projection and RoPE produce (a view is refused, not copied);
    ``positions`` (B, S) ints, or None for 0..S-1, and ``kv_positions``
    the keys' (default: ``positions``). Returns (B, S, H, hd)
    contiguous in q's dtype. With grad mode on and q, k or v requiring
    grad it goes through ``FlashAttentionFn``; otherwise CPU tensors take
    the plain version and CUDA tensors launch the forward kernel.
    Anything the kernel does not take raises."""
    _check(q, k, v, positions, kv_positions)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, bool(causal), positions,
                                      kv_positions)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal, positions,
                                     kv_positions=kv_positions)
    return _launch_fwd(q, k, v, causal, positions, False, kv_positions)[0]


flash_attention.launches = 0
