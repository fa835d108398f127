"""Dual-evaluation matmul: ``(x @ w, x @ (w + mu*u))`` in one pass.

Every AsyREVEL round evaluates the party tower twice, at w and at the
perturbed w + mu*u (Eq. 15's two function values). Both first-layer
products read the same x and w, so the CUDA kernel (csrc/dual_matmul.cu)
reads each tile of x and w once, forms the perturbed tile in f32 as it
loads it, and runs two f32 accumulators on Hopper's tensor cores (3xTF32:
each f32 operand split into two tf32 halves, three products). It replaces
the reference's Pallas ``dual_matmul_pallas``; ``dual_matmul_plain`` is its
plain torch version, which the wrapper takes for CPU tensors only.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import build

_LIB_FN = {torch.float32: "dual_matmul_f32",
           torch.bfloat16: "dual_matmul_bf16"}


def dual_matmul_plain(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor,
                      mu):
    """f32 operands; the perturbation's product and add each round once
    in f32; both products cast back to x's dtype."""
    x32, w32 = x.float(), w.float()
    mu32 = torch.as_tensor(np.float32(mu), device=w.device)
    wp = w32 + mu32 * u.float()
    return (x32 @ w32).to(x.dtype), (x32 @ wp).to(x.dtype)


def dual_matmul(x: torch.Tensor, w: torch.Tensor, u: torch.Tensor, mu):
    """x: (M, K) f32 or bf16 with unit column stride (a column slice of a
    wider matrix is fine); w: (K, N) of x's dtype and u: (K, N) f32, both
    contiguous; mu: the perturbation scale, taken as f32. Returns
    ``(x @ w, x @ (w + mu*u))`` in x's dtype. CPU tensors take the plain
    version; CUDA tensors launch the kernel, and anything the kernel does
    not take raises."""
    tensors = (x, w, u)
    if all(t.device.type == "cpu" for t in tensors):
        return dual_matmul_plain(x, w, u, mu)
    if x.device.type != "cuda" or any(t.device != x.device for t in tensors):
        raise ValueError(f"dual_matmul: x on {x.device}, w on {w.device}, "
                         f"u on {u.device}; all must be on one CUDA device "
                         "(or the CPU)")
    if x.dtype not in _LIB_FN or w.dtype != x.dtype \
            or u.dtype != torch.float32:
        raise TypeError(f"dual_matmul takes x and w both f32 or both bf16 "
                        f"and f32 u, got {x.dtype}, {w.dtype}, {u.dtype}")
    if x.dim() != 2 or w.dim() != 2 or u.shape != w.shape \
            or x.shape[1] != w.shape[0]:
        raise ValueError(f"dual_matmul: x {tuple(x.shape)}, w "
                         f"{tuple(w.shape)}, u {tuple(u.shape)}; need x (M, "
                         "K) and w, u (K, N)")
    if x.stride(1) != 1 or not (w.is_contiguous() and u.is_contiguous()):
        raise ValueError("dual_matmul takes x with unit column stride and "
                         "contiguous w and u")
    M, K = x.shape
    N = w.shape[1]
    if max(M, N, K) >= 1 << 31:
        raise ValueError(f"dual_matmul: dimension too large ({M}, {K}, {N})")
    y0 = torch.empty((M, N), dtype=x.dtype, device=x.device)
    y1 = torch.empty((M, N), dtype=x.dtype, device=x.device)
    if M == 0 or N == 0:
        return y0, y1
    fn = getattr(build.load("dual_matmul"), _LIB_FN[x.dtype])
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), x.stride(0), w.data_ptr(), u.data_ptr(),
                 float(np.float32(mu)), y0.data_ptr(), y1.data_ptr(), M, N, K,
                 torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"dual_matmul kernel launch failed: CUDA error "
                           f"{err}")
    dual_matmul.launches += 1
    return y0, y1


dual_matmul.launches = 0
