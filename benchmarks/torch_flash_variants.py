#!/usr/bin/env python3
"""Where the bf16 flash_attention kernel's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 benchmarks/torch_flash_variants.py [VARIANT ...]

Builds src/repro_torch/kernels/csrc/flash_attention.cu as committed and,
for each named variant, a copy with one piece of the kernel's work taken
out or swapped (a text substitution of the source, checked to apply),
with the same nvcc flags. Then at the vfl-zoo shape (B 4, S 2048, H 16,
hd 64, causal), the same shape without the mask, and yi-34b's GQA heads
(S 1024, 56/8, hd 128), it times every build in turns (all, then all
again; CUDA events, median of 20 after 3 warm-ups) beside PyTorch's
scaled_dot_product_attention, and prints one JSON line per shape. Each
build's first number is its largest |out - f32 result| over the element
allowance (2^-8 |f32 result| + 1e-5 max): only the committed kernel and
``expf`` must stay at or below 1; the others compute something else and
are timed only. Those times are chip_smoke.py's: one call between two
events, so they hold the wrapper's host time; ``device_ms`` is 20 calls
queued back to back between two events, over 20, which hides the host
time under the device's. Ends with the card's name and power limit.
Imports nothing of jax or of the reference package.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: (text in the committed source, its replacement)
VARIANTS = {
    # the exponent by the accurate expf instead of ex2.approx
    "expf": ("x = ex2(__fmaf_rn(x, c, -m_new));",
             "x = expf(__fmul_rn(__fmaf_rn(x, c, -m_new), 0.6931472f));"),
    # no softmax: the scores go to the p.v products as they are
    "no_softmax": ("""    if (edge)
      softmax<true>(s, m, l, corr, k0, r0, c0, S, causal, c);
    else
      softmax<false>(s, m, l, corr, k0, r0, c0, S, causal, c);""",
                   "    corr[0] = corr[1] = 1.0f;"),
    # p_hi and p_lo not formed after the first tile
    "no_split": ("      C::rescale(o, corr);\n      C::split(s, p_hi, p_lo);\n",
                 "      C::rescale(o, corr);\n"),
    # no q.k products after the first tile
    "no_qk": ("      C::issue_qk(s, q_wg, k_tile(i));\n      wgmma_commit();\n",
              "      wgmma_commit();\n"),
    # no p.v products but the last tile's
    "no_pv": ("      C::issue_pv(o, p_hi, p_lo, v_tile(i - 1));\n", ""),
    # p rounded once to bf16: the p_lo products left out
    "p_bf16": ("        wgmma_rs_n64(o[hf], p_lo[kk],",
               "        if (0) wgmma_rs_n64(o[hf], p_lo[kk],"),
}
SHAPES = [(4, 2048, 16, 16, 64, True), (4, 2048, 16, 16, 64, False),
          (1, 1024, 56, 8, 128, True)]


def build_variant(name: str, source: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    old, new = VARIANTS[name]
    if source.count(old) != 1:
        raise SystemExit(f"variant {name}: its text is not in the source "
                         "exactly once")
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"flash_attention_{name}.cu"
    cu.write_text(source.replace(old, new))
    lib = out_dir / f"libflash_attention_{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    build._declare("flash_attention", dll)
    return dll


def main(names) -> int:
    import torch
    import torch.nn.functional as F
    from chip_smoke import card_line, device_ms, time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 2
    source = (build.CSRC / "flash_attention.cu").read_text()
    libs = {"kernel": build.load("flash_attention")}
    libs.update({name: build_variant(name, source) for name in names})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    for B, S, H, KV, hd, causal in SHAPES:
        q, k, v = (torch.randn(B, S, n, hd, device=dev, generator=gen)
                   .bfloat16() for n in (H, KV, KV))
        want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                          causal)
        allowed = 2.0 ** -8 * want32.abs() + 1e-5 * want32.abs().max()
        row = {}
        for name, lib in libs.items():
            build._LOADED["flash_attention"] = lib
            got = fa.flash_attention(q, k, v, causal)
            torch.cuda.synchronize()
            row[name] = [float(((got.float() - want32).abs()
                                / allowed).max())]
        for _ in range(2):
            for name, lib in libs.items():
                build._LOADED["flash_attention"] = lib
                row[name].append(time_ms(
                    lambda: fa.flash_attention(q, k, v, causal)))
        build._LOADED["flash_attention"] = libs["kernel"]

        def kernel():
            return fa.flash_attention(q, k, v, causal)

        def sdpa():
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=KV != H)
        print(json.dumps({"shape": [B, S, H, KV, hd], "causal": causal,
                          "elem_ratio_then_ms": row,
                          "sdpa_ms": time_ms(sdpa),
                          "device_ms": {"kernel": device_ms(kernel),
                                        "sdpa": device_ms(sdpa)}}),
              flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
