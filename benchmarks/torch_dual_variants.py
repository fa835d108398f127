#!/usr/bin/env python3
"""Where the f32 dual_matmul kernel's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 benchmarks/torch_dual_variants.py [VARIANT ...]

Builds src/repro_torch/kernels/csrc/dual_matmul.cu as committed and, for
each named variant, a copy with one piece of the kernel's work taken out
or swapped (text substitutions of the source, each checked to apply
once), with the same nvcc flags. Then at the D7 main path's shape (x 2048
x 98, w 98 x 128), the async phase's (64 x 98 x 128) and 4096^3, it runs
every build once and prints max |y - plain| / max |plain| over both
outputs (the committed kernel must stay within chip_smoke.py's 1e-5; the
variants compute something else and are timed only), then times every
build in turns (all, then all again): one call between two CUDA events
(median of 20 after 3 warm-ups, as chip_smoke.py), the device time of 20
calls queued back to back between two events, over 20, and the kernel's
own duration in a ``torch.profiler`` trace of 20 calls, over 20 (the
queued calls of a few-us kernel wait on the host). Beside them the same
times of the two ``torch.matmul`` calls that compute the same function.
One JSON line per shape; ends with the card's name and power limit.
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

# name: [(text in the committed source, its replacement), ...]
VARIANTS = {
    # one wgmma accumulator over the whole K: no per-stage round-to-nearest
    # totals, the tensor cores' own accumulation throughout
    "no_promote": [
        ("    wgmma_tf32(acc0, ah[kk], d_wh, kk > 0);\n"
         "    wgmma_tf32(acc1, ah[kk], d_ph, kk > 0);\n",
         "    wgmma_tf32(acc0, ah[kk], d_wh, 1);\n"
         "    wgmma_tf32(acc1, ah[kk], d_ph, 1);\n"),
        ("      tot0[i] = __fadd_rn(tot0[i], acc0[i]);\n"
         "      tot1[i] = __fadd_rn(tot1[i], acc1[i]);\n",
         "      tot0[i] = acc0[i];\n      tot1[i] = acc1[i];\n")],
    # no products at all: the copies, the split and the stores alone
    "no_mma": [("  for (int kk = 0; kk < BK / 8; ++kk) {\n"
                "    const uint32_t k_off",
                "  for (int kk = 0; kk < 0; ++kk) {\n"
                "    const uint32_t k_off")],
    # no copies after the first stages: the later stages reuse stale tiles
    "no_copies": [("    load(s + STAGES - 1);\n", "    cp_async_commit();\n")],
    # no B operands formed after the first stage: the products reuse stale
    # ones
    "no_prepare": [("      prepare_b<T, WGS, BN>(stage(s + 1), "
                    "bt + ((s + 1) & 1) * 4 * C::BT_BYTES,\n"
                    "                            mu, tid);\n", "")],
    # the products alone: no copies, no B operands and no x fragments
    # formed after the first stage (x is still loaded)
    "mma_only": [("    load(s + STAGES - 1);\n", "    cp_async_commit();\n"),
                 ("      prepare_b<T, WGS, BN>(stage(s + 1), "
                  "bt + ((s + 1) & 1) * 4 * C::BT_BYTES,\n"
                  "                            mu, tid);\n", ""),
                 ("      split_x<T>(xv, ah, al);\n      if (s + 2 < steps)",
                  "      if (s + 2 < steps)")],
    # no x fragments split after the first stage
    "no_split_x": [("      split_x<T>(xv, ah, al);\n      if (s + 2 < steps)",
                    "      if (s + 2 < steps)")],
    # large shapes on 64 x 64 tiles of one warpgroup, two blocks an SM (a
    # 3-stage ring, so that two fit), in place of 128 x 64 tiles
    "one_wg": [("constexpr int STAGES = 4;", "constexpr int STAGES = 3;"),
               ("__launch_bounds__(128 * WGS, 1)",
                "__launch_bounds__(128 * WGS, 2)"),
               ("return launch_tile<T, 2, 64>(",
                "return launch_tile<T, 1, 64>(")],
    # the split's rounding by cvt.rna.tf32.f32 instead of on the bits
    "cvt_rna": [("  return (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;",
                 "  uint32_t r;\n"
                 "  asm(\"cvt.rna.tf32.f32 %0, %1;\""
                 " : \"=r\"(r) : \"f\"(a));\n"
                 "  return r;")],
}
SHAPES = [(2048, 98, 128), (64, 98, 128), (4096, 4096, 4096)]


def build_variant(name: str, source: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise SystemExit(f"variant {name}: its text is not in the "
                             "source exactly once")
        source = source.replace(old, new)
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"dual_matmul_{name}.cu"
    cu.write_text(source)
    lib = out_dir / f"libdual_matmul_{name}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True, capture_output=True)
    dll = ctypes.CDLL(str(lib))
    build._declare("dual_matmul", dll)
    return dll


def main(names) -> int:
    import torch
    from chip_smoke import card_line, device_ms, time_ms, traced_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import dual_matmul as dm

    if not torch.cuda.is_available():
        print("torch_dual_variants: no CUDA device", file=sys.stderr)
        return 2
    source = (build.CSRC / "dual_matmul.cu").read_text()
    libs = {"kernel": build.load("dual_matmul")}
    libs.update({name: build_variant(name, source) for name in names})
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    mu = 1e-3
    for M, K, N in SHAPES:
        x = torch.randn(M, K, device=dev, generator=gen)
        w = torch.randn(K, N, device=dev, generator=gen)
        u = torch.randn(K, N, device=dev, generator=gen)
        want = dm.dual_matmul_plain(x, w, u, mu)
        scale = max(float(y.abs().max()) for y in want)

        def kernel():
            return dm.dual_matmul(x, w, u, mu)

        def library():
            return torch.matmul(x, w), torch.matmul(x, w + mu * u)
        row = {}
        for name, lib in libs.items():
            build._LOADED["dual_matmul"] = lib
            got = kernel()
            torch.cuda.synchronize()
            row[name] = {"rel_err": max(float((g - y).abs().max())
                                        for g, y in zip(got, want)) / scale,
                         "ms": [], "device_ms": [], "traced_ms": []}
        for _ in range(2):
            for name, lib in libs.items():
                build._LOADED["dual_matmul"] = lib
                row[name]["ms"].append(time_ms(kernel))
                row[name]["device_ms"].append(device_ms(kernel))
                row[name]["traced_ms"].append(traced_ms(kernel))
        build._LOADED["dual_matmul"] = libs["kernel"]
        print(json.dumps({"shape": [M, K, N], "builds": row,
                          "library_ms": time_ms(library),
                          "library_device_ms": device_ms(library),
                          "library_traced_ms": traced_ms(library)}),
              flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or list(VARIANTS)))
