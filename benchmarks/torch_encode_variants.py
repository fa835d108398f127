#!/usr/bin/env python3
"""Where defended_encode's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 benchmarks/torch_encode_variants.py \
        [--baseline OTHER.cu] [VARIANT ...]

Builds src/repro_torch/kernels/csrc/defended_encode.cu as committed and,
for each named variant, a copy with one piece of the kernel's work taken
out or swapped (text substitutions of the source with csrc/prng.cuh
inlined, each checked to apply once), with the same nvcc flags.
``--baseline`` adds another defended_encode.cu with the interface the
kernel had before it drew its own bits (c, dp_bits, rnd_bits, has_dp,
clip, noise_scale, mechanism, ...; another commit's, say): it is timed on
pre-made bits, and its SASS opcodes are printed for the functions that
evaluate erf_inv.

At n = 2048 (D7's payload), 2^21 (the vfl-zoo payload) and 2^24, int8 and
f32 with gaussian DP, every build runs once (the committed kernel must be
bitwise equal to the plain chain, and so must the variants that only
reorder its work; the others compute something else and are timed only),
then all builds are timed in turns (all, then all again): one call
between two CUDA events (median of 20 after 3 warm-ups, as
chip_smoke.py) and the kernel's own duration in a ``torch.profiler``
trace of 20 calls, over 20. The committed kernel is timed twice, drawing
its bits from the keys ("kernel") and reading pre-made bits from device
memory ("bits_from_memory"). One JSON line per case; ends with the card's
name and power limit. Imports nothing of jax or of the reference package.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: [(text in the committed source, its replacement), ...]
VARIANTS = {
    # the part past what the grid keeps is not swept again after the
    # barrier (at 2^24 most of q stays unwritten)
    "no_second_sweep": [("  for (long long i = rest0; i < n; i += rest_stride) "
                         "{\n    if (i + 4 <= n) {\n      reinterpret_cast"
                         "<char4*>(q)[i >> 2] =",
                         "  for (long long i = n; i < n; i += rest_stride) "
                         "{\n    if (i + 4 <= n) {\n      reinterpret_cast"
                         "<char4*>(q)[i >> 2] =")],
    # no noise chain: the dp word goes in as a uniform (threefry stays)
    "no_noise": [("  float z = NOISE == kGaussian ? prng::normal(b) : "
                  "prng::laplace(b);",
                  "  float z = prng::uniform01(b);")],
    # no threefry: each word is the counter xor the key
    "no_threefry": [("    return prng::bits_at(k0, k1, (unsigned long long)i);",
                     "    return (uint32_t)i ^ k0 ^ k1;")],
    # log1p's two branches both computed and one selected, no branch (the
    # same operations, so the same bits)
    "branchless_log1p": [
        ("  if (fabsf(x) < (float)0.41421356237309504880) return "
         "__fadd_rn(x, small);\n  return xla_log(__fadd_rn(x, 1.0f));",
         "  float big = xla_log(__fadd_rn(x, 1.0f));\n  return fabsf(x) < "
         "(float)0.41421356237309504880 ? __fadd_rn(x, small) : big;")],
}
# variants that compute the same bits as the kernel
SAME_BITS = ("branchless_log1p",)
SIZES = (2048, 1 << 21, 1 << 24)
CODECS = ("int8", "f32")
# opcodes that tell how erf_inv reads its coefficients
SASS_OPS = ("LDC", "ULDC", "LDG", "LD.", "FSEL", "FFMA")


def _build(tag: str, source: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / f"defended_encode_{tag}.cu"
    cu.write_text(source)
    lib = out_dir / f"libdefended_encode_{tag}.so"
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
                    "-o", str(lib), str(cu)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def build_variant(name: str, source: str) -> ctypes.CDLL:
    from repro_torch.kernels import build
    source = source.replace('#include "prng.cuh"',
                            (build.CSRC / "prng.cuh").read_text())
    for old, new in VARIANTS[name]:
        if source.count(old) != 1:
            raise SystemExit(f"variant {name}: its text is not in the "
                             "source exactly once")
        source = source.replace(old, new)
    dll = _build(name, source)
    build._declare("defended_encode", dll)
    return dll


def build_baseline(path: str):
    """The earlier interface: f32/bf16 in one launch, int8 as a memset and
    two launches, bits read from device memory."""
    dll = _build("baseline", Path(path).read_text())
    P, I, F, LL = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                   ctypes.c_longlong)
    dll.defended_encode_cast.argtypes = (P, P, I, F, F, I, I, P, LL, P)
    dll.defended_encode_int8.argtypes = (P, P, P, I, F, F, I, P, P, P, LL, P)
    dll.defended_encode_cast.restype = dll.defended_encode_int8.restype = I
    return dll


def print_sass(tag: str):
    from chip_smoke import sass_functions
    from repro_torch.kernels import build
    target = build.BUILD_DIR / "variants" / f"libdefended_encode_{tag}.so"
    saved = build._target
    build._target = lambda name: target
    try:
        funcs = sass_functions("defended_encode")
    finally:
        build._target = saved
    for fn, text in funcs.items():
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                         text)
        counts = {op: sum(o.startswith(op) for o in ops) for op in SASS_OPS}
        print(json.dumps({"sass": tag, "function": fn,
                          "instructions": len(ops), **counts}), flush=True)


def main(args) -> int:
    import torch
    from chip_smoke import card_line, time_ms, traced_ms
    from repro_torch.configs import DPConfig
    from repro_torch.kernels import build, fused_round
    from repro_torch.utils import prng

    if not torch.cuda.is_available():
        print("torch_encode_variants: no CUDA device", file=sys.stderr)
        return 2
    baseline = None
    if "--baseline" in args:
        at = args.index("--baseline")
        baseline = build_baseline(args[at + 1])
        args = args[:at] + args[at + 2:]
    names = args or list(VARIANTS)
    source = (build.CSRC / "defended_encode.cu").read_text()
    libs = {"kernel": build.load("defended_encode")}
    libs.update({name: build_variant(name, source) for name in names})
    if baseline is not None:
        print_sass("baseline")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    dp = DPConfig(noise_multiplier=1.3, clip=1.0)
    noise = float(fused_round._noise_scale32(dp))
    for n in SIZES:
        c = 2.0 * torch.randn(n, device=dev, generator=gen)
        dk, rk = (7, n), (9, n)
        dpb = prng.bits(dk, c.shape, dev)
        rnb = prng.bits(rk, c.shape, dev)
        for codec in CODECS:
            rkey = rk if codec == "int8" else None
            want = fused_round._encode_math(
                fused_round._defend_math(c, dpb, dp),
                rnb if codec == "int8" else None, codec)

            def keyed():
                return fused_round.defended_encode_keyed(c, dk, rkey, dp,
                                                         codec)

            def from_bits():
                return fused_round.defended_encode(
                    c, dpb, rnb if codec == "int8" else None, dp, codec)
            runs = {name: keyed for name in libs}
            runs["bits_from_memory"] = from_bits
            if baseline is not None:
                stream = torch.cuda.current_stream(dev).cuda_stream
                amax = torch.empty(1, dtype=torch.int32, device=dev)
                q = torch.empty_like(c, dtype=torch.int8)
                scale = torch.empty((), dtype=torch.float32, device=dev)
                out = torch.empty_like(c)

                def base(codec=codec, q=q, scale=scale, out=out, amax=amax,
                         stream=stream):
                    if codec == "int8":
                        err = baseline.defended_encode_int8(
                            c.data_ptr(), dpb.data_ptr(), rnb.data_ptr(), 1,
                            1.0, noise, 0, amax.data_ptr(), q.data_ptr(),
                            scale.data_ptr(), n, stream)
                        result = (q, scale)
                    else:
                        err = baseline.defended_encode_cast(
                            c.data_ptr(), dpb.data_ptr(), 1, 1.0, noise, 0, 0,
                            out.data_ptr(), n, stream)
                        result = out
                    if err:
                        raise RuntimeError(f"baseline: CUDA error {err}")
                    return result
                runs["baseline"] = base
            row = {}
            for name, fn in runs.items():
                build._LOADED["defended_encode"] = libs.get(name,
                                                            libs["kernel"])
                got = fn()
                torch.cuda.synchronize()
                same = all(torch.equal(a.view(torch.int8) if a.dtype ==
                                       torch.int8 else a.view(torch.int32),
                                       b.view(torch.int8) if b.dtype ==
                                       torch.int8 else b.view(torch.int32))
                           for a, b in zip(got if codec == "int8" else (got,),
                                           want if codec == "int8" else
                                           (want,)))
                if name in ("kernel", "bits_from_memory", "baseline",
                            *SAME_BITS) and not same:
                    raise AssertionError(f"{name} != plain at n={n} {codec}")
                row[name] = {"bitwise": same, "ms": [], "traced_ms": []}
            for _ in range(2):
                for name, fn in runs.items():
                    build._LOADED["defended_encode"] = libs.get(
                        name, libs["kernel"])
                    row[name]["ms"].append(time_ms(fn))
                    row[name]["traced_ms"].append(traced_ms(fn))
            build._LOADED["defended_encode"] = libs["kernel"]
            print(json.dumps({"n": n, "codec": codec, "dp": "gaussian",
                              "builds": row}), flush=True)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
