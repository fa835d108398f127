#!/usr/bin/env python3
"""Where the bf16 attention backward's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 benchmarks/torch_flash_bwd_variants.py [VARIANT ...]
    PYTHONPATH=src python3 benchmarks/torch_flash_bwd_variants.py \
        --baseline OTHER.cu [VARIANT ...]

Builds src/repro_torch/kernels/csrc/flash_attention_bwd.cu as committed
and, for each named variant, a copy with one of its choices undone (text
substitutions of the source, each checked to apply once), with the same
nvcc flags and beside the same csrc/hopper.cuh, all builds at once.
``--baseline`` builds another flash_attention_bwd.cu (another commit's:
``git show COMMIT:src/repro_torch/kernels/csrc/flash_attention_bwd.cu >
OTHER.cu``) as the build "baseline"; its bf16 entry may lack the scratch
argument (the CUDA-core kernel before the tensor-core one), which the
script reads off its source. Then at the lm / vfl-zoo shape (B 4, S 2048,
16 heads of 64, causal), qwen3-moe's GQA (32/4 heads of 128, causal) and
whisper's encoder (B 4, S 1500, 12 heads of 64, full) it times every build
in turns (all, then all again in reverse order) and prints one JSON line
per build and shape: max |grad - plain| / max |plain| of dq, dk and dv
against flash_attention_bwd_plain (within 2e-2), ``ms`` (chip_smoke.py's
one call between two events), ``traced_ms`` (the kernels' own durations
in a ``torch.profiler`` trace of 20 calls, over 20) and ``passes``, each
kernel's traced time a call (the dq and the dk/dv pass apart).

Ends with the card's name and power limit. Imports nothing of jax or of
the reference package.
"""
from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

# name: [(text in the committed source, its replacement), ...]
VARIANTS = {
    # the dk/dv pass at hd 64 reads k and v from shared memory in each s^T
    # and dp^T product, instead of holding them as register fragments
    "no_areg": [("static constexpr bool AREG = HD == 64;",
                 "static constexpr bool AREG = false;")],
}
SHAPES = [(4, 2048, 16, 16, 64, True), (4, 2048, 32, 4, 128, True),
          (4, 1500, 12, 12, 64, False)]
BUILD = ROOT / "build" / "flash_bwd_variants"


def _sources(names, baseline):
    """{build name: its flash_attention_bwd.cu text}."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    out = {"kernel": src}
    for name in names:
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 "source exactly once")
            text = text.replace(old, new)
        out[name] = text
    if baseline:
        out["baseline"] = Path(baseline).read_text()
    return out


def _build_all(sources):
    """Compile every source at once; {name: its bf16 entry, bound}."""
    from repro_torch.kernels import build
    procs = {}
    for name, text in sources.items():
        d = BUILD / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "flash_attention_bwd.cu").write_text(text)
        shutil.copy(build.CSRC / "hopper.cuh", d / "hopper.cuh")
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
             str(d / "flash_attention_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    entries = {}
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(json.dumps({"build": name, "spills": spills}))
        params = re.search(r'extern "C" int flash_attention_bwd_bf16\(([^)]*)\)',
                           sources[name]).group(1)
        scratch = "scratch" in params
        fn = ctypes.CDLL(str(BUILD / name / "lib.so")).flash_attention_bwd_bf16
        fn.argtypes = (P,) * (12 if scratch else 11) + (I,) * 5 + (F, I, P)
        fn.restype = I
        entries[name] = (fn, scratch)
    return entries


def _passes(fn, n=20):
    """Each kernel's traced device time a call, by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.count:
            name = re.search(r"(\w+)<", e.key)
            out[name.group(1) if name else e.key] = \
                e.device_time_total / 1e3 / n
    return out


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("torch_flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    baseline = None
    if "--baseline" in args:
        i = args.index("--baseline")
        baseline = args[i + 1]
        del args[i:i + 2]
    unknown = [a for a in args if a not in VARIANTS]
    if unknown:
        raise SystemExit(f"unknown variants {unknown}; known: "
                         f"{sorted(VARIANTS)}")
    entries = _build_all(_sources(args, baseline))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    for B, S, H, KV, hd, causal in SHAPES:
        q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                 .bfloat16() for _ in range(2))
        k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen)
                .bfloat16() for _ in range(2))
        out, lse = fa._launch_fwd(q, k, v, causal, None, True)
        want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal)
        grads = (torch.empty_like(q), torch.empty_like(k),
                 torch.empty_like(v))
        scratch = torch.empty((B, H, S, 4), dtype=torch.float32, device=dev)

        def launcher(fn, with_scratch):
            ptrs = [t.data_ptr() for t in (q, k, v, out, do, lse)] + \
                [None, None] + [t.data_ptr() for t in grads] + \
                ([scratch.data_ptr()] if with_scratch else [])

            def run():
                err = fn(*ptrs, B, S, H, KV, hd, float(hd ** -0.5),
                         int(causal), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return run

        order = list(entries) + list(entries)[::-1]
        for name in order:
            run = launcher(*entries[name])
            run()
            torch.cuda.synchronize()
            rel = [float((g.float() - w.float()).abs().max()
                         / w.float().abs().max()) for g, w in zip(grads, want)]
            print(json.dumps({
                "build": name, "shape": [B, S, H, KV, hd], "causal": causal,
                "rel_errs": rel, "ms": cs.time_ms(run),
                "traced_ms": cs.traced_ms(run), "passes": _passes(run)}),
                flush=True)
        del q, k, v, do, out, lse, want, grads, scratch
        torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
