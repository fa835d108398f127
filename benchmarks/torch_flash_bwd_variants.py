#!/usr/bin/env python3
"""Where the attention backward's time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 benchmarks/torch_flash_bwd_variants.py \
        [--dtype bf16|f32] [--baseline OTHER.cu] [VARIANT ...]

Builds src/repro_torch/kernels/csrc/flash_attention_bwd.cu as committed
and, for each named variant, a copy with one of its choices undone (text
substitutions of the source, each checked to apply once), with the same
nvcc flags and beside the same csrc/hopper.cuh, all builds at once.
``--baseline`` builds another flash_attention_bwd.cu (another commit's:
``git show COMMIT:src/repro_torch/kernels/csrc/flash_attention_bwd.cu >
OTHER.cu``) as the build "baseline"; an entry of it may lack the scratch
argument (the CUDA-core kernels before the tensor-core ones), which the
script reads off its source.

``--dtype bf16`` (the default) runs the lm / vfl-zoo shape (B 4, S 2048,
16 heads of 64, causal), qwen3-moe's GQA (32/4 heads of 128, causal) and
whisper's encoder (B 4, S 1500, 12 heads of 64, full). ``--dtype f32``
runs the lm shape in f32, explicit positions with rows that see no key
(B 2, S 1000, 8/4 heads of 64), a GQA case at hd 128 (B 2, S 1024, 16/4
heads, causal) and the reduced shape (B 2, S 32, 4 heads of 64, causal).
At each shape it times every build in turns (all, then all again in
reverse order) and prints one JSON line per build and shape: max
|grad - plain| / max |plain| of dq, dk and dv against
flash_attention_bwd_plain, ``bitwise``: whether the build's three outputs
equal the committed kernel's bit for bit, ``ms`` (chip_smoke.py's one call
between two events), ``traced_ms`` (the kernels' own durations in a
``torch.profiler`` trace of 20 calls, over 20) and ``passes``, each kernel's
traced time a call (the dq and the dk/dv pass apart); before them, each
build's registers and spill bytes by function (ptxas). Then one line for
the backward of scaled_dot_product_attention through autograd at that
shape (the yardstick chip_smoke.py times): its one-call and traced times
and its backend.

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

# name: (dtype, [(text in the committed source, its replacement), ...])
VARIANTS = {
    # the dk/dv pass at hd 64 reads k and v from shared memory in each s^T
    # and dp^T product, instead of holding them as register fragments
    "no_areg": ("bf16", [("static constexpr bool AREG = HD == 64;",
                          "static constexpr bool AREG = false;")]),
    # f32: one consumer warpgroup in the dq pass at hd 64 (64 q rows a
    # block), not two
    "f32_dq_one_wg": ("f32", [(
        "static constexpr int NWG = HD == 64 ? 2 : 1;        // 64 q rows",
        "static constexpr int NWG = 1;                       // 64 q rows")]),
    # f32: the dk/dv pass releases a tile's q and dO (set A) with its q^T
    # and dO^T at the end of the tile, so the producer refills neither
    # while the tile's second stage runs
    "f32_late_release": ("f32", [
        ("  mbar_arrive(bars + 8);\n  sum_chunks(sc);\n  sum_chunks(dc);\n"
         "  mbar_wait(bars + 16, parity);",
         "  sum_chunks(sc);\n  sum_chunks(dc);\n"
         "  mbar_wait(bars + 16, parity);"),
        ("  mbar_arrive(bars + 24);\n#pragma unroll\n"
         "  for (int x = 0; x < T::NO; ++x) dk[x]",
         "  mbar_arrive(bars + 8);\n  mbar_arrive(bars + 24);\n"
         "#pragma unroll\n  for (int x = 0; x < T::NO; ++x) dk[x]")]),
    # f32: the dk/dv pass's producer loads each q tile's q and dO into
    # registers itself, twice (both layouts), instead of staging them raw by
    # cp.async a tile ahead and splitting them from shared memory
    "f32_no_staging": ("f32", [("static constexpr bool STAGED = HD == 64;",
                                "static constexpr bool STAGED = false;")]),
    # f32: the producer stores each value as it is (its tf32 truncation as
    # hi) and zeros as lo: every product still runs, the split's work goes
    # (and with it the precision)
    "f32_no_split": ("f32", [
        ("for (int e = 0; e < 4; ++e) split(a[e], h[e], l[e]);",
         "for (int e = 0; e < 4; ++e) h[e] = __float_as_uint(a[e]), l[e] = 0;"),
        ("split(x[8 * a + 2 * c + odd], h[c], l[c]);",
         "h[c] = __float_as_uint(x[8 * a + 2 * c + odd]), l[c] = 0;")]),
    # f32: hi.hi alone, one tf32 product where the kernel runs three (the
    # products' share of the time; misses the precision)
    "f32_one_product": ("f32", [
        ("    wgmma_tf32_ss(sc[kk / 4], da, db + (B_LO >> 4), 1);\n"
         "    wgmma_tf32_ss(sc[kk / 4], da + (A_LO >> 4), db, 1);\n", ""),
        ("    wgmma_tf32_rs(acc, ah[kk], db + (B_LO >> 4), 1);\n"
         "    wgmma_tf32_rs(acc, al[kk], db, 1);\n", "")]),
}
# (B, S, H, KV, hd, causal, positions)
SHAPES = {"bf16": [(4, 2048, 16, 16, 64, True, False),
                   (4, 2048, 32, 4, 128, True, False),
                   (4, 1500, 12, 12, 64, False, False)],
          "f32": [(4, 2048, 16, 16, 64, True, False),
                  (2, 1000, 8, 4, 64, True, True),
                  (2, 1024, 16, 4, 128, True, False),
                  (2, 32, 4, 4, 64, True, False)]}
BUILD = ROOT / "build" / "flash_bwd_variants"


def _sources(names, baseline):
    """{build name: its flash_attention_bwd.cu text}."""
    from repro_torch.kernels import build
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    out = {"kernel": src}
    for name in names:
        text = src
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in the "
                                 "source exactly once")
            text = text.replace(old, new)
        out[name] = text
    if baseline:
        out["baseline"] = Path(baseline).read_text()
    return out


def _build_all(sources, dtype):
    """Compile every source at once; {name: (its entry for dtype, whether
    the entry takes the scratch)}."""
    import chip_smoke as cs
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
    entry = f"flash_attention_bwd_{dtype}"
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
        print(json.dumps({"build": name, "functions": {
            cs.bwd_function(fn) or fn: regs
            for fn, regs in cs.ptxas_functions(log).items()}}))
        params = re.search(rf'extern "C" int {entry}\(([^)]*)\)',
                           sources[name]).group(1)
        scratch = "scratch" in params
        fn = getattr(ctypes.CDLL(str(BUILD / name / "lib.so")), entry)
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
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels import flash_attention as fa

    if not torch.cuda.is_available():
        print("torch_flash_bwd_variants: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    baseline, dtype = None, "bf16"
    for flag in ("--baseline", "--dtype"):
        if flag in args:
            i = args.index(flag)
            if flag == "--baseline":
                baseline = args[i + 1]
            else:
                dtype = args[i + 1]
            del args[i:i + 2]
    if dtype not in SHAPES:
        raise SystemExit(f"--dtype {dtype}: bf16 or f32")
    unknown = [a for a in args if a not in VARIANTS
               or VARIANTS[a][0] != dtype]
    if unknown:
        known = sorted(n for n, v in VARIANTS.items() if v[0] == dtype)
        raise SystemExit(f"unknown variants {unknown} for {dtype}; known: "
                         f"{known}")
    entries = _build_all(_sources(args, baseline), dtype)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    dt = {"bf16": torch.bfloat16, "f32": torch.float32}[dtype]
    gen = torch.Generator(device=dev).manual_seed(5)
    for B, S, H, KV, hd, causal, positions in SHAPES[dtype]:
        q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                 .to(dt) for _ in range(2))
        k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen)
                .to(dt) for _ in range(2))
        qp = kp = None
        if positions:
            qp = torch.randint(0, S, (B, S), device=dev, generator=gen)
            kp = torch.randint(5, S, (B, S), device=dev, generator=gen)
            qp[0, :3] = 2
        out, lse = fa._launch_fwd(q, k, v, causal, qp, True, kp)
        want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal,
                                            qp, kp)
        pos = [None, None] if qp is None else \
            [t.to(torch.int32).contiguous() for t in (qp, kp)]
        scratch = torch.empty((B, H, S, 4), dtype=torch.float32, device=dev)
        grads = {name: (torch.empty_like(q), torch.empty_like(k),
                        torch.empty_like(v)) for name in entries}

        def launcher(name):
            fn, with_scratch = entries[name]
            g = grads[name]
            ptrs = [t.data_ptr() for t in (q, k, v, out, do, lse)] + \
                [None if t is None else t.data_ptr() for t in pos] + \
                [t.data_ptr() for t in g] + \
                ([scratch.data_ptr()] if with_scratch else [])

            def run():
                err = fn(*ptrs, B, S, H, KV, hd, float(hd ** -0.5),
                         int(causal), torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: CUDA error {err}")
            return run

        runs = {name: launcher(name) for name in entries}
        runs["kernel"]()
        order = list(entries) + list(entries)[::-1]
        for name in order:
            run = runs[name]
            run()
            torch.cuda.synchronize()
            got = grads[name]
            rel = [float((g.float() - w.float()).abs().max()
                         / w.float().abs().max()) for g, w in zip(got, want)]
            bitwise = all(torch.equal(a, b)
                          for a, b in zip(got, grads["kernel"]))
            print(json.dumps({
                "build": name, "dtype": dtype, "shape": [B, S, H, KV, hd],
                "causal": causal, "positions": positions, "rel_errs": rel,
                "bitwise": bitwise, "ms": cs.time_ms(run),
                "traced_ms": cs.traced_ms(run), "passes": _passes(run)}),
                flush=True)
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v)]
        mask = None
        if positions:
            mask = torch.where(kp[:, None, None, :] > qp[:, None, :, None],
                               torch.tensor(-1e30, dtype=dt, device=dev),
                               torch.tensor(0.0, dtype=dt, device=dev))
        sdpa = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and not positions,
            enable_gqa=KV != H)
        do_t = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(sdpa, leaves, do_t, retain_graph=True)
        print(json.dumps({
            "library": "scaled_dot_product_attention backward",
            "dtype": dtype, "shape": [B, S, H, KV, hd], "causal": causal,
            "positions": positions, "ms": cs.time_ms(library),
            "traced_ms": cs.traced_ms(library),
            **cs.sdpa_backend(library)}), flush=True)
        del q, k, v, do, out, lse, want, grads, scratch, runs, leaves, sdpa
        torch.cuda.empty_cache()
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
