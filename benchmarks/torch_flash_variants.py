#!/usr/bin/env python3
"""Where the flash_attention kernels' time goes, on one NVIDIA GPU.

    PYTHONPATH=src python3 benchmarks/torch_flash_variants.py [VARIANT ...]
    PYTHONPATH=src python3 benchmarks/torch_flash_variants.py \
        --baseline OTHER.cu [VARIANT ...]
    PYTHONPATH=src python3 benchmarks/torch_flash_variants.py --bf16-gap

Builds src/repro_torch/kernels/csrc/flash_attention.cu as committed and,
for each named variant, a copy with one piece of a kernel's work taken
out or swapped (text substitutions of the source, each checked to apply
once), with the same nvcc flags, all builds at once. Each variant belongs
to the bf16 kernel, the f32 kernel or both (``expf``). Then, per type, at
the vfl-zoo shape (B 4, S 2048, H 16, hd 64, causal), yi-34b's GQA heads
(S 1024, 56/8, hd 128, causal), and without the mask (bf16: the vfl-zoo
shape; f32: S 1024, 8 heads of 128, where a truncating q.k sum shows
most), it times every build of that type in turns (all, then all again)
beside PyTorch's scaled_dot_product_attention, and prints one JSON line
per shape. Each build's error comes first: bf16, its largest |out - f32
result| over the element allowance (2^-8 |f32 result| + 1e-5 max), which
must stay at or below 1; f32, max |out - plain| / max |plain|, within
1e-5. Only the committed kernel, ``expf`` and the f32 accumulator and
turn variants compute the same function; the others compute something
else and are timed only. Times: ``ms`` is chip_smoke.py's one call
between two events (it holds the wrapper's host time), ``device_ms`` 20
calls queued back to back between two events over 20, ``traced_ms`` the
kernels' own durations in a ``torch.profiler`` trace of 20 calls, over
20. ``--baseline`` builds another flash_attention.cu (another commit's,
say) as the build "baseline", timed in both types beside the kernel.

``--bf16-gap`` runs chip_smoke.reduced_bf16_steps (3 fused int8 vfl-zoo
steps of reduced qwen1.5-0.5b in bf16, from seed 0) on the CPU and on the
card with the committed kernel, with the plain attention called on the
card in its place, with the ``expf`` build and with the ``p_bf16`` build
(p not split), and prints each run's h and its gaps to the CPU's: which of
the bf16 kernel's approximations moves h.

Ends with the card's name and power limit. Imports nothing of jax or of
the reference package.
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

# name: (the types it is timed in, [(text in the committed source, its
# replacement), ...])
VARIANTS = {
    # the exponent by the accurate expf instead of ex2.approx (the softmax
    # both kernels share)
    "expf": (("bf16", "f32"), [
        ("x = ex2(__fmaf_rn(x, c, -m_new));",
         "x = expf(__fmul_rn(__fmaf_rn(x, c, -m_new), 0.6931472f));")]),
    # bf16: no softmax, the scores go to the p.v products as they are
    "no_softmax": (("bf16",), [
        ("    softmax_step(s, m, l, corr, k0, r0, c0, edge, S, causal, c);",
         "    corr[0] = corr[1] = 1.0f;")]),
    # bf16: p_hi and p_lo not formed after the first tile
    "no_split": (("bf16",), [
        ("      C::rescale(o, corr);\n      C::split(s, p_hi, p_lo);\n",
         "      C::rescale(o, corr);\n")]),
    # bf16: no q.k products after the first tile
    "no_qk": (("bf16",), [
        ("      C::issue_qk(s, q_wg, k_tile(i));\n      wgmma_commit();\n",
         "      wgmma_commit();\n")]),
    # bf16: no p.v products but the last tile's
    "no_pv": (("bf16",), [
        ("      C::issue_pv(o, p_hi, p_lo, v_tile(i - 1));\n", "")]),
    # bf16: p rounded once to bf16, the p_lo products left out
    "p_bf16": (("bf16",), [
        ("        wgmma_rs_n64(o[hf], p_lo[kk],",
         "        if (0) wgmma_rs_n64(o[hf], p_lo[kk],")]),
    # f32: the products alone; after the first tiles the producer loads
    # and stores nothing (the products reread stale operands), and the
    # consumers skip the softmax and hand s to the p.v products unsplit
    "f32_products_only": (("f32",), [
        ("      Rows<HD, BKV>::load(x, kb, kv_s, i * BKV, S, pt, 0);",
         "      if (i < SETS) Rows<HD, BKV>::load(x, kb, kv_s, i * BKV, S, pt, 0);"),
        ("      Rows<HD, BKV>::store(x, op(i, 0), op(i, 1), pt, 0);",
         "      if (i < SETS) Rows<HD, BKV>::store(x, op(i, 0), op(i, 1), pt, 0);"),
        ("      VT<HD, BKV>::load(y, vb, kv_s, i * BKV, S, pt);",
         "      if (i < SETS) VT<HD, BKV>::load(y, vb, kv_s, i * BKV, S, pt);"),
        ("      VT<HD, BKV>::store(y, op(i, 2), op(i, 3), pt);",
         "      if (i < SETS) VT<HD, BKV>::store(y, op(i, 2), op(i, 3), pt);"),
        ("      softmax_step(s, m, l, corr, i * BKV, r0, c0, edge(i), S, causal, c);\n"
         "      C::split_p(s, p_hi, p_lo);",
         "      corr[0] = corr[1] = 1.0f;\n"
         "      for (int j = 0; j < C::KSTEPS; ++j)\n"
         "        for (int r = 0; r < 4; ++r)\n"
         "          p_hi[j][r] = p_lo[j][r] = __float_as_uint(s[4 * j + r]);")]),
    # f32: the producer's half of f32_products_only: after the first tiles
    # it loads and stores nothing (the products reread stale operands)
    "f32_no_loads": (("f32",), [
        ("      Rows<HD, BKV>::load(x, kb, kv_s, i * BKV, S, pt, 0);",
         "      if (i < SETS) Rows<HD, BKV>::load(x, kb, kv_s, i * BKV, S, pt, 0);"),
        ("      Rows<HD, BKV>::store(x, op(i, 0), op(i, 1), pt, 0);",
         "      if (i < SETS) Rows<HD, BKV>::store(x, op(i, 0), op(i, 1), pt, 0);"),
        ("      VT<HD, BKV>::load(y, vb, kv_s, i * BKV, S, pt);",
         "      if (i < SETS) VT<HD, BKV>::load(y, vb, kv_s, i * BKV, S, pt);"),
        ("      VT<HD, BKV>::store(y, op(i, 2), op(i, 3), pt);",
         "      if (i < SETS) VT<HD, BKV>::store(y, op(i, 2), op(i, 3), pt);")]),
    # f32: the consumers' half: no softmax, s handed to the p.v products
    # unsplit
    "f32_no_softmax": (("f32",), [
        ("      softmax_step(s, m, l, corr, i * BKV, r0, c0, edge(i), S, causal, c);\n"
         "      C::split_p(s, p_hi, p_lo);",
         "      corr[0] = corr[1] = 1.0f;\n"
         "      for (int j = 0; j < C::KSTEPS; ++j)\n"
         "        for (int r = 0; r < 4; ++r)\n"
         "          p_hi[j][r] = p_lo[j][r] = __float_as_uint(s[4 * j + r]);")]),
    # f32: k and v^T not split: the producer stores hi = a and no lo (the
    # lo products reread stale operands)
    "f32_no_split": (("f32",), [
        ("      for (int e = 0; e < 4; ++e) split(a[e], h[e], l[e]);\n"
         "      st_shared_v4(hi + off, h);\n"
         "      st_shared_v4(lo + off, l);",
         "      for (int e = 0; e < 4; ++e) h[e] = __float_as_uint(a[e]);\n"
         "      st_shared_v4(hi + off, h);"),
        ("        for (int c = 0; c < 4; ++c) split(x[8 * a + 2 * c + odd], h[c], l[c]);\n"
         "        st_shared_v4(hi + off, h);\n"
         "        st_shared_v4(lo + off, l);",
         "        for (int c = 0; c < 4; ++c) h[c] = __float_as_uint(x[8 * a + 2 * c + odd]);\n"
         "        st_shared_v4(hi + off, h);")]),
    # f32: one p.v accumulator over all kv: o *= corr, then p.v into o on
    # the tensor cores (no fresh accumulators, no fold)
    "f32_one_acc": (("f32",), [
        ("      wgmma_tf32_rs(o_t, p_hi[kk], vh, kk > 0);",
         "      wgmma_tf32_rs(o_t, p_hi[kk], vh, 1);"),
        ("      mbar_wait(v_full(i), parity);\n      turn_wait(wg);\n"
         "      wgmma_fence();\n"
         "      C::issue_pv(o_t, p_hi, p_lo, op(i, 2), op(i, 3));",
         "      for (int x = 0; x < C::NO; ++x)\n"
         "        o[x] = __fmul_rn(o[x], corr[(x / 2) % 2]);\n"
         "      mbar_wait(v_full(i), parity);\n      turn_wait(wg);\n"
         "      wgmma_fence();\n"
         "      C::issue_pv(o, p_hi, p_lo, op(i, 2), op(i, 3));"),
        ("      reg_fence(o_t);\n", "      reg_fence(o);\n"),
        ("      C::fold(o, corr, o_t);\n", "")]),
    # f32: q.k into one accumulator over all of hd (no 32-deep chunks)
    "f32_qk_one_acc": (("f32",), [
        ("      wgmma_tf32_ss(sc[kk / 4], qh, kh, kk % 4 > 0);\n"
         "      wgmma_tf32_ss(sc[kk / 4], qh, kl, 1);\n"
         "      wgmma_tf32_ss(sc[kk / 4], ql, kh, 1);",
         "      wgmma_tf32_ss(sc[0], qh, kh, kk > 0);\n"
         "      wgmma_tf32_ss(sc[0], qh, kl, 1);\n"
         "      wgmma_tf32_ss(sc[0], ql, kh, 1);"),
        ("      C::sum_chunks(sc);\n", "")]),
    # f32: the consumer warpgroups issue their products without taking
    # turns
    "f32_no_turns": (("f32",), [
        ('  asm volatile("bar.sync %0, 256;" :: "r"(1 + wg) : "memory");', ""),
        ('  asm volatile("bar.arrive %0, 256;" :: "r"(2 - wg) : "memory");',
         "")]),
    # f32: one tf32 product each for q.k and p.v (hi.hi only)
    "f32_1xtf32": (("f32",), [
        ("      wgmma_tf32_ss(sc[kk / 4], qh, kl, 1);\n"
         "      wgmma_tf32_ss(sc[kk / 4], ql, kh, 1);\n", ""),
        ("      wgmma_tf32_rs(o_t, p_hi[kk], vl, 1);\n"
         "      wgmma_tf32_rs(o_t, p_lo[kk], vh, 1);\n", "")]),
}
SHAPES = {"bf16": [(4, 2048, 16, 16, 64, True), (4, 2048, 16, 16, 64, False),
                   (1, 1024, 56, 8, 128, True)],
          "f32": [(4, 2048, 16, 16, 64, True), (1, 1024, 56, 8, 128, True),
                  (2, 1024, 8, 8, 128, False)]}


def build_variants(names, source: str, baseline=None) -> dict:
    """{name: loaded library}, one nvcc per variant (and for the baseline
    source, if given), all started at once."""
    from repro_torch.kernels import build
    out_dir = build.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name in names:
        text = source
        for old, new in VARIANTS[name][1]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: its text is not in the "
                                 "source exactly once")
            text = text.replace(old, new)
        texts[name] = text
    if baseline is not None:
        texts["baseline"] = Path(baseline).read_text()
    jobs = {}
    for name, text in texts.items():
        cu = out_dir / f"flash_attention_{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libflash_attention_{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line})
        print(json.dumps({"variant": name, "ptxas_spills": spills}),
              flush=True)
        libs[name] = ctypes.CDLL(str(lib))
        build._declare("flash_attention", libs[name])
    return libs


def error(got, q, k, v, causal) -> float:
    """bf16: the largest element ratio to the allowance; f32: the relative
    error to the plain version."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    if q.dtype == torch.float32:
        want = fa.flash_attention_plain(q, k, v, causal)
        return float((got - want).abs().max() / want.abs().max())
    want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal)
    allowed = 2.0 ** -8 * want32.abs() + 1e-5 * want32.abs().max()
    return float(((got.float() - want32).abs() / allowed).max())


def time_builds(libs):
    import torch
    import torch.nn.functional as F
    from chip_smoke import device_ms, time_ms, traced_ms
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    for dt, shapes in SHAPES.items():
        mine = {name: lib for name, lib in libs.items()
                if name in ("kernel", "baseline") or dt in VARIANTS[name][0]}
        for B, S, H, KV, hd, causal in shapes:
            q, k, v = (torch.randn(B, S, n, hd, device=dev, generator=gen)
                       .to(dtypes[dt]) for n in (H, KV, KV))

            def kernel():
                return fa.flash_attention(q, k, v, causal)

            def sdpa():
                return F.scaled_dot_product_attention(
                    q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    is_causal=causal, enable_gqa=KV != H)
            row = {}
            for name, lib in mine.items():
                build._LOADED["flash_attention"] = lib
                got = kernel()
                torch.cuda.synchronize()
                row[name] = {"error": error(got, q, k, v, causal), "ms": [],
                             "device_ms": [], "traced_ms": []}
            for _ in range(2):
                for name, lib in mine.items():
                    build._LOADED["flash_attention"] = lib
                    row[name]["ms"].append(time_ms(kernel))
                    row[name]["device_ms"].append(device_ms(kernel))
                    row[name]["traced_ms"].append(traced_ms(kernel))
            build._LOADED["flash_attention"] = libs["kernel"]
            print(json.dumps({"dtype": dt, "shape": [B, S, H, KV, hd],
                              "causal": causal, "builds": row,
                              "sdpa_ms": time_ms(sdpa),
                              "sdpa_device_ms": device_ms(sdpa),
                              "sdpa_traced_ms": traced_ms(sdpa)}),
                  flush=True)


def bf16_gap(libs):
    """The bf16 card-vs-CPU check's 3 steps with each of the kernel's
    approximations taken back in turn."""
    from chip_smoke import reduced_bf16_steps
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    h_cpu = reduced_bf16_steps("cpu")
    runs = {}
    build._LOADED["flash_attention"] = libs["kernel"]
    runs["kernel"] = reduced_bf16_steps("cuda")
    kernel_fn = ops.flash_attention

    def plain(q, k, v, causal=True):
        return fa.flash_attention_plain(q, k, v, causal)
    ops.flash_attention = plain         # the model looks it up on ops
    try:
        runs["plain_on_card"] = reduced_bf16_steps("cuda")
    finally:
        ops.flash_attention = kernel_fn
    for name in ("expf", "p_bf16"):
        build._LOADED["flash_attention"] = libs[name]
        runs[name] = reduced_bf16_steps("cuda")
    build._LOADED["flash_attention"] = libs["kernel"]
    print(json.dumps({"bf16_gap": {
        "h_cpu": h_cpu,
        "runs": {name: {"h": h, "gaps": [abs(a - b) for a, b in zip(h, h_cpu)]}
                 for name, h in runs.items()}}}), flush=True)


def main(args) -> int:
    import torch
    from chip_smoke import card_line
    from repro_torch.kernels import build

    if not torch.cuda.is_available():
        print("torch_flash_variants: no CUDA device", file=sys.stderr)
        return 2
    gap = "--bf16-gap" in args
    baseline = None
    if "--baseline" in args:
        at = args.index("--baseline")
        baseline = args[at + 1]
        args = args[:at] + args[at + 2:]
    names = [a for a in args if a != "--bf16-gap"]
    if not names:
        names = ["expf", "p_bf16"] if gap else list(VARIANTS)
    source = (build.CSRC / "flash_attention.cu").read_text()
    libs = {"kernel": build.load("flash_attention")}
    libs.update(build_variants(names, source, baseline))
    if gap:
        bf16_gap(libs)
    else:
        time_builds(libs)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
