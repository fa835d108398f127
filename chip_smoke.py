#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one card
    python3 chip_smoke.py --profile  # only: where a round's or step's time goes

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device and build: the card's name, power limit and top SM clock, TF32
   off, and the five CUDA kernels built from src/repro_torch/kernels/csrc/
   (one nvcc per source, in parallel) into build/kernels/; ptxas's
   register and spill lines, and the integer instructions of the draw
   kernel's SASS.
2. Kernels: each kernel against its plain torch version on the card, at
   the main path's shapes and larger ones, with CUDA-event times (median
   of 20 after warm-up) and the bound (the larger of bytes over the
   memory rate and operations over the rate of their pipe: f32, or for
   threefry's rotates and xors the INT32 lanes). defended_encode draws its
   noise and rounding bits from the keys in the kernel, at 2048, 2^21 and
   2^24 for every codec x mechanism (and clip only, and int8 without a
   rounding key), bitwise equal to the plain chain on the eager bits of
   the same keys; its rows also carry the profiler-traced time and the
   time of the same kernel reading pre-made bits from device memory. The
   draw kernel (bits, normal, rademacher) is bitwise equal to the eager
   chain at 2048, 12 544, 2^24 and qwen1.5-0.5b's embedding (155 582 464),
   and on a counter range across 2^32. zo_update is bitwise; dual_matmul
   (f32 and bf16, ragged shapes too, and the batch-2048 and batch-64
   shapes the driven paths give it) within
   a stated relative tolerance, plus exact checks: its perturbed product is
   bitwise its plain product at the weights that the zo_update kernel, and
   the unfused uniform and gaussian perturbations, form. It runs as
   3xTF32 on the tensor cores (``wgmma``; ``HGMMA`` in its SASS). Besides
   the single-call time: its device time and that of the two
   ``torch.matmul`` calls that are its yardstick (20 calls queued between
   two events, over 20; and the kernels' own durations in a
   ``torch.profiler`` trace of 20 calls, over 20), and two bounds, the
   CUDA-core one (4MKN at the f32 rate) and the tensor-core one its line
   reports (3 x 4MKN at the TF32 rate, or the bytes). flash_attention
   (causal at the vfl-zoo shape in bf16 and f32, yi-34b's GQA heads, a
   ragged S, full attention) within a stated relative tolerance, and in
   bf16 element by element within half a bf16 ulp of the plain version's
   f32 result. Both its kernels run on the tensor cores, which the build
   checks in each kernel's own SASS functions (counted with
   ``cuobjdump``): the bf16 one on ``wgmma`` and TMA (``HGMMA`` and
   ``UTMALDG``), the f32 one as 3xTF32 on ``wgmma`` (``HGMMA``). Its bf16
   bound takes both products at the tensor-core rate; its f32 rows carry
   two, both products at the f32 rate of the CUDA cores and, as the line's
   bound, three tf32 products each at the TF32 rate. Its library time is
   PyTorch's scaled_dot_product_attention, which the port never calls; at
   the vfl-zoo and yi-34b shapes the rows also carry both device times
   (profiler-traced), and the f32 kernel must take less than SDPA at the
   vfl-zoo shape.
3. Main path: the defended AsyREVEL party round (Algorithm 1,
   ``HostAsyncTrainer.run_serial``) on the paper FCN at D7 width: 8 parties
   x 98 features, towers 98->128->1, server 8->10, n = 60000, batch 2048,
   fused int8 + gaussian DP + rademacher, 10 rounds of 8 party updates.
   Launch counters are zeroed just before it and read just after, and
   every count is exact: per fused party round 2 defended_encode, 6
   zo_update, 1 dual_matmul and 6 draws (one per perturbed leaf: 4 of the
   party's, 2 of the server's), plus one draw per initial weight; per
   unfused round 1 dual_matmul and 10 draws (the 6 directions, and the
   noise and rounding bits of c and c_hat); losses must be finite, wire
   bytes exact, and the unfused run bitwise equal. Then the same port on
   the card against the port on the CPU on a small problem, and an
   undefended D7 training run (scale 0.01, 1200 updates) whose loss must
   fall.
4. vfl-zoo: ``python -m repro_torch.launch.train --arch qwen1.5-0.5b --mode
   vfl-zoo --parties 4 --batch-size 4 --seq-len 2048 --steps 5 --fused
   --codec int8`` through ``launch.train.main``, at full width and all 24
   layers (random weights from the seed). Counters zeroed just before it
   and read just after: exactly 72 flash_attention, 5 defended_encode and
   17 draws (the gaussian directions) per step, 181 draws of the initial
   weights, and none of the other two; every h finite, the first
   within 1.0 of ln(vocab). Seconds per step, peak memory, then the time
   split of 2 more steps (direction draws, server forwards, party towers,
   up-link, rest), then a reduced run on the card against the CPU (3
   steps, h within 1e-3 in f32; in bf16 the first h within 2e-3 and the
   rest within 5e-2).
5. Async: the paper's Section 5.1 experiment (examples/federated_fcn_mnist.py)
   on the threaded executors: D7 at scale 0.01, q = 8, batch 64, uniform
   directions, 1 ms simulated compute per party round, party 3 a 1.4x
   straggler. ``run_async`` (1200 updates) and ``run_sync`` (150 rounds),
   each with the counters zeroed just before it and read just after:
   exactly 1200 updates, 1200 dual_matmul and 6 x 1200 draw launches each
   (the directions of 4 party and 2 server leaves an update), falling loss,
   exact wire bytes; both wall-clock times and their ratio.
6. Scan: the device-scan trainer (``asyrevel.train``) on the defended
   paper FCN at D7 width (n = 60000, batch 2048, fused int8 + gaussian DP
   calibrated by the port's accountant to epsilon 8, delta 1e-5, clip 1
   for each run's steps and directions; rademacher, mu 5e-2): asyrevel
   for 50 steps at K = 1 and K = 4, synrevel for 10 steps, each fused and
   unfused with the counters zeroed just before it and read just after.
   Launches per step exact (``scan_launches``), losses finite, and the
   fused run's per-step h and final state bitwise the unfused run's. Then
   ``run_serial`` at K = 4 (10 rounds of 8): launches exact
   (``host_round_launches``), bytes exact against the analytic formula
   (up (1+K)(B + 4), down (1+K) 4 a round), fused bitwise unfused. Then
   the card against the CPU (D7 at scale 0.01, batch 64, 20 asyrevel
   steps at K = 2, fused f32 + DP: losses within 1e-3) and
   examples/quickstart_torch.py on the card (4000 steps: train acc > 0.8).
7. The ``{"kernels": [...]}`` line, the card line, and last
   ``{"ok": true, "device": {...}}``.

``--profile`` runs none of that: it builds the kernels, warms up, and
traces 2 serial rounds (16 party updates) of each D7 cell, the defended
round and the async experiment's configuration, 4 steps of the scan
trainer's defended D7 cell (asyrevel, K = 1), and one step of the
vfl-zoo cell, with ``torch.profiler``,
printing the device-busy share, the kernels by device time, the
flash_attention kernels' device time and launches, and what the draws
cost in that trace: each ``prng.bits`` and ``prng.sample_direction``
call is a ``record_function`` span, counted, with its host time and the
device launches the profiler ties to it (torch's own: it ties a launch
made through ctypes to no span); the port's kernels are counted by the
names of their functions, so the draw kernel's launches stand beside the
spans' calls (one each; a uniform direction adds its norm's launches).

It imports nothing of jax or of the reference package ``repro``.
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

HBM_BYTES_PER_S = 3.35e12       # H100 SXM device memory
F32_FLOPS_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
TF32_TC_FLOPS_PER_S = 495e12    # H100 SXM dense TF32 tensor cores
# INT32 lanes per SM and clock (Hopper: 16 in each of its 4 partitions); the
# rate is that times the SMs times the top SM clock nvidia-smi reports
INT32_LANES_PER_SM = 64
# threefry2x32 integer operations per 32-bit word that only the INT32 pipe
# runs: 20 rotates (one funnel shift each) and 21 xors (prng.cuh). Its 32
# adds the compiler issues partly as IMAD on the FMA pipe, so the least
# time of the integer work is max(41 / 64, 73 / 128) SM clocks a word: the
# INT32 pipe's 41 (the SASS of the bits draw kernel holds 100 SHF and 107
# LOP3 for its 5 words, 4 in the loop and 1 in the tail)
INT32_OPS_PER_WORD = 41
# f32 operations per element of defended_encode, counted from the kernel's
# source: the gaussian chain (uniform, open interval, log1p or log,
# erf_inv's Horner, two products, the add) is ~64, Laplace's ~48; clip 2;
# the int8 quantize (divide, add, floor, clamp) 6.
OPS_NOISE = {"gaussian": 64, "laplace": 48}


def log(msg):
    print(msg, flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def int32_ops_per_s(sms: int) -> float:
    """The card's INT32 rate: 64 lanes an SM a clock, at its top SM clock
    (``clocks.max.sm``)."""
    mhz = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    return INT32_LANES_PER_SM * sms * float(mhz) * 1e6


def ops_bound(nbytes, int_ops, f32_ops, int_rate):
    """(bound ms, what bounds it, and each of the three times in ms): bytes
    at the memory rate, INT32-pipe operations at the INT32 rate and f32
    operations at the f32 rate; the pipes run side by side, so the least
    time is the largest of the three."""
    times = {"bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
             "int32_ms": int_ops / int_rate * 1e3,
             "f32_ms": f32_ops / F32_FLOPS_PER_S * 1e3}
    top = max(times, key=times.get)
    return times[top], "bytes" if top == "bytes_ms" else "operations", times


# (library, kernel, SASS instructions each of its functions must hold):
# HGMMA (wgmma) and UTMALDG (TMA loads) in the bf16 flash_attention kernel,
# HGMMA in the f32 one (3xTF32, no TMA) and in dual_matmul's
TENSOR_CORE_SASS = (
    ("flash_attention", "flash_attention_bf16_kernel", ("HGMMA", "UTMALDG")),
    ("flash_attention", "flash_attention_f32_kernel", ("HGMMA",)),
    ("dual_matmul", "dual_matmul_kernel", ("HGMMA",)))


def sass_functions(name) -> dict:
    """{function: its SASS} of the built library of kernel ``name``, as
    ``cuobjdump -sass`` prints it."""
    from repro_torch.kernels import build
    cuobjdump = Path(build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(build._target(name))],
                          capture_output=True, text=True, check=True).stdout
    return {chunk.split("\n", 1)[0].strip(): chunk
            for chunk in sass.split("Function : ")[1:]}


def draw_sass():
    """The integer instructions of each draw-kernel instance's SASS (the
    bits instance holds 5 words: 4 in its loop, 1 in its tail)."""
    for fn, text in sass_functions("prng_draw").items():
        counts = {op: text.count(f" {op}") for op in
                  ("SHF.", "LOP3.", "IADD3", "IMAD", "FFMA")}
        log(f"[sass prng_draw] {fn} {counts}")


def tensor_core_route():
    """Each tensor-core kernel's own SASS functions (one per template
    instance) hold the Hopper instructions of its route."""
    for lib, kernel, ops in TENSOR_CORE_SASS:
        funcs = {fn: text for fn, text in sass_functions(lib).items()
                 if kernel in fn}
        if not funcs:
            raise AssertionError(f"{lib}'s SASS has no {kernel}")
        for fn, text in funcs.items():
            counts = {op: text.count(op) for op in ops}
            log(f"[sass {kernel}] {fn} {counts}")
            if not all(counts.values()):
                raise AssertionError(f"{fn}'s SASS lacks the tensor-core "
                                     f"route: {counts}")


def time_ms(fn, reps=20, warmup=3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e))
    return statistics.median(out)


def device_ms(fn, n=20) -> float:
    """n calls queued back to back between two events, over n: the
    device's time per call, with the wrapper's host time hidden under the
    device's (one call between two events holds 30-50 us of it)."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(n):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / n


def traced_ms(fn, n=20, tries=5) -> float:
    """The device time of fn's kernels per call, from ``torch.profiler``'s
    trace of n calls: the sum of their durations over n, whatever the host
    time between them (for a kernel of a few us the queued calls of
    ``device_ms`` wait on the host). fn launches the same kernels on every
    call, so a trace whose kernel count is not a multiple of n lost events
    (seen on the card: none, or about half) and is taken again."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for attempt in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        launches = sum(e.count for e in events)
        if launches and launches % n == 0:
            break
        log(f"[traced_ms] {launches} kernels in a trace of {n} calls; "
            f"tracing again ({attempt + 1} of {tries})")
    else:
        raise AssertionError(f"no complete trace of {n} calls in {tries}")
    return sum(e.self_device_time_total for e in events) / 1e3 / n


def bitwise_equal(a, b) -> bool:
    import torch
    if isinstance(a, tuple):
        return all(bitwise_equal(x, y) for x, y in zip(a, b))
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ia = a.view(torch.int16) if a.element_size() == 2 else (
        a.view(torch.int32) if a.element_size() == 4 else a)
    ib = b.view(torch.int16) if b.element_size() == 2 else (
        b.view(torch.int32) if b.element_size() == 4 else b)
    return bool(torch.equal(ia, ib))


def max_abs(a, b) -> float:
    if isinstance(a, tuple):
        return max(max_abs(x, y) for x, y in zip(a, b))
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------------ kernel phase --

# defended_encode's sizes: D7's payload, the vfl-zoo payload (4 x 2048 x
# 256, kept on chip by the int8 kernel) and 2^24 (past what it keeps: the
# second sweep)
ENCODE_SIZES = (2048, 1 << 21, 1 << 24)
# (dp mechanism, noise multiplier): none, gaussian, laplace, clip only
DEFENSES = ((None, None), ("gaussian", 1.3), ("laplace", 1.3),
            ("gaussian", 0.0))


def plain_encode_keyed(c, dk, rk, dp, codec):
    """defended_encode's plain chain on the eager bits of the same keys."""
    from repro_torch.kernels import fused_round
    from repro_torch.utils import prng
    dpb = None if dk is None else prng.bits_plain(dk, c.shape, c.device)
    rnb = None if rk is None else prng.bits_plain(rk, c.shape, c.device)
    return fused_round._encode_math(fused_round._defend_math(c, dpb, dp),
                                    rnb, codec)


def kernel_phase(dev, int_rate):
    import torch
    from repro_torch.configs import DPConfig
    from repro_torch.kernels import fused_round, zo_update
    from repro_torch.utils import prng

    gen = torch.Generator(device=dev).manual_seed(0)
    worst = {"defended_encode": 0.0, "zo_update": 0.0}
    timed = {}

    for n in ENCODE_SIZES:
        c = 2.0 * torch.randn(n, device=dev, generator=gen)
        plain_reps = 20 if n <= 2048 else 5
        for codec in ("f32", "bf16", "int8"):
            for mech, sigma in DEFENSES:
                dp = None if mech is None else DPConfig(
                    noise_multiplier=sigma, clip=1.0, mechanism=mech)
                noise = dp is not None and sigma != 0.0
                dk = (7, n) if noise else None
                rk = (9, n) if codec == "int8" else None

                def kernel():
                    return fused_round.defended_encode_keyed(c, dk, rk, dp,
                                                             codec)
                got = kernel()
                want = plain_encode_keyed(c, dk, rk, dp, codec)
                torch.cuda.synchronize()
                where = (f"n={n} codec={codec} dp={mech} "
                         f"sigma={sigma}")
                if not bitwise_equal(got, want):
                    raise AssertionError(
                        f"defended_encode from keys != plain at {where}: "
                        f"max |diff| {max_abs(got, want)}")
                worst["defended_encode"] = max(worst["defended_encode"],
                                               max_abs(got, want))
                # the same kernel reading the two streams from device memory
                dpb = None if dk is None else prng.bits(dk, c.shape, dev)
                rnb = None if rk is None else prng.bits(rk, c.shape, dev)

                def from_bits():
                    return fused_round.defended_encode(c, dpb, rnb, dp, codec)
                if not bitwise_equal(from_bits(), got):
                    raise AssertionError(
                        f"defended_encode from bits != from keys at {where}")
                streams = int(dk is not None) + int(rk is not None)
                nbytes = 4 * n + {"f32": 4 * n, "bf16": 2 * n,
                                  "int8": n + 4}[codec]
                f32_ops = n * ((OPS_NOISE[mech] if noise else 0)
                               + (2 if dp else 0)
                               + (6 if codec == "int8" else 0))
                bound, by, parts = ops_bound(
                    nbytes, INT32_OPS_PER_WORD * streams * n, f32_ops,
                    int_rate)
                row = {"kernel": "defended_encode", "n": n, "codec": codec,
                       "dp": mech, "sigma": sigma, "from": "keys",
                       "bitwise": True, "kernel_ms": time_ms(kernel),
                       "kernel_traced_ms": traced_ms(kernel),
                       "plain_ms": time_ms(
                           lambda: plain_encode_keyed(c, dk, rk, dp, codec),
                           reps=plain_reps),
                       "bound_ms": bound, "bound_by": by, **parts}
                if (n, codec, mech, noise) == (1 << 24, "int8", "gaussian",
                                               True):
                    # the bits-operand launch is timed at one case only
                    # (benchmarks/torch_encode_variants.py times it at
                    # every size)
                    row["bits_from_memory_ms"] = time_ms(from_bits)
                    row["bits_from_memory_traced_ms"] = traced_ms(from_bits)
                log(json.dumps(row))
                if n == 2048 and codec == "int8" and mech == "gaussian" \
                        and noise:
                    timed["defended_encode"] = row
            if codec == "int8":
                # the undefended int8 path without a rounding key
                # (round-to-even)
                got = fused_round.defended_encode_keyed(c, None, None, None,
                                                        "int8")
                if not bitwise_equal(got, plain_encode_keyed(
                        c, None, None, None, "int8")):
                    raise AssertionError(
                        f"defended_encode int8 without key at n={n}")

    for n in (12544, 128, 1, 80, 10, 1 << 24):
        w = torch.randn(n, device=dev, generator=gen)
        b = prng.bits((3, n), (n,), dev)
        for scale in (-5e-2, 3.7e-4):
            got = zo_update.zo_update(w, b, scale)
            want = zo_update.zo_update_plain(w, b, scale)
            torch.cuda.synchronize()
            if not bitwise_equal(got, want):
                raise AssertionError(f"zo_update != plain at N={n}")
            worst["zo_update"] = max(worst["zo_update"], max_abs(got, want))
        def kernel():
            return zo_update.zo_update(w, b, -5e-2)
        kern = time_ms(kernel)
        plain = time_ms(lambda: zo_update.zo_update_plain(w, b, -5e-2))
        bound = max(12 * n / HBM_BYTES_PER_S,
                    2 * n / F32_FLOPS_PER_S) * 1e3
        row = {"kernel": "zo_update", "n": n, "bitwise": True,
               "kernel_ms": kern, "kernel_traced_ms": traced_ms(kernel),
               "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes"}
        log(json.dumps(row))
        if n == 12544:
            timed["zo_update"] = row
    return timed, worst


# the draw kernel's sizes: every size the driven paths draw, and 2^24.
# D7 (fused, unfused, async): the party's b2 (1), the server's b (10) and
# w (8 x 10), the party's b1 and w2 (128), the up-link's c (2048) and
# the party's w1 (98 x 128). vfl-zoo on qwen1.5-0.5b with 4 parties: the
# final norm (1024), the stacked norms and biases (24 x 1024), a party's
# w1 and w2 (256 x 128), one layer's 1024 x 1024 and 1024 x 2816 at
# init, their stacks (24 x 1024 x 1024, 24 x 1024 x 2816), a party's
# embedding slice (151936 x 256) and the server's embedding (151936 x
# 1024). The small defended FCN held against the CPU adds 16, 20 and
# 256. Then ranges across counter 2^32: (n, offset)
DRAW_SIZES = (1, 10, 16, 20, 80, 128, 256, 1024, 2048, 12544, 24576, 32768,
              1 << 20, 2883584, 1 << 24, 25165824, 38895616, 69206016,
              155582464)
DRAW_RANGES = ((5003, (1 << 32) - 1000), (1 << 24, (1 << 32) - (1 << 23)))


def draw_phase(dev, int_rate):
    """The draw kernel against the eager chain (bitwise), with its times
    and bound: 4 bytes written and 41 INT32-pipe operations a word, and the
    normal chain's f32 operations."""
    import torch
    from repro_torch.kernels import prng_draw
    from repro_torch.utils import prng

    timed, worst = None, 0.0
    cases = list(DRAW_RANGES) + [(n, 0) for n in DRAW_SIZES]
    for n, offset in cases:
        k = (0x5EED, n)
        for mode in prng_draw.MODES:
            def kernel():
                return prng_draw.draw(k, (n,), mode, dev, offset)

            def plain():
                return prng.draw_plain(k, (n,), mode, dev, offset)
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if not bitwise_equal(got, want):
                raise AssertionError(
                    f"prng_draw != the eager chain: {mode} n={n} "
                    f"offset={offset}: {int((got != want).sum())} differ")
            worst = max(worst, max_abs(got, want))
            del got, want
            f32_ops = n * {"bits": 0, "normal": OPS_NOISE["gaussian"],
                           "rademacher": 1}[mode]
            bound, by, parts = ops_bound(4 * n, INT32_OPS_PER_WORD * n,
                                         f32_ops, int_rate)
            big = n >= 1 << 24
            row = {"kernel": "prng_draw", "n": n, "offset": offset,
                   "mode": mode, "bitwise": True, "kernel_ms": time_ms(kernel),
                   "kernel_traced_ms": traced_ms(kernel),
                   "plain_ms": time_ms(plain, reps=3 if big else 20,
                                       warmup=1 if big else 3),
                   "bound_ms": bound, "bound_by": by, **parts}
            log(json.dumps(row))
            if (n, offset, mode) == (12544, 0, "bits"):
                timed = row
            torch.cuda.empty_cache()
    return timed, worst


# f32 at D7 (the main path), the reference bench's shape, a large square and
# a ragged one; bf16 at two
# the main phase's shape (batch 2048), the async and training phases'
# (batch 64), the reference bench's, a large square one and a ragged one
DUAL_CASES = [((2048, 98, 128), "f32"), ((64, 98, 128), "f32"),
              ((256, 1024, 512), "f32"),
              ((4096, 4096, 4096), "f32"), ((1000, 98, 130), "f32"),
              ((2048, 98, 128), "bf16"), ((256, 1024, 512), "bf16")]
# max |kernel - plain| / max |plain|. f32: the same f32 products summed in
# another order than cuBLAS's, a few ulps of the largest output; bf16: the
# outputs are rounded to 8 mantissa bits, so the two may sit one bf16
# rounding apart (the reference's bf16 tolerance).
DUAL_TOL = {"f32": 1e-5, "bf16": 2e-2}


def dual_matmul_phase(dev):
    import numpy as np
    import torch
    from repro_torch.kernels import dual_matmul, ops, zo_update
    from repro_torch.utils import prng

    gen = torch.Generator(device=dev).manual_seed(1)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    mu = 1e-3
    worst, timed = 0.0, None
    for (M, K, N), dt in DUAL_CASES:
        x = torch.randn(M, K, device=dev, generator=gen).to(dtypes[dt])
        w = torch.randn(K, N, device=dev, generator=gen).to(dtypes[dt])
        u = torch.randn(K, N, device=dev, generator=gen)
        got = ops.dual_matmul(x, w, u, mu)
        want = dual_matmul.dual_matmul_plain(x, w, u, mu)
        torch.cuda.synchronize()
        err = max_abs(got, want)
        rel = err / max(float(want[0].float().abs().max()),
                        float(want[1].float().abs().max()))
        if not rel <= DUAL_TOL[dt]:
            raise AssertionError(f"dual_matmul != plain at {(M, K, N)} {dt}: "
                                 f"relative error {rel} > {DUAL_TOL[dt]}")
        worst = max(worst, err)

        def kernel():
            return ops.dual_matmul(x, w, u, mu)

        def library():
            # the yardstick: torch.matmul(x, w) and torch.matmul(x, w +
            # mu*u), the latter in f32 (w + mu*u is f32; .float() of f32 is
            # x itself)
            return (torch.matmul(x, w),
                    torch.matmul(x.float(), w.float() + mu * u))

        kern = time_ms(kernel)
        plain = time_ms(lambda: dual_matmul.dual_matmul_plain(x, w, u, mu))
        lib = time_ms(library)
        kern_dev, lib_dev = device_ms(kernel), device_ms(library)
        kern_traced, lib_traced = traced_ms(kernel), traced_ms(library)
        esize = x.element_size()
        nbytes = (M * K + K * N) * esize + K * N * 4 + 2 * M * N * esize
        # both products are f32 arithmetic (w + mu*u is f32 whatever the
        # input type): a multiply and an add per term, two products. On
        # the CUDA cores that is 4MKN at the f32 rate; the kernel runs it as
        # 3xTF32 (bf16: 1 + 2 tf32 products), 3 x 4MKN at the TF32 rate
        n_ops = 4 * M * K * N
        n_tc = (3 if dt == "f32" else 1.5) * n_ops
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops, t_tc = n_ops / F32_FLOPS_PER_S, n_tc / TF32_TC_FLOPS_PER_S
        row = {"kernel": "dual_matmul", "shape": [M, K, N], "dtype": dt,
               "max_abs_err": err, "rel_err": rel, "tol": DUAL_TOL[dt],
               "kernel_ms": kern, "plain_ms": plain, "library_ms": lib,
               "kernel_device_ms": kern_dev, "library_device_ms": lib_dev,
               "kernel_traced_ms": kern_traced,
               "library_traced_ms": lib_traced,
               "cuda_core_bound_ms": max(t_bytes, t_ops) * 1e3,
               "cuda_core_bound_by":
                   "bytes" if t_bytes >= t_ops else "operations",
               "bound_ms": max(t_bytes, t_tc) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_tc else "operations",
               "kernel_tflops": n_ops / (kern_traced * 1e-3) / 1e12}
        log(json.dumps(row))
        if (M, K, N) == (2048, 98, 128) and dt == "f32":
            timed = row
            # exact: the perturbed product is the plain product at the
            # weights the zo_update kernel perturbs
            b = prng.bits((5, 6), w.shape, dev)
            w_p = zo_update.zo_update(w, b, -float(np.float32(mu)))
            _, y1 = ops.dual_matmul(x, w, prng.rademacher_from_bits(b), mu)
            y0_p, _ = ops.dual_matmul(x, w_p, torch.zeros_like(w), mu)
            torch.cuda.synchronize()
            if not bitwise_equal(y1, y0_p):
                raise AssertionError("dual_matmul y1(w, u) != y0(w + mu*u)")
            log("[dual_matmul] y1 at (w, u) bitwise y0 at the zo_update-"
                "perturbed weights")
        if (M, K, N) == (64, 98, 128) and dt == "f32":
            # the unfused exchange's perturbation (the async phase's
            # uniform directions, and gaussian): the kernel's own w + mu*u
            # is bitwise the w_p the party's regularizer and update see
            for direction in ("uniform", "gaussian"):
                unfused_pair_is_exact(x, w, direction, mu)
    return timed, worst


# (B, S, H, KV, hd, dtype, causal): the vfl-zoo path's shape (qwen1.5-0.5b
# at batch 4, sequence 2048) in both types, yi-34b's GQA heads, a ragged S
# and full (non-causal) attention
FLASH_CASES = [(4, 2048, 16, 16, 64, "bf16", True),
               (4, 2048, 16, 16, 64, "f32", True),
               (1, 1024, 56, 8, 128, "bf16", True),
               (1, 1024, 56, 8, 128, "f32", True),
               (2, 1000, 8, 4, 64, "f32", True),
               (2, 1000, 8, 4, 64, "bf16", True),
               (2, 1024, 8, 8, 128, "f32", False),
               (2, 1024, 8, 2, 64, "bf16", False)]
# f32: max |kernel - plain| / max |plain| <= 1e-5, the same f32 terms
# summed in another order (online softmax over 64-wide tiles against one
# softmax over the row), a few ulps of the largest output. bf16, element by
# element: the kernel rounds its f32 result to bf16 once, so each output
# lies within half a bf16 ulp (2^-8 of its size) of the plain version's f32
# result before the cast, plus the f32 bound for the order of the sums:
# |got - want32| <= 2^-8 |want32| + 1e-5 max|want32|. Also the max-
# normalised 2e-2 against the plain version's bf16 output.
FLASH_TOL = {"f32": 1e-5, "bf16": 2e-2}
BF16_HALF_ULP = 2.0 ** -8
BF16_TC_FLOPS_PER_S = 989e12    # H100 SXM dense bf16 tensor cores


def flash_errors(got, q, k, v, causal):
    """(max |got - plain|, that over max |plain|, and for bf16 the largest
    |got - want32| / (2^-8 |want32| + 1e-5 max |want32|), which must be at
    most 1; None for f32)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    want = fa.flash_attention_plain(q, k, v, causal)
    err = max_abs(got, want)
    rel = err / float(want.float().abs().max())
    if q.dtype == torch.float32:
        return err, rel, None
    want32 = fa.flash_attention_plain(q.float(), k.float(), v.float(),
                                      causal)
    allowed = BF16_HALF_ULP * want32.abs() \
        + FLASH_TOL["f32"] * float(want32.abs().max())
    return err, rel, float(((got.float() - want32).abs() / allowed).max())


def flash_bound(B, S, H, KV, hd, esize, causal):
    """(bytes time, operations time, operations, the f32 kernel's tensor-core
    time or None) for one causal or full attention: q, k, v read once and
    out written once; q.k and p.v over the pairs the mask keeps, a multiply
    and an add each. In bf16 both products count at the tensor-core rate
    (the kernel's split of p into two bf16 halves is its own cost, not the
    work's); in f32 both at the f32 rate of the CUDA cores, and beside that
    as the f32 kernel runs them, 3xTF32: three tf32 products each at the
    TF32 tensor-core rate."""
    nbytes = (2 * B * S * H * hd + 2 * B * S * KV * hd) * esize
    pairs = S * (S + 1) // 2 if causal else S * S
    n_ops = 2 * 2 * B * H * hd * pairs
    rate = BF16_TC_FLOPS_PER_S if esize == 2 else F32_FLOPS_PER_S
    t_tc = None if esize == 2 else 3 * n_ops / TF32_TC_FLOPS_PER_S
    return nbytes / HBM_BYTES_PER_S, n_ops / rate, n_ops, t_tc


# the shapes whose rows also carry device times (the profiler's kernel
# durations): the vfl-zoo path's and yi-34b's GQA heads, in both types
FLASH_TRACED = ((4, 2048, 16, 16, 64), (1, 1024, 56, 8, 128))


def flash_phase(dev):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops

    gen = torch.Generator(device=dev).manual_seed(2)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst, timed = 0.0, None
    for B, S, H, KV, hd, dt, causal in FLASH_CASES:
        q, k, v = (torch.randn(B, S, n, hd, device=dev, generator=gen)
                   .to(dtypes[dt]) for n in (H, KV, KV))
        got = ops.flash_attention(q, k, v, causal=causal)
        err, rel, elem = flash_errors(got, q, k, v, causal)
        torch.cuda.synchronize()
        where = f"{(B, S, H, KV, hd)} {dt} causal={causal}"
        if not rel <= FLASH_TOL[dt]:
            raise AssertionError(
                f"flash_attention != plain at {where}: relative error "
                f"{rel} > {FLASH_TOL[dt]}")
        if elem is not None and not elem <= 1.0:
            raise AssertionError(
                f"flash_attention != plain at {where}: an element is "
                f"{elem} x (half a bf16 ulp + 1e-5 max) from the f32 result")
        worst = max(worst, err)

        def kernel():
            return ops.flash_attention(q, k, v, causal=causal)

        def library():
            # the yardstick, never called on the path: PyTorch's fused SDPA
            return F.scaled_dot_product_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                is_causal=causal, enable_gqa=KV != H)

        kern = time_ms(kernel)
        plain = time_ms(lambda: fa.flash_attention_plain(q, k, v, causal))
        lib = time_ms(library)
        t_bytes, t_ops, n_ops, t_tc = flash_bound(B, S, H, KV, hd,
                                                  q.element_size(), causal)
        row = {"kernel": "flash_attention", "shape": [B, S, H, KV, hd],
               "dtype": dt, "causal": causal, "max_abs_err": err,
               "rel_err": rel, "tol": FLASH_TOL[dt],
               "bf16_elem_ratio": elem, "kernel_ms": kern,
               "plain_ms": plain, "library_ms": lib,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "kernel_tflops": n_ops / (kern * 1e-3) / 1e12}
        if t_tc is not None:
            # as dual_matmul's rows: the kernel's own (3xTF32) bound, the
            # CUDA cores' beside it
            row["cuda_core_bound_ms"] = row["bound_ms"]
            row["cuda_core_bound_by"] = row["bound_by"]
            row["bound_ms"] = max(t_bytes, t_tc) * 1e3
            row["bound_by"] = "bytes" if t_bytes >= t_tc else "operations"
        if (B, S, H, KV, hd) in FLASH_TRACED:
            row["kernel_traced_ms"] = traced_ms(kernel)
            row["library_traced_ms"] = traced_ms(library)
        log(json.dumps(row))
        if (B, S, H, KV, hd, dt) == (4, 2048, 16, 16, 64, "bf16"):
            timed = row
        if (B, S, H, KV, hd, dt) == (4, 2048, 16, 16, 64, "f32") and \
                not row["kernel_traced_ms"] < row["library_traced_ms"]:
            raise AssertionError(
                f"the f32 flash_attention kernel takes "
                f"{row['kernel_traced_ms']} ms of device time at the vfl-zoo "
                f"shape, SDPA {row['library_traced_ms']}")
    return timed, worst


def unfused_pair_is_exact(x, w, direction, mu):
    import torch
    from repro_torch.configs import VFLConfig
    from repro_torch.core.exchange import ZOExchange
    from repro_torch.kernels import ops
    from repro_torch.utils import prng

    ex = ZOExchange.from_config(VFLConfig(num_parties=8, direction=direction,
                                          mu=mu, fused=False))
    w_p, u = ex.perturb({"w1": w}, prng.key(7))
    _, y1 = ops.dual_matmul(x, w, u["w1"], mu)
    y0_p, _ = ops.dual_matmul(x, w_p["w1"], torch.zeros_like(w), mu)
    torch.cuda.synchronize()
    if not bitwise_equal(y1, y0_p):
        raise AssertionError(f"dual_matmul y1(w, u) != y0(w_p) for the "
                             f"unfused {direction} perturbation")
    log(f"[dual_matmul] y1 at (w, u) bitwise y0 at the unfused {direction} "
        "perturbation's w_p")


# --------------------------------------------------------- main-path phase --

def d7_config(fused: bool, dp: bool):
    from repro_torch.configs import DPConfig, VFLConfig
    return VFLConfig(num_parties=8, direction="rademacher", mu=5e-2,
                     lr_party=2e-2, lr_server=1e-2, codec="int8",
                     dp=DPConfig(noise_multiplier=1.3, clip=1.0) if dp
                     else None, fused=fused)


def main_path_phase(dev):
    import numpy as np
    import torch
    from repro_torch.configs import DPConfig, PaperFCNConfig, VFLConfig
    from repro_torch.core import comms
    from repro_torch.core.async_host import HostAsyncTrainer
    from repro_torch.core.vfl import PaperFCNModel
    from repro_torch.data.synthetic import make_paper_dataset
    from repro_torch.data.vertical import pad_party_views, vertical_partition

    q, batch, rounds = 8, 2048, 10
    t = time.perf_counter()
    Xp, y, spec, pad = d7_data(q)
    model = PaperFCNModel(PaperFCNConfig(num_features=spec.d,
                                         num_classes=spec.classes,
                                         num_parties=q))
    log(f"[main] D7 n={len(y)} d={spec.d} q={q} pad={pad} batch={batch} "
        f"data {time.perf_counter() - t:.1f}s")

    def run(fused):
        tr = HostAsyncTrainer(model, d7_config(fused, dp=True), Xp, y,
                              batch_size=batch, seed=0, compute_cost_s=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.run_serial(rounds)
        torch.cuda.synchronize()
        return tr, res, (time.perf_counter() - t0) * 1e3 / (rounds * q)

    zero_launches()
    tr_f, res_f, ms_f = run(fused=True)
    launches = read_launches()
    log(f"[main] fused: {len(res_f.history)} updates, {ms_f:.2f} ms per "
        f"party round, launches {launches}")
    want = {name: per * rounds * q for name, per in D7_FUSED_ROUND.items()}
    want["prng_draw"] += fcn_init_draws(q)
    if launches != want:
        raise AssertionError(f"fused D7 launches {launches}, want {want}")

    losses = [h for _, h in res_f.history]
    if len(losses) != rounds * q or not all(math.isfinite(h) for h in losses):
        raise AssertionError(f"bad losses {losses}")
    up, down = rounds * q * 2 * (batch + 4), rounds * q * 2 * 4
    if (res_f.bytes_up, res_f.bytes_down) != (up, down):
        raise AssertionError(f"bytes {(res_f.bytes_up, res_f.bytes_down)} "
                             f"!= {(up, down)}")
    comms.validate_channel(tr_f.channel, rounds * q, batch, codec="int8")
    comms.validate_measured(comms.RoundComms(up // (rounds * q),
                                             down // (rounds * q)),
                            batch, codec="int8")
    log(f"[main] loss {losses[0]:.4f} -> {losses[-1]:.4f}; bytes up "
        f"{res_f.bytes_up} down {res_f.bytes_down} (exact, = analytic)")

    zero_launches()
    tr_u, res_u, ms_u = run(fused=False)
    unfused = read_launches()
    want = {name: per * rounds * q for name, per in D7_UNFUSED_ROUND.items()}
    want["prng_draw"] += fcn_init_draws(q)
    if unfused != want:
        raise AssertionError(f"unfused run launches {unfused}: want {want}, "
                             "one dual_matmul and 10 draws per party round")
    if [h for _, h in res_u.history] != losses:
        raise AssertionError("fused losses != unfused losses")
    for m in range(q):
        for k in tr_f.party_w[m]:
            if not bitwise_equal(tr_f.party_w[m][k], tr_u.party_w[m][k]):
                raise AssertionError(f"party {m} {k}: fused != unfused")
    for k in tr_f.server.w0:
        if not bitwise_equal(tr_f.server.w0[k], tr_u.server.w0[k]):
            raise AssertionError(f"server {k}: fused != unfused")
    log(f"[main] unfused (eager torch arithmetic on the card, its "
        f"directions and bits from the draw kernel): {ms_u:.2f} ms per "
        "party round; losses and final params bitwise equal to fused")

    # the card against the CPU (the CPU port is held to the jax
    # reference by tests/test_torch_host.py): a small defended problem
    rng = np.random.default_rng(0)
    Xs = rng.random((256, 32)).astype(np.float32)
    ys = rng.integers(0, 10, 256).astype(np.int32)
    small = PaperFCNModel(PaperFCNConfig(num_features=32, num_parties=2,
                                         party_hidden=16))
    cfg = VFLConfig(num_parties=2, direction="rademacher", mu=5e-2,
                    lr_party=2e-2, lr_server=1e-2, codec="int8",
                    dp=DPConfig(noise_multiplier=1.3, clip=1.0), fused=True)
    h_dev = [h for _, h in HostAsyncTrainer(
        small, cfg, Xs, ys, batch_size=16, seed=0,
        compute_cost_s=0.0).run_serial(4).history]
    h_cpu = [h for _, h in HostAsyncTrainer(
        small, cfg, Xs, ys, batch_size=16, seed=0, compute_cost_s=0.0,
        device="cpu").run_serial(4).history]
    gap = max(abs(a - b) for a, b in zip(h_dev, h_cpu))
    # f32 matmul and reduction orders differ between the card and the CPU,
    # by ulps of c; should one ulp flip an int8 stochastic rounding, that
    # c moves one quantum (~0.04 with DP noise) and the loss ~3e-4. A wrong
    # key, bit or noise draw moves losses by ~1e-1.
    if not gap < 1e-3:
        raise AssertionError(f"card vs CPU losses differ by {gap}")
    log(f"[main] card vs CPU, small defended FCN, 8 updates: max loss gap "
        f"{gap:.3g}")

    # undefended training run, as examples/federated_fcn_mnist.py
    (Xu, yu), _ = make_paper_dataset("D7_MNIST", scale=0.01)
    Xu, _ = pad_party_views(vertical_partition(Xu, q)[0])
    vfl = VFLConfig(
        num_parties=q, direction="rademacher", mu=1e-3, lr_party=2e-2,
        lr_server=2e-2 / q, codec="int8", fused=True)
    tr = HostAsyncTrainer(model, vfl, Xu, yu, batch_size=64, seed=0,
                          compute_cost_s=0.0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tr.run_serial(150)
    torch.cuda.synchronize()
    ms_t = (time.perf_counter() - t0) * 1e3 / (150 * q)
    lt = [h for _, h in res.history]
    first, last = float(np.mean(lt[:50])), float(np.mean(lt[-50:]))
    log(f"[train] {len(lt)} updates, loss {first:.3f} -> {last:.3f}, "
        f"{ms_t:.2f} ms per party round, bytes up {res.bytes_up} down "
        f"{res.bytes_down}")
    if not last < first:
        raise AssertionError("undefended training loss did not fall")
    return launches, {"fused_ms_per_round": ms_f,
                      "unfused_ms_per_round": ms_u,
                      "fused_launches": launches, "unfused_launches": unfused,
                      "train_ms_per_round": ms_t,
                      "train_loss_first50": first,
                      "train_loss_last50": last}


# launches per D7 FCN party round. Fused: c and c_hat encoded from their
# keys; a draw and a zo_update for each perturbed leaf (the party's w1, b1,
# w2, b2 and the server's w, b); the two tower evaluations in one
# dual_matmul. Unfused: the dual_matmul, the 6 directions, and for c and
# c_hat the DP noise bits and the int8 rounding bits.
D7_FUSED_ROUND = {"defended_encode": 2, "zo_update": 6, "dual_matmul": 1,
                  "flash_attention": 0, "prng_draw": 6}
D7_UNFUSED_ROUND = {"defended_encode": 0, "zo_update": 0, "dual_matmul": 1,
                    "flash_attention": 0, "prng_draw": 10}
# directions per update of the async experiment (uniform: the gaussian
# draw, then its norm): the party's 4 leaves and the server's 2
ASYNC_DRAWS_PER_UPDATE = 6


def fcn_init_draws(q):
    """Draws of a paper FCN trainer's initial weights: each party's w1 and
    w2, and the server's w."""
    return 2 * q + 1


def _counters():
    from repro_torch.kernels import fused_round, ops, prng_draw, zo_update
    return {"defended_encode": fused_round.defended_encode,
            "zo_update": zo_update.zo_update,
            "dual_matmul": ops.dual_matmul,
            "flash_attention": ops.flash_attention,
            "prng_draw": prng_draw.draw}


def zero_launches():
    for fn in _counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _counters().items()}


# ------------------------------------------------------------- async phase --

def async_phase(dev):
    """examples/federated_fcn_mnist.py on the card, through both threaded
    executors."""
    import numpy as np
    import torch
    from repro_torch.configs import PaperFCNConfig, VFLConfig
    from repro_torch.core import comms
    from repro_torch.core.async_host import HostAsyncTrainer
    from repro_torch.core.vfl import PaperFCNModel
    from repro_torch.data.synthetic import make_paper_dataset
    from repro_torch.data.vertical import pad_party_views, vertical_partition

    q, batch, updates = 8, 64, 1200
    (X, y), spec = make_paper_dataset("D7_MNIST", scale=0.01)
    Xp, _ = pad_party_views(vertical_partition(X, q)[0])
    model = PaperFCNModel(PaperFCNConfig(num_features=spec.d,
                                         num_classes=spec.classes,
                                         num_parties=q))
    vfl = VFLConfig(num_parties=q, direction="uniform", mu=1e-3,
                    lr_party=2e-2, lr_server=2e-2 / q)
    stats = {}
    for name in ("async", "sync"):
        tr = HostAsyncTrainer(model, vfl, Xp, y, batch_size=batch,
                              compute_cost_s=1e-3, straggler={3: 1.4})
        zero_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = (tr.run_async(total_updates=updates) if name == "async"
               else tr.run_sync(rounds=updates // q))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        losses = [h for _, h in res.history]
        first, last = float(np.mean(losses[:50])), float(np.mean(losses[-50:]))
        log(f"[async] run_{name}: {res.updates} updates in {wall:.3f} s "
            f"({res.updates / wall:.1f}/s), loss {first:.3f} -> {last:.3f}, "
            f"bytes up {res.bytes_up} down {res.bytes_down}, launches "
            f"{launches}")
        if res.updates != updates or len(losses) != updates:
            raise AssertionError(f"run_{name}: {res.updates} updates")
        if not all(math.isfinite(h) for h in losses) or not last < first:
            raise AssertionError(f"run_{name}: loss did not fall")
        if (res.bytes_up, res.bytes_down) != (updates * 2 * batch * 4,
                                              updates * 8):
            raise AssertionError(f"run_{name}: bytes {res.bytes_up}, "
                                 f"{res.bytes_down}")
        comms.validate_channel(tr.channel, updates, batch)
        want = {"defended_encode": 0, "zo_update": 0, "dual_matmul": updates,
                "flash_attention": 0,
                "prng_draw": ASYNC_DRAWS_PER_UPDATE * updates}
        if launches != want:
            raise AssertionError(f"run_{name}: launches {launches}, want "
                                 f"{want}")
        stats[name] = {"wall_s": wall, "updates_per_s": res.updates / wall,
                       "loss_first50": first, "loss_last50": last,
                       "launches": launches}
    stats["async_over_sync_wall"] = (stats["async"]["wall_s"]
                                     / stats["sync"]["wall_s"])
    log(f"[async] wall-clock async/sync = "
        f"{stats['async_over_sync_wall']:.4f}")
    return stats


# --------------------------------------------------------------- scan phase --

# the scan runs: (algorithm, directions K, steps)
SCAN_RUNS = (("asyrevel", 1, 50), ("asyrevel", 4, 50), ("synrevel", 1, 10))
# the paper FCN's perturbed leaves: a party's w1, b1, w2, b2; the server's
# w, b
PARTY_LEAVES, SERVER_LEAVES = 4, 2


def scan_launches(algorithm, K, fused, q):
    """Launches of one scan-trainer step on the defended paper FCN (int8
    + gaussian DP, rademacher directions). P parties perturb (asyrevel 1,
    synrevel q), K directions each. Fused: the q stale c's and the P·K
    c_hat's are one defended_encode each (bits from the keys); each
    perturbed leaf is a draw of its bits and a zo_update. Unfused: each of
    those q + P·K releases draws its noise and its rounding bits, and each
    perturbed leaf its direction. Both draw the step's batch indices as
    two bit streams (randint on the card). The towers run as plain
    matmuls."""
    P = 1 if algorithm == "asyrevel" else q
    leaves = P * K * PARTY_LEAVES + SERVER_LEAVES
    releases = q + P * K
    if fused:
        return {"defended_encode": releases, "zo_update": leaves,
                "dual_matmul": 0, "flash_attention": 0,
                "prng_draw": leaves + 2}
    return {"defended_encode": 0, "zo_update": 0, "dual_matmul": 0,
            "flash_attention": 0, "prng_draw": leaves + 2 * releases + 2}


def host_round_launches(K, fused):
    """Launches of one defended party round of the host executor with K
    directions: the K tower pairs are one dual_matmul each; c and the K
    c_hat's are one defended_encode each fused, two bit draws each
    unfused; each perturbed leaf is a draw (and fused a zo_update)."""
    leaves = K * PARTY_LEAVES + SERVER_LEAVES
    if fused:
        return {"defended_encode": 1 + K, "zo_update": leaves,
                "dual_matmul": K, "flash_attention": 0, "prng_draw": leaves}
    return {"defended_encode": 0, "zo_update": 0, "dual_matmul": K,
            "flash_attention": 0, "prng_draw": leaves + 2 * (1 + K)}


def scan_config(K, fused, dp, **kw):
    from repro_torch.configs import VFLConfig
    return VFLConfig(**{**dict(num_parties=8, direction="rademacher",
                               mu=5e-2, lr_party=2e-2, lr_server=1e-2,
                               codec="int8", dp=dp, fused=fused,
                               num_directions=K), **kw})


def scan_dp(rounds, K):
    """DPConfig(epsilon=8, delta=1e-5, clip=1) calibrated by the port's
    accountant for ``rounds`` rounds of K directions."""
    from repro_torch.configs import DPConfig
    from repro_torch.dp.accountant import resolve_dp
    return resolve_dp(DPConfig(epsilon=8.0, delta=1e-5, clip=1.0),
                      rounds=rounds, num_directions=K)


def _states_bitwise(a, b) -> bool:
    from repro_torch.utils import trees
    return all(bitwise_equal(x, y)
               for ta, tb in ((a.w0, b.w0), (a.parties, b.parties),
                              (a.hist, b.hist))
               for x, y in zip(trees.leaves(ta), trees.leaves(tb)))


def scan_phase(dev):
    """The device-scan trainer (``asyrevel.train``) on the defended paper
    FCN at D7 width, fused against unfused, then the host round at K = 4,
    the card against the CPU, and the quickstart's training check."""
    import importlib.util

    import numpy as np
    import torch
    from repro_torch.configs import PaperFCNConfig
    from repro_torch.core import asyrevel, comms
    from repro_torch.core.async_host import HostAsyncTrainer
    from repro_torch.core.vfl import PaperFCNModel
    from repro_torch.data.synthetic import make_paper_dataset
    from repro_torch.data.vertical import pad_party_views, vertical_partition
    from repro_torch.utils import prng

    q, batch = 8, 2048
    Xp, y, spec, _ = d7_data(q)
    model = PaperFCNModel(PaperFCNConfig(num_features=spec.d,
                                         num_classes=spec.classes,
                                         num_parties=q))
    data = {"x": torch.as_tensor(Xp, device=dev),
            "y": torch.as_tensor(y, device=dev)}
    stats = {"scan": {}}
    for alg, K, steps in SCAN_RUNS:
        dp = scan_dp(steps, K)
        runs = {}
        for fused in (True, False):
            vfl = scan_config(K, fused, dp)
            zero_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, losses = asyrevel.train(model, vfl, data, prng.key(0),
                                           steps, batch, algorithm=alg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3 / steps
            launches = read_launches()
            want = {name: n * steps for name, n in
                    scan_launches(alg, K, fused, q).items()}
            want["prng_draw"] += fcn_init_draws(q)
            name = f"{alg}_k{K}_{'fused' if fused else 'unfused'}"
            log(f"[scan] {name}: sigma {dp.noise_multiplier:.6g} over "
                f"{steps} steps, {ms:.3f} ms per step, launches {launches}")
            if launches != want:
                raise AssertionError(f"scan {name} launches {launches}, "
                                     f"want {want}")
            h = losses.cpu()
            if h.shape != (steps,) or not bool(torch.isfinite(h).all()):
                raise AssertionError(f"scan {name} losses {h}")
            runs[fused] = (state, h)
            stats["scan"][name] = {"ms_per_step": ms, "launches": launches,
                                   "sigma": dp.noise_multiplier,
                                   "h_first": float(h[0]),
                                   "h_last": float(h[-1])}
        (s_f, h_f), (s_u, h_u) = runs[True], runs[False]
        if not (bitwise_equal(h_f, h_u) and _states_bitwise(s_f, s_u)):
            raise AssertionError(f"scan {alg} K={K}: fused != unfused")
        log(f"[scan] {alg} K={K}: {steps} steps, h {float(h_f[0]):.4f} -> "
            f"{float(h_f[-1]):.4f}; fused losses and final state bitwise "
            "equal to unfused")

    # the host executor's K-direction round at D7 width
    K, rounds = 4, 10
    dp = scan_dp(rounds, K)
    host = {}
    for fused in (True, False):
        zero_launches()
        tr = HostAsyncTrainer(model, scan_config(K, fused, dp), Xp, y,
                              batch_size=batch, seed=0, compute_cost_s=0.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = tr.run_serial(rounds)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / (rounds * q)
        launches = read_launches()
        want = {name: n * rounds * q
                for name, n in host_round_launches(K, fused).items()}
        want["prng_draw"] += fcn_init_draws(q)
        log(f"[scan] run_serial K={K} {'fused' if fused else 'unfused'}: "
            f"{ms:.3f} ms per party round, launches {launches}")
        if launches != want:
            raise AssertionError(f"host K={K} launches {launches}, want "
                                 f"{want}")
        updates = rounds * q
        per = comms.zoo_vfl_round(batch, codec="int8", num_directions=K)
        if (res.bytes_up, res.bytes_down) != (updates * per.up_bytes,
                                              updates * per.down_bytes) or \
                per.up_bytes != (1 + K) * (batch + 4) or \
                per.down_bytes != (1 + K) * 4:
            raise AssertionError(f"host K={K} bytes {res.bytes_up}, "
                                 f"{res.bytes_down}")
        comms.validate_channel(tr.channel, updates, batch, codec="int8",
                               num_directions=K)
        host[fused] = (tr, [h for _, h in res.history])
        stats[f"run_serial_k{K}_{'fused' if fused else 'unfused'}"] = {
            "ms_per_party_round": ms, "launches": launches,
            "bytes_up": res.bytes_up, "bytes_down": res.bytes_down}
    (tr_f, h_f), (tr_u, h_u) = host[True], host[False]
    if h_f != h_u or not all(math.isfinite(h) for h in h_f):
        raise AssertionError("host K=4: fused losses != unfused")
    for m in range(q):
        for k in tr_f.party_w[m]:
            if not bitwise_equal(tr_f.party_w[m][k], tr_u.party_w[m][k]):
                raise AssertionError(f"host K=4 party {m} {k}: fused != "
                                     "unfused")
    for k in tr_f.server.w0:
        if not bitwise_equal(tr_f.server.w0[k], tr_u.server.w0[k]):
            raise AssertionError(f"host K=4 server {k}: fused != unfused")
    log(f"[scan] run_serial K={K}: fused bitwise equal to unfused; bytes up "
        f"{tr_f.server.losses.bytes_up} down {tr_f.server.losses.bytes_down}"
        " (exact, = analytic)")

    # train's batch indices on the card (two draws and int64 ops) are the
    # host's randint, its plain version, exactly
    for t in (0, 1, SCAN_RUNS[0][2] - 1):
        k_t = prng.split_at(prng.fold_in(prng.key(0), 7), t)
        got = asyrevel.batch_indices(prng.key(0), t, batch, len(y), dev)
        if got.cpu().tolist() != prng.randint(k_t, (batch,), 0, len(y)):
            raise AssertionError(f"scan step {t}: batch indices on the card "
                                 "!= the host's randint")
    log(f"[scan] batch indices on the card equal the host's randint at "
        f"batch {batch}")

    # the card against the CPU (the CPU port is held to the reference by
    # tests/test_torch_scan.py): D7 at scale 0.01, batch 64, 20 asyrevel
    # steps at K = 2, fused f32 + gaussian DP. The f32 sums run in other
    # orders on the two devices, a few ulps of h a step, and each step's
    # coefficient divides them by mu; a wrong key or bit moves h by 1e-1.
    (Xs, ys), _ = make_paper_dataset("D7_MNIST", scale=0.01)
    Xs, _ = pad_party_views(vertical_partition(Xs, q)[0])
    vfl = scan_config(2, True, scan_dp(20, 2), codec="f32")
    h_dev, h_cpu = (asyrevel.train(model, vfl, {"x": Xs, "y": ys},
                                   prng.key(0), 20, 64, device=d)[1].cpu()
                    for d in (dev, "cpu"))
    gap = float((h_dev - h_cpu).abs().max())
    if not gap < 1e-3:
        raise AssertionError(f"scan card vs CPU losses differ by {gap}")
    log(f"[scan] card vs CPU, D7 at scale 0.01, 20 asyrevel steps at K=2: "
        f"max loss gap {gap:.3g}")
    stats["card_vs_cpu_gap"] = gap

    # the training check: examples/quickstart_torch.py on the card
    spec_ = importlib.util.spec_from_file_location(
        "quickstart_torch", ROOT / "examples" / "quickstart_torch.py")
    quick = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(quick)
    res = quick.run(dev)
    final = float(np.mean(res["losses"][-100:]))
    log(f"[scan] quickstart on the card: {len(res['losses'])} steps in "
        f"{res['seconds']:.2f} s, final loss {final:.4f}, train acc "
        f"{res['acc']:.3f}")
    if not res["acc"] > 0.8:
        raise AssertionError(f"quickstart train acc {res['acc']}")
    stats["quickstart"] = {"steps": len(res["losses"]),
                           "seconds": res["seconds"], "final_loss": final,
                           "acc": res["acc"]}
    return stats


# ------------------------------------------------------------ vfl-zoo phase --

ZOO_STEPS = 5
ZOO_ARGS = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--parties", "4",
            "--batch-size", "4", "--seq-len", "2048", "--fused", "--codec",
            "int8"]
# what one step launches: h, h_bar and h_hat are three forwards of the
# 24-layer backbone, one flash_attention per layer each; the up-link
# encodes q = 4 c's and one c_hat, one defended_encode each (bits from the
# keys); one gaussian direction (a draw) per perturbed leaf, 17
ZOO_FLASH_PER_STEP = 3 * 24
ZOO_ENCODE_PER_STEP = 4 + 1
ZOO_DRAWS_PER_STEP = 17


def zoo_init_draws(layers, parties):
    """Draws of the vfl-zoo initial weights: the server's embedding, 7
    matrices a layer (wq, wk, wv, wo, w_gate, w_up, w_down), and each
    party's embedding slice, w1 and w2."""
    return 1 + 7 * layers + 3 * parties
# the parts of a step timed on their own (the rest is the party update,
# the server update's arithmetic and the ring buffer)
SPLIT = (("directions", "repro_torch.core.zoo", "direction_tree"),
         ("server_forward", "repro_torch.core.vfl",
          "TransformerVFLModel.server_forward"),
         ("party_forward", "repro_torch.core.vfl",
          "TransformerVFLModel.party_forward"),
         ("up_link", "repro_torch.core.exchange", "ZOExchange.roundtrip_up"))


def zoo_phase(dev):
    """The vfl-zoo training mode at qwen1.5-0.5b's full width and depth,
    through the port's launcher, then the same step's time split, then a
    reduced run on the card against the same run on the CPU."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config("qwen1.5-0.5b")
    argv = ZOO_ARGS + ["--steps", str(ZOO_STEPS), "--log-every", "1"]
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    res = train.main(argv)
    launches = read_launches()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    h = res["h"]
    log(f"[zoo] qwen1.5-0.5b {cfg.num_params()} params, {cfg.num_layers} "
        f"layers, d {cfg.d_model}: setup {res['setup_s']:.2f} s, s per step "
        f"{[round(t, 4) for t in res['step_s']]}, h {h}, peak "
        f"{peak_gb:.2f} GB, launches {launches}")
    want = {"flash_attention": ZOO_FLASH_PER_STEP * ZOO_STEPS,
            "defended_encode": ZOO_ENCODE_PER_STEP * ZOO_STEPS,
            "dual_matmul": 0, "zo_update": 0,
            "prng_draw": ZOO_DRAWS_PER_STEP * ZOO_STEPS
            + zoo_init_draws(cfg.num_layers, 4)}
    if launches != want:
        raise AssertionError(f"vfl-zoo launches {launches}, want {want}")
    if len(h) != ZOO_STEPS or not all(math.isfinite(x) for x in h):
        raise AssertionError(f"vfl-zoo losses {h}")
    if not abs(h[0] - math.log(cfg.vocab_size)) < 1.0:
        raise AssertionError(f"first h {h[0]} is not within 1.0 of ln V = "
                             f"{math.log(cfg.vocab_size):.4f}")
    split = zoo_split(dev)

    # the card against the CPU (the CPU port is held to the jax reference
    # by tests/test_torch_zoo.py): reduced qwen (2 layers, d 256, f32),
    # S 128, 3 steps from the same seed. f32 orders differ by ulps of c;
    # should one ulp flip an int8 stochastic rounding the loss moves
    # ~1e-5; a wrong key or kernel moves it by 1e-2 or more.
    small = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
             "--parties", "4", "--batch-size", "4", "--seq-len", "128",
             "--steps", "3", "--fused", "--codec", "int8", "--lr", "1e-2",
             "--log-every", "100"]
    h_dev = train.main(small)["h"]
    h_cpu = train.main(small + ["--device", "cpu"])["h"]
    gap = max(abs(a - b) for a, b in zip(h_dev, h_cpu))
    if not gap < 1e-3:
        raise AssertionError(f"vfl-zoo card vs CPU losses differ by {gap}")
    log(f"[zoo] card vs CPU, reduced qwen1.5-0.5b, 3 steps: max h gap "
        f"{gap:.3g}")
    # the same in bf16, the full-size run's dtype: the first h is one
    # forward (roundings moved by another matmul order or an expf an ulp
    # off spread through the layers, within 2e-3); later h's follow ZO
    # coefficients that divide such gaps by mu (within 5e-2), the
    # tolerances tests/test_torch_bf16.py holds the CPU port to against
    # the reference
    h_dev, h_cpu = reduced_bf16_steps(dev), reduced_bf16_steps("cpu")
    gaps16 = [abs(a - b) for a, b in zip(h_dev, h_cpu)]
    if not (gaps16[0] < 2e-3 and max(gaps16) < 5e-2
            and all(math.isfinite(x) for x in h_dev)):
        raise AssertionError(f"bf16 vfl-zoo card vs CPU: h {h_dev} against "
                             f"{h_cpu}")
    log(f"[zoo] card vs CPU, reduced qwen1.5-0.5b in bf16, 3 steps: h gaps "
        f"{gaps16}")
    return launches, {"steps": ZOO_STEPS, "h": h, "step_s": res["step_s"],
                      "setup_s": res["setup_s"], "peak_gb": peak_gb,
                      "split_s": split, "card_vs_cpu_gap": gap,
                      "card_vs_cpu_bf16_gaps": gaps16}


def reduced_bf16_steps(device, steps=3):
    """h of 3 fused int8 vfl-zoo steps of reduced qwen1.5-0.5b in bf16 (2
    layers, d 256, S 128), from seed 0, on ``device``."""
    import numpy as np
    import torch
    from repro_torch.configs import VFLConfig, get_config
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.train import make_batch_arrays
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng

    device = torch.device(device)
    cfg = get_config("qwen1.5-0.5b", reduced=True).replace(dtype="bfloat16")
    vfl = VFLConfig(num_parties=4, mu=1e-3, lr_party=1e-2, lr_server=1e-2 / 4,
                    fused=True, codec="int8")
    _, init, step = step_lib.make_vfl_zoo_step(build_model(cfg), vfl)
    state = init(prng.key(0), device)
    data = make_batch_arrays(cfg, 64, 128, 0, device)
    rng = np.random.default_rng(0)
    h = []
    for _ in range(steps):
        idx = torch.as_tensor(rng.integers(0, 64, 4), device=device)
        state, loss = step(state, {k: a[idx] for k, a in data.items()})
        h.append(float(loss))
    return h


def zoo_split(dev):
    """2 more steps at the same shapes, each part of SPLIT timed on the host
    between device syncs (the syncs cost a few ms). Returns the mean
    seconds per step of each part, of the whole step and of the rest."""
    import importlib

    import torch
    from repro_torch.launch import train

    spent, saved = {}, []
    for name, mod, attr in SPLIT:
        owner = importlib.import_module(mod)
        *cls, fn_name = attr.split(".")
        if cls:
            owner = getattr(owner, cls[0])
        fn = getattr(owner, fn_name)
        saved.append((owner, fn_name, fn))

        def timed(*a, _fn=fn, _name=name, **k):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            out = _fn(*a, **k)
            torch.cuda.synchronize(dev)
            spent[_name] = spent.get(_name, 0.0) + time.perf_counter() - t0
            return out
        setattr(owner, fn_name, timed)
    try:
        res = train.main(ZOO_ARGS + ["--steps", "2", "--log-every", "100",
                                     "--seed", "1"])
    finally:
        for owner, fn_name, fn in saved:
            setattr(owner, fn_name, fn)
    n = len(res["step_s"])
    split = {name: spent.get(name, 0.0) / n for name, _, _ in SPLIT}
    split["step"] = sum(res["step_s"]) / n
    split["rest"] = split["step"] - sum(split[name] for name, _, _ in SPLIT)
    log(f"[zoo] time split, s per step (mean of {n}, under syncs): "
        f"{json.dumps(split)}")
    return split


def d7_data(q):
    from repro_torch.data.synthetic import make_paper_dataset
    from repro_torch.data.vertical import pad_party_views, vertical_partition
    (X, y), spec = make_paper_dataset("D7_MNIST", scale=1.0)
    Xp, pad = pad_party_views(vertical_partition(X, q)[0])
    return Xp, y, spec, pad


PROFILE_SPANS = ("prng.bits", "prng.sample_direction")
PORT_KERNEL_FUNCTIONS = {"defended_encode": ("cast_kernel", "int8_kernel"),
                         "zo_update": ("zo_update",),
                         "dual_matmul": ("dual_matmul",),
                         "flash_attention": ("flash_attention",),
                         "prng_draw": ("draw_kernel",)}


def _fcn_workload(cell):
    """2 serial rounds (16 party updates) of a D7 FCN cell, after a warm-up:
    the defended main path ("d7") or the async experiment's configuration
    ("async", on the serial schedule, without the simulated compute)."""
    from repro_torch.configs import PaperFCNConfig, VFLConfig
    from repro_torch.core.async_host import HostAsyncTrainer
    from repro_torch.core.vfl import PaperFCNModel
    from repro_torch.data.synthetic import make_paper_dataset
    from repro_torch.data.vertical import pad_party_views, vertical_partition

    q = 8
    if cell == "d7":
        batch, vfl = 2048, d7_config(True, dp=True)
        Xp, y, spec, _ = d7_data(q)
    else:
        batch = 64
        vfl = VFLConfig(num_parties=q, direction="uniform", mu=1e-3,
                        lr_party=2e-2, lr_server=2e-2 / q)
        (X, y), spec = make_paper_dataset("D7_MNIST", scale=0.01)
        Xp, _ = pad_party_views(vertical_partition(X, q)[0])
    model = PaperFCNModel(PaperFCNConfig(num_features=spec.d,
                                         num_classes=spec.classes,
                                         num_parties=q))
    HostAsyncTrainer(model, vfl, Xp, y, batch_size=batch, seed=1,
                     compute_cost_s=0.0).run_serial(1)
    tr = HostAsyncTrainer(model, vfl, Xp, y, batch_size=batch, seed=0,
                          compute_cost_s=0.0)
    return (lambda: tr.run_serial(2)), 2 * q, "party_round"


def _zoo_workload(dev):
    """One vfl-zoo step of the smoke's configuration (qwen1.5-0.5b at full
    width and depth, batch 4, S 2048, fused int8), after a warm-up step."""
    from repro_torch.configs import VFLConfig, get_config
    from repro_torch.launch import steps, train
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng

    args = train.parse_args(ZOO_ARGS + ["--steps", "2"])
    cfg = get_config(args.arch, reduced=args.reduced)
    model = build_model(cfg)
    # the launcher's VFLConfig for these flags
    vfl = VFLConfig(num_parties=args.parties, mu=args.mu, lr_party=args.lr,
                    lr_server=args.lr / args.parties, fused=args.fused,
                    codec=args.codec)
    _, init, step = steps.make_vfl_zoo_step(model, vfl)
    state = init(prng.key(0), dev)
    data = train.make_batch_arrays(cfg, args.batch_size, args.seq_len, 0,
                                   dev)
    state, h = step(state, data)
    float(h)
    return (lambda: float(step(state, data)[1])), 1, "step"


def _scan_workload(dev):
    """4 steps of the scan trainer's defended D7 cell (asyrevel, K = 1,
    fused int8 + gaussian DP) from a warmed-up state, each with its batch
    indices drawn and gathered on the card as ``train`` does: the steps
    alone, without the set-up of ``train``."""
    import torch
    from repro_torch.configs import PaperFCNConfig
    from repro_torch.core import asyrevel
    from repro_torch.core.exchange import ZOExchange
    from repro_torch.core.vfl import PaperFCNModel
    from repro_torch.utils import prng

    q, batch, steps = 8, 2048, 4
    Xp, y, spec, _ = d7_data(q)
    model = PaperFCNModel(PaperFCNConfig(num_features=spec.d,
                                         num_classes=spec.classes,
                                         num_parties=q))
    vfl = scan_config(1, True, scan_dp(50, 1))
    x, yt = torch.as_tensor(Xp, device=dev), torch.as_tensor(y, device=dev)
    key, n = prng.key(0), len(y)
    ex = ZOExchange.from_config(vfl)
    state = asyrevel.init_state(model, vfl, key, dev)

    def step(s, t):
        i = asyrevel.batch_indices(key, t, batch, n, dev)
        return asyrevel.asyrevel_step(model, vfl, s, {"x": x[i], "y": yt[i]},
                                      ex)[0]
    for t in range(2):
        state = step(state, t)
    # the host's share of a step that no device trace shows: the discrete
    # draws (m_t and the delays), host clock
    t0 = time.perf_counter()
    for t in range(20):
        asyrevel.draw_party_and_delays(vfl, state._replace(step=t))
    log(json.dumps({"scan_host_ms_per_step": {
        "draw_party_and_delays": (time.perf_counter() - t0) * 1e3 / 20}}))

    def run():
        s = state
        for t in range(2, steps + 2):
            s = step(s, t)
    return run, steps, "step"


def profile_phase(dev, cell):
    """Trace one cell's workload with ``torch.profiler``: 2 serial rounds of
    a D7 FCN cell ("d7", "async"), 4 scan-trainer steps ("scan") or one
    vfl-zoo step ("zoo"). Each
    ``prng.bits`` and ``prng.sample_direction`` call is a
    ``record_function`` span; a direction's span holds its bits span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.utils import prng

    run, units, unit = {"zoo": _zoo_workload, "scan": _scan_workload}.get(
        cell, lambda _: _fcn_workload(cell))(dev)

    plain = {name: getattr(prng, name.split(".")[1]) for name in PROFILE_SPANS}

    def spanned(name):
        def fn(*args):
            with record_function(name):
                return plain[name](*args)
        return fn

    # every caller looks these up on the module
    for name in PROFILE_SPANS:
        setattr(prng, name.split(".")[1], spanned(name))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    for name in PROFILE_SPANS:
        setattr(prng, name.split(".")[1], plain[name])
    # the profiler mirrors each record_function span onto the device
    # timeline as an annotation; those are neither launches nor busy time
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and e.key not in PROFILE_SPANS]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    launches = sum(e.count for e in dev_events)
    top = sorted(dev_events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]

    def kernels_under(e):
        """(device launches, device us) of ``e`` and everything it called."""
        n, us = len(e.kernels), sum(k.duration for k in e.kernels)
        for child in e.cpu_children:
            cn, cus = kernels_under(child)
            n, us = n + cn, us + cus
        return n, us

    flash = [e for e in dev_events if "flash_attention" in e.key]
    # the port's kernels in the trace, by the names of their functions (the
    # profiler does not tie a launch made through ctypes to the span around
    # it, so the draws are counted here)
    mine = {name: [e for e in dev_events if any(f in e.key for f in fns)]
            for name, fns in PORT_KERNEL_FUNCTIONS.items()}
    out = {"cell": cell, f"{unit}s": units, "wall_ms": wall_ms,
           f"ms_per_{unit}": wall_ms / units,
           "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
           "device_launches": launches,
           "flash_attention": {
               "device_ms": sum(e.self_device_time_total
                                for e in flash) / 1e3,
               "launches": sum(e.count for e in flash)},
           "port_kernels": {
               name: {"launches": sum(e.count for e in evs),
                      f"launches_per_{unit}":
                          sum(e.count for e in evs) / units,
                      "device_ms": sum(e.self_device_time_total
                                       for e in evs) / 1e3}
               for name, evs in mine.items()},
           "top_device_ms": [[e.key[:60], e.self_device_time_total / 1e3,
                              e.count] for e in top]}
    for name in PROFILE_SPANS:
        spans = [e for e in prof.events() if e.name == name
                 and e.device_type == DeviceType.CPU]
        under = [kernels_under(e) for e in spans]
        host_ms = sum(e.cpu_time_total for e in spans) / 1e3
        n = sum(k for k, _ in under)
        out[name] = {f"calls_per_{unit}": len(spans) / units,
                     "host_ms": host_ms, "host_share": host_ms / wall_ms,
                     "device_launches": n,
                     "launch_share": n / launches if launches else 0.0,
                     "device_ms": sum(us for _, us in under) / 1e3}
    out["bits_call_ms_12544"] = time_ms(
        lambda: plain["prng.bits"]((1, 2), (12544,), dev))
    log(json.dumps({"profile": out}))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.kernels import build

    dev = torch.device("cuda")
    card = card_line()
    int_rate = int32_ops_per_s(
        torch.cuda.get_device_properties(0).multi_processor_count)
    log(f"[device] {torch.cuda.get_device_name(0)} | {card} | torch "
        f"{torch.__version__} cuda {torch.version.cuda} | INT32 "
        f"{int_rate / 1e12:.3f} Tops/s")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    torch.backends.cudnn.allow_tf32 = False

    t = time.perf_counter()
    built = build.build_all()
    log(f"[build] {built} wall {time.perf_counter() - t:.1f}s")
    for name, (_, text) in build.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    tensor_core_route()
    draw_sass()

    if "--profile" in sys.argv[1:]:
        for cell in ("d7", "async", "scan", "zoo"):
            profile_phase(dev, cell)
        return 0
    timed, worst = kernel_phase(dev, int_rate)
    timed["prng_draw"], worst["prng_draw"] = draw_phase(dev, int_rate)
    timed["dual_matmul"], worst["dual_matmul"] = dual_matmul_phase(dev)
    timed["flash_attention"], worst["flash_attention"] = flash_phase(dev)
    launches, main_stats = main_path_phase(dev)
    log(json.dumps({"main_path": main_stats}))
    zoo_launches, zoo_stats = zoo_phase(dev)
    log(json.dumps({"vfl_zoo": zoo_stats}))
    launches["flash_attention"] = zoo_launches["flash_attention"]
    log(json.dumps({"async": async_phase(dev)}))
    log(json.dumps({"scan": scan_phase(dev)}))

    sources = {
        "defended_encode": ("src/repro_torch/kernels/csrc/defended_encode.cu",
                            "src/repro/kernels/fused_round.py:171"),
        "zo_update": ("src/repro_torch/kernels/csrc/zo_update.cu",
                      "src/repro/kernels/zo_update.py:69"),
        "dual_matmul": ("src/repro_torch/kernels/csrc/dual_matmul.cu",
                        "src/repro/kernels/dual_matmul.py:24"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:25"),
        # not a Pallas kernel: XLA's jax.random.bits / jax.random.normal,
        # which the reference's sample_direction draws through
        "prng_draw": ("src/repro_torch/kernels/csrc/prng_draw.cu",
                      "src/repro/utils/prng.py:23"),
    }
    # launches: the D7 main path's fused run for defended_encode,
    # zo_update, dual_matmul and prng_draw, the vfl-zoo run for
    # flash_attention; library_ms: no single torch call takes the keys or
    # the bit streams of defended_encode, zo_update and prng_draw (torch's
    # own generator draws other numbers), two torch.matmul calls compute
    # dual_matmul, scaled_dot_product_attention flash_attention
    kernels = [{"name": name, "route": "cuda", "source": src_path,
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": worst[name], "ms": timed[name]["kernel_ms"],
                "plain_ms": timed[name]["plain_ms"],
                "bound_ms": timed[name]["bound_ms"],
                "bound_by": timed[name]["bound_by"],
                "library_ms": timed[name].get("library_ms")}
               for name, (src_path, replaces) in sources.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
