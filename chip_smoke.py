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
   undefended D7 training run (scale 0.01, 600 updates) whose loss must
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
   rest within 5e-2), and the reduced run's 2 steps plus 2 resumed from
   its ``--ckpt-dir`` checkpoint bitwise equal to 4 straight steps.
5. Async: the paper's Section 5.1 experiment (examples/federated_fcn_mnist.py)
   on the threaded executors: D7 at scale 0.01, q = 8, batch 64, uniform
   directions, 1 ms simulated compute per party round, party 3 a 1.4x
   straggler. ``run_async`` (600 updates) and ``run_sync`` (75 rounds),
   each with the counters zeroed just before it and read just after:
   exactly 600 updates, 600 dual_matmul and 6 x 600 draw launches each
   (the directions of 4 party and 2 server leaves an update), falling loss,
   exact wire bytes; both wall-clock times and their ratio.
6. Scan: the device-scan trainer (``asyrevel.train``) on the defended
   paper FCN at D7 width (n = 60000, batch 2048, fused int8 + gaussian DP
   calibrated by the port's accountant to epsilon 8, delta 1e-5, clip 1
   for each run's steps and directions; rademacher, mu 5e-2): asyrevel
   for 25 steps at K = 1 and K = 4, synrevel for 10 steps, each fused and
   unfused with the counters zeroed just before it and read just after.
   Launches per step exact (``scan_launches``), losses finite, and the
   fused run's per-step h and final state bitwise the unfused run's. Then
   ``run_serial`` at K = 4 (5 rounds of 8): launches exact
   (``host_round_launches``), bytes exact against the analytic formula
   (up (1+K)(B + 4), down (1+K) 4 a round), fused bitwise unfused. Then
   the card against the CPU (D7 at scale 0.01, batch 64, 20 asyrevel
   steps at K = 2, fused f32 + DP: losses within 1e-3) and
   examples/quickstart_torch.py on the card (2000 steps: train acc > 0.8).
7. Runtime: the multi-process TCP federation (``runtime.run_federation``)
   on the defended D7 FCN of phase 3 at full width (n = 60000, batch 2048,
   4 rounds a party), the server and the 8 parties as 9 OS processes on
   the one card: (a) the serial schedule, losses, every party's final
   params and w0 bitwise equal to ``run_reference`` in this process, bytes
   and messages by kind equal, c_up exactly rounds·q·(2048 + 4) bytes,
   socket bytes above payload bytes; (b) party 3 crashes at round 2 and
   rejoins from its checkpoint, bitwise equal to (a), one rejoin and one
   disconnect; (c) the arrival schedule with tau = 1 and party 7 stalling
   0.2 s a send: rounds parked, no admitted round staler than 1, every
   round processed, finite losses. Every process reports its device (the
   card) and its launch counts, exact against ``runtime_launches``; the
   parent launches nothing during a federation, and no process is left
   alive after one. Host-clock ms per party update of (a) and (c) beside
   the in-process ``run_serial``'s.
8. At the end, after 9 to 11: the ``{"kernels": [...]}`` line, the card
   line, and last ``{"ok": true, "device": {...}}``.
9. Serving: federated inference (``serving.federated``, and over TCP
   ``runtime.run_tcp_serving``) on the runtime phase's D7 FCN without DP
   (fused int8), the 8 party blocks phase 3's fused run ended with saved
   as step-10 checkpoints, w0 from the seed. 2048 request ids from
   ``default_rng(0)`` in memory at slots 8 and 64, each with the counters
   zeroed just before and read just after: launches exact
   (``serving_launches``: one keyless int8 defended_encode per issued
   (party, step), 3 data draws, 2 per party block, 1 for w0, nothing
   else), bytes equal to the analytic formula, the serving transcript's
   exposure (ids and function values, no grads or params, one c_up per
   serve_down). A second pass over 512 of the ids is all answer-cache
   hits (8 x 512), with no serve_down and no launch. Fused int8 bitwise
   unfused int8 (predictions and payloads); in f32 slots 64 bitwise slots 1
   (predictions and cached values); the card's predictions equal the CPU
   port's on a small problem. TCP: 8 serving party processes on the card
   at slots 64, bitwise the in-memory engine, launches exact in every
   process, each exiting with 0. The launcher's ``--serve 64
   --serve-batch 8 --network wan`` and its ``--transport tcp`` twin (4
   parties, qwen1.5-0.5b's d_model of features). Predictions per second on
   the host clock, the split of an engine step, socket and payload bytes
   per prediction, and the simulated 'wan' wire's priced time, p50, p99.
10. Audits: benchmarks/bench_privacy.py's two transcripts (ZOO-VFL's
   ``run_serial`` and TIG's ``HostTIGTrainer``, and the aligned ZOO
   rounds) recorded on the card and on the CPU, through every attack of
   ``core/privacy.py``: accuracies, flags and reasons equal (tig_acc 1.0,
   zoo_acc 0.5, zoo_ratio 0.358, recovery error below 1e-9). Then
   ``HostTIGTrainer`` on the D7 FCN at full width (8 parties, batch 2048,
   10 rounds): finite, falling losses, grad_down exactly 2048 x 4 bytes a
   round, ms per TIG round beside the fused ZOO round's.
11. Traced federation (``repro_torch/obs``): the runtime phase's
   ``run_reference`` again with a tracer in this process, bitwise the
   untraced one (losses, params, payloads), launches exact (a fused D7
   round each update, the data's 3 draws and the initial weights'); the
   serial TCP federation again, traced and monitored (the collector in
   this process), bitwise the untraced (a) (losses, params, bytes, socket
   bytes), launches exact in every process, no alert, every process
   exiting with 0; TCP serving of 256 requests at slots 64 from the
   checkpointed blocks, traced and monitored, bitwise the in-memory
   engine, launches exact. Every merged trace has its chains complete and
   its wire records equal to the analytic bytes (both sides over TCP).
   Prints p50 and p99 of ``server_process``, ``server_handle``,
   ``party_prepare``, ``party_round`` and ``party_wait_reply``, the TCP
   ``server_process`` split into observe, handle and send (by the
   timestamps of the ``server_handle`` span inside it), and ms per party
   update traced against untraced, in memory and over TCP.

``--profile`` runs none of that: it builds the kernels, warms up, and
traces 2 serial rounds (16 party updates) of each D7 cell, the defended
round and the async experiment's configuration, 4 steps of the scan
trainer's defended D7 cell (asyrevel, K = 1), one step of the
vfl-zoo cell, and 128 predictions of the serving cell in memory at slots
8 (after 64 of warm-up), with ``torch.profiler``,
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

import functools
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
    # the serving answers' keyless int8 encodes: one per party a step, of
    # as many values as the step's new ids (1 up to the slots, 8 or 64)
    for n in SERVING_ENCODE_SIZES:
        c = 2.0 * torch.randn(n, device=dev, generator=gen)
        got = fused_round.defended_encode_keyed(c, None, None, None, "int8")
        want = plain_encode_keyed(c, None, None, None, "int8")
        if not bitwise_equal(got, want):
            raise AssertionError(f"defended_encode int8 without key at n={n}")
        worst["defended_encode"] = max(worst["defended_encode"],
                                       max_abs(got, want))

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
# the sizes only the runtime's and serving's problems draw, checked bitwise
# without timing rows: the FCN labels' two bit streams (n = 60000) and X
# (60000 x 784)
DRAW_CHECKED = (60000, 47040000)
SERVING_ENCODE_SIZES = (1, 7, 8, 63, 64)


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
    for n in DRAW_CHECKED:
        k = (0x5EED, n)
        for mode in ("bits", "normal"):
            got = prng_draw.draw(k, (n,), mode, dev)
            want = prng.draw_plain(k, (n,), mode, dev)
            if not bitwise_equal(got, want):
                raise AssertionError(f"prng_draw != the eager chain: {mode} "
                                     f"n={n}")
            worst = max(worst, max_abs(got, want))
            del got, want
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
    res = tr.run_serial(TRAIN_ROUNDS)
    torch.cuda.synchronize()
    ms_t = (time.perf_counter() - t0) * 1e3 / (TRAIN_ROUNDS * q)
    lt = [h for _, h in res.history]
    first, last = float(np.mean(lt[:50])), float(np.mean(lt[-50:]))
    log(f"[train] {len(lt)} updates, loss {first:.3f} -> {last:.3f}, "
        f"{ms_t:.2f} ms per party round, bytes up {res.bytes_up} down "
        f"{res.bytes_down}")
    if not last < first:
        raise AssertionError("undefended training loss did not fall")
    # the fused run's final party blocks, which the serving phase serves
    blocks = [dict(w) for w in tr_f.party_w]
    return launches, blocks, {"fused_ms_per_round": ms_f,
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
# the depths of the undefended training check and the async experiment
# (PR 20 halved them, from 150 rounds and 1200 updates, to keep the whole
# script within PR 19's time with the serving and audit phases added)
TRAIN_ROUNDS = 75
ASYNC_UPDATES = 600
# directions per update of the async experiment (uniform: the gaussian
# draw, then its norm): the party's 4 leaves and the server's 2
ASYNC_DRAWS_PER_UPDATE = 6


def fcn_init_draws(q):
    """Draws of a paper FCN trainer's initial weights: each party's w1 and
    w2, and the server's w."""
    return 2 * q + 1


def zero_launches():
    from repro_torch.kernels import ops
    for fn in ops.launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    from repro_torch.kernels.ops import launch_counts
    return launch_counts()


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

    q, batch, updates = 8, 64, ASYNC_UPDATES
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
SCAN_RUNS = (("asyrevel", 1, 25), ("asyrevel", 4, 25), ("synrevel", 1, 10))
# the K = 4 host round's rounds of q and the quickstart's steps (PR 20
# halved them from 10 and 4000 for the script's time; the quickstart
# still reaches acc 0.869 on the CPU at 2000)
HOST_K4_ROUNDS = 5
QUICKSTART_STEPS = 2000
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
    K, rounds = 4, HOST_K4_ROUNDS
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
    quick.STEPS = QUICKSTART_STEPS
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


# ------------------------------------------------------------ runtime phase --

# the main path's D7 FCN at full width as a runtime spec: the settings of
# d7_config(fused=True, dp=True) (asserted in runtime_phase)
RUNTIME_SPEC = {"kind": "fcn", "parties": 8, "features": 784, "classes": 10,
                "samples": 60000, "batch": 2048, "seed": 0,
                "vfl": {"direction": "rademacher", "mu": 5e-2,
                        "lr_party": 2e-2, "lr_server": 1e-2, "codec": "int8",
                        "fused": True,
                        "dp": {"noise_multiplier": 1.3, "clip": 1.0}}}
RUNTIME_ROUNDS = 4
# launches of one defended D7 party round in a party process (c and c_hat
# encoded from their keys, a draw and a zo_update for each of the 4
# perturbed leaves, the two tower evaluations in one dual_matmul), and of
# one update in the server process (a draw and a zo_update for each of
# its 2 perturbed leaves)
RUNTIME_PARTY_ROUND = {"defended_encode": 2, "zo_update": 4,
                       "dual_matmul": 1, "flash_attention": 0, "prng_draw": 4}
RUNTIME_SERVER_UPDATE = {"defended_encode": 0, "zo_update": 2,
                         "dual_matmul": 0, "flash_attention": 0,
                         "prng_draw": 2}
# draws every process makes before its first round: the data (X a normal
# draw, the FCN's labels a randint of two bit streams), then its initial
# weights (a party's w1 and w2, the server's w)
RUNTIME_DATA_DRAWS = 3
RUNTIME_INIT_DRAWS = {"party": 2, "server": 1}


def runtime_launches(role, units):
    """Exact launches of one runtime process: ``units`` party rounds or
    server updates, plus the data and initial-weight draws."""
    per = RUNTIME_PARTY_ROUND if role == "party" else RUNTIME_SERVER_UPDATE
    want = {name: n * units for name, n in per.items()}
    want["prng_draw"] += RUNTIME_DATA_DRAWS + RUNTIME_INIT_DRAWS[role]
    return want


def _no_orphans(res, what, crashed=()):
    """Every process of the federation exited by itself: none is alive,
    each scripted crasher's first process exited with CRASH_EXIT_CODE and
    every other process with 0."""
    import multiprocessing
    import os
    from repro_torch.runtime import CRASH_EXIT_CODE
    alive = [p.pid for p in multiprocessing.active_children()] + [
        pid for pid in res["pids"] if os.path.exists(f"/proc/{pid}")]
    if alive:
        raise AssertionError(f"runtime {what}: processes still alive {alive}")
    want, seen = [], set()
    for name, _ in res["exitcodes"]:
        first_crash = name in crashed and name not in seen
        seen.add(name)
        want.append((name, CRASH_EXIT_CODE if first_crash else 0))
    if list(res["exitcodes"]) != want:
        raise AssertionError(f"runtime {what}: exit codes "
                             f"{res['exitcodes']}, want {want}")


def runtime_phase(dev, spec=RUNTIME_SPEC, rounds=RUNTIME_ROUNDS):
    """The multi-process TCP federation runtime on the defended D7 FCN:
    q + 1 OS processes on the one card. (a) serial, bitwise equal to
    ``run_reference`` in this process (losses, final params, bytes and
    messages by kind); (b) party 3 crashes at round 2 and rejoins from its
    checkpoint, bitwise equal to (a); (c) the arrival schedule with tau = 1
    and party 7 stalling 0.2 s a send. Every process reports its device
    and its launches, which must be exact (``runtime_launches``); the
    checks of launches come last, after all three runs. Returns the
    phase's numbers and the untraced runs the traced phase is held to:
    (a) and ``run_reference``'s (trainer, result, channel)."""
    import tempfile

    import numpy as np
    from repro_torch.configs import DPConfig, RuntimeConfig, VFLConfig
    from repro_torch.core.wire import RecordingChannel
    from repro_torch.runtime import (FailurePlan, PartyFault, history_losses,
                                     ms_per_update, run_federation,
                                     run_reference, serial_levels)

    q, batch = spec["parties"], spec["batch"]
    vfl_kw = dict(spec["vfl"])
    dp = DPConfig(**vfl_kw.pop("dp"))
    if spec is RUNTIME_SPEC and \
            VFLConfig(num_parties=q, dp=dp, **vfl_kw) != d7_config(True, True):
        raise AssertionError("RUNTIME_SPEC differs from d7_config")
    cfg = RuntimeConfig(deadline_s=900.0)
    stats, launch_checks = {}, []

    def finals_equal(a, b, what):
        for m in range(q):
            for k, v in a["parties"][m]["final_w"].items():
                if not np.array_equal(v.view(np.int32),
                                      b["parties"][m]["final_w"][k]
                                      .view(np.int32)):
                    raise AssertionError(f"runtime {what}: party {m} {k}")
        for k, v in a["server"]["w0"].items():
            if not np.array_equal(v.view(np.int32),
                                  b["server"]["w0"][k].view(np.int32)):
                raise AssertionError(f"runtime {what}: server {k}")

    def devices(res, what):
        got = {res["server"]["device"]} | {p["device"] for p in
                                          res["parties"].values()}
        if {d.split(":")[0] for d in got} != {dev.type}:
            raise AssertionError(f"runtime {what}: devices {got}")

    def split(res):
        """Host ms past start-up, as ``ms_per_update`` counts it: per update
        of the server's dispatcher after the slowest party's first round
        (waiting for a complete round, processing one), and per round of
        the parties from their second on (prepare, send and wait for the
        reply, apply; the mean over parties and rounds)."""
        srv = res["server"]
        warm = sum(t <= srv["levels"][0][1] for t, _ in srv["history"])
        waits = srv["dispatch_s"][warm:]
        out = {"server_wait": 1e3 * sum(w for w, _ in waits) / len(waits),
               "server_process": 1e3 * sum(p for _, p in waits)
               / len(waits)}
        rows = [r for p in res["parties"].values() for r in p["round_s"][1:]]
        for i, k in enumerate(("prepare", "wait", "apply")):
            out[f"party_{k}"] = 1e3 * sum(r[i] for r in rows) / len(rows)
        return out

    def run(what, crashed=(), **kw):
        zero_launches()
        t0 = time.perf_counter()
        res = run_federation(spec, rounds, cfg=kw.pop("cfg", cfg),
                             device=dev, **kw)
        wall = time.perf_counter() - t0
        parent = read_launches()
        _no_orphans(res, what, crashed)
        devices(res, what)
        if any(parent.values()):
            raise AssertionError(f"runtime {what}: the parent launched "
                                 f"{parent}")
        return res, wall

    # (a) serial TCP against the in-process reference on the card
    res_a, wall_a = run("serial", channel_kind="recording")
    rec = RecordingChannel()
    tr, ref = run_reference(spec, rounds, channel=rec, device=dev)
    h_a = history_losses(res_a)
    if not np.array_equal(h_a, np.asarray([h for _, h in ref.history])):
        raise AssertionError("runtime serial: losses != run_reference")
    ref_like = {"parties": {m: {"final_w": {k: v.cpu().numpy() for k, v in
                                            tr.party_w[m].items()}}
                            for m in range(q)},
                "server": {"w0": {k: v.cpu().numpy()
                                  for k, v in tr.server.w0.items()}}}
    finals_equal(res_a, ref_like, "serial vs run_reference")
    srv = res_a["server"]
    if srv["bytes_by_kind"] != dict(rec.bytes_by_kind) or \
            srv["msgs_by_kind"] != dict(rec.msgs_by_kind):
        raise AssertionError(f"runtime serial: bytes {srv['bytes_by_kind']} "
                             f"msgs {srv['msgs_by_kind']} != "
                             f"{dict(rec.bytes_by_kind)} "
                             f"{dict(rec.msgs_by_kind)}")
    c_up = rounds * q * (batch + 4)
    payload = sum(srv["bytes_by_kind"].values())
    socket_bytes = srv["socket_bytes_in"] + srv["socket_bytes_out"]
    if srv["bytes_by_kind"]["c_up"] != c_up or not socket_bytes > payload:
        raise AssertionError(f"runtime serial: c_up "
                             f"{srv['bytes_by_kind']['c_up']} != {c_up} or "
                             f"socket {socket_bytes} <= payload {payload}")
    if srv["levels"] != serial_levels(srv["history"], q):
        raise AssertionError(f"runtime serial: levels {srv['levels']}")
    ms_a = ms_per_update(srv["levels"], q)
    ms_ref = ms_per_update(serial_levels(ref.history, q), q)
    updates = rounds * q
    log(f"[runtime] serial: {q + 1} processes on {srv['device']}, {updates} "
        f"updates, {wall_a:.2f} s with start-up; {ms_a:.3f} ms per party "
        f"update (in-process run_serial {ms_ref:.3f}); losses {h_a[0]:.4f} "
        f"-> {h_a[-1]:.4f} and final params bitwise run_reference; payload "
        f"{payload} B ({srv['bytes_by_kind']}), socket {socket_bytes} B")
    split_a = split(res_a)
    log(f"[runtime] serial split, host ms: {json.dumps(split_a)}")
    launch_checks.append(("serial", res_a, {m: rounds for m in range(q)}))
    stats["serial"] = {"ms_per_update": ms_a, "inprocess_ms_per_update":
                       ms_ref, "split_ms": split_a, "wall_s": wall_a,
                       "payload_bytes": payload,
                       "socket_bytes": socket_bytes,
                       "socket_bytes_per_update": socket_bytes / updates,
                       "launches_server": srv["launches"],
                       "launches_party0": res_a["parties"][0]["launches"]}

    # (b) party 3 crashes at round 2 and rejoins from its checkpoint
    crash_at = 2
    with tempfile.TemporaryDirectory() as root:
        res_b, wall_b = run("crash", crashed=("fed-party3",),
                            ckpt_root=root, plan=FailurePlan(
            {3: PartyFault(crash_at_round=crash_at, rejoin_delay_s=0.5)}))
    if (res_b["rejoins"], res_b["server"]["disconnects"]) != (1, 1):
        raise AssertionError(f"runtime crash: rejoins {res_b['rejoins']} "
                             f"disconnects {res_b['server']['disconnects']}")
    if not np.array_equal(history_losses(res_b), h_a):
        raise AssertionError("runtime crash: losses != the serial run's")
    finals_equal(res_b, res_a, "crash vs serial")
    if res_b["server"]["bytes_by_kind"] != srv["bytes_by_kind"]:
        raise AssertionError("runtime crash: bytes != the serial run's")
    log(f"[runtime] crash of party 3 at round {crash_at}: rejoins 1, "
        f"disconnects 1, {wall_b:.2f} s; losses and final params bitwise "
        "the serial run's")
    # the respawned party counts its own rounds, from its checkpoint on
    launch_checks.append(("crash", res_b, {m: rounds if m != 3 else
                                           rounds - crash_at
                                           for m in range(q)}))
    stats["crash"] = {"wall_s": wall_b, "rejoins": res_b["rejoins"]}

    # (c) the arrival schedule, tau = 1, party 7 a straggler
    res_c, wall_c = run("arrival", cfg=RuntimeConfig(
        deadline_s=900.0, schedule="arrival", max_staleness=1),
        plan=FailurePlan({q - 1: PartyFault(slow_send_s=0.2)}))
    src = res_c["server"]
    h_c = history_losses(res_c)
    if not (src["parked"] > 0 and src["staleness_max"] <= 1
            and src["processed"] == [rounds] * q
            and len(h_c) == updates and np.isfinite(h_c).all()):
        raise AssertionError(f"runtime arrival: parked {src['parked']}, "
                             f"staleness {src['staleness_max']}, processed "
                             f"{src['processed']}, losses {h_c}")
    if [k for k, _ in src["levels"]] != list(range(1, rounds + 1)):
        raise AssertionError(f"runtime arrival: levels {src['levels']}")
    ms_c = ms_per_update(src["levels"], q)
    log(f"[runtime] arrival, tau 1, party {q - 1} stalls 0.2 s a send: "
        f"{ms_c:.3f} ms per party update (the slowest party's rounds 2 to "
        f"{rounds}), parked {src['parked']}, max staleness "
        f"{src['staleness_max']}, {wall_c:.2f} s")
    split_c = split(res_c)
    log(f"[runtime] arrival split, host ms: {json.dumps(split_c)}")
    launch_checks.append(("arrival", res_c, {m: rounds for m in range(q)}))
    stats["arrival"] = {"ms_per_update": ms_c, "split_ms": split_c,
                        "levels": src["levels"],
                        "wall_s": wall_c,
                        "parked": src["parked"],
                        "staleness_max": src["staleness_max"]}

    for what, res, party_rounds in launch_checks:
        got = res["server"]["launches"]
        want = runtime_launches("server", res["server"]["updates"])
        if got != want:
            raise AssertionError(f"runtime {what}: server launches {got}, "
                                 f"want {want}")
        for m, n in party_rounds.items():
            got = res["parties"][m]["launches"]
            if got != runtime_launches("party", n):
                raise AssertionError(f"runtime {what}: party {m} launches "
                                     f"{got}, want "
                                     f"{runtime_launches('party', n)}")
    log("[runtime] launches exact in every process of the three runs: a "
        f"party round {RUNTIME_PARTY_ROUND}, a server update "
        f"{RUNTIME_SERVER_UPDATE}, plus {RUNTIME_DATA_DRAWS} data draws and "
        f"the initial weights' {RUNTIME_INIT_DRAWS}")
    stats["launches_total"] = {
        name: sum(r["server"]["launches"][name]
                  + sum(p["launches"][name] for p in r["parties"].values())
                  for _, r, _ in launch_checks)
        for name in RUNTIME_PARTY_ROUND}
    # the untraced runs the traced phase is held to
    twins = {"serial": res_a, "reference": (tr, ref, rec),
             "ms_per_update": ms_a, "inprocess_ms_per_update": ms_ref}
    return stats, twins


# ------------------------------------------------------------ serving phase --

# the runtime phase's D7 FCN without DP (serving refuses a defended
# exchange): fused int8, 8 parties x 98 features, n = 60000
SERVING_SPEC = {**RUNTIME_SPEC, "vfl": {k: v for k, v in
                                        RUNTIME_SPEC["vfl"].items()
                                        if k != "dp"}}
SERVING_REQUESTS = 2048
SERVING_REPEAT = 512
SERVING_CKPT_STEP = 10
SERVING_SLOTS = (8, 64)


def serving_launches(role, answers, q=1):
    """Exact launches of serving: a party process ('party') makes one
    keyless defended_encode per answer it sends (one c_up a step it is
    queried in) plus the data draws and its block's 2 initial draws (the
    tree a checkpoint restores into); the TCP front end ('front') only
    the data draws and w0's; the in-memory engine ('memory') all of it
    for its q parties, every answer of every party in ``answers``. The
    one-row forwards and reduces are plain products: no other kernel."""
    want = {name: 0 for name in RUNTIME_PARTY_ROUND}
    init = {"party": RUNTIME_INIT_DRAWS["party"],
            "front": RUNTIME_INIT_DRAWS["server"],
            "memory": q * RUNTIME_INIT_DRAWS["party"]
            + RUNTIME_INIT_DRAWS["server"]}[role]
    want["defended_encode"] = answers if role != "front" else 0
    want["prng_draw"] = RUNTIME_DATA_DRAWS + init
    return want


def serving_engine(spec, dev, ckpt_root, slots, channel=None):
    """The in-memory serving engine as ``run_tcp_serving`` builds its
    parties and front end: the problem on ``dev``, each party's block
    restored from ``<ckpt_root>/party<m>`` into its seed-initialized tree
    (its step the version), w0 from the seed."""
    import os

    from repro_torch.checkpoint import latest_step, restore_checkpoint
    from repro_torch.core import async_host
    from repro_torch.runtime.problem import build_problem
    from repro_torch.serving.federated import FederatedServingEngine

    prob = build_problem(spec, dev)
    model, q = prob.model, prob.model.num_parties
    server_key, party_keys, _ = async_host.trainer_keys(prob.seed, q)
    blocks, versions = [], []
    for m in range(q):
        d = os.path.join(ckpt_root, f"party{m}")
        step = latest_step(d)
        w, _ = restore_checkpoint(d, model.init_party(party_keys[m], m, dev),
                                  step)
        blocks.append(w)
        versions.append(step)
    return FederatedServingEngine.from_problem(
        prob, channel=channel, slots=slots, party_params=blocks,
        w0=model.init_server(server_key, dev), versions=versions)


def serve(engine, ids, first_rid=0):
    """Submit ``ids`` and run the engine; returns the host seconds of the
    run, which ends with the predictions on the host."""
    from repro_torch.serving.federated import ServeRequest
    for i, sid in enumerate(ids):
        engine.submit(ServeRequest(rid=first_rid + i, sample_id=int(sid)))
    t0 = time.perf_counter()
    engine.run()
    return time.perf_counter() - t0


def payload_bits_equal(a, b) -> bool:
    """Two host wire payloads (numpy arrays, or the int8 codec's pair)
    equal bit for bit."""
    import numpy as np
    if isinstance(a, tuple):
        return len(a) == len(b) and all(payload_bits_equal(x, y)
                                        for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def predictions(engine, first_rid=0):
    return [r.prediction for r in sorted(engine.completed,
                                         key=lambda r: r.rid)
            if r.rid >= first_rid]


def serving_phase(dev, blocks):
    """Federated serving on the D7 FCN at full width (module docstring,
    phase 9): ``blocks`` are saved as step-10 checkpoints of the 8
    parties, which every run serves; returns its numbers."""
    import tempfile

    import numpy as np
    spec, q = SERVING_SPEC, SERVING_SPEC["parties"]
    ids = np.random.default_rng(0).integers(0, spec["samples"],
                                            SERVING_REQUESTS)
    with tempfile.TemporaryDirectory() as root:
        return _serving_runs(dev, blocks, spec, q, ids, root)


def _serving_runs(dev, blocks, spec, q, ids, root):
    import os

    import numpy as np
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import RuntimeConfig
    from repro_torch.core.comms import serving_bytes_per_prediction
    from repro_torch.core.privacy import serving_exposure_from_transcript
    from repro_torch.core.wire import RecordingChannel
    from repro_torch.launch import train
    from repro_torch.runtime.problem import build_problem
    from repro_torch.runtime.serving import run_tcp_serving
    from repro_torch.serving.federated import FederatedServingEngine

    stats = {}
    for m, w in enumerate(blocks):
        save_checkpoint(os.path.join(root, f"party{m}"), SERVING_CKPT_STEP,
                        w, {"party": m})

    # (a) in memory, slots 8 and 64, each with the counters zeroed just
    # before and read just after
    runs = {}
    for slots in SERVING_SLOTS:
        zero_launches()
        rec = RecordingChannel()
        eng = serving_engine(spec, dev, root, slots, channel=rec)
        wall = serve(eng, ids)
        launches = read_launches()
        eng.validate_wire()
        met = eng.metrics()
        issued = rec.msgs_by_kind["c_up"]
        want = serving_launches("memory", issued, q)
        if launches != want or rec.msgs_by_kind["serve_down"] != issued:
            raise AssertionError(f"serving slots {slots}: launches "
                                 f"{launches}, want {want} ({issued} c_up)")
        analytic = sum(eng._analytic.values())
        if met["wire_bytes"] != analytic or met["served"] != len(ids):
            raise AssertionError(f"serving slots {slots}: {met}")
        preds = predictions(eng)
        if not all(isinstance(p, int) and 0 <= p < spec["classes"]
                   for p in preds):
            raise AssertionError(f"serving slots {slots}: predictions "
                                 f"{preds[:8]}")
        runs[slots] = (eng, rec, preds)
        stats[f"memory_slots{slots}"] = {
            "wall_s": wall, "predictions_per_s": len(ids) / wall,
            "steps": met["steps"], "c_up_messages": issued,
            "step_split_s": dict(eng.step_s),
            "bytes_per_prediction": met["bytes_per_prediction"],
            "full_batch_formula": serving_bytes_per_prediction(slots, q,
                                                               "int8"),
            "launches": launches}
        log(f"[serve] memory, slots {slots}: {len(ids)} predictions in "
            f"{wall:.3f} s ({len(ids) / wall:.1f}/s, host clock), "
            f"{met['steps']} steps, {issued} c_up, split "
            f"{ {k: round(v, 4) for k, v in eng.step_s.items()} } s, "
            f"{met['bytes_per_prediction']:.2f} B/prediction "
            f"(= analytic), launches {launches}")

    # (b) a second pass over 512 of the ids: all answers from the cache
    eng, rec, _ = runs[8]
    hits0, down0 = eng.metrics()["cache_hits"], rec.msgs_by_kind["serve_down"]
    zero_launches()
    serve(eng, ids[:SERVING_REPEAT], first_rid=len(ids))
    again = read_launches()
    hits = eng.metrics()["cache_hits"] - hits0
    if hits != q * SERVING_REPEAT or \
            rec.msgs_by_kind["serve_down"] != down0 or any(again.values()):
        raise AssertionError(f"serving repeat: {hits} hits, serve_down "
                             f"{rec.msgs_by_kind['serve_down']} != {down0}, "
                             f"launches {again}")
    if predictions(eng, len(ids)) != runs[8][2][:SERVING_REPEAT]:
        raise AssertionError("serving repeat: cached predictions differ")
    eng.validate_wire()
    log(f"[serve] second pass over {SERVING_REPEAT} ids: {hits} hits "
        f"({q} x {SERVING_REPEAT}), no serve_down, no launch")
    exposure = serving_exposure_from_transcript(rec.transcript)
    if not (exposure["serve_query_ids"] and exposure["function_values"]
            and not exposure["intermediate_grads"]
            and not exposure["model_params"]
            and exposure["messages"]["c_up"]
            == exposure["messages"]["serve_down"]):
        raise AssertionError(f"serving exposure {exposure}")
    log(f"[serve] exposure of the slots-8 transcript: {exposure}")

    # (c) fused int8 == unfused int8, and slots 64 == slots 1 in f32
    unfused = {**spec, "vfl": {**spec["vfl"], "fused": False}}
    eng_u = serving_engine(unfused, dev, root, 64, channel=RecordingChannel())
    serve(eng_u, ids[:SERVING_REPEAT])
    if predictions(eng_u) != runs[64][2][:SERVING_REPEAT] or not all(
            payload_bits_equal(a.payload, b.payload) for a, b in
            zip(eng_u.channel.transcript, runs[64][1].transcript)):
        raise AssertionError("serving: fused int8 != unfused int8")
    f32 = {**spec, "vfl": {**unfused["vfl"], "codec": "f32"}}
    few = ids[:SERVING_REPEAT // 2]
    e64, e1 = (serving_engine(f32, dev, root, s) for s in (64, 1))
    serve(e64, few)
    serve(e1, few)
    if predictions(e64) != predictions(e1) or any(
            dict(a._d) != dict(b._d) for a, b in zip(e64.caches, e1.caches)):
        raise AssertionError("serving f32: slots 64 != slots 1")
    log(f"[serve] fused int8 bitwise unfused (predictions and payloads, "
        f"{SERVING_REPEAT} requests at slots 64); f32 slots 64 bitwise slots 1 "
        f"(predictions and cached values, {len(few)} requests)")

    # (d) the card against the CPU on a small problem
    small = {"kind": "fcn", "parties": 4, "features": 32, "classes": 10,
             "samples": 256, "batch": 16, "seed": 0,
             "vfl": {"mu": 5e-2, "codec": "int8", "fused": True}}
    small_ids = np.random.default_rng(1).integers(0, 256, 64)
    got = []
    for d in (dev, "cpu"):
        e = FederatedServingEngine.from_problem(build_problem(small, d),
                                                slots=8)
        serve(e, small_ids)
        got.append(predictions(e))
    if got[0] != got[1]:
        raise AssertionError(f"serving card vs CPU: {got}")
    log("[serve] card vs CPU, small fused int8 FCN, 64 requests: "
        "predictions equal")

    # (e) TCP: 8 serving party processes on the card, slots 64
    zero_launches()
    res = run_tcp_serving(spec, ids, cfg=RuntimeConfig(deadline_s=600.0),
                          slots=64, ckpt_root=root, device=dev)
    parent = read_launches()
    _no_orphans(res, "serving")
    if [p for _, p in res["predictions"]] != runs[64][2]:
        raise AssertionError("serving TCP != the in-memory engine")
    if res["analytic"] != runs[64][0]._analytic:
        raise AssertionError(f"serving TCP bytes {res['analytic']}")
    if parent != serving_launches("front", 0):
        raise AssertionError(f"serving front end launches {parent}")
    for m, p in res["parties"].items():
        want = serving_launches("party", p["msgs_by_kind"]["c_up"])
        if p["device"].split(":")[0] != dev.type or p["launches"] != want \
                or p["version"] != SERVING_CKPT_STEP or p["aborted"]:
            raise AssertionError(f"serving party {m}: {p['device']} "
                                 f"launches {p['launches']}, want {want}, "
                                 f"version {p['version']}")
    tcp_s = sum(res["step_s"].values())
    sock = sum(p["socket_bytes_in"] + p["socket_bytes_out"]
               for p in res["parties"].values())
    met = res["metrics"]
    stats["tcp_slots64"] = {
        "engine_s": tcp_s, "predictions_per_s": len(ids) / tcp_s,
        "step_split_s": res["step_s"],
        "bytes_per_prediction": met["bytes_per_prediction"],
        "socket_bytes_per_prediction": sock / len(ids),
        "party_answer_s": [res["parties"][m]["answer_s"] for m in range(q)],
        "launches_party0": res["parties"][0]["launches"]}
    log(f"[serve] TCP, {q} party processes on {res['parties'][0]['device']}"
        f", slots 64: predictions bitwise the in-memory engine's; "
        f"{len(ids) / tcp_s:.1f} predictions/s over the engine's steps "
        f"({tcp_s:.3f} s; split "
        f"{ {k: round(v, 4) for k, v in res['step_s'].items()} }); "
        f"{met['bytes_per_prediction']:.2f} payload B/prediction, "
        f"{sock / len(ids):.1f} socket B/prediction; launches exact in "
        "every process; every process exited with 0")

    # (f) the launcher: memory priced on 'wan', and its tcp twin
    argv = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--parties", "4",
            "--serve", "64", "--serve-batch", "8"]
    wan = train.main(argv + ["--network", "wan"])
    tcp = train.main(argv + ["--transport", "tcp"])
    if (wan["served"], tcp["served"]) != (64.0, 64.0):
        raise AssertionError(f"launcher --serve: {wan} {tcp}")
    import multiprocessing
    if multiprocessing.active_children():
        raise AssertionError("launcher --serve tcp left processes")
    stats["launcher_wan"] = {k: wan[k] for k in (
        "wire_s", "p50_s", "p99_s", "requests_per_s",
        "bytes_per_prediction")}
    log(f"[serve] launcher --serve 64 --serve-batch 8: memory on the "
        f"simulated 'wan' wire: wire_s {wan['wire_s']:.4f} s, p50 "
        f"{wan['p50_s']:.4f} s, p99 {wan['p99_s']:.4f} s (the simulated "
        f"wire's clock, not the card's), {wan['bytes_per_prediction']} "
        f"B/prediction; --transport tcp served {tcp['served']:.0f} on "
        f"{tcp['device']}")
    return stats


# ------------------------------------------------------------- traced phase --

# the spans whose p50 and p99 the phase prints, and the requests of its
# traced TCP serving run (4 steps at slots 64)
TRACED_SPANS = ("server_process", "server_handle", "party_prepare",
                "party_round", "party_wait_reply")
TRACED_SERVE_REQUESTS = 256


def pct(xs, q):
    """The q-quantile of xs as the reference's collector takes it (the
    element at round(q (n - 1)) of the sorted values)."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def span_table(recs):
    """p50 and p99, ms, of each of TRACED_SPANS in a merged trace, over
    the rounds after each party's first (start-up excluded; a
    ``party_prepare`` carries no round, so all of them)."""
    out = {}
    for name in TRACED_SPANS:
        ds = [r["dur"] * 1e3 for r in recs if r["ev"] == "span"
              and r["name"] == name and r.get("round", 1) >= 1]
        if ds:
            out[name] = {"n": len(ds), "p50": pct(ds, 0.5),
                         "p99": pct(ds, 0.99)}
    return out


def process_split(recs):
    """``server_process`` split by the ``server_handle`` span inside it
    (the same process, party and round): observe (admission and the
    up-link's decode into Messages, up to the handle), handle (decode, the
    server's step, ``float(h)``, the reply's channel send) and send (the
    reply onto the socket, the cache, a snapshot), ms, p50 and mean over
    the rounds after each party's first."""
    handles = {(r["pid"], r["party"], r["round"]): r for r in recs
               if r["ev"] == "span" and r["name"] == "server_handle"}
    rows = []
    for r in recs:
        if r["ev"] == "span" and r["name"] == "server_process" \
                and r["round"] >= 1:
            h = handles[(r["pid"], r["party"], r["round"])]
            rows.append((h["ts"] - r["ts"], h["dur"],
                         r["ts"] + r["dur"] - h["ts"] - h["dur"]))
    return {k: {"p50": pct([x[i] * 1e3 for x in rows], 0.5),
                "mean": 1e3 * sum(x[i] for x in rows) / len(rows)}
            for i, k in enumerate(("observe", "handle", "send"))}


def sent_bytes(recs, observed=False):
    """Bytes by kind of a merged trace's wire records, send side (or the
    receivers' observed side)."""
    out = {}
    for r in recs:
        if r["ev"] == "wire" and bool(r["observed"]) == observed:
            out[r["kind"]] = out.get(r["kind"], 0) + r["nbytes"]
    return out


def traced_phase(dev, twins, blocks, spec=RUNTIME_SPEC,
                 rounds=RUNTIME_ROUNDS, serving_spec=SERVING_SPEC):
    """The federation traced through repro_torch/obs on the card (module
    docstring, phase 11): ``run_reference`` in this process, traced; the
    serial TCP federation, traced and monitored; TCP serving, traced and
    monitored. Each is held to its untraced twin bit for bit (``twins``,
    from the runtime phase on the same ``spec`` and ``rounds``; the
    serving phase's ``blocks``), with exact launches in every process;
    returns the phase's numbers."""
    import tempfile
    with tempfile.TemporaryDirectory() as root:
        return _traced_runs(dev, twins, blocks, root, spec, rounds,
                            serving_spec)


def _traced_runs(dev, twins, blocks, root, spec, rounds, serving_spec):
    import os

    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import RuntimeConfig
    from repro_torch.core.wire import RecordingChannel
    from repro_torch.obs.collect import chain_completeness, load_dir_stats
    from repro_torch.runtime import (history_losses, ms_per_update,
                                     run_federation, run_reference,
                                     serial_levels)
    from repro_torch.runtime.serving import run_tcp_serving

    q, batch = spec["parties"], spec["batch"]
    analytic = {"c_up": rounds * q * (batch + 4),
                "c_hat_up": rounds * q * (batch + 4),
                "loss_down": rounds * q * 8}
    stats = {}

    def merged(d, what, chains):
        recs, st = load_dir_stats(d)
        if st["dropped_lines"] or not recs:
            raise AssertionError(f"traced {what}: merge {st}")
        if chains is not None and \
                chain_completeness(recs) != (chains, chains, 1.0):
            raise AssertionError(f"traced {what}: chains "
                                 f"{chain_completeness(recs)}")
        return recs

    # (a) run_reference in this process, traced, against the runtime
    # phase's untraced run_reference
    tr0, ref0, rec0 = twins["reference"]
    d = os.path.join(root, "memory")
    rec = RecordingChannel()
    zero_launches()
    obs.configure(d, role="main")
    try:
        t0 = time.perf_counter()
        tr, ref = run_reference(spec, rounds, channel=rec, device=dev)
        wall = time.perf_counter() - t0
    finally:
        obs.configure(None)
    launches = read_launches()
    want = {k: v * rounds * q for k, v in D7_FUSED_ROUND.items()}
    want["prng_draw"] += fcn_init_draws(q) + RUNTIME_DATA_DRAWS
    if launches != want:
        raise AssertionError(f"traced memory: launches {launches}, want "
                             f"{want}")
    if [h for _, h in ref.history] != [h for _, h in ref0.history] or \
            dict(rec.bytes_by_kind) != dict(rec0.bytes_by_kind) or \
            len(rec.transcript) != len(rec0.transcript) or not all(
                payload_bits_equal(a.payload, b.payload)
                for a, b in zip(rec.transcript, rec0.transcript)):
        raise AssertionError("traced memory: != the untraced run_reference")
    for m in range(q):
        for k, v in tr.party_w[m].items():
            if not torch.equal(v, tr0.party_w[m][k]):
                raise AssertionError(f"traced memory: party {m} {k}")
    for k, v in tr.server.w0.items():
        if not torch.equal(v, tr0.server.w0[k]):
            raise AssertionError(f"traced memory: server {k}")
    recs = merged(d, "memory", rounds * q)
    if sent_bytes(recs) != analytic:
        raise AssertionError(f"traced memory: wire {sent_bytes(recs)}, "
                             f"want {analytic}")
    ms_t = ms_per_update(serial_levels(ref.history, q), q)
    ms_u = twins["inprocess_ms_per_update"]
    stats["memory"] = {"wall_s": wall, "ms_per_update": ms_t,
                       "untraced_ms_per_update": ms_u,
                       "overhead": ms_t / ms_u - 1,
                       "records": len(recs), "spans_ms": span_table(recs)}
    log(f"[traced] memory: run_reference traced, {rounds * q} updates, "
        f"bitwise the untraced run (losses, params, payloads), launches "
        f"exact, chains {rounds * q}/{rounds * q}, wire records = analytic "
        f"{analytic}; {ms_t:.3f} ms per party update traced, {ms_u:.3f} "
        f"untraced ({100 * (ms_t / ms_u - 1):+.1f}%), {len(recs)} records")
    log(f"[traced] memory spans, ms: {json.dumps(span_table(recs))}")

    # (b) the serial TCP federation traced and monitored, against the
    # runtime phase's untraced serial run
    res0 = twins["serial"]
    d = os.path.join(root, "tcp")
    zero_launches()
    t0 = time.perf_counter()
    res = run_federation(spec, rounds, cfg=RuntimeConfig(
        deadline_s=900.0, trace_dir=d, monitor=True),
        channel_kind="recording", device=dev)
    wall = time.perf_counter() - t0
    parent = read_launches()
    _no_orphans(res, "traced")
    if any(parent.values()):
        raise AssertionError(f"traced tcp: the parent launched {parent}")
    srv, srv0 = res["server"], res0["server"]
    if not np.array_equal(history_losses(res), history_losses(res0)) or \
            any(srv[k] != srv0[k] for k in (
                "bytes_by_kind", "msgs_by_kind", "socket_bytes_in",
                "socket_bytes_out")):
        raise AssertionError("traced tcp: != the untraced serial run")
    for m in range(q):
        for k, v in res["parties"][m]["final_w"].items():
            if not np.array_equal(v.view(np.int32), res0["parties"][m][
                    "final_w"][k].view(np.int32)):
                raise AssertionError(f"traced tcp: party {m} {k}")
    for k, v in srv["w0"].items():
        if not np.array_equal(v.view(np.int32),
                              srv0["w0"][k].view(np.int32)):
            raise AssertionError(f"traced tcp: server {k}")
    if srv["launches"] != runtime_launches("server", srv["updates"]) or \
            any(p["launches"] != runtime_launches("party", rounds)
                for p in res["parties"].values()):
        raise AssertionError(
            f"traced tcp: launches {srv['launches']}, "
            f"{[p['launches'] for p in res['parties'].values()]}")
    mon = res["monitor"]
    if mon["alerts"] or mon["flight_files"] or not mon["records"]:
        raise AssertionError(f"traced tcp: monitor {mon}")
    recs = merged(d, "tcp", rounds * q)
    if not (sent_bytes(recs) == sent_bytes(recs, observed=True) == analytic
            == srv["bytes_by_kind"]):
        raise AssertionError(f"traced tcp: wire {sent_bytes(recs)}, "
                             f"observed {sent_bytes(recs, observed=True)}, "
                             f"want {analytic}")
    ms_t = ms_per_update(srv["levels"], q)
    ms_u = twins["ms_per_update"]
    split = process_split(recs)
    stats["tcp"] = {"wall_s": wall, "ms_per_update": ms_t,
                    "untraced_ms_per_update": ms_u,
                    "overhead": ms_t / ms_u - 1,
                    "monitor_records": mon["records"],
                    "records": len(recs), "spans_ms": span_table(recs),
                    "server_process_split_ms": split}
    log(f"[traced] tcp serial, traced and monitored: {q + 1} processes, "
        f"bitwise the untraced run (losses, params, bytes, socket bytes), "
        f"launches exact in every process, no alert, every process exited "
        f"with 0, chains {rounds * q}/{rounds * q}, wire records = analytic "
        f"on both sides; {ms_t:.3f} ms per party update traced, "
        f"{ms_u:.3f} untraced ({100 * (ms_t / ms_u - 1):+.1f}%), "
        f"{wall:.2f} s with start-up")
    log(f"[traced] tcp spans, ms: {json.dumps(span_table(recs))}")
    log(f"[traced] tcp server_process split, ms: {json.dumps(split)}")

    # (c) TCP serving traced and monitored (the front end is this
    # process), against the in-memory engine on the same blocks
    for m, w in enumerate(blocks):
        save_checkpoint(os.path.join(root, "ckpt", f"party{m}"),
                        SERVING_CKPT_STEP, w, {"party": m})
    ids = np.random.default_rng(0).integers(0, serving_spec["samples"],
                                            TRACED_SERVE_REQUESTS)
    eng = serving_engine(serving_spec, dev, os.path.join(root, "ckpt"), 64)
    serve(eng, ids)
    d = os.path.join(root, "serve")
    zero_launches()
    obs.configure(d, role="front")
    try:
        t0 = time.perf_counter()
        res = run_tcp_serving(serving_spec, ids, cfg=RuntimeConfig(
            deadline_s=600.0, trace_dir=d, monitor=True), slots=64,
            ckpt_root=os.path.join(root, "ckpt"), device=dev)
        wall = time.perf_counter() - t0
    finally:
        obs.configure(None)
    parent = read_launches()
    _no_orphans(res, "traced serving")
    if [p for _, p in res["predictions"]] != predictions(eng):
        raise AssertionError("traced serving: != the in-memory engine")
    if parent != serving_launches("front", 0) or any(
            p["launches"] != serving_launches("party",
                                              p["msgs_by_kind"]["c_up"])
            for p in res["parties"].values()):
        raise AssertionError(f"traced serving: launches {parent}")
    if res["monitor"]["alerts"] or res["monitor"]["flight_files"]:
        raise AssertionError(f"traced serving: monitor {res['monitor']}")
    recs = merged(d, "serving", None)
    spans = {}
    for r in recs:
        if r["ev"] == "span":
            spans.setdefault(r["name"], []).append(r["dur"] * 1e3)
    if len(spans.get("serve_answer", ())) != \
            res["channel"].msgs_by_kind["c_up"] or \
            len(spans.get("serve_step", ())) != res["metrics"]["steps"]:
        raise AssertionError(f"traced serving: spans "
                             f"{ {k: len(v) for k, v in spans.items()} }")
    stats["serving"] = {"wall_s": wall, "requests": len(ids),
                        "steps": res["metrics"]["steps"],
                        "spans_ms": {k: {"n": len(v), "p50": pct(v, 0.5),
                                         "p99": pct(v, 0.99)}
                                     for k, v in spans.items()}}
    log(f"[traced] tcp serving, traced and monitored: {len(ids)} requests "
        f"at slots 64, predictions bitwise the in-memory engine, launches "
        f"exact in every process, no alert; spans, ms: "
        f"{json.dumps(stats['serving']['spans_ms'])}; {wall:.2f} s")
    return stats


# -------------------------------------------------------------- audit phase --

# benchmarks/bench_privacy.py's setup: the paper LR over Q parties of D
# features (make_classification's N samples, its seed 3), BATCH, ROUNDS
PRIVACY_Q, PRIVACY_D, PRIVACY_N, PRIVACY_BATCH, PRIVACY_ROUNDS = \
    4, 32, 256, 32, 24
BACKDOOR_KEYS = 20
TIG_ROUNDS = 10


def privacy_setup():
    """bench_privacy's model, VFL settings, padded features and labels."""
    import torch
    from repro_torch.configs import PaperLRConfig, VFLConfig
    from repro_torch.core.vfl import PaperLRModel, pad_features
    from repro_torch.data.synthetic import make_classification
    q, d = PRIVACY_Q, PRIVACY_D
    X, y = make_classification(PRIVACY_N, d, seed=3)
    model = PaperLRModel(PaperLRConfig(num_features=d, num_parties=q))
    vfl = VFLConfig(num_parties=q, mu=1e-3, lr_party=5e-2,
                    lr_server=5e-2 / q)
    return model, vfl, pad_features(torch.from_numpy(X), d, q).numpy(), y


def record_transcripts(device, seed=0):
    """bench_privacy's ``record_transcripts`` on the port, on ``device``:
    one (data, seed) pair, the ZOO-VFL host executor and the TIG one (its
    'full' sampler: successive rounds revisit the same aligned samples),
    two transcripts."""
    from repro_torch.core.async_host import HostAsyncTrainer
    from repro_torch.core.tig import HostTIGTrainer
    from repro_torch.core.wire import RecordingChannel
    model, vfl, Xp, y = privacy_setup()
    rec_zoo, rec_tig = RecordingChannel(), RecordingChannel()
    HostAsyncTrainer(model, vfl, Xp, y, batch_size=PRIVACY_BATCH,
                     compute_cost_s=0.0, seed=seed, channel=rec_zoo,
                     device=device).run_serial(rounds=PRIVACY_ROUNDS)
    HostTIGTrainer(model, vfl, Xp, y, batch_size=PRIVACY_BATCH, seed=seed,
                   channel=rec_tig, sampler="full",
                   device=device).run(rounds=PRIVACY_ROUNDS)
    return rec_zoo.transcript, rec_tig.transcript, y


def record_aligned_zoo(device, seed=0, rounds=4):
    """bench_privacy's ``record_aligned_zoo`` on the port: ZOO-VFL rounds
    of party 0 on a FIXED aligned batch, the colluding RMA adversary's
    ideal observation pattern."""
    import numpy as np
    from repro_torch.core.async_host import HostAsyncTrainer
    from repro_torch.core.wire import RecordingChannel
    from repro_torch.utils import prng
    model, vfl, Xp, y = privacy_setup()
    rec = RecordingChannel()
    tr = HostAsyncTrainer(model, vfl, Xp, y, batch_size=PRIVACY_BATCH,
                          compute_cost_s=0.0, seed=seed, channel=rec,
                          device=device)
    for r in range(rounds):
        tr.party_step(0, np.arange(PRIVACY_BATCH), prng.key(r))
    return rec.transcript


def audit_numbers(privacy, t_zoo, t_tig, t_aligned, y, keys):
    """bench_privacy's Theorem-1 numbers from recorded transcripts, through
    ``privacy`` (the port's core/privacy.py, or any module with its
    functions); ``keys`` are the backdoor replay's BACKDOOR_KEYS keys."""
    import numpy as np
    rng = np.random.default_rng(0)
    d, n, T = 8, 6, 32
    x_true = rng.normal(size=(n, d))
    ws = [rng.normal(size=(d,)) for _ in range(T)]
    zs = [w @ x_true.T for w in ws]
    rma_tig = privacy.reverse_multiplication_from_transcript(
        t_tig, eta=5e-2, colluders=(0, 1))
    rma_zoo = privacy.reverse_multiplication_from_transcript(
        t_aligned, eta=5e-2, colluders=(0, 1))
    backdoor = [privacy.replay_backdoor_attack(
        t_zoo, lr=5e-2, mu=1e-3, w_dim=4096, key=k) for k in keys]
    return {
        "msgs": {"zoo": len(t_zoo), "tig": len(t_tig)},
        "kinds": {"zoo": sorted(t_zoo.kinds()), "tig": sorted(t_tig.kinds())},
        "feature_inference": privacy.feature_inference_from_transcript(
            t_zoo, x_dim=PRIVACY_D // PRIVACY_Q),
        "param_leak_recovery_err": privacy.feature_inference_with_grads(
            ws, zs, x_true),
        "label_tig": privacy.label_inference_attack(t_tig, y, m=0),
        "label_zoo": privacy.label_inference_attack(t_zoo, y, m=0),
        "uploads_zoo": privacy.label_inference_from_uploads(t_zoo, y),
        "rma_tig": {k: rma_tig.get(k) for k in ("feasible", "round",
                                                 "reason")},
        "rma_tig_recovered": rma_tig.get("recovered"),
        "rma_zoo": {k: rma_zoo.get(k) for k in ("feasible", "reason")},
        "backdoor_tig": privacy.replay_backdoor_attack(
            t_tig, lr=5e-2, mu=1e-3, w_dim=4096),
        "backdoor_zoo": backdoor,
        "exposure": {"zoo": privacy.exposure_from_transcript(t_zoo),
                     "tig": privacy.exposure_from_transcript(t_tig)},
        "exposure_report": {f: privacy.exposure_report(f)
                            for f in ("zoo-vfl", "tig", "tg")},
    }


def audits_agree(a, b, rtol) -> bool:
    """Two runs of ``audit_numbers``: accuracies, counts, kinds, flags and
    reasons exact; the recovered RMA features, the backdoor's cosines and
    deviation norms within ``rtol``. The deviation scales with the
    difference of two recorded losses over mu, so it carries their float
    order's ulps divided by mu; the cosine does not depend on its scale."""
    import numpy as np
    exact = ("msgs", "kinds", "feature_inference", "label_tig", "label_zoo",
             "uploads_zoo", "rma_tig", "rma_zoo", "backdoor_tig",
             "exposure", "exposure_report")
    if any(a[k] != b[k] for k in exact):
        return False
    if not np.allclose(a["rma_tig_recovered"], b["rma_tig_recovered"],
                       rtol=rtol, atol=rtol):
        return False
    return len(a["backdoor_zoo"]) == len(b["backdoor_zoo"]) and all(
        x["observable"] == y["observable"]
        and x["direction_control"] == y["direction_control"]
        and abs(x["cos_to_target"] - y["cos_to_target"]) <= 1e-5
        and abs(x["deviation_norm"] - y["deviation_norm"])
        <= rtol * abs(y["deviation_norm"])
        for x, y in zip(a["backdoor_zoo"], b["backdoor_zoo"]))


def audit_phase(dev, serial_ms):
    """bench_privacy's audits on transcripts recorded on the card, against
    the same audits on the CPU port's; then the TIG baseline on the D7 FCN
    at full width (module docstring, phase 10)."""
    import numpy as np
    import torch
    from repro_torch.configs import PaperFCNConfig, VFLConfig
    from repro_torch.core import privacy
    from repro_torch.core.tig import HostTIGTrainer
    from repro_torch.core.vfl import PaperFCNModel
    from repro_torch.core.wire import RecordingChannel
    from repro_torch.utils import prng

    keys = [prng.key(s) for s in range(BACKDOOR_KEYS)]
    numbers = {}
    for d in (dev, "cpu"):
        t_zoo, t_tig, y = record_transcripts(d)
        numbers[str(d)] = audit_numbers(privacy, t_zoo, t_tig,
                                        record_aligned_zoo(d), y, keys)
    card, cpu = numbers[str(dev)], numbers["cpu"]
    # the card's f32 sums differ from the CPU's by ulps, which 24 ZOO
    # rounds at mu 1e-3 grow to ~1e-5 of a loss (PERF.md §2)
    if not audits_agree(card, cpu, rtol=1e-3):
        raise AssertionError(f"audits on the card {card} != the CPU's {cpu}")
    fi = card["feature_inference"]
    summary = {
        "tig_acc": card["label_tig"]["accuracy"],
        "zoo_acc": card["label_zoo"]["accuracy"],
        "zoo_ratio": fi["ratio"], "zoo_solvable": fi["solvable"],
        "param_leak_recovery_err": card["param_leak_recovery_err"],
        "rma_tig_feasible": card["rma_tig"]["feasible"],
        "rma_zoo_feasible": card["rma_zoo"]["feasible"],
        "rma_zoo_reason": card["rma_zoo"]["reason"],
        "zoo_mean_cos_target": float(np.mean(
            [b["cos_to_target"] for b in card["backdoor_zoo"]])),
        "tig_direction_control": card["backdoor_tig"]["direction_control"]}
    if not (summary["tig_acc"] == 1.0 and summary["zoo_acc"] == 0.5
            and round(fi["ratio"], 3) == 0.358 and not fi["solvable"]
            and summary["param_leak_recovery_err"] < 1e-9
            and summary["rma_tig_feasible"]
            and not summary["rma_zoo_feasible"]):
        raise AssertionError(f"audits: {summary}")
    log(f"[audit] transcripts recorded on the card, the same numbers as the "
        f"CPU port's: {json.dumps(summary)}")

    # TIG at D7 width: 8 parties x 98 features, batch 2048
    q, batch = 8, 2048
    Xp, y, spec, _ = d7_data(q)
    model = PaperFCNModel(PaperFCNConfig(num_features=spec.d,
                                         num_classes=spec.classes,
                                         num_parties=q))
    rec = RecordingChannel()
    zero_launches()
    tr = HostTIGTrainer(model, VFLConfig(num_parties=q, lr_party=2e-2,
                                         lr_server=1e-2),
                        Xp, y, batch_size=batch, seed=0, channel=rec,
                        device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = tr.run(TIG_ROUNDS)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3 / (TIG_ROUNDS * q)
    launches = read_launches()
    first, last = float(np.mean(losses[:q])), float(np.mean(losses[-q:]))
    updates = TIG_ROUNDS * q
    if len(losses) != updates or not all(math.isfinite(h) for h in losses) \
            or not last < first:
        raise AssertionError(f"TIG D7 losses {losses}")
    if rec.bytes_by_kind != {"c_up": updates * batch * 4,
                             "grad_down": updates * batch * 4,
                             "loss_down": updates * 4}:
        raise AssertionError(f"TIG D7 bytes {rec.bytes_by_kind}")
    want = {name: 0 for name in RUNTIME_PARTY_ROUND}
    want["prng_draw"] = fcn_init_draws(q)
    if launches != want:
        raise AssertionError(f"TIG D7 launches {launches}, want {want}")
    log(f"[audit] TIG on the D7 FCN, {updates} party rounds of batch "
        f"{batch}: loss {first:.4f} -> {last:.4f}, {ms:.3f} ms per TIG "
        f"round (the fused defended ZOO round: {serial_ms:.3f} ms), "
        f"grad_down {batch * 4} B a round, launches {launches}")
    return {"audits": summary, "tig_ms_per_round": ms,
            "zoo_ms_per_round": serial_ms, "tig_loss_first": first,
            "tig_loss_last": last, "tig_launches": launches}

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
    zoo_resume_check()
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


def zoo_resume_check():
    """The reduced vfl-zoo run on the card: 2 steps with ``--ckpt-dir``,
    then ``--resume`` for 2 more, bitwise 4 straight steps (h and the
    saved state: w0, the party blocks and the delay ring buffer)."""
    import tempfile

    import numpy as np
    from repro_torch.launch import train

    argv = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
            "--parties", "4", "--batch-size", "4", "--seq-len", "128",
            "--fused", "--codec", "int8", "--lr", "1e-2", "--log-every",
            "100"]
    with tempfile.TemporaryDirectory() as root:
        a, c = f"{root}/a", f"{root}/c"
        h = train.main(argv + ["--steps", "2", "--ckpt-dir", a])["h"]
        h += train.main(argv + ["--steps", "2", "--ckpt-dir", a,
                                "--resume"])["h"]
        straight = train.main(argv + ["--steps", "4", "--ckpt-dir", c])["h"]
        with np.load(f"{a}/step_00000004.npz") as x, \
                np.load(f"{c}/step_00000004.npz") as y:
            same = sorted(x.files) == sorted(y.files) and all(
                np.array_equal(x[k], y[k]) for k in x.files)
    if h != straight or not same:
        raise AssertionError(f"vfl-zoo 2 + 2 resumed steps {h} != 4 "
                             f"straight {straight} (state equal: {same})")
    log(f"[zoo] reduced run on the card, 2 steps + 2 resumed from the "
        f"checkpoint: bitwise 4 straight steps, h {h}")


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


@functools.lru_cache(maxsize=1)
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


def _serve_workload(dev):
    """The serving cell in memory at slots 8 (``ServingConfig``'s
    default): the runtime cell's FCN without DP (fused int8), blocks from
    the seed, 64 requests of warm-up, then 128 requests of other ids (16
    steps, no cache hit)."""
    import numpy as np
    from repro_torch.runtime.problem import build_problem
    from repro_torch.serving.federated import FederatedServingEngine

    eng = FederatedServingEngine.from_problem(build_problem(SERVING_SPEC,
                                                            dev), slots=8)
    ids = np.random.default_rng(0).permutation(SERVING_SPEC["samples"])
    serve(eng, ids[:64])
    return (lambda: serve(eng, ids[64:192], first_rid=64)), 128, \
        "prediction"


def profile_phase(dev, cell):
    """Trace one cell's workload with ``torch.profiler``: 2 serial rounds of
    a D7 FCN cell ("d7", "async"), 4 scan-trainer steps ("scan"), one
    vfl-zoo step ("zoo") or 128 served predictions ("serve"). Each
    ``prng.bits`` and ``prng.sample_direction`` call is a
    ``record_function`` span; a direction's span holds its bits span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.utils import prng

    run, units, unit = {"zoo": _zoo_workload, "scan": _scan_workload,
                        "serve": _serve_workload}.get(
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
           f"device_launches_per_{unit}": launches / units,
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


class PhaseClock:
    """Host seconds of each phase, from the end of the previous one."""

    def __init__(self):
        self.t = time.perf_counter()
        self.laps = {}

    def lap(self, name):
        now = time.perf_counter()
        self.laps[name] = now - self.t
        self.t = now
        log(f"[time] {name}: {self.laps[name]:.1f} s")


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
        for cell in ("d7", "async", "scan", "zoo", "serve"):
            profile_phase(dev, cell)
        return 0
    clock = PhaseClock()
    timed, worst = kernel_phase(dev, int_rate)
    timed["prng_draw"], worst["prng_draw"] = draw_phase(dev, int_rate)
    timed["dual_matmul"], worst["dual_matmul"] = dual_matmul_phase(dev)
    timed["flash_attention"], worst["flash_attention"] = flash_phase(dev)
    clock.lap("kernels")
    launches, blocks, main_stats = main_path_phase(dev)
    log(json.dumps({"main_path": main_stats}))
    clock.lap("main")
    zoo_launches, zoo_stats = zoo_phase(dev)
    log(json.dumps({"vfl_zoo": zoo_stats}))
    launches["flash_attention"] = zoo_launches["flash_attention"]
    clock.lap("vfl_zoo")
    log(json.dumps({"async": async_phase(dev)}))
    clock.lap("async")
    log(json.dumps({"scan": scan_phase(dev)}))
    clock.lap("scan")
    runtime_stats, twins = runtime_phase(dev)
    log(json.dumps({"runtime": runtime_stats}))
    clock.lap("runtime")
    log(json.dumps({"serving": serving_phase(dev, blocks)}))
    clock.lap("serving")
    log(json.dumps({"traced": traced_phase(dev, twins, blocks)}))
    clock.lap("traced")
    log(json.dumps({"audits": audit_phase(
        dev, main_stats["fused_ms_per_round"])}))
    clock.lap("audits")
    log(json.dumps({"phase_s": clock.laps}))

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
