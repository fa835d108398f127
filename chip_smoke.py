#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root; needs one card
    python3 chip_smoke.py --profile  # only: where a round's or step's time goes

Phases (any failure raises and exits non-zero; nothing is caught):

1. Device and build: the card's name, power limit and top SM clock, TF32
   off, and the six CUDA kernels built from src/repro_torch/kernels/csrc/
   (one nvcc per source, in parallel) into build/kernels/; ptxas's
   register and spill lines, and the integer instructions of the draw
   kernel's SASS.
2. Kernels: each kernel against its plain torch version on the card, at
   the main path's shapes and larger ones, with CUDA-event times (median
   of 20 after warm-up) and the bound (the larger of bytes over the
   memory rate and operations over the rate of their pipe: f32, or for
   threefry's rotates and xors the INT32 lanes). defended_encode draws its
   noise and rounding bits from the keys in the kernel, at 2048, the
   vfl-zoo payloads (344064, 2^21, 2^22) and 2^24 for every codec x
   mechanism (and clip only, and int8 without a
   rounding key), bitwise equal to the plain chain on the eager bits of
   the same keys; its rows also carry the profiler-traced time and the
   time of the same kernel reading pre-made bits from device memory. The
   draw kernel (bits, normal, rademacher) is bitwise equal to the eager
   chain at 2048, 12 544, 2^24 and qwen1.5-0.5b's embedding (155 582 464),
   and on a counter range across 2^32, and without timing rows at the
   sizes only other phases draw, up to chameleon-34b's embedding (536 870
   912 words; the eager chain in pieces of 2^26 words). zo_update is
   bitwise; dual_matmul
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
   ragged S, full attention, and phase 13's vfl-zoo shapes in bf16:
   qwen3-moe's GQA 32/4 at hd 128 and S 2048, whisper's encoder, full at
   S 1500, and decoder, causal at S 448) within a stated relative
   tolerance, and in
   bf16 element by element within half a bf16 ulp of the plain version's
   f32 result. Both its kernels run on the tensor cores, which the build
   checks in each kernel's own SASS functions (counted with
   ``cuobjdump``): the bf16 one on ``wgmma`` and TMA (``HGMMA`` and
   ``UTMALDG``), the f32 one as 3xTF32 on ``wgmma`` (``HGMMA``). Its bf16
   bound takes both products at the tensor-core rate; its f32 rows carry
   two, both products at the f32 rate of the CUDA cores and, as the line's
   bound, three tf32 products each at the TF32 rate. Its library time is
   PyTorch's scaled_dot_product_attention, which the port never calls; at
   the vfl-zoo shapes and yi-34b's the rows also carry both device times
   (profiler-traced), and the f32 kernel must take less than SDPA at the
   vfl-zoo shape. Its backward kernel (``flash_bwd_phase``) against
   ``flash_attention_bwd_plain`` from the same forward output and lse
   (1e-4 relative in f32, 2e-2 in bf16), two calls bitwise, at the
   vfl-zoo shape in bf16, qwen3-moe's GQA, whisper's encoder, the reduced
   f32 shape and explicit q and kv positions with rows that see no key
   (the mean of v); the forward with lse bitwise the forward-only launch,
   its lse the plain row logsumexp within 1e-5; one call and traced
   times, the bound (5 products, at the bf16 tensor cores' or the f32
   CUDA cores' rate) and the backward of scaled_dot_product_attention
   through autograd as its yardstick.
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
8. At the end, after 9 to 13: the ``{"kernels": [...]}`` line, the card
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
12. LM serving (``serving/engine.py``, ``launch/serve.py``) through the
   Model decode API, no kernel but the draws: (a) ``ServingEngine`` on
   qwen1.5-0.5b at full width (24 layers, d 1024, vocab 151 936, bf16,
   random weights from seed 0) at slots 8, max_len 512, over 16 requests
   from ``default_rng(0)`` (prompts of 16–256 tokens, 16–64 new), greedy,
   then sampled (seed 11) at slots 8 and at slots 3, every rid's tokens
   equal between the two; launches exact: the initial weights' draws
   (``lm_init_draws``), then in each sampled run one draw a step for each
   occupied slot (``lm_sampled_draws``), nothing else. Generated tokens a
   second (host clock around ``run``, ending with the ids on the host),
   engine steps, ms a step, peak memory. (b) The same with the int8 KV
   cache: under 0.6 of the bf16 cache's bytes, finite logits, tokens a
   second. (c) ``launch/serve.py``'s ``main`` at full width with its
   defaults (batch 4, prompt 32, gen 16) for qwen1.5-0.5b, rwkv6-1.6b and
   hymba-1.5b: its ``prefill_s``, ``decode_s`` and ``tok_per_s``, every
   step's logits finite, launches the initial weights' draws. (d) Each
   family reduced (f32) on the card against the CPU port: decode logits
   within 1e-4, continuous batching (6 requests at 2 slots) with greedy
   tokens equal by the margin rule (``tokens_agree``), the dense forward
   (the f32 flash_attention kernel, one launch a layer) within 2e-4 of
   token-by-token decode, and hymba decoding 80 steps past its window of
   64 through a rolling buffer of 64, finite and within 1e-4 of the CPU.
13. The moe, vlm and audio families (``families_phase``), bf16, random
   weights from seed 0: (a) ``launch/serve.py``'s ``main`` with its
   defaults at full width and depth for qwen3-moe-30b-a3b (48 layers, d
   2048, 128 experts top-8), chameleon-34b (48 layers, d 8192, qk-norm)
   and whisper-small (12 + 12 layers, 1500 frames), one model on the card
   at a time: parameters and bf16 bytes before each loads, ``prefill_s``,
   ``decode_s``, ``tok_per_s`` and the peak after; every step's logits
   finite; launches the initial weights' draws (``lm_init_draws``) and
   whisper's 12 encoder layers (one flash_attention each in
   ``init_cache``). phi3.5-moe (83.7 GB in bf16) does not fit one card
   and runs reduced only. (b) vfl-zoo as the launcher builds and steps
   it (``train.make_zoo_run``, ``train.draw_batch``), fused int8, q = 4,
   batch 4, 3 steps: whisper-small at full size at S 448, and qwen3-moe
   at full width with 2 of its layers at S 2048 (the server's ZO update
   holds ~14 bytes a parameter); launches exact (per
   step 3 x the layers' flash_attention, the encoder's too, 5
   defended_encode, a draw a server leaf and 3; the initial weights'),
   h finite, the first within 1.0 of ln V (+ the router's balanced aux
   loss); s per step and the peak. (c) Each new architecture reduced
   (f32) on the card against the CPU port: initial weights bitwise,
   forward and decode logits within 1e-4, the greedy engine at 8 slots step by step
   (``steps_agree``: a moe row depends on its co-tenants, so both decode
   8 rows), 3 vfl-zoo steps for each of 3 seeds, every step run on both
   from the card's state, h within 1e-3. (d) The MoE layer at
   qwen3-moe's vfl-zoo width, two router columns equal: two calls bitwise
   equal, ties to the lower expert.
14. First-order LM training (``lm_train_phase``), bf16, random weights
   from seed 0: (a) ``launch/train.py``'s ``main`` with ``--mode lm`` at
   qwen1.5-0.5b's full width and depth (24 layers, d 1024, vocab 151 936,
   464M parameters, remat on as the config has it), batch 4, S 2048, 5
   Adam steps: every loss finite, the first within 1.0 of ln V; s per
   step and the peak; launches exact (``lm_train_launches``: a forward
   flash_attention a layer and another that remat recomputes, a backward
   a layer, each step; the initial weights' draws). (b) One step of the
   same model and batch shape with ``chunked_ce``: its loss and peak
   beside (a)'s. (c) Every architecture reduced (f32) from one state on
   the card and on the CPU: initial weights bitwise, at the first step
   every gradient leaf within 1e-4 of its largest, then 3 Adam steps each
   run on both from the card's state, losses within 1e-4; and
   qwen1.5-0.5b with explicit positions, a loss mask and the chunked
   loss.

``--profile`` runs none of that: it builds the kernels, warms up, and
traces 2 serial rounds (16 party updates) of each D7 cell, the defended
round and the async experiment's configuration, 4 steps of the scan
trainer's defended D7 cell (asyrevel, K = 1), one step of the
vfl-zoo cell, 128 predictions of the serving cell in memory at slots
8 (after 64 of warm-up), and 32 engine steps of the LM-serving cell
(phase 12 (a)'s greedy engine, after 8 of warm-up), and phase 13's
cells: one vfl-zoo step of qwen3-moe (2 layers) and of whisper-small,
and 8 decode steps of each full model of (a), and one training step of
phase 14 (a)'s model ("lm_train", after a warm-up step; the backward
kernel's two grids count as two launches a call), with
``torch.profiler``, printing the device-busy share, the kernels by device time, the
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
# HGMMA (wgmma) and UTMALDG (TMA loads) in the bf16 flash_attention kernel
# and in both passes of the bf16 backward, HGMMA in the f32 forward (3xTF32,
# no TMA) and in dual_matmul's; the f32 backward runs on the CUDA cores
TENSOR_CORE_SASS = (
    ("flash_attention", "flash_attention_bf16_kernel", ("HGMMA", "UTMALDG")),
    ("flash_attention", "flash_attention_f32_kernel", ("HGMMA",)),
    ("flash_attention_bwd", "flash_attention_bwd_bf16_dq_kernel",
     ("HGMMA", "UTMALDG")),
    ("flash_attention_bwd", "flash_attention_bwd_bf16_dkdv_kernel",
     ("HGMMA", "UTMALDG")),
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


# the records a trace may lose, over all of its kernels, and still count
TRACE_LOST_MAX = 2


def traced_ms(fn, n=20, tries=5) -> float:
    """The device time of fn's kernels per call, from ``torch.profiler``'s
    trace of n calls, whatever the host time between them (for a kernel of
    a few us the queued calls of ``device_ms`` wait on the host). fn
    launches the same kernels on every call, so each kernel's count of
    records is m * n for its m launches a call; a trace can lose records
    (seen on the card: all, about half, or one of a kernel's 20 in five
    traces running). Each kernel counts as its mean duration times m (its
    count over n, rounded); a trace that lost more than TRACE_LOST_MAX
    records, or recorded none, is taken again. Two spin kernels trail the
    n calls in each trace and are left out."""
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
            for _ in range(2):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA
                  and "spin_kernel" not in e.key and e.count]
        per_call, lost = 0.0, 0
        for e in events:
            m = max(1, round(e.count / n))
            lost += abs(m * n - e.count)
            per_call += e.self_device_time_total / e.count * m
        records = sum(e.count for e in events)
        if events and lost <= TRACE_LOST_MAX:
            if lost:
                log(f"[traced_ms] {records} kernel records in a trace of "
                    f"{n} calls: {lost} lost, each kernel timed by its mean")
            return per_call / 1e3
        log(f"[traced_ms] {records} kernel records in a trace of {n} calls, "
            f"{lost} lost; tracing again ({attempt + 1} of {tries})")
    raise AssertionError(f"no complete trace of {n} calls in {tries}")


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

# defended_encode's sizes: D7's payload, the vfl-zoo payloads (a party's c
# of 4 x S x d/4: 4 x 448 x 192 on whisper-small, 4 x 2048 x 256 on
# qwen1.5-0.5b, 4 x 2048 x 512 on qwen3-moe) and 2^24 (past what the int8
# kernel keeps on chip: the second sweep)
ENCODE_SIZES = (2048, 344064, 1 << 21, 1 << 22, 1 << 24)
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
# the sizes only the runtime's, serving's and phase 13's problems draw,
# checked bitwise without timing rows: the FCN labels' two bit streams (n =
# 60000) and X (60000 x 784); then every phase-13 draw not listed above
# (initial weights and vfl-zoo directions). whisper-small: the final norms
# (768), the stacked norms (12 x 768), a 768 x 768 and a 768 x 3072 matrix
# and their stacks (12 x ...), a party's embedding slice (51865 x 192) and
# the embedding (51865 x 768). qwen3-moe at full width, 2 layers in
# vfl-zoo: the stacked norms (2 x 2048), a party's w1 and w2 (512 x 128),
# the router (2048 x 128) and its stack (2 x ...), wk/wv stacked (2 x 2048
# x 512), wq/wo (2048 x 4096), a party's embedding slice (151936 x 512),
# an expert stack (128 x 2048 x 768) and its 2 layers (2 x ...), the
# embedding (151936 x 2048). chameleon-34b: the modality embedding (2 x
# 8192), wk/wv (8192 x 1024), wq/wo (8192 x 8192), the MLP's (8192 x
# 22016) and the embedding (65536 x 8192)
DRAW_CHECKED = (60000, 47040000, 768, 4096, 9216, 16384, 65536, 262144,
                524288, 589824, 2097152, 2359296, 7077888, 8388608, 9958080,
                28311552, 39832320, 67108864, 77791232, 180355072, 201326592,
                311164928, 402653184, 536870912)
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
        worst = max(worst, draw_checked(dev, n))
    return timed, worst


# the eager chain of a large draw runs in pieces of this many words (its
# int64 counters and f32 temporaries of 537M words would not fit the card)
DRAW_PIECE = 1 << 26


def draw_checked(dev, n) -> float:
    """The draw kernel's bits and normal of n words against the eager chain,
    bitwise, the chain run over pieces of the counter range (a piece from
    counter lo is the slice [lo, lo + m) of the whole stream). Returns the
    largest difference (0)."""
    import torch
    from repro_torch.kernels import prng_draw
    from repro_torch.utils import prng

    k = (0x5EED, n)
    worst = 0.0
    for mode in ("bits", "normal"):
        got = prng_draw.draw(k, (n,), mode, dev)
        for lo in range(0, n, DRAW_PIECE):
            m = min(DRAW_PIECE, n - lo)
            want = prng.draw_plain(k, (m,), mode, dev, lo)
            if not bitwise_equal(got[lo:lo + m], want):
                raise AssertionError(f"prng_draw != the eager chain: {mode} "
                                     f"n={n}, words {lo} to {lo + m}")
            worst = max(worst, max_abs(got[lo:lo + m], want))
            del want
        del got
        torch.cuda.empty_cache()
    return worst


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
# and full (non-causal) attention; phase 13's vfl-zoo shapes: qwen3-moe's
# GQA heads (32 over 4, hd 128) at batch 4, S 2048, whisper-small's encoder
# (full, S 1500) and decoder (causal, S 448), both ragged
FLASH_CASES = [(4, 2048, 16, 16, 64, "bf16", True),
               (4, 2048, 32, 4, 128, "bf16", True),
               (4, 1500, 12, 12, 64, "bf16", False),
               (4, 448, 12, 12, 64, "bf16", True),
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
# durations): the vfl-zoo paths' (qwen1.5-0.5b's, qwen3-moe's, whisper's
# encoder and decoder) and yi-34b's GQA heads
FLASH_TRACED = ((4, 2048, 16, 16, 64), (1, 1024, 56, 8, 128),
                (4, 2048, 32, 4, 128), (4, 1500, 12, 12, 64),
                (4, 448, 12, 12, 64))


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
    ops.flash_attention_bwd.launches = 0


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

# ------------------------------------------------------- LM serving phase --

LM_ARCH = "qwen1.5-0.5b"
LM_SLOTS = 8
LM_MAX_LEN = 512
LM_REQUESTS = 16
LM_SEED = 11
LM_SAMPLED_SLOTS = (8, 3)
LM_LAUNCHERS = ("qwen1.5-0.5b", "rwkv6-1.6b", "hymba-1.5b")
# logits of the reduced f32 models, card against CPU (TF32 off); tokens by
# the margin rule on them
LM_TOL = 1e-4
# the reduced dense forward (the f32 flash_attention kernel) against
# token-by-token decode: the reference's tests/test_archs.py tolerance
LM_CONSISTENCY_TOL = 2e-4


def lm_requests(vocab, n=LM_REQUESTS, seed=0, prompt=(16, 257),
                new=(16, 65)):
    """(rid, prompt ids, max_new_tokens) from ``default_rng(seed)``:
    prompt lengths and new-token budgets uniform in [lo, hi)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for rid in range(n):
        p, m = int(rng.integers(*prompt)), int(rng.integers(*new))
        out.append((rid, rng.integers(0, vocab, p).astype(np.int32), m))
    return out


def lm_init_draws(cfg):
    """Draws of a Model's initial weights (one a matrix drawn from normal):
    the embedding, the head unless tied, and per layer 7 (dense and vlm:
    wq, wk, wv, wo, w_gate, w_up, w_down), 8 (moe: the 4 attention
    matrices, the router and the 3 expert stacks), 11 (audio's decoder:
    dense's 7 and the cross attention's wq, wk, wv, wo), 11 (ssm: the time
    mix's 2 LoRA matrices, 5 projections and u; the channel mix's 3) or 12
    (hybrid: 4 attention, 5 mamba (in_proj, conv_w, bc_proj, dt_proj,
    out_proj), 3 mlp); then 7 an encoder layer (audio) and the modality
    embedding (vlm). The q/k gammas and the norms are ones, not draws."""
    per_layer = {"dense": 7, "vlm": 7, "moe": 8, "audio": 11, "ssm": 11,
                 "hybrid": 12}[cfg.family]
    return 1 + (0 if cfg.tie_embeddings else 1) \
        + per_layer * cfg.num_layers \
        + (7 * cfg.num_encoder_layers if cfg.enc_dec else 0) \
        + (1 if cfg.frontend == "vq_stub" else 0)


def lm_sampled_draws(done):
    """Gumbel draws of a sampled engine run: one a step for each occupied
    slot (an empty slot draws nothing). A request holds its slot for
    len(prompt) + len(out_tokens) - 1 steps: one a prompt token (the last
    also emits the first token), then one a further token."""
    return sum(len(r.prompt) + len(r.out_tokens) - 1 for r in done)


def run_lm_engine(model, params, dev, reqs, slots, greedy, max_len=LM_MAX_LEN):
    """Serve ``reqs`` through a ServingEngine; returns (engine, {rid:
    tokens}, host seconds of ``run``, which ends with the ids on the
    host)."""
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(model, params, slots=slots, max_len=max_len,
                        greedy=greedy, seed=LM_SEED, device=dev)
    for rid, prompt, n in reqs:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    t0 = time.perf_counter()
    done = eng.run()
    return eng, {r.rid: r.out_tokens for r in done}, \
        time.perf_counter() - t0


def replay_rows(model, params, prompt, tokens, device):
    """The logits (numpy) that chose each of ``tokens``: the request
    decoded alone on ``device`` with its tokens forced."""
    import torch
    cache = model.init_cache(params, 1, len(prompt) + len(tokens))
    rows = []
    for pos, t in enumerate(list(prompt) + list(tokens[:-1])):
        lg, cache = model.decode_step(
            params, cache, torch.full((1, 1), int(t), device=device), pos)
        if pos >= len(prompt) - 1:
            rows.append(lg[0, 0].float().cpu().numpy())
    return rows


def tokens_agree(want, got, want_rows, got_rows, tol, noise=None) -> int:
    """The margin rule for one request: the logits that chose each token
    within ``tol`` of ``want_rows``, and the tokens equal while the chosen
    score (logits, + Gumbel noise when sampled) leads the runner-up by
    more than 2 * tol; from a nearer tie on only the logits are compared.
    Returns how many tokens it compared; raises on a disagreement."""
    import numpy as np
    for j, w in enumerate(want):
        gap = float(np.max(np.abs(got_rows[j] - want_rows[j])))
        if not gap <= tol:
            raise AssertionError(f"token {j}: logits differ by {gap}")
        score = want_rows[j] + (0.0 if noise is None else noise[j])
        second, first = np.sort(score)[-2:]
        if first - second <= 2 * tol:
            return j
        if j >= len(got) or got[j] != w:
            raise AssertionError(f"token {j}: {got} against {want}")
    if len(got) != len(want):
        raise AssertionError(f"{got} against {want}")
    return len(want)


def lm_serving_phase(dev, reduced=False):
    """LM serving through the Model decode API (module docstring, phase
    12): the engine at qwen1.5-0.5b's full width, greedy and sampled, the
    int8 cache, the serve launcher on the three families at full width,
    then the reduced models on the card against the CPU port.
    ``reduced`` runs (a) to (c) on the reduced configs (a rehearsal on
    the CPU)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng, trees

    cfg = get_config(LM_ARCH, reduced=reduced)
    model = build_model(cfg)
    reqs = lm_requests(cfg.vocab_size)
    stats = {"requests": len(reqs), "slots": LM_SLOTS,
             "max_len": LM_MAX_LEN}
    # (a) greedy at slots 8: the initial weights' draws and nothing else
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    params = model.init(prng.key(0), dev)
    eng, greedy, secs = run_lm_engine(model, params, dev, reqs, LM_SLOTS,
                                      True)
    launches = read_launches()
    want = {"defended_encode": 0, "zo_update": 0, "dual_matmul": 0,
            "flash_attention": 0, "prng_draw": lm_init_draws(cfg)}
    if launches != want:
        raise AssertionError(f"LM serving launches {launches}, want {want}")
    tokens = sum(len(t) for t in greedy.values())
    if tokens != sum(n for _, _, n in reqs):
        raise AssertionError(f"greedy run generated {tokens} tokens")
    stats["bf16"] = {"tok_per_s": tokens / secs, "steps": eng.steps,
                     "ms_per_step": secs * 1e3 / eng.steps, "tokens": tokens,
                     "run_s": secs, "cache_bytes": trees.tree_bytes(
                         eng.cache),
                     "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"[lm] {LM_ARCH} {cfg.num_params()} params, {cfg.dtype}, greedy at "
        f"slots {LM_SLOTS}: {json.dumps(stats['bf16'])}, launches "
        f"{launches}")
    # sampled at slots 8 and 3: the same tokens for every rid; draws: one
    # a step for each occupied slot (lm_sampled_draws)
    sampled = {}
    for slots in LM_SAMPLED_SLOTS:
        zero_launches()
        eng_s, sampled[slots], secs = run_lm_engine(model, params, dev, reqs,
                                                    slots, False)
        launches = read_launches()
        want = {"defended_encode": 0, "zo_update": 0, "dual_matmul": 0,
                "flash_attention": 0,
                "prng_draw": lm_sampled_draws(eng_s.completed)}
        if launches != want:
            raise AssertionError(f"sampled serving at slots {slots}: "
                                 f"launches {launches}, want {want}")
        n = sum(len(t) for t in sampled[slots].values())
        stats[f"sampled_slots{slots}"] = {
            "tok_per_s": n / secs, "steps": eng_s.steps,
            "ms_per_step": secs * 1e3 / eng_s.steps, "draws":
                launches["prng_draw"]}
        log(f"[lm] sampled at slots {slots}: "
            f"{json.dumps(stats[f'sampled_slots{slots}'])}")
    a, b = LM_SAMPLED_SLOTS
    if sampled[a] != sampled[b]:
        raise AssertionError(f"sampled tokens depend on the slots: "
                             f"{sampled[a]} against {sampled[b]}")
    # (b) the int8 cache
    model8 = build_model(cfg.replace(kv_cache_dtype="int8"))
    eng8, _, secs = run_lm_engine(model8, params, dev, reqs, LM_SLOTS, True)
    ratio = trees.tree_bytes(eng8.cache) / stats["bf16"]["cache_bytes"]
    if not ratio < 0.6:
        raise AssertionError(f"int8 cache is {ratio:.3f} of the bf16 one")
    logits, _ = model8.decode_step(
        params, eng8.cache, torch.zeros((eng8.rows, 1), dtype=torch.int64,
                                        device=dev),
        torch.arange(eng8.rows, device=dev) + 300)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("int8 cache: non-finite logits")
    n = sum(len(r.out_tokens) for r in eng8.completed)
    stats["int8"] = {"tok_per_s": n / secs, "steps": eng8.steps,
                     "ms_per_step": secs * 1e3 / eng8.steps,
                     "cache_ratio": ratio}
    log(f"[lm] int8 cache at slots {LM_SLOTS}: {json.dumps(stats['int8'])}")
    del eng, eng_s, eng8, params, logits
    torch.cuda.empty_cache()
    stats["launcher"] = lm_launchers(dev, reduced)
    stats["reduced"] = lm_reduced_checks(dev)
    return stats


def lm_launchers(dev, reduced=False, archs=LM_LAUNCHERS):
    """(c) ``launch/serve.py``'s main at full width with its defaults
    (batch 4, prompt 32, gen 16) for each of ``archs``; every step's
    logits finite (folded into one flag on the card, read at the end),
    launches exactly the initial weights' draws (and an encoder-decoder's
    encoder layers, one flash_attention each, as ``init_cache`` encodes
    the frames). Before each model loads: its parameters and their bytes
    in its dtype; after: the peak memory. One model at a time: each is
    freed before the next loads."""
    import contextlib
    import io
    import re

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as model_mod

    decode = model_mod.Model.decode_step
    out = {}
    for arch in archs:
        cfg = get_config(arch, reduced=reduced)
        nbytes = cfg.num_params() * model_mod.DTYPES[cfg.dtype].itemsize
        log(f"[lm] serve {arch}: {cfg.num_params()} params, "
            f"{nbytes / 1e9:.1f} GB in {cfg.dtype}")
        finite = torch.ones((), dtype=torch.bool, device=dev)

        def checked(self, params, cache, token, pos):
            nonlocal finite
            logits, cache = decode(self, params, cache, token, pos)
            finite = finite & torch.isfinite(logits).all()
            return logits, cache
        model_mod.Model.decode_step = checked
        text = io.StringIO()
        torch.cuda.reset_peak_memory_stats(dev)
        try:
            zero_launches()
            with contextlib.redirect_stdout(text):
                ids = serve.main(["--arch", arch, "--device", str(dev)]
                                 + (["--reduced"] if reduced else []))
            launches = read_launches()
        finally:
            model_mod.Model.decode_step = decode
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        line = next(s for s in text.getvalue().splitlines()
                    if "tok_per_s=" in s)
        log(f"[lm] {line} peak {peak_gb:.2f} GB")
        nums = {k: float(v) for k, v in re.findall(
            r"(prefill_s|decode_s|tok_per_s)=(\S+)", line)}
        want = {"defended_encode": 0, "zo_update": 0, "dual_matmul": 0,
                "flash_attention": cfg.num_encoder_layers if cfg.enc_dec
                else 0, "prng_draw": lm_init_draws(cfg)}
        if launches != want or not bool(finite) or ids.shape != (4, 16):
            raise AssertionError(f"serve {arch}: launches {launches} (want "
                                 f"{want}), finite {bool(finite)}, ids "
                                 f"{ids.shape}")
        out[arch] = {**nums, "params": cfg.num_params(),
                     "param_gb": nbytes / 1e9, "peak_gb": peak_gb}
        torch.cuda.empty_cache()
    return out


def lm_reduced_checks(dev):
    """(d) Each family's reduced f32 model on the card against the CPU
    port, weights from seed 1: 10 decode steps' logits within LM_TOL;
    continuous batching (6 requests at 2 slots) greedy, tokens by the
    margin rule; the dense forward (the f32 flash_attention kernel, its
    launches counted), the prefill step, against token-by-token decode
    within LM_CONSISTENCY_TOL; hymba decoding 80 steps past its window of
    64 through a rolling buffer of 64, logits finite and within LM_TOL."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as step_lib
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng

    devs = {"card": dev, "cpu": torch.device("cpu")}
    out = {}
    for arch in LM_LAUNCHERS:
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg)
        params = {k: model.init(prng.key(1), d) for k, d in devs.items()}
        toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 10))
        logits = {}
        for k, d in devs.items():
            cache = model.init_cache(params[k], 2, 16)
            rows = []
            for pos in range(10):
                lg, cache = model.decode_step(
                    params[k], cache,
                    torch.as_tensor(toks[:, pos:pos + 1], device=d), pos)
                rows.append(lg)
            logits[k] = torch.cat(rows, dim=1)
        gap = float((logits["card"].cpu() - logits["cpu"]).abs().max())
        if not gap <= LM_TOL:
            raise AssertionError(f"{arch}: card decode logits {gap} off")
        res = {"decode_gap": gap}
        # continuous batching, card against CPU
        reqs = lm_requests(cfg.vocab_size, n=6, seed=3, prompt=(3, 10),
                           new=(2, 7))
        runs = {k: run_lm_engine(model, params[k], d, reqs, 2, True,
                                 max_len=32)[1] for k, d in devs.items()}
        compared = total = 0
        for rid, prompt, _ in reqs:
            want, got = runs["cpu"][rid], runs["card"][rid]
            compared += tokens_agree(
                want, got,
                replay_rows(model, params["cpu"], prompt, want, devs["cpu"]),
                replay_rows(model, params["card"], prompt, want, dev),
                LM_TOL)
            total += len(want)
        if not compared >= 0.8 * total:
            raise AssertionError(f"{arch}: only {compared} of {total} "
                                 "tokens outside a near tie")
        res["tokens_compared"] = [compared, total]
        if cfg.family == "dense":
            zero_launches()
            t = torch.as_tensor(toks, device=dev)
            full = step_lib.make_prefill_step(model)(
                params["card"], {"tokens": t, "targets": t})
            flash = read_launches()["flash_attention"]
            gap = float((full - logits["card"]).abs().max())
            if flash != cfg.num_layers or not gap <= LM_CONSISTENCY_TOL:
                raise AssertionError(f"dense forward on the card: {flash} "
                                     f"flash launches, {gap} from decode")
            res.update(forward_vs_decode=gap, flash_launches=flash)
        if cfg.family == "hybrid":
            seq = np.random.default_rng(4).integers(0, cfg.vocab_size,
                                                    (1, 80))
            last = {}
            for k, d in devs.items():
                cache = model.init_cache(params[k], 1, 96)
                if cache["layers"]["kv"]["k"].shape[2] != cfg.sliding_window:
                    raise AssertionError("hymba cache is not a rolling "
                                         "buffer of its window")
                for pos in range(80):
                    lg, cache = model.decode_step(
                        params[k], cache,
                        torch.as_tensor(seq[:, pos:pos + 1], device=d), pos)
                last[k] = lg
            gap = float((last["card"].cpu() - last["cpu"]).abs().max())
            if not (bool(torch.isfinite(last["card"]).all())
                    and gap <= LM_TOL):
                raise AssertionError(f"hymba past its window: gap {gap}")
            res["past_window_gap"] = gap
        log(f"[lm] reduced {arch} card vs CPU: {json.dumps(res)}")
        out[arch] = res
    return out

# ------------------------------------------- phase 13: moe, vlm, audio --

FAMILY_ARCHS = ("qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "chameleon-34b",
                "whisper-small")
# at full width and depth through the serve launcher; phi3.5-moe's 83.7 GB
# in bf16 do not fit one 80 GB card, so it runs reduced only, in (c)
FAMILY_SERVE = ("qwen3-moe-30b-a3b", "chameleon-34b", "whisper-small")
FAMILY_ZOO_STEPS = 3
# (arch, layers, S) of the vfl-zoo runs: whisper-small at full size and its
# published decoder context; qwen3-moe at full width with 2 of its 48
# layers (the server's ZO update holds ~14 bytes a parameter: ~26 GB at 2
# layers, ~430 GB at 48)
FAMILY_ZOO = (("whisper-small", None, 448), ("qwen3-moe-30b-a3b", 2, 2048))
FAMILY_ZOO_ARGS = ["--mode", "vfl-zoo", "--parties", "4", "--batch-size",
                   "4", "--fused", "--codec", "int8", "--log-every", "1"]
FAMILY_SLOTS = 8


def server_leaves(arch) -> int:
    """Leaves of an architecture's server params (w0): the reduced model's
    tree, which has the same leaves, built on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng, trees
    model = build_model(get_config(arch, reduced=True))
    return len(trees.leaves(model.init(prng.key(0), "cpu")))


def families_phase(dev, reduced=False):
    """The moe, vlm and audio families (module docstring, phase 13): the
    serve launcher at full width and depth, vfl-zoo at full width, then
    every new architecture reduced on the card against the CPU port.
    ``reduced`` runs (a) and (b) on the reduced configs (a rehearsal on
    the CPU)."""
    stats = {"launcher": lm_launchers(dev, reduced, FAMILY_SERVE)}
    stats["vfl_zoo"] = {arch: families_zoo(dev, arch, layers, seq, reduced)
                        for arch, layers, seq in FAMILY_ZOO}
    stats["moe_dispatch"] = moe_repeat_check(dev, reduced)
    stats["reduced"] = families_reduced_checks(dev)
    return stats


def moe_repeat_check(dev, reduced=False):
    """(d) The MoE layer at qwen3-moe's vfl-zoo width (128 experts, top 8,
    d 2048, d_ff_expert 768; 4 x 2048 tokens, bf16) with experts 1 and 2
    given the same router column: two calls bitwise equal (the dispatch's
    scatter and gather use no atomics), and every tie to the lower expert
    (2 never without 1, and after it). ``reduced``: at d 256 and
    d_ff_expert 64 (a rehearsal on the CPU)."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.utils import prng

    cfg = get_config("qwen3-moe-30b-a3b")
    if reduced:
        cfg = cfg.replace(d_model=256, moe=dataclasses.replace(
            cfg.moe, d_ff_expert=64))
    p = moe.moe_init(prng.key(5), cfg, dev, torch.bfloat16)
    p["router"][:, 2] = p["router"][:, 1]
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn(4, 2048, cfg.d_model, device=dev, generator=gen).to(
        torch.bfloat16)
    a, aux_a = moe.moe_apply(p, cfg, x)
    b, aux_b = moe.moe_apply(p, cfg, x)
    _, _, idx = moe.route(p, cfg, x.reshape(-1, cfg.d_model))
    one, two = (idx == 1), (idx == 2)
    both = one.any(1) & two.any(1)
    first = torch.argmax(one.int(), 1) < torch.argmax(two.int(), 1)
    res = {"bitwise_repeat": bitwise_equal(a, b) and bitwise_equal(aux_a,
                                                                   aux_b),
           "tokens_with_both": int(both.sum()),
           "tokens_with_1_only": int((one.any(1) & ~two.any(1)).sum()),
           "tokens_with_2_only": int((two.any(1) & ~one.any(1)).sum()),
           "finite": bool(torch.isfinite(a).all())}
    log(f"[families] moe dispatch at qwen3-moe's width: {json.dumps(res)}")
    if not (res["bitwise_repeat"] and res["finite"]
            and res["tokens_with_2_only"] == 0
            and bool(first[both].all())):
        raise AssertionError(f"moe dispatch on the card: {res}")
    del p, x, a, b
    torch.cuda.empty_cache()
    return res


def family_zoo_run(dev, arch, layers, seq_len, reduced=False, argv=()):
    """A vfl-zoo run of ``arch`` as the launcher builds it
    (``train.make_zoo_run``; fused int8, q = 4, batch 4, plus ``argv``),
    ``layers`` of the config's depth where given: (cfg, args, step,
    state, data)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train

    cfg = get_config(arch, reduced=reduced)
    if layers is not None:
        cfg = cfg.replace(num_layers=layers)
    args = train.parse_args(["--arch", arch, "--seq-len", str(seq_len)]
                            + FAMILY_ZOO_ARGS + list(argv))
    _, step, state, data = train.make_zoo_run(args, cfg, dev)
    return cfg, args, step, state, data


def families_zoo(dev, arch, layers, seq_len, reduced=False):
    """(b) vfl-zoo as the launcher runs it (``family_zoo_run``, batches by
    ``train.draw_batch``), 3 steps, at the config's full width (``layers``
    of its depth where given). Launches exact: per step one
    flash_attention a layer (the encoder's too) in each of the three
    forwards, 5 defended_encode (4 c's and one c_hat) and one draw a
    perturbed leaf (every server leaf and the activated party's 3); the
    initial weights' draws (the server's and 3 a party). Every h finite,
    the first within 1.0 of ln V plus the router's aux loss at a balanced
    load (coef * K a layer). ``reduced``: the reduced config at S 16 (a
    rehearsal on the CPU)."""
    import numpy as np
    import torch
    from repro_torch.launch import train

    steps = FAMILY_ZOO_STEPS
    leaves = server_leaves(arch)
    seq_len = 16 if reduced else seq_len
    torch.cuda.reset_peak_memory_stats(dev)
    zero_launches()
    t0 = time.perf_counter()
    cfg, args, step, state, data = family_zoo_run(
        dev, arch, None if reduced else layers, seq_len, reduced)
    torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t0
    log(f"[families] vfl-zoo {arch}: {cfg.num_params()} params, "
        f"{cfg.num_layers} layers, d {cfg.d_model}, S {seq_len}")
    rng = np.random.default_rng(args.seed)
    h, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, h_t = step(state, train.draw_batch(rng, data,
                                                  args.batch_size))
        h.append(float(h_t))
        step_s.append(time.perf_counter() - t0)
    launches = read_launches()
    del state, data
    torch.cuda.empty_cache()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    depth = cfg.num_layers + (cfg.num_encoder_layers if cfg.enc_dec else 0)
    want = {"flash_attention": 3 * depth * steps,
            "defended_encode": 5 * steps, "dual_matmul": 0, "zo_update": 0,
            "prng_draw": (leaves + 3) * steps + lm_init_draws(cfg) + 3 * 4}
    aux = cfg.moe.router_aux_coef * cfg.moe.top_k * cfg.num_layers \
        if cfg.moe is not None else 0.0
    center = math.log(cfg.vocab_size) + aux
    log(f"[families] vfl-zoo {arch}: setup {setup_s:.2f} s, s per "
        f"step {[round(t, 4) for t in step_s]}, h {h}, peak "
        f"{peak_gb:.2f} GB, launches {launches}")
    if launches != want:
        raise AssertionError(f"vfl-zoo {arch} launches {launches}, want "
                             f"{want}")
    if len(h) != steps or not all(math.isfinite(x) for x in h) \
            or not abs(h[0] - center) < 1.0:
        raise AssertionError(f"vfl-zoo {arch}: h {h}, the first not within "
                             f"1.0 of {center:.4f}")
    return {"params": cfg.num_params(), "layers": cfg.num_layers,
            "seq_len": seq_len, "h": h, "step_s": step_s,
            "setup_s": setup_s, "peak_gb": peak_gb, "launches": launches}


# (c)'s vfl-zoo check: the seeds (initial weights and data) it runs, and
# |h_card - h_cpu| allowed at each step
ZOO_CHECK_SEEDS = (0, 1, 2)
ZOO_CHECK_TOL = 1e-3


def zoo_steps_agree(dev, arch, seed):
    """(c)'s vfl-zoo check of one seed: 3 steps of the reduced ``arch``
    (S 128, lr 1e-2) on the card, each step also run on the CPU from a
    copy of the same state and batch; returns each step's |h_card -
    h_cpu|. Both sides start every step from one state, so a routing
    near-tie that one side breaks otherwise cannot reach the next step's
    weights through 1/mu (PERF.md, PR 23)."""
    import numpy as np
    import torch
    from repro_torch.launch import train
    from repro_torch.utils import trees

    _, args, step, state, data = family_zoo_run(
        dev, arch, None, 128, reduced=True,
        argv=["--lr", "1e-2", "--seed", str(seed)])
    rng = np.random.default_rng(args.seed)
    gaps = []
    for _ in range(FAMILY_ZOO_STEPS):
        batch = train.draw_batch(rng, data, args.batch_size)
        on_cpu = state._replace(**{f: trees.tree_map(
            lambda a: a.cpu(), getattr(state, f))
            for f in ("w0", "parties", "hist")})
        _, h_cpu = step(on_cpu, {k: a.cpu() for k, a in batch.items()})
        state, h = step(state, batch)
        gaps.append(abs(float(h) - float(h_cpu)))
    return gaps


def engine_steps(model, params, dev, reqs, frames, slots=FAMILY_SLOTS):
    """Greedy ``ServingEngine`` at ``slots`` (``slots`` rows: the moe
    family's rows depend on their co-tenants, so both sides decode the
    same rows) over ``reqs``; returns each step's logits (numpy, a row a
    slot)."""
    import torch
    from repro_torch.models import model as model_mod
    from repro_torch.serving import Request, ServingEngine

    rows = []
    decode = model_mod.Model.decode_step

    def recording(self, *a):
        lg, c = decode(self, *a)
        rows.append(lg[:, 0].float().cpu().numpy())
        return lg, c
    eng = ServingEngine(model, params, slots=slots, max_len=32,
                        frames=None if frames is None
                        else torch.as_tensor(frames, device=dev),
                        device=dev)
    if eng.rows != slots:
        raise AssertionError(f"engine at {slots} slots decodes {eng.rows}")
    for rid, prompt, n in reqs:
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    model_mod.Model.decode_step = recording
    try:
        eng.run()
    finally:
        model_mod.Model.decode_step = decode
    return rows


def steps_agree(want_rows, got_rows, tol) -> int:
    """Two engines step by step: every row's logits within ``tol``, the
    chosen tokens equal while each row's top logit leads its runner-up by
    more than 2 * tol; from a nearer tie on the schedules may part, so
    the comparison stops. Returns the steps compared."""
    import numpy as np
    compared = 0
    for w, g in zip(want_rows, got_rows):
        gap = float(np.abs(w - g).max())
        if not gap <= tol:
            raise AssertionError(f"engine step {compared}: logits {gap} off")
        top2 = np.sort(w, axis=-1)[:, -2:]
        if np.any(top2[:, 1] - top2[:, 0] <= 2 * tol):
            break
        if not np.array_equal(np.argmax(g, -1), np.argmax(w, -1)):
            raise AssertionError(f"engine step {compared}: tokens differ")
        compared += 1
    return compared


def families_reduced_checks(dev):
    """(c) Each new architecture reduced (f32) on the card against the CPU
    port, weights from seed 1 (bitwise the CPU's): the forward's logits
    (the f32 flash_attention kernel, one launch a layer, the encoder's too)
    within
    LM_TOL; 10 decode steps from ``init_cache`` (whisper's frames encoded
    into the cross K/V) within LM_TOL; the greedy engine at 8 slots over
    11 requests step by step (``steps_agree``); 3 fused int8 vfl-zoo steps
    of each seed in ZOO_CHECK_SEEDS, each from one state on both
    (``zoo_steps_agree``), h within ZOO_CHECK_TOL."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng, trees

    devs = {"card": dev, "cpu": torch.device("cpu")}
    out = {}
    for arch in FAMILY_ARCHS:
        cfg = get_config(arch, reduced=True)
        model = build_model(cfg)
        params = {k: model.init(prng.key(1), d) for k, d in devs.items()}
        if not all(bitwise_equal(a.cpu(), b) for a, b in zip(
                trees.leaves(params["card"]), trees.leaves(params["cpu"]))):
            raise AssertionError(f"{arch}: the card's initial weights are "
                                 "not the CPU's")
        rng = np.random.default_rng(2)
        toks = rng.integers(0, cfg.vocab_size, (2, 10))
        frames = rng.normal(size=(FAMILY_SLOTS, cfg.encoder_frames,
                                  cfg.d_model)).astype(np.float32) \
            if cfg.enc_dec else None
        mask = (rng.random((2, 10)) < 0.3).astype(np.int32)
        fwd, dec = {}, {}
        for k, d in devs.items():
            batch = {"tokens": torch.as_tensor(toks, device=d),
                     "targets": torch.as_tensor(toks, device=d)}
            if cfg.enc_dec:
                batch["frames"] = torch.as_tensor(frames[:2], device=d)
            if cfg.frontend == "vq_stub":
                batch["modality_mask"] = torch.as_tensor(mask, device=d)
            zero_launches()
            fwd[k] = model.forward(params[k], batch)[0].cpu()
            flash = read_launches()["flash_attention"]
            if k == "card" and flash != cfg.num_layers + (
                    cfg.num_encoder_layers if cfg.enc_dec else 0):
                raise AssertionError(f"{arch} forward: {flash} flash "
                                     "launches")
            cache = model.init_cache(params[k], 2, 16,
                                     frames=batch.get("frames"))
            rows = []
            for pos in range(10):
                lg, cache = model.decode_step(
                    params[k], cache, batch["tokens"][:, pos:pos + 1], pos)
                rows.append(lg.cpu())
            dec[k] = torch.cat(rows, dim=1)
        res = {"forward_gap": float((fwd["card"] - fwd["cpu"]).abs().max()),
               "decode_gap": float((dec["card"] - dec["cpu"]).abs().max())}
        if not (res["forward_gap"] <= LM_TOL and res["decode_gap"] <= LM_TOL
                and bool(torch.isfinite(fwd["card"]).all())):
            raise AssertionError(f"{arch} card vs CPU: {res}")
        reqs = lm_requests(cfg.vocab_size, n=11, seed=3, prompt=(3, 10),
                           new=(2, 7))
        runs = {k: engine_steps(model, params[k], d, reqs, frames)
                for k, d in devs.items()}
        compared = steps_agree(runs["cpu"], runs["card"], LM_TOL)
        if not compared >= 0.8 * len(runs["cpu"]):
            raise AssertionError(f"{arch}: the engines agree for {compared} "
                                 f"of {len(runs['cpu'])} steps")
        res["engine_steps_compared"] = [compared, len(runs["cpu"])]
        res["zoo_h_gaps"] = {seed: zoo_steps_agree(dev, arch, seed)
                             for seed in ZOO_CHECK_SEEDS}
        if not all(g < ZOO_CHECK_TOL for gaps in res["zoo_h_gaps"].values()
                   for g in gaps):
            raise AssertionError(f"{arch} vfl-zoo card vs CPU: h gaps "
                                 f"{res['zoo_h_gaps']}")
        log(f"[families] reduced {arch} card vs CPU: {json.dumps(res)}")
        out[arch] = res
    return out

# ----------------------------------------- phase 14: first-order LM training --

LM_TRAIN_STEPS = 5
LM_TRAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--mode", "lm", "--batch-size",
                 "4", "--log-every", "1"]
LM_TRAIN_TOL = 1e-4
# (c)'s reduced runs: batch 2, S 32, 3 Adam steps each from one state
LM_TRAIN_CHECK = (2, 32, 3)


def lm_train_launches(cfg, steps):
    """flash_attention launches of ``steps`` first-order steps: a forward a
    layer (and an encoder layer), another where remat recomputes the layer
    in the backward, and a backward a layer. Returns (forward, backward)."""
    layers = cfg.num_layers + (cfg.num_encoder_layers if cfg.enc_dec else 0)
    return layers * (2 if cfg.remat else 1) * steps, layers * steps


def lm_train_phase(dev, reduced=False):
    """First-order LM training (module docstring, phase 14): (a) the
    launcher's ``--mode lm`` at qwen1.5-0.5b's full width and depth, (b) the
    same model with the vocab-chunked loss, (c) every architecture reduced,
    card against CPU. ``reduced`` runs (a) and (b) on the reduced config
    (a rehearsal on the CPU). Returns (the backward's launches in (a), the
    phase's numbers)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train

    seq_len = 64 if reduced else 2048
    argv = LM_TRAIN_ARGS + ["--steps", str(LM_TRAIN_STEPS), "--seq-len",
                            str(seq_len)] + (["--reduced"] if reduced else [])
    if dev.type != "cuda":
        argv += ["--device", str(dev)]
    cfg = get_config("qwen1.5-0.5b", reduced=reduced)
    torch.cuda.empty_cache()
    zero_launches()
    res = train.main(argv)
    launches = read_launches()
    bwd = fa.flash_attention_bwd.launches
    fwd_want, bwd_want = lm_train_launches(cfg, LM_TRAIN_STEPS)
    want = {"defended_encode": 0, "zo_update": 0, "dual_matmul": 0,
            "flash_attention": fwd_want, "prng_draw": lm_init_draws(cfg)}
    loss = res["loss"]
    peak_gb = res["peak_bytes"] / 1e9
    log(f"[lm_train] qwen1.5-0.5b {cfg.num_params()} params, "
        f"{cfg.num_layers} layers, d {cfg.d_model}, remat {cfg.remat}: "
        f"setup {res['setup_s']:.2f} s, s per step "
        f"{[round(t, 4) for t in res['step_s']]}, loss {loss}, lr "
        f"{res['lr']}, peak {peak_gb:.2f} GB, launches {launches}, "
        f"flash_attention_bwd {bwd}")
    if launches != want or bwd != bwd_want:
        raise AssertionError(f"lm launches {launches} and {bwd} backward, "
                             f"want {want} and {bwd_want}")
    if len(loss) != LM_TRAIN_STEPS or not all(map(math.isfinite, loss)):
        raise AssertionError(f"lm losses {loss}")
    if not abs(loss[0] - math.log(cfg.vocab_size)) < 1.0:
        raise AssertionError(f"first loss {loss[0]} is not within 1.0 of "
                             f"ln V = {math.log(cfg.vocab_size):.4f}")
    chunked = lm_chunked_peak(dev, cfg, res["state"].params, seq_len)
    del res["state"]
    torch.cuda.empty_cache()
    checks = lm_train_checks(dev)
    return bwd, {"steps": LM_TRAIN_STEPS, "loss": loss,
                 "step_s": res["step_s"], "steps_per_s": res["steps_per_s"],
                 "setup_s": res["setup_s"], "peak_gb": peak_gb,
                 "launches": {**launches, "flash_attention_bwd": bwd},
                 "chunked": chunked, "reduced_card_vs_cpu": checks}


def lm_chunked_peak(dev, cfg, params, seq_len):
    """(b): one training step of (a)'s model and batch shape (4 x
    ``seq_len``) with ``chunked_ce``, from (a)'s final weights: its loss
    (finite) and the peak device memory of the step, beside (a)'s."""
    import torch
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.train import make_batch_arrays
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import adam_init

    model = build_model(cfg.replace(chunked_ce=True))
    batch = make_batch_arrays(cfg, 4, seq_len, 1, dev)
    state = step_lib.TrainState(params, adam_init(params), 0)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, (loss, _) = step_lib.make_train_step(model)(state, batch)
    loss = float(loss)
    step_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated(dev) / 1e9
               if dev.type == "cuda" else 0.0)
    if not math.isfinite(loss):
        raise AssertionError(f"chunked-loss step: loss {loss}")
    log(f"[lm_train] chunked_ce: one step {step_s:.3f} s, loss {loss}, "
        f"peak {peak_gb:.2f} GB")
    return {"loss": loss, "step_s": step_s, "peak_gb": peak_gb}


def lm_train_checks(dev):
    """(c): each architecture reduced (f32) from one state on the card and
    on the CPU: initial weights bitwise; 3 Adam steps, each run on both
    from the card's state and batch: the loss within LM_TRAIN_TOL, and at
    the first step every gradient leaf within LM_TRAIN_TOL of its largest
    magnitude on the CPU; then qwen1.5-0.5b with explicit positions (out
    of order, repeats), a loss mask and the chunked loss. Returns
    {arch: the largest loss gap and relative gradient gap}."""
    import numpy as np
    import torch
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.train import make_batch_arrays
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng, trees

    B, S, steps = LM_TRAIN_CHECK
    cpu = torch.device("cpu")
    out = {}
    runs = [(arch, {}) for arch in ARCH_IDS] + [
        ("qwen1.5-0.5b+positions+mask+chunked", {"chunked_ce": True})]
    for name, replace in runs:
        arch = name.split("+")[0]
        cfg = get_config(arch, reduced=True).replace(**replace)
        model = build_model(cfg)
        states = {d: step_lib.make_train_state(model, prng.key(0), d)
                  for d in (dev, cpu)}
        if not all(bitwise_equal(a.cpu(), b) for a, b in zip(
                trees.leaves(states[dev].params),
                trees.leaves(states[cpu].params))):
            raise AssertionError(f"{name}: initial weights differ")
        data = make_batch_arrays(cfg, B * steps, S, 0, cpu)
        if replace:
            rng = np.random.default_rng(3)
            data["positions"] = torch.as_tensor(
                rng.integers(0, S + 8, (B * steps, S)))
            data["loss_mask"] = torch.as_tensor(
                (rng.random((B * steps, S)) < 0.6).astype(np.int32))
        step = step_lib.make_train_step(model)
        state = states[dev]
        gaps, grad_gap = [], 0.0
        for s in range(steps):
            batch = {k: a[s * B:(s + 1) * B] for k, a in data.items()}
            on_cpu = trees.tree_map(lambda a: a.cpu(),
                                    {"p": state.params, "o": state.opt})
            if s == 0:
                grad_gap = lm_grad_gap(model, state.params, on_cpu["p"],
                                       batch, dev)
            _, (l_cpu, _) = step(step_lib.TrainState(
                on_cpu["p"], on_cpu["o"], state.step), batch)
            state, (l_dev, _) = step(
                state, {k: a.to(dev) for k, a in batch.items()})
            gaps.append(abs(float(l_dev) - float(l_cpu)))
        if not (max(gaps) <= LM_TRAIN_TOL and grad_gap <= LM_TRAIN_TOL):
            raise AssertionError(f"{name}: card vs CPU loss gaps {gaps}, "
                                 f"gradient gap {grad_gap}")
        out[name] = {"loss_gaps": gaps, "grad_rel_gap": grad_gap}
    log(f"[lm_train] reduced, card vs CPU, {steps} Adam steps each from "
        f"one state: {json.dumps(out)}")
    return out


def lm_grad_gap(model, params_dev, params_cpu, batch, dev):
    """The largest |card - CPU| of a gradient leaf over that leaf's largest
    magnitude on the CPU, for one loss at the same weights and batch."""
    import torch
    from repro_torch.utils import trees

    grads = []
    for params, d in ((params_dev, dev), (params_cpu, torch.device("cpu"))):
        live = [t.detach().requires_grad_(True)
                for t in trees.leaves(params)]
        loss, _ = model.loss(trees.unflatten(params, live),
                             {k: a.to(d) for k, a in batch.items()})
        grads.append(torch.autograd.grad(loss, live))
    return max(float((a.cpu() - b).abs().max())
               / max(float(b.abs().max()), 1e-30)
               for a, b in zip(*grads))


# the backward kernel's rows (B, S, H, KV, hd, dtype, causal, blind): the
# vfl-zoo and lm shape in bf16 (qwen1.5-0.5b, batch 4, S 2048), qwen3-moe's
# GQA 32/4 at hd 128, whisper's encoder (full, S 1500), the reduced f32
# shape (2 layers of d 256: 4 heads of 64, batch 2, S 32), and explicit q
# and kv positions with rows that see no key
FLASH_BWD_CASES = [(4, 2048, 16, 16, 64, "bf16", True, False),
                   (4, 2048, 32, 4, 128, "bf16", True, False),
                   (4, 1500, 12, 12, 64, "bf16", False, False),
                   (2, 32, 4, 4, 64, "f32", True, False),
                   (2, 1000, 8, 4, 64, "f32", True, True),
                   (2, 1000, 8, 4, 128, "bf16", True, True)]
# max |kernel - plain| over the plain gradient's largest magnitude
FLASH_BWD_TOL = {"f32": 1e-4, "bf16": 2e-2}


def flash_bwd_bound(B, S, H, KV, hd, esize, causal):
    """(bytes time, operations time, f32 tensor-core time or None) of one
    backward: q, k, v, o, dO and lse read once, dq, dk, dv written once;
    5 products (q.k, dO.v, p^T dO, ds k, ds^T q) over the pairs the mask
    keeps, twice the forward's 2; bf16 at the tensor cores' rate, f32 at
    the CUDA cores' (and 3xTF32 on the tensor cores beside it)."""
    nbytes = (4 * B * S * H * hd + 4 * B * S * KV * hd) * esize \
        + 4 * B * H * S
    pairs = S * (S + 1) // 2 if causal else S * S
    n_ops = 5 * 2 * B * H * hd * pairs
    rate = BF16_TC_FLOPS_PER_S if esize == 2 else F32_FLOPS_PER_S
    t_tc = None if esize == 2 else 3 * n_ops / TF32_TC_FLOPS_PER_S
    return nbytes / HBM_BYTES_PER_S, n_ops / rate, t_tc


def flash_bwd_phase(dev):
    """The backward kernel against flash_attention_bwd_plain from the same
    forward output and lse (FLASH_BWD_TOL), two calls bitwise; the
    forward with lse gives the forward-only launch's output bitwise; with
    positions, rows that see no key have the plain version's lse below
    MASKED_LSE and the mean of v. Times: one call, traced, the plain
    version, and the backward of scaled_dot_product_attention through
    autograd (the yardstick); with positions, SDPA takes an additive float
    mask of -1e30 where kv_pos > q_pos, under which a row that sees no key
    is the mean of v, as in the reference."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa

    gen = torch.Generator(device=dev).manual_seed(3)
    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    worst, timed = 0.0, None
    for B, S, H, KV, hd, dt, causal, blind in FLASH_BWD_CASES:
        q, do = (torch.randn(B, S, H, hd, device=dev, generator=gen)
                 .to(dtypes[dt]) for _ in range(2))
        k, v = (torch.randn(B, S, KV, hd, device=dev, generator=gen)
                .to(dtypes[dt]) for _ in range(2))
        qp = kp = None
        if blind:
            qp = torch.randint(0, S, (B, S), device=dev, generator=gen)
            kp = torch.randint(5, S, (B, S), device=dev, generator=gen)
            qp[0, :3] = 2
        out, lse = fa._launch_fwd(q, k, v, causal, qp, True, kp)
        where = f"{(B, S, H, KV, hd)} {dt} causal={causal} blind={blind}"
        if not blind and not bitwise_equal(
                out, fa.flash_attention(q, k, v, causal)):
            raise AssertionError(f"the forward with lse is not the "
                                 f"forward-only launch at {where}")
        want_out, want_lse = fa.flash_attention_plain(q, k, v, causal, qp,
                                                      True, kp)
        seen = want_lse > fa.MASKED_LSE
        if not (bool(((lse > fa.MASKED_LSE) == seen).all())
                and float((lse - want_lse)[seen].abs().max())
                <= 1e-5 * float(want_lse[seen].abs().max())):
            raise AssertionError(f"flash_attention lse != plain at {where}")
        if blind:
            mean = v[0].float().mean(0).repeat_interleave(H // KV, 0)
            if not float((out[0, 0].float() - mean).abs().max()) <= \
                    FLASH_BWD_TOL[dt] * float(mean.abs().max()):
                raise AssertionError(f"a row that sees no key is not the "
                                     f"mean of v at {where}")

        def kernel():
            return fa.flash_attention_bwd(q, k, v, out, do, lse, causal, qp,
                                          kp)

        got, again = kernel(), kernel()
        want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, causal, qp,
                                            kp)
        torch.cuda.synchronize()
        if not all(bitwise_equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f"flash_attention_bwd: two calls differ at "
                                 f"{where}")
        errs = [max_abs(a, w) for a, w in zip(got, want)]
        rels = [e / float(w.float().abs().max()) for e, w in zip(errs, want)]
        if not max(rels) <= FLASH_BWD_TOL[dt]:
            raise AssertionError(f"flash_attention_bwd != plain at {where}: "
                                 f"relative errors {rels}")
        worst = max(worst, max(errs))
        kern = time_ms(kernel)
        plain = time_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, out, do, lse, causal, qp, kp))
        leaves = [t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v)]
        mask = None
        if blind:
            mask = torch.where(kp[:, None, None, :] > qp[:, None, :, None],
                               torch.tensor(-1e30, dtype=q.dtype, device=dev),
                               torch.tensor(0.0, dtype=q.dtype, device=dev))
        sdpa = F.scaled_dot_product_attention(
            *leaves, attn_mask=mask, is_causal=causal and not blind,
            enable_gqa=KV != H)
        do_t = do.transpose(1, 2)

        def library():
            return torch.autograd.grad(sdpa, leaves, do_t, retain_graph=True)
        lib, traced_lib = time_ms(library), traced_ms(library)
        t_bytes, t_ops, t_tc = flash_bwd_bound(B, S, H, KV, hd,
                                               q.element_size(), causal)
        row = {"kernel": "flash_attention_bwd", "shape": [B, S, H, KV, hd],
               "dtype": dt, "causal": causal, "positions": blind,
               "max_abs_err": max(errs), "rel_errs": rels,
               "tol": FLASH_BWD_TOL[dt], "kernel_ms": kern,
               "kernel_traced_ms": traced_ms(kernel), "plain_ms": plain,
               "library_ms": lib, "library_traced_ms": traced_lib,
               "bound_ms": max(t_bytes, t_ops) * 1e3,
               "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
        if t_tc is not None:
            row["tensor_core_bound_ms"] = max(t_bytes, t_tc) * 1e3
        log(json.dumps(row))
        if (B, S, H, KV, hd, dt) == (4, 2048, 16, 16, 64, "bf16"):
            timed = row
        del q, k, v, do, out, lse, got, again, want, leaves, sdpa, mask
        torch.cuda.empty_cache()
    return timed, worst


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
                         "flash_attention": ("flash_attention_f32_kernel",
                                             "flash_attention_bf16_kernel"),
                         "flash_attention_bwd": ("flash_attention_bwd_",),
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


def _lm_workload(dev):
    """The LM-serving cell: phase 12 (a)'s engine (qwen1.5-0.5b at full
    width, bf16, slots 8, max_len 512, greedy) on its 16 requests, 8 engine
    steps of warm-up, then 32 steps (every slot busy: a request holds its
    slot for at least 31 steps, and 8 more wait in the queue)."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.utils import prng

    cfg = get_config(LM_ARCH)
    model = build_model(cfg)
    eng = ServingEngine(model, model.init(prng.key(0), dev), slots=LM_SLOTS,
                        max_len=LM_MAX_LEN, device=dev)
    for rid, prompt, n in lm_requests(cfg.vocab_size):
        eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    for _ in range(8):
        eng.step()

    def run():
        for _ in range(32):
            eng.step()
    return run, 32, "engine_step"


def _lm_train_workload(dev):
    """One first-order training step of phase 14 (a)'s configuration
    (qwen1.5-0.5b at full width and depth, remat, batch 4, S 2048), after
    a warm-up step."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps, train
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng

    cfg = get_config("qwen1.5-0.5b")
    model = build_model(cfg)
    state = steps.make_train_state(model, prng.key(0), dev)
    batch = train.make_batch_arrays(cfg, 4, 2048, 0, dev)
    step = steps.make_train_step(model)
    state, (loss, _) = step(state, batch)
    float(loss)
    return (lambda: float(step(state, batch)[1][0])), 1, "step"


def _families_zoo_workload(dev, arch, layers, seq_len):
    """One vfl-zoo step of phase 13 (b)'s run of ``arch``
    (``family_zoo_run``), after a warm-up step."""
    import numpy as np
    from repro_torch.launch import train

    _, args, step, state, data = family_zoo_run(dev, arch, layers, seq_len)
    batch = train.draw_batch(np.random.default_rng(args.seed), data,
                             args.batch_size)
    state, h = step(state, batch)
    float(h)
    return (lambda: float(step(state, batch)[1])), 1, "step"


def _families_serve_workload(dev, arch):
    """8 decode steps of phase 13 (a)'s serve launcher on ``arch`` (full
    width and depth, bf16, batch 4; whisper's frames encoded into the
    cache), after its 32-token prompt and 4 generated tokens."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng

    cfg = get_config(arch)
    model = build_model(cfg)
    params = model.init(prng.key(0), dev)
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (4, 44)),
                           device=dev)
    frames = torch.as_tensor(rng.normal(size=(
        4, cfg.encoder_frames, cfg.d_model)).astype(np.float32),
        device=dev) if cfg.enc_dec else None
    cache = model.init_cache(params, 4, 48, frames=frames)
    for pos in range(36):
        model.decode_step(params, cache, toks[:, pos:pos + 1], pos)

    def run():
        for pos in range(36, 44):
            model.decode_step(params, cache, toks[:, pos:pos + 1], pos)
    return run, 8, "decode_step"


# phase 13's cells for --profile: one vfl-zoo step of each (b) run, 8
# decode steps of each (a) model
FAMILY_PROFILE = {
    "moe_zoo": lambda dev: _families_zoo_workload(dev, *FAMILY_ZOO[1]),
    "audio_zoo": lambda dev: _families_zoo_workload(dev, *FAMILY_ZOO[0]),
    "moe_serve": lambda dev: _families_serve_workload(dev, FAMILY_SERVE[0]),
    "vlm_serve": lambda dev: _families_serve_workload(dev, FAMILY_SERVE[1]),
    "audio_serve": lambda dev: _families_serve_workload(dev, FAMILY_SERVE[2]),
}


def profile_phase(dev, cell):
    """Trace one cell's workload with ``torch.profiler``: 2 serial rounds of
    a D7 FCN cell ("d7", "async"), 4 scan-trainer steps ("scan"), one
    vfl-zoo step ("zoo"), 128 served predictions ("serve"), 32 LM
    engine steps ("lm"), a cell of phase 13 (``FAMILY_PROFILE``) or one
    first-order training step ("lm_train"). Each
    ``prng.bits`` and ``prng.sample_direction`` call is a
    ``record_function`` span; a direction's span holds its bits span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.utils import prng

    run, units, unit = {"zoo": _zoo_workload, "scan": _scan_workload,
                        "serve": _serve_workload, "lm": _lm_workload,
                        "lm_train": _lm_train_workload,
                        **FAMILY_PROFILE}.get(
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

    flash = [e for e in dev_events if "flash_attention" in e.key
             and "bwd" not in e.key]
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
    del run, prof
    torch.cuda.empty_cache()        # the next cell's model may need the room


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
        for cell in ("d7", "async", "scan", "zoo", "serve", "lm",
                     *FAMILY_PROFILE, "lm_train"):
            profile_phase(dev, cell)
        return 0
    clock = PhaseClock()
    timed, worst = kernel_phase(dev, int_rate)
    timed["prng_draw"], worst["prng_draw"] = draw_phase(dev, int_rate)
    timed["dual_matmul"], worst["dual_matmul"] = dual_matmul_phase(dev)
    timed["flash_attention"], worst["flash_attention"] = flash_phase(dev)
    timed["flash_attention_bwd"], worst["flash_attention_bwd"] = \
        flash_bwd_phase(dev)
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
    log(json.dumps({"lm_serving": lm_serving_phase(dev)}))
    clock.lap("lm_serving")
    log(json.dumps({"families": families_phase(dev)}))
    clock.lap("families")
    launches["flash_attention_bwd"], lm_train = lm_train_phase(dev)
    log(json.dumps({"lm_train": lm_train}))
    clock.lap("lm_train")
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
        # not a Pallas kernel: the reference trains through pure-jnp
        # attention and XLA differentiates it
        "flash_attention_bwd": (
            "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "none: XLA's autodiff of blocked_attention, "
            "src/repro/models/attention.py:67"),
    }
    # launches: the D7 main path's fused run for defended_encode,
    # zo_update, dual_matmul and prng_draw, the vfl-zoo run for
    # flash_attention, phase 14 (a)'s lm run for flash_attention_bwd;
    # library_ms: no single torch call takes the keys or the bit streams
    # of defended_encode, zo_update and prng_draw (torch's own generator
    # draws other numbers), two torch.matmul calls compute dual_matmul,
    # scaled_dot_product_attention flash_attention, and its backward
    # through autograd flash_attention_bwd
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
