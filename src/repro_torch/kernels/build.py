"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu``, with the local headers it includes (such as
``csrc/prng.cuh``), is compiled by ``nvcc`` on its own into a shared
library with a plain C interface, ``build/kernels/lib<name>-<hash>.so``
at the repository root, and loaded with ``ctypes``. Nothing is built when a module is
imported: the first launch builds what it needs, and ``build_all``
starts one ``nvcc`` per source, all at once.

Flags: ``sm_90a`` (Hopper), ``-O3``, and ``--fmad=false`` so the compiler
never contracts a multiply and an add the kernel did not write as an FMA
(the kernels also spell every rounding with ``__f*_rn`` intrinsics).
``CUDA_HOME`` (default ``/usr/local/cuda``) locates ``nvcc`` when it is
not on PATH. The hash in the library's name covers the source, every
local header it includes (``#include "..."``, followed through headers),
the flags and ``nvcc --version``, so an edited kernel or header, a changed
flag or another toolchain never loads a library built for something else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("defended_encode", "zo_update", "dual_matmul",
           "flash_attention", "prng_draw", "flash_attention_bwd")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

_LOADED: dict = {}
BUILD_LOG: dict = {}        # name -> (seconds, nvcc's stdout + stderr)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


@functools.cache
def _toolchain() -> bytes:
    """What a built library depends on besides its source: the flags and
    the compiler's version banner."""
    version = subprocess.run([_nvcc(), "--version"], capture_output=True,
                             check=True).stdout
    return "\0".join(NVCC_FLAGS).encode() + b"\0" + version


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.M)


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and the local headers it includes, directly or
    through another header, in the order first met."""
    seen, todo = [], [CSRC / f"{name}.cu"]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        todo += [path.parent / inc.decode()
                 for inc in _LOCAL_INCLUDE.findall(path.read_bytes())]
    return seen


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in sources(name):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    h.update(_toolchain())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def _start(name: str):
    out = _target(name)
    if out.exists():
        return None
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    return (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True),
            tmp, out, time.perf_counter())


def _finish(name: str, job) -> None:
    proc, tmp, out, t0 = job
    stdout, stderr = proc.communicate()
    BUILD_LOG[name] = (time.perf_counter() - t0, stdout + stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{stdout}{stderr}")
    os.replace(tmp, out)


def build_all(names=KERNELS) -> dict:
    """Compile every named kernel that is not built yet, in parallel.
    Returns {name: build seconds} for the ones compiled now."""
    jobs = {n: _start(n) for n in names}
    for n, job in jobs.items():
        if job is not None:
            _finish(n, job)
    return {n: BUILD_LOG[n][0] for n, job in jobs.items() if job is not None}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _declare(name, lib)
        _LOADED[name] = lib
    return lib


_P = ctypes.c_void_p
_I, _U, _F = ctypes.c_int, ctypes.c_uint, ctypes.c_float
_LL = ctypes.c_longlong
_SIGNATURES = {
    "flash_attention": {
        # q, k, v, out, B, S, H, KV, hd, scale, causal, stream
        f"flash_attention_{t}": (_P, _P, _P, _P,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_int, _P)
        for t in ("f32", "bf16")
    } | {
        # q, k, v, out, lse (or null), q and kv positions (or null), B, S,
        # H, KV, hd, scale, causal, stream
        f"flash_attention_fwd_{t}": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _I, _I, _F, _I, _P)
        for t in ("f32", "bf16")
    },
    "flash_attention_bwd": {
        # q, k, v, o, do, lse, q and kv positions (or null), dq, dk, dv, B,
        # S, H, KV, hd, scale, causal, stream
        "flash_attention_bwd_f32": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _I, _I, _I, _I, _I, _F, _I, _P),
        # the same with the (B, H, S, 4) f32 scratch after dv
        "flash_attention_bwd_bf16": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                     _P, _P, _I, _I, _I, _I, _I, _F, _I, _P),
    },
    "dual_matmul": {
        # x, ldx, w, u, mu, y0, y1, M, N, K, stream
        f"dual_matmul_{t}": (_P, ctypes.c_longlong, _P, _P, ctypes.c_float,
                             _P, _P, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, _P)
        for t in ("f32", "bf16")
    },
    "zo_update": {
        # w, bits, scale, out, n, stream
        "zo_update_f32": (_P, _P, ctypes.c_float, _P, ctypes.c_longlong, _P),
    },
    "defended_encode": {
        # c, dp_bits, has_dp, noise, clip, noise_scale, out_bf16, out, n,
        # stream
        "defended_encode_cast": (_P, _P, _I, _I, _F, _F, _I, _P, _LL, _P),
        # c, dp_k0, dp_k1, has_dp, noise, clip, noise_scale, out_bf16, out,
        # n, stream
        "defended_encode_cast_keyed": (_P, _U, _U, _I, _I, _F, _F, _I, _P,
                                       _LL, _P),
        # cooperative: c, dp_bits, rnd_bits, has_dp, noise, clip,
        # noise_scale, slots, max_slots, q, scale_out, n, stream
        "defended_encode_int8": (_P, _P, _P, _I, _I, _F, _F, _P, _I, _P, _P,
                                 _LL, _P),
        # cooperative: c, dp_k0, dp_k1, rnd_k0, rnd_k1, has_rnd, has_dp,
        # noise, clip, noise_scale, slots, max_slots, q, scale_out, n, stream
        "defended_encode_int8_keyed": (_P, _U, _U, _U, _U, _I, _I, _I, _F,
                                       _F, _P, _I, _P, _P, _LL, _P),
        # the slots an int8 launch needs at most
        "defended_encode_int8_slots": (),
    },
    "prng_draw": {
        # k0, k1, offset, mode, out, n, stream
        "prng_draw": (_U, _U, ctypes.c_ulonglong, _I, _P, _LL, _P),
    },
}


def _declare(name: str, lib: ctypes.CDLL) -> None:
    """Set each entry's argument and return types. A library built from an
    older source (a benchmark's baseline) may lack newer entries: those
    are left undeclared, and calling one raises."""
    for fn, argtypes in _SIGNATURES[name].items():
        f = getattr(lib, fn, None)
        if f is None:
            continue
        f.argtypes = argtypes
        f.restype = ctypes.c_int
