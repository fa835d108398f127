"""Out-of-band observability for the federation, as the reference's
repro/obs (docs/observability.md): the same records, the same file names
and the same environment variables, so either package's collector merges
the other's traces.

Two entry points are approved for use inside the scoped subsystems
(core / runtime / dp / kernels; tests/test_torch_port_rules.py keeps the
discipline, since zvlint's obs-discipline rule matches only the
reference's module name), both free when tracing is off:

  with obs.trace("party_round", party=m, round=rnd): ...
      — a span, or a shared no-op context manager when no tracer is
        configured (one cached None check, no allocation)

  tr = obs.maybe_tracer()
  if tr is not None: tr.counter("reply_cache_hit", party=m)
      — the process tracer handle, or None

While ``torch.profiler`` records, ``trace`` also puts the span on the
profiler's trace (a FUNCTION-scope range of the same name, with no
device-side twin) and in a bounded in-memory record of the profiled
stretch, read with ``profiled_spans()``: (name, step, depth, t0_ns,
t1_ns), unix ns. The record holds the latest stretch only: the first
span after one that found the profiler off clears it. Off, a trace
point reads the profiler's flag besides the cached tracer.

  obs.profiled_count("moe.kept", lambda: kept.sum())
      — while torch.profiler records, the value (a number, or a device
        tensor left unsynced) with the step of the span around it, kept
        beside the profiled spans and resolved when read with
        ``profiled_counts()``; off, the function is never called

``configure(dir, role=...)`` is the explicit switch for unscoped code
(launch/train.py, tests, benchmarks); ``configure(None)`` flushes and
disables. Spawned children self-configure lazily: the runtime harness
exports ``REPRO_TRACE_DIR`` before spawning, and the child's first
``maybe_tracer()`` call opens its own trace file with a role derived
from the multiprocessing process name. Merge the per-process files with
``python -m repro_torch.obs <dir>``.

Live plane: when ``REPRO_MONITOR_ADDR`` is exported (the harness does
this under ``RuntimeConfig.monitor``), every tracer additionally mirrors
its records to the parent's ``obs.monitor.MonitorServer`` collector and
the online detectors in ``obs.health`` score them as they arrive; watch
with ``python -m repro_torch.obs.live <dir>``. Configuring a tracer also arms
the flight recorder: a SIGTERM dumps the ring of recent records to
``flight-<role>-<pid>.jsonl`` before the process dies.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import signal
import sys
import threading
from collections import deque
from typing import Optional

from repro_torch.obs.tracer import (MONITOR_ENV, ProfiledCount,
                                    ProfiledSpan, ProfilerSpan, Tracer,
                                    open_step)

__all__ = ["Tracer", "configure", "maybe_tracer", "trace", "profiled_spans",
           "profiled_count", "profiled_counts", "ProfiledSpan",
           "ProfiledCount", "ENV_VAR", "MONITOR_ENV", "PROFILED_SPANS_MAX"]

ENV_VAR = "REPRO_TRACE_DIR"

_LOCK = threading.Lock()
_UNSET = object()            # "not yet resolved from the environment"
_tracer = _UNSET
_NULL_SPAN = contextlib.nullcontext()   # shared: nullcontext is stateless
_term_hook_installed = False
# the profiled stretch's spans and counts (each record holds this many).
# torch's profiler flag is read from its module once a process has
# imported torch, so the collector and the live view never import it
PROFILED_SPANS_MAX = 16384
_profiled: deque = deque(maxlen=PROFILED_SPANS_MAX)
_counted: deque = deque(maxlen=PROFILED_SPANS_MAX)
_profiler_was_off = True
_profiler = None                # torch.autograd.profiler, once imported


class _NoProfiler:
    _is_profiler_enabled = False


def _find_profiler():
    global _profiler
    _profiler = sys.modules.get("torch.autograd.profiler")
    return _profiler or _NoProfiler


def configure(out_dir: Optional[str], role: Optional[str] = None):
    """Install (or, with ``out_dir=None``, tear down) this process's
    tracer. Returns the new tracer or None. The previous tracer, if any,
    is flushed and closed."""
    global _tracer
    with _LOCK:
        if _tracer is not _UNSET and _tracer is not None:
            _tracer.close()
        _tracer = Tracer(out_dir, role=role) if out_dir else None
        t = _tracer
    if t is not None:
        _install_term_dump()
    return t


def maybe_tracer() -> Optional[Tracer]:
    """The process tracer, or None when tracing is off. First call in a
    process that was never ``configure``d resolves ``REPRO_TRACE_DIR``
    once and caches the answer — the steady-state cost of a disabled
    trace point is this single attribute read."""
    global _tracer
    t = _tracer
    if t is not _UNSET:
        return t
    with _LOCK:
        if _tracer is _UNSET:
            out_dir = os.environ.get(ENV_VAR)
            _tracer = Tracer(out_dir) if out_dir else None
        t = _tracer
    if t is not None:
        _install_term_dump()
    return t


def _install_term_dump() -> None:
    """SIGTERM -> dump the flight ring, close the tracer, then die with
    the default signal semantics (the handler re-raises after restoring
    SIG_DFL, so the exit status still says 'killed by SIGTERM' and the
    harness's terminate/join/kill escalation is unchanged). ``os._exit``
    bypasses signals and atexit both — that path is covered by the
    monitor-side ring in ``obs.monitor``. No-op off the main thread
    (signal.signal would raise) and installed at most once."""
    global _term_hook_installed
    if _term_hook_installed:
        return
    if threading.current_thread() is not threading.main_thread():
        return
    try:
        prev = signal.getsignal(signal.SIGTERM)

        def _dump_and_die(signum, frame):
            t = _tracer
            if t is not _UNSET and t is not None:
                try:
                    t.dump_flight(f"signal:{signum}")
                    t.close()
                except Exception:
                    pass                      # we are dying; best effort
            signal.signal(signum, prev if callable(prev) else signal.SIG_DFL)
            os.kill(os.getpid(), signum)

        signal.signal(signal.SIGTERM, _dump_and_die)
        _term_hook_installed = True
    except (ValueError, OSError):
        pass                                  # exotic embedding: skip


def _profiling() -> bool:
    """Whether ``torch.profiler`` records. The first call that finds it
    on after one that found it off clears the profiled records."""
    global _profiler_was_off
    if (_profiler or _find_profiler())._is_profiler_enabled:
        if _profiler_was_off:
            _profiled.clear()
            _counted.clear()
            _profiler_was_off = False
        return True
    _profiler_was_off = True
    return False


def trace(name: str, **attrs):
    """A span context manager: the tracer's span when one is configured,
    a ``ProfilerSpan`` around it while ``torch.profiler`` records, else
    a shared no-op."""
    t = _tracer
    if t is _UNSET:
        t = maybe_tracer()
    if _profiling():
        return ProfilerSpan(name, attrs.get("step"),
                            None if t is None else t.span(name, **attrs),
                            _profiled)
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


def profiled_count(name: str, value) -> None:
    """While ``torch.profiler`` records, ``value()`` with the step of the
    profiled span around it (None outside any), for ``profiled_counts``;
    off, ``value`` is not called, so an untraced step does no more work."""
    if _profiling():
        _counted.append((name, open_step(), value()))


def profiled_spans() -> tuple:
    """The latest profiled stretch's spans (``ProfiledSpan``), in the
    order they closed; at most ``PROFILED_SPANS_MAX``, the newest."""
    return tuple(_profiled)


def profiled_counts() -> tuple:
    """The latest profiled stretch's counts (``ProfiledCount``), in the
    order they were made, each value resolved to a float (a device
    tensor syncs here, after the traced steps); at most
    ``PROFILED_SPANS_MAX``, the newest."""
    return tuple(ProfiledCount(n, s, float(v)) for n, s, v in _counted)


@atexit.register
def _flush_at_exit() -> None:
    # mp 'spawn' children exit through the normal interpreter shutdown,
    # so their buffered tail reaches disk even without an explicit close
    t = _tracer
    if t is not _UNSET and t is not None:
        t.close()
