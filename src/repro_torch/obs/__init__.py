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
import threading
from typing import Optional

from repro_torch.obs.tracer import MONITOR_ENV, Tracer

__all__ = ["Tracer", "configure", "maybe_tracer", "trace", "ENV_VAR",
           "MONITOR_ENV"]

ENV_VAR = "REPRO_TRACE_DIR"

_LOCK = threading.Lock()
_UNSET = object()            # "not yet resolved from the environment"
_tracer = _UNSET
_NULL_SPAN = contextlib.nullcontext()   # shared: nullcontext is stateless
_term_hook_installed = False


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


def trace(name: str, **attrs):
    """A span context manager, or a shared no-op when tracing is off."""
    t = maybe_tracer()
    if t is None:
        return _NULL_SPAN
    return t.span(name, **attrs)


@atexit.register
def _flush_at_exit() -> None:
    # mp 'spawn' children exit through the normal interpreter shutdown,
    # so their buffered tail reaches disk even without an explicit close
    t = _tracer
    if t is not _UNSET and t is not None:
        t.close()
