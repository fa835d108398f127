"""The data-parallel group of the sharded ZO-VFL trainer, the counterpart
of the reference's ``make_data_mesh`` (launch/mesh.py): a 1-D 'data' axis
of ``world`` ranks, each an OS process with its own device, over
``torch.distributed``.

    group = make_data_mesh(2, rank, "file:///tmp/x/store")   # in each rank
    results = spawn_ranks(fn, 2, args)     # fn(rank, world, rendezvous, *args)

The batch shards over the ranks and the party and server parameters
replicate (core/asyrevel.py ``train_sharded``), so the only collective a
run issues is the ``all_reduce`` of each server loss
(``DataGroup.all_reduce_sum``).

* **Device.** Rank r takes ``cuda:{r % torch.cuda.device_count()}``; the
  CPU only when the caller names it (one thread a rank).
* **Backend.** NCCL when every rank has a card of its own, gloo when
  ranks share a card (gloo reduces CUDA tensors too) or run on the CPU.
* **Rendezvous.** A ``FileStore`` (``file://`` in a temporary directory),
  so runs side by side never race for a port.
* **Timeouts.** ``init_process_group`` and every collective give up after
  ``TIMEOUT_S``; ``spawn_ranks`` fails the whole run when a rank raises,
  dies or outlives its time limit, and kills the others. Nothing falls
  back to fewer ranks or to the CPU.

The reference's production and host meshes serve only its dry-run, and
its TPU constants only its roofline: neither has a counterpart.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist

from repro_torch.utils.device import child_device

TIMEOUT_S = 300.0           # the group's rendezvous and each collective
RESULT_GRACE_S = 10.0       # a rank that exited 0: its result's way over


class RankError(RuntimeError):
    """A rank of a data-parallel run failed; the run failed with it."""


@dataclass
class DataGroup:
    """One rank's view of the data axis: its rank, the world size, its
    device, the backend and the process group, and the count and host
    seconds of the ``all_reduce`` calls it made."""

    rank: int
    world: int
    device: torch.device
    backend: str
    group: object
    store_dir: str | None = None       # a rendezvous this group made
    all_reduces: int = 0
    all_reduce_s: float = 0.0

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks, a new tensor shaped like ``t``
        and bitwise the same on every rank. Counted, with the host seconds
        of the call (with gloo it returns when the sum is there; with
        NCCL when it is queued on the stream)."""
        out = t.detach().reshape(1).clone()
        t0 = time.perf_counter()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        self.all_reduce_s += time.perf_counter() - t0
        self.all_reduces += 1
        return out.reshape(t.shape)

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def close(self) -> None:
        """Leave the group (every rank calls it) and drop a rendezvous
        directory the group made."""
        if dist.is_initialized():
            dist.destroy_process_group()
        if self.store_dir is not None:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None


def rank_device(rank: int, device=None) -> torch.device:
    """Rank ``rank``'s device: the CPU when ``device`` names it (one thread
    a rank), else ``cuda:{rank % count}``, which must exist."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cpu":
            return child_device("cpu")
        if dev.type != "cuda" or dev.index is not None:
            raise ValueError(f"rank {rank}: device {device!r}: a data group "
                             "places rank r on cuda:{r % cards}, or on the "
                             "CPU when asked")
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(f"rank {rank}: no CUDA device; pass device='cpu' "
                           "explicitly to run the ranks on the CPU")
    return child_device(f"cuda:{rank % n}")


def make_data_mesh(data_parallel: int, rank: int = 0,
                   rendezvous: str | None = None, device=None) -> DataGroup:
    """Join rank ``rank`` of a ``data_parallel``-rank data group at
    ``rendezvous`` (a ``file://`` URL every rank shares; None makes one,
    for a group of one rank) on ``rank_device(rank, device)``. Every rank
    calls it; it returns when all have joined, or raises after
    ``TIMEOUT_S``, as does every collective of the group."""
    world = int(data_parallel)
    if world < 1 or not 0 <= rank < world:
        raise ValueError(f"rank {rank} of a data group of {world}")
    dev = rank_device(rank, device)
    store_dir = None
    if rendezvous is None:
        if world != 1:
            raise ValueError("a data group of more than one rank needs the "
                             "rendezvous every rank shares")
        store_dir = tempfile.mkdtemp(prefix="dp-rdzv-")
        rendezvous = "file://" + os.path.join(store_dir, "store")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = "nccl" if world <= torch.cuda.device_count() else "gloo"
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=rendezvous,
                            world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return DataGroup(rank, world, dev, backend, dist.group.WORLD, store_dir)


# ------------------------------------------------------------ the ranks ----

def _rank_entry(target, rank, world, rendezvous, args, result_q):
    try:
        out = target(rank, world, rendezvous, *args)
    except BaseException:
        result_q.put(("error", rank, traceback.format_exc()))
        raise
    result_q.put(("ok", rank, out))


def _terminate(procs) -> None:
    for p in procs:
        if p.is_alive():
            p.terminate()
    for p in procs:
        p.join(timeout=5.0)
        if p.is_alive():
            p.kill()
            p.join(timeout=5.0)


def spawn_ranks(target, world: int, args=(),
                timeout_s: float = 900.0) -> list:
    """Run ``target(rank, world, rendezvous, *args)`` in ``world`` OS
    processes ('spawn': CUDA cannot be forked), rank r named
    f"dp-rank{r}" (its trace role), and return their results in rank
    order. The run fails with RankError when a rank raises (its traceback
    in the message), exits without a result, does not exit, or the run
    outlives ``timeout_s``; every other rank is then terminated, killed if
    it must be, and joined."""
    ctx = mp.get_context("spawn")
    procs, results = [], {}
    with tempfile.TemporaryDirectory(prefix="dp-rdzv-") as root:
        rendezvous = "file://" + os.path.join(root, "store")
        result_q = ctx.Queue()
        try:
            for r in range(world):
                p = ctx.Process(target=_rank_entry,
                                args=(target, r, world, rendezvous, args,
                                      result_q),
                                name=f"dp-rank{r}", daemon=True)
                p.start()
                procs.append(p)
            deadline = time.monotonic() + timeout_s
            gone = {}
            while len(results) < world:
                if time.monotonic() > deadline:
                    raise RankError(
                        f"ranks {sorted(set(range(world)) - set(results))} "
                        f"gave no result within {timeout_s:.0f} s")
                try:
                    tag, r, payload = result_q.get(timeout=0.25)
                except queue_mod.Empty:
                    now = time.monotonic()
                    for r, p in enumerate(procs):
                        if r in results or p.exitcode is None:
                            continue
                        if p.exitcode != 0:
                            raise RankError(f"rank {r} exited with "
                                            f"{p.exitcode}")
                        if now - gone.setdefault(r, now) > RESULT_GRACE_S:
                            raise RankError(f"rank {r} exited without a "
                                            "result")
                    continue
                if tag == "error":
                    raise RankError(f"rank {r} failed:\n{payload}")
                results[r] = payload
            for p in procs:
                p.join(timeout=30.0)
            bad = [(p.name, p.exitcode) for p in procs if p.exitcode != 0]
            if bad:
                raise RankError(f"ranks did not exit cleanly: {bad}")
        except BaseException:
            _terminate(procs)
            raise
    return [results[r] for r in range(world)]
