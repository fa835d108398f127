"""The port's runtime after a hard kill of the whole federation, on the
CPU: a party whose checkpoint lags the server replays a processed round
and is answered from the server's PERSISTED reply cache, and a server
whose newest snapshot is lost makes every party rewind to its progress;
both resumed runs are bitwise the uninterrupted one."""
import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import available_steps
from repro_torch.configs import RuntimeConfig
from repro_torch.runtime import history_losses, run_federation

pytestmark = [pytest.mark.torch, pytest.mark.runtime, pytest.mark.slow]
torch.set_num_threads(1)


def _spec():
    return {"kind": "lr", "parties": 2, "features": 16, "samples": 64,
            "batch": 8, "seed": 0,
            "vfl": {"mu": 1e-3, "lr_party": 1e-2, "lr_server": 1e-3}}


def _cfg():
    return RuntimeConfig(deadline_s=240.0)


@pytest.fixture(scope="module")
def uninterrupted():
    return run_federation(_spec(), 5, cfg=_cfg(), device="cpu")


def _same_party_finals(a, b):
    for m in range(2):
        np.testing.assert_array_equal(a["parties"][m]["final_w"]["w"],
                                      b["parties"][m]["final_w"]["w"])


def test_resume_replays_rounds_behind_server_from_persisted_cache(
        uninterrupted, tmp_path):
    """Every party's newest checkpoint is deleted between runs (a kill in
    the window between the server processing a round and the party
    checkpointing it): on resume each replays round 2, the server answers
    it from the persisted cache without advancing, and the history gains
    only the new rounds."""
    root = str(tmp_path)
    first = run_federation(_spec(), 3, cfg=_cfg(), ckpt_root=root,
                           device="cpu")
    for m in range(2):
        for suffix in ("npz", "json"):
            os.remove(os.path.join(root, f"party{m}",
                                   f"step_00000003.{suffix}"))
    second = run_federation(_spec(), 5, cfg=_cfg(), ckpt_root=root,
                            resume=True, device="cpu")
    stitched = np.concatenate([history_losses(first),
                               history_losses(second)])
    np.testing.assert_array_equal(stitched, history_losses(uninterrupted))
    _same_party_finals(uninterrupted, second)


def test_resume_rewinds_party_when_server_snapshot_lags(uninterrupted,
                                                        tmp_path):
    """The server's newest snapshot is lost while the parties checkpointed
    further: the welcome tells each party the server's restored progress,
    the party rewinds to it, and the lost rounds re-execute exactly."""
    root = str(tmp_path)
    run_federation(_spec(), 3, cfg=_cfg(), ckpt_root=root, device="cpu")
    server_dir = os.path.join(root, "server")
    steps = available_steps(server_dir)
    assert len(steps) > 1                # cadence snapshots exist
    for suffix in ("npz", "json"):
        os.remove(os.path.join(server_dir, f"step_{steps[-1]:08d}.{suffix}"))
    restored_updates = available_steps(server_dir)[-1]
    second = run_federation(_spec(), 5, cfg=_cfg(), ckpt_root=root,
                            resume=True, device="cpu")
    np.testing.assert_array_equal(
        history_losses(second),
        history_losses(uninterrupted)[restored_updates:])
    _same_party_finals(uninterrupted, second)


def test_dispatch_waits_for_every_party_to_join(uninterrupted):
    """The server (in this process, on a thread) holds a round that
    arrives before every party has said hello: party 0's first round
    waits until party 1 joins, and the run is then the uninterrupted
    one. The wait is a property of the dispatcher, not of timing: without
    party 1 the round would wait for ever."""
    import threading

    from repro_torch.runtime.party import party_main
    from repro_torch.runtime.server import RuntimeServer
    server = RuntimeServer(_spec(), 5, _cfg(), device="cpu")
    ports, out, threads = [], {}, []

    def run(name, fn, *args):
        def body():
            out[name] = fn(*args)
        threads.append(threading.Thread(target=body, daemon=True))
        threads[-1].start()

    run("server", server.serve, ports.append)
    while not ports:
        threads[0].join(timeout=0.05)
    run(0, party_main, _spec(), 0, ports[0], 5, _cfg(), None, None, False,
        None, "cpu")
    threads[-1].join(timeout=2.0)       # party 0 sends round 0 and waits
    with server.core.lock:
        assert server.core.losses.updates == 0
        assert server._processed == [0, 0]
    run(1, party_main, _spec(), 1, ports[0], 5, _cfg(), None, None, False,
        None, "cpu")
    for t in threads:
        t.join(timeout=120.0)
    assert not any(t.is_alive() for t in threads)
    np.testing.assert_array_equal(
        [h for _, h in out["server"]["history"]],
        history_losses(uninterrupted))
    _same_party_finals(uninterrupted, {"parties": out})
    assert [k for k, _ in out["server"]["levels"]] == [1, 2, 3, 4, 5]
