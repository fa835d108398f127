"""The port's runtime through faults, on the CPU: a party crash with a
checkpointed rejoin, and a stop and resume of the whole federation, each
bitwise the uninterrupted run; the launcher's ``--transport tcp`` with
``--dropout-at`` and ``--ckpt-dir``/``--resume``, and its in-memory
vfl-zoo resume (2 steps, then 2 resumed, bitwise 4 straight)."""

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step, load_metadata
from repro_torch.configs import RuntimeConfig
from repro_torch.runtime import (CRASH_EXIT_CODE, FailurePlan, PartyFault,
                                 history_losses, run_federation)

pytestmark = [pytest.mark.torch, pytest.mark.runtime, pytest.mark.slow]
torch.set_num_threads(1)


def _spec():
    return {"kind": "lr", "parties": 2, "features": 16, "samples": 64,
            "batch": 8, "seed": 0,
            "vfl": {"mu": 1e-3, "lr_party": 5e-2, "lr_server": 1e-2}}


def _cfg(**kw):
    kw.setdefault("deadline_s", 240.0)
    return RuntimeConfig(**kw)


@pytest.fixture(scope="module")
def uninterrupted():
    """The 6-round run every faulted run must reproduce."""
    return run_federation(_spec(), 6, cfg=_cfg(), device="cpu")


def _same_finals(a, b):
    for m in range(2):
        for k, v in a["parties"][m]["final_w"].items():
            np.testing.assert_array_equal(v, b["parties"][m]["final_w"][k])
    for k, v in a["server"]["w0"].items():
        np.testing.assert_array_equal(v, b["server"]["w0"][k])


def test_party_crash_rejoin_resumes_losslessly(uninterrupted, tmp_path):
    """A scripted crash at round 3 and a delayed rejoin: the rejoined party
    restores its checkpoint, fast-forwards its RNG, and the federation
    reproduces the fault-free run bitwise across the process boundary."""
    plan = FailurePlan({1: PartyFault(crash_at_round=3,
                                      rejoin_delay_s=0.3)})
    crashed = run_federation(_spec(), 6, cfg=_cfg(), plan=plan,
                             ckpt_root=str(tmp_path), device="cpu")
    assert crashed["rejoins"] == 1
    assert crashed["server"]["disconnects"] == 1
    # every process exited by itself: the crasher's first process with
    # CRASH_EXIT_CODE, its respawn and every other process with 0
    assert crashed["exitcodes"] == [
        ("fed-server", 0), ("fed-party0", 0), ("fed-party1", CRASH_EXIT_CODE),
        ("fed-party1", 0)]
    np.testing.assert_array_equal(history_losses(uninterrupted),
                                  history_losses(crashed))
    _same_finals(uninterrupted, crashed)
    assert crashed["server"]["bytes_by_kind"] == \
        uninterrupted["server"]["bytes_by_kind"]
    # the membership change snapshotted the server state (and the final
    # run-complete snapshot landed at the last update)
    server_dir = str(tmp_path / "server")
    step = latest_step(server_dir)
    assert step == crashed["server"]["updates"] == 12
    assert load_metadata(server_dir, step)["updates"] == step
    assert latest_step(str(tmp_path / "party1")) == 6


def test_federation_stop_and_resume_is_bitwise_continuous(uninterrupted,
                                                          tmp_path):
    """Run 3 rounds with checkpoints, restart every process with
    resume=True for 6: the stitched trajectory and the final params equal
    the uninterrupted run's bitwise."""
    root = str(tmp_path)
    first = run_federation(_spec(), 3, cfg=_cfg(), ckpt_root=root,
                           device="cpu")
    second = run_federation(_spec(), 6, cfg=_cfg(), ckpt_root=root,
                            resume=True, device="cpu")
    stitched = np.concatenate([history_losses(first),
                               history_losses(second)])
    np.testing.assert_array_equal(stitched, history_losses(uninterrupted))
    _same_finals(uninterrupted, second)
    assert second["server"]["updates"] == 12


ZOO = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
       "--device", "cpu", "--log-every", "100"]


def test_launcher_tcp_dropout_rejoins_and_resumes(tmp_path):
    from repro_torch.launch import train
    ck = str(tmp_path / "fed")
    tcp = ZOO + ["--transport", "tcp", "--parties", "2", "--batch-size", "4",
                 "--lr", "1e-2", "--ckpt-dir", ck]
    res = train.main(tcp + ["--steps", "4", "--dropout-at", "2"])
    assert (res["rejoins"], res["disconnects"], res["updates"]) == (1, 1, 8)
    assert res["device"] == "cpu" and np.isfinite(res["h"]).all()
    more = train.main(tcp + ["--steps", "6", "--resume"])
    assert (more["rejoins"], more["updates"], len(more["h"])) == (0, 12, 4)


def test_launcher_vfl_zoo_resume_is_four_straight_steps(tmp_path):
    from repro_torch.launch import train
    zoo = ZOO + ["--batch-size", "2", "--seq-len", "16", "--fused",
                 "--codec", "int8"]
    a = train.main(zoo + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a")])
    b = train.main(zoo + ["--steps", "2", "--ckpt-dir", str(tmp_path / "a"),
                          "--resume"])
    c = train.main(zoo + ["--steps", "4", "--ckpt-dir", str(tmp_path / "c")])
    assert (a["start_step"], b["start_step"]) == (0, 2)
    assert a["h"] + b["h"] == c["h"]
    with np.load(tmp_path / "a" / "step_00000004.npz") as x, \
            np.load(tmp_path / "c" / "step_00000004.npz") as y:
        assert sorted(x.files) == sorted(y.files)
        assert {f.split("/")[0] for f in x.files} == {"w0", "parties", "hist"}
        for k in x.files:
            np.testing.assert_array_equal(x[k], y[k])
