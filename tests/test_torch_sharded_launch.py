"""The launcher's ``--data-parallel`` (launch/train.py) on the CPU under
gloo, against the port's own sharded vfl-zoo step (launch/steps.py with a
data group) driven through the library in two rank processes:

* 2 steps with ``--ckpt-dir`` (traced and monitored), then 2 more with
  ``--resume``, give the library's 4 world-2 steps bit for bit: h, and
  every rank's final state (its digest);
* the traced run's files merge (repro_torch/obs), rank 0's metric records
  carrying its h;
* an indivisible ``--batch-size`` and ``--data-parallel`` outside the
  vfl-zoo trainer are parse errors;
* a rank that raises, or ranks that outlive the run's time limit, fail
  the run within it, and no rank process is left.

The world-2 path against the reference is tests/test_torch_sharded.py's.
This file imports no jax, so its rank processes start quickly.
"""
import multiprocessing
import time

import numpy as np
import pytest
import torch

from repro_torch.configs import VFLConfig, get_config
from repro_torch.core import asyrevel
from repro_torch.data.synthetic import make_lm_dataset
from repro_torch.launch import mesh, train
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

WORLD = 2
ZOO_ARGS = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
            "--parties", "4", "--batch-size", "4", "--seq-len", "8",
            "--fused", "--codec", "int8", "--lr", "1e-2", "--log-every", "1",
            "--device", "cpu", "--data-parallel", str(WORLD)]
ZOO_STEPS = 4


def _library_rank(rank, world, rendezvous, steps=ZOO_STEPS):
    """The sharded vfl-zoo step driven as ZOO_ARGS ask, through the
    library: reduced qwen1.5-0.5b, 64 rows from the seed, the global batch
    of 4 drawn with numpy each step, 2 rows a rank."""
    group = mesh.make_data_mesh(world, rank, rendezvous, device="cpu")
    try:
        cfg = get_config("qwen1.5-0.5b", reduced=True)
        vfl = VFLConfig(num_parties=4, mu=1e-3, lr_party=1e-2,
                        lr_server=1e-2 / 4, fused=True, codec="int8")
        _, init, step = step_lib.make_vfl_zoo_step(build_model(cfg), vfl,
                                                   group)
        state = init(prng.key(0), group.device)
        toks, targets = make_lm_dataset(64, 8, cfg.vocab_size, 0)
        data = {"tokens": torch.as_tensor(toks),
                "targets": torch.as_tensor(targets)}
        rng = np.random.default_rng(0)
        h = []
        for _ in range(steps):
            idx = torch.as_tensor(rng.integers(0, 64, 4))
            state, loss = step(state, {k: a[idx] for k, a in data.items()})
            h.append(float(loss))
        return {"h": h, "digest": asyrevel.state_digest(state),
                "all_reduces": group.all_reduces}
    finally:
        group.close()


def test_launcher_resumed_run_is_the_librarys_world2_run(tmp_path):
    from repro_torch.obs import collect
    lib = mesh.spawn_ranks(_library_rank, WORLD, timeout_s=240.0)
    assert lib[0] == lib[1]
    assert lib[0]["all_reduces"] == 3 * ZOO_STEPS  # h, h_bar, h_hat a step
    ckpt, tr = tmp_path / "ckpt", tmp_path / "trace"
    first = train.main(ZOO_ARGS + ["--steps", "2", "--ckpt-dir", str(ckpt),
                                   "--trace", str(tr), "--monitor"])
    rest = train.main(ZOO_ARGS + ["--steps", "2", "--ckpt-dir", str(ckpt),
                                  "--resume"])
    assert first["h"] + rest["h"] == lib[0]["h"]
    assert rest["start_step"] == 2 and rest["data_parallel"] == WORLD
    assert [r["rank"] for r in rest["ranks"]] == list(range(WORLD))
    assert [r["digest"] for r in rest["ranks"]] == [lib[0]["digest"]] * WORLD
    for run in (first, rest):
        assert all(r["backend"] == "gloo" and r["device"] == "cpu"
                   and r["all_reduces"] == 3 * 2 for r in run["ranks"])
        assert run["ranks"][0]["launches"] == run["ranks"][1]["launches"]
    assert (ckpt / "step_00000004.npz").exists()
    # the traced and monitored run: a file a process, rank 0's h records
    assert sorted(p.name.split("-")[1] for p in tr.glob("trace-*.jsonl")) \
        == ["dp", "dp", "launch"]
    recs = collect.load_dir(str(tr))
    hs = [r["h"] for r in recs if r.get("ev") == "metric"
          and r["role"] == "dp-rank0" and "h" in r]
    assert hs == first["h"]
    assert first["alerts"] == []
    assert multiprocessing.active_children() == []


@pytest.mark.parametrize("extra,needle", [
    (["--mode", "vfl-zoo", "--batch-size", "3"],
     "must divide by --data-parallel"),
    (["--mode", "lm"], "--mode vfl-zoo"),
    (["--mode", "vfl-zoo", "--serve", "4"], "--mode vfl-zoo"),
    (["--mode", "vfl-zoo", "--data-parallel", "0"], "positive")],
    ids=["indivisible-batch", "lm", "serve", "zero"])
def test_launcher_data_parallel_parse_errors(extra, needle, capsys):
    """The reference's assertion that the batch divides, as a parse error;
    --data-parallel outside the in-memory vfl-zoo trainer refused."""
    with pytest.raises(SystemExit) as exc:
        train.parse_args(["--arch", "qwen1.5-0.5b", "--reduced",
                          "--batch-size", "4", "--data-parallel", "2"]
                         + extra)
    assert exc.value.code == 2
    assert needle in capsys.readouterr().err


def _raising_rank(rank, world, rendezvous, args):
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    return train._rank_main(rank, world, rendezvous, args)


def _hanging_rank(rank, world, rendezvous):
    time.sleep(600)


@pytest.mark.parametrize("target,limit,needle", [
    (_raising_rank, 120.0, "rank 1 failed"),
    (_hanging_rank, 6.0, "within 6 s")], ids=["raises", "hangs"])
def test_a_failed_rank_fails_the_run(target, limit, needle):
    """One rank raises while the other joins the group and trains, or
    every rank outlives the run's time limit: the run raises RankError
    within the limit, and no rank process is left."""
    args = ((train.parse_args(ZOO_ARGS + ["--steps", "2"]),)
            if target is _raising_rank else ())
    t0 = time.monotonic()
    with pytest.raises(mesh.RankError, match=needle):
        mesh.spawn_ranks(target, WORLD, args, timeout_s=limit)
    assert time.monotonic() - t0 < limit + 20.0
    assert multiprocessing.active_children() == []
