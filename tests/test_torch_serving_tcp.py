"""The port's federated serving over TCP (runtime/serving.py) on the CPU:
party processes (``device="cpu"``, one thread each) restoring checkpointed
blocks and answering serve_down queries over sockets. A TCP run is
bitwise the port's in-memory engine with the same blocks and versions,
every process exits by itself with 0, the serving frames are byte-equal
to the reference transport's, and the reference's own front end serves
through port party processes as its in-memory engine does. Then the
launcher's ``--serve --transport tcp --ckpt-dir``."""
import contextlib
import io
import multiprocessing as mp
import os
import socket

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import RuntimeConfig as RefRuntimeConfig
from repro.core.exchange import ZOExchange as RefZOExchange
from repro.core.wire import Message as RefMessage
from repro.runtime.problem import build_problem as ref_build_problem
from repro.runtime.serving import RemotePartyBackend as RefRemotePartyBackend
from repro.runtime.serving import _accept_parties as ref_accept_parties
from repro.runtime.transport import encode_message as ref_encode_message
from repro.serving.federated import \
    FederatedServingEngine as RefFederatedServingEngine
from repro.serving.federated import ServeRequest as RefServeRequest
from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import RuntimeConfig
from repro_torch.core.exchange import ZOExchange, to_host
from repro_torch.core.wire import SERVER, Message, party
from repro_torch.interop import params_from_numpy
from repro_torch.runtime.harness import _ensure_child_pythonpath, _terminate
from repro_torch.runtime.problem import build_problem
from repro_torch.runtime.serving import run_tcp_serving, serving_party_main
from repro_torch.runtime.transport import encode_message
from repro_torch.serving.federated import (FederatedServingEngine,
                                           ServeRequest)

pytestmark = [pytest.mark.torch, pytest.mark.serving, pytest.mark.runtime,
              pytest.mark.slow]
torch.set_num_threads(1)


def _spec(codec="int8", parties=2):
    spec = {"kind": "lr", "parties": parties, "features": 32, "samples": 64,
            "batch": 8, "seed": 0, "vfl": {"mu": 1e-3}}
    if codec != "f32":
        spec["vfl"]["codec"] = codec
    return spec


def _blocks(q, pad, seed=7):
    """Nonzero LR blocks from jax's draws (the reference test's), as numpy."""
    keys = jax.random.split(jax.random.key(seed), q)
    return [{"w": np.asarray(jax.random.normal(keys[m], (pad,)))}
            for m in range(q)]


def _checkpoint(root, blocks, step):
    for m, b in enumerate(blocks):
        save_checkpoint(os.path.join(str(root), f"party{m}"), step,
                        params_from_numpy(b, "cpu"), {"party": m})


def _memory(spec, ids, blocks, versions, slots):
    prob = build_problem(spec, "cpu")
    eng = FederatedServingEngine.from_problem(
        prob, slots=slots, party_params=[params_from_numpy(b, "cpu")
                                         for b in blocks],
        versions=versions)
    for i, sid in enumerate(ids):
        eng.submit(ServeRequest(rid=i, sample_id=int(sid)))
    eng.run()
    eng.validate_wire()
    return eng


def _no_orphans(res):
    assert not mp.active_children()
    for pid in res["pids"]:
        assert not os.path.exists(f"/proc/{pid}"), f"process {pid} alive"
    assert [code for _, code in res["exitcodes"]] == [0] * len(res["pids"])


def test_tcp_serving_is_the_in_memory_engine_bitwise(tmp_path):
    """Party processes restoring CHECKPOINTED blocks (step 5: LR, int8, 2
    parties) and answering over sockets at 4 slots serve bitwise the
    in-memory engine given the same blocks and versions, with equal
    analytic and measured bytes; every process exits by itself with 0."""
    spec = _spec()
    prob = build_problem(spec, "cpu")
    blocks = _blocks(2, prob.model.pad)
    _checkpoint(tmp_path, blocks, 5)
    ids = np.random.default_rng(3).integers(0, 64, 12)
    res = run_tcp_serving(spec, ids, cfg=RuntimeConfig(deadline_s=120.0),
                          slots=4, ckpt_root=str(tmp_path), device="cpu")
    _no_orphans(res)
    assert all(p["version"] == 5 and not p["aborted"]
               and p["device"] == "cpu" for p in res["parties"].values())
    ref = _memory(spec, ids, blocks, [5, 5], slots=4)
    assert res["predictions"] == [(r.sample_id, r.prediction) for r in
                                  sorted(ref.completed, key=lambda r: r.rid)]
    assert set(p for _, p in res["predictions"]) <= {-1.0, 1.0}
    assert res["analytic"] == ref._analytic
    assert res["metrics"] == ref.metrics()
    assert sum(p["served"] for p in res["parties"].values()) == \
        ref._analytic["serve_down"] // 4
    # the parties' own channels saw exactly the front end's crossings
    for kind in ("serve_down", "c_up"):
        assert sum(p["bytes_by_kind"][kind] for p in res["parties"].values()) \
            == res["channel"].bytes_by_kind[kind]


def _ref_wire(codec, cs):
    ex = RefZOExchange(mu=1e-3, codec=codec)
    return jax.tree.map(np.asarray, ex.encode_up(jax.numpy.asarray(cs)))


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_serving_frames_are_the_references_bytes(codec):
    """The serve_down query and the c_up answer of the same Message encode
    to the reference transport's bytes, for every codec (bf16 rides as its
    uint16 patterns in the port and as ml_dtypes bfloat16 in the
    reference)."""
    ids = np.asarray([5, 17, 3, 60], np.int32)
    cs = np.random.default_rng(0).normal(size=4).astype(np.float32)
    assert encode_message(Message.make(
        "serve_down", SERVER, party(1), 3, ids)) == ref_encode_message(
        RefMessage.make("serve_down", SERVER, party(1), 3, ids))
    meta = {"idx": ids.astype(np.int64), "version": 5}
    wire = to_host(ZOExchange(mu=1e-3, codec=codec).encode_up(
        torch.from_numpy(cs)))
    got = encode_message(Message.make("c_up", party(1), SERVER, 3, wire,
                                      meta=meta))
    want = ref_encode_message(RefMessage.make(
        "c_up", party(1), SERVER, 3, _ref_wire(codec, cs), meta=meta))
    assert got == want


def test_reference_front_end_serves_through_port_parties(tmp_path):
    """The reference's front end (``_accept_parties``,
    ``RemotePartyBackend``, ``FederatedServingEngine``) in this process,
    the port's ``serving_party_main`` in the party processes: the
    predictions are the reference's in-memory engine's on the same
    checkpointed blocks."""
    spec = _spec()
    rprob = ref_build_problem(spec)
    blocks = _blocks(2, rprob.model.pad)
    _checkpoint(tmp_path, blocks, 5)
    ids = np.random.default_rng(5).integers(0, 64, 12)

    ref_mem = RefFederatedServingEngine.from_problem(
        rprob, slots=4, party_params=[{"w": jax.numpy.asarray(b["w"])}
                                      for b in blocks], versions=[5, 5])
    for i, sid in enumerate(ids):
        ref_mem.submit(RefServeRequest(rid=i, sample_id=int(sid)))
    ref_mem.run()

    from repro.core import async_host as ref_async_host
    server_key, _, _ = ref_async_host.trainer_keys(rprob.seed, 2)
    w0 = rprob.model.init_server(server_key)
    rcfg = RefRuntimeConfig(deadline_s=120.0)
    _ensure_child_pythonpath()
    ctx = mp.get_context("spawn")
    result_q = ctx.Queue()
    sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    sock.bind(("127.0.0.1", 0))
    sock.listen(8)
    port = sock.getsockname()[1]
    procs = [ctx.Process(target=serving_party_main,
                         args=(spec, m, port, RuntimeConfig(deadline_s=120.0),
                               os.path.join(str(tmp_path), f"party{m}"),
                               result_q, "cpu"), daemon=True)
             for m in range(2)]
    try:
        for p in procs:
            p.start()
        links = ref_accept_parties(sock, 2, rcfg)
        assert {m: v for m, (_, v) in links.items()} == {0: 5, 1: 5}
        eng = RefFederatedServingEngine(
            rprob.model, w0, [RefRemotePartyBackend(m, links[m][0], rcfg,
                                                    version=links[m][1])
                              for m in range(2)],
            RefZOExchange.from_config(rprob.vfl), slots=4)
        for i, sid in enumerate(ids):
            eng.submit(RefServeRequest(rid=i, sample_id=int(sid)))
        eng.run()
        eng.validate_wire()
        eng.close()
        reports = {}
        while len(reports) < 2:
            tag, payload = result_q.get(timeout=60.0)
            reports[payload["party"]] = payload
        for p in procs:
            p.join(timeout=30.0)
    except BaseException:
        _terminate(procs)
        raise
    finally:
        sock.close()
    assert [p.exitcode for p in procs] == [0, 0]
    assert all(not r["aborted"] and r["version"] == 5
               for r in reports.values())
    got = {r.rid: r.prediction for r in eng.completed}
    assert got == {r.rid: r.prediction for r in ref_mem.completed}
    assert eng._analytic == ref_mem._analytic


def test_launcher_serves_checkpointed_blocks_over_tcp(tmp_path):
    """``--serve 8 --transport tcp --ckpt-dir`` serves 8 from party
    processes that restored the step-3 blocks (version 3), with the bytes
    per prediction of the in-memory ``--serve``."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    pad = -(-cfg.d_model // 2)
    _checkpoint(tmp_path, _blocks(2, pad), 3)
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "vfl-zoo",
            "--parties", "2", "--serve", "8", "--serve-batch", "4",
            "--device", "cpu"]
    with contextlib.redirect_stdout(io.StringIO()):
        tcp = train.main(argv + ["--transport", "tcp",
                                 "--ckpt-dir", str(tmp_path)])
        mem = train.main(argv)
    assert not mp.active_children()
    assert tcp["served"] == mem["served"] == 8.0
    assert tcp["transport"] == "tcp" and tcp["versions"] == [3, 3]
    assert tcp["bytes_per_prediction"] == mem["bytes_per_prediction"]
    assert tcp["cache_hits"] == mem["cache_hits"]
