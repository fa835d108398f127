"""The port's federated serving engine (serving/federated.py) on the CPU,
in memory, against the reference's engine on the reference's problems (lr
and fcn, 4 parties, 32 features, 64 samples): predictions equal per codec
and slot count, decoded c values within a stated tolerance; within the
port, batched is bitwise sequential (f32, bf16: predictions and cached
values), fused is bitwise unfused, the answer cache counts as the
reference's, bytes per prediction are the analytic formula, a recorded
serving transcript passes the privacy audits, and a defended exchange is
refused. Then the launcher's ``--serve`` and ``--network`` against the
reference's launcher with the same flags."""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.core.privacy import (
    label_inference_from_uploads as ref_label_inference_from_uploads)
from repro.core.privacy import (
    serving_exposure_from_transcript as ref_serving_exposure)
from repro.core.wire import RecordingChannel as RefRecordingChannel
from repro.runtime.problem import build_problem as ref_build_problem
from repro.serving.federated import \
    FederatedServingEngine as RefFederatedServingEngine
from repro.serving.federated import ServeRequest as RefServeRequest
from repro_torch.core import async_host
from repro_torch.core.comms import serving_bytes_per_prediction
from repro_torch.core.privacy import (label_inference_from_uploads,
                                      serving_exposure_from_transcript)
from repro_torch.core.wire import RecordingChannel
from repro_torch.interop import params_from_numpy
from repro_torch.runtime.problem import build_problem
from repro_torch.serving.federated import (FederatedServingEngine,
                                           ServeRequest)

pytestmark = [pytest.mark.torch, pytest.mark.serving]
torch.set_num_threads(1)

CODECS = ("f32", "bf16", "int8")
# decoded c values against the reference's: f32 within 1e-5 relative (the
# tower's product sums in another order), bf16 one ulp of the value, int8
# one quantization step (the message's scale)
F32_RTOL = 1e-5


def _spec(codec="f32", kind="lr", parties=4, fused=False):
    spec = {"kind": kind, "parties": parties, "features": 32, "samples": 64,
            "batch": 8, "seed": 0, "vfl": {"mu": 1e-3}}
    if codec != "f32":
        spec["vfl"]["codec"] = codec
    if fused:
        spec["vfl"]["fused"] = True
    return spec


def _ref_lr_params(prob, seed=7):
    """Nonzero LR blocks (zero init would serve all-zero predictions), the
    reference test's."""
    q = prob.model.num_parties
    keys = jax.random.split(jax.random.key(seed), q)
    return [{"w": jax.random.normal(keys[m], (prob.model.pad,))}
            for m in range(q)]


def _to_numpy(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _ref_engine(spec, ids, *, slots=8, cache=2048, party_params=None,
                channel=None, versions=None):
    prob = ref_build_problem(spec)
    eng = RefFederatedServingEngine.from_problem(
        prob, channel=channel, slots=slots, cache_entries=cache,
        party_params=party_params, versions=versions)
    for i, sid in enumerate(ids):
        eng.submit(RefServeRequest(rid=i, sample_id=int(sid)))
    eng.run()
    eng.validate_wire()
    return eng


def _blocks(ref_eng):
    """The reference engine's blocks as the port's tensors on the CPU."""
    return ([params_from_numpy(_to_numpy(be.w_m), "cpu")
             for be in ref_eng.backends],
            params_from_numpy(_to_numpy(ref_eng.w0), "cpu"))


def _engine(spec, ids, *, slots=8, cache=2048, party_params=None, w0=None,
            channel=None, versions=None):
    prob = build_problem(spec, "cpu")
    eng = FederatedServingEngine.from_problem(
        prob, channel=channel, slots=slots, cache_entries=cache,
        party_params=party_params, w0=w0, versions=versions)
    for i, sid in enumerate(ids):
        eng.submit(ServeRequest(rid=i, sample_id=int(sid)))
    eng.run()
    eng.validate_wire()
    return eng


def _preds(eng):
    return {r.rid: r.prediction for r in eng.completed}


def _cache_values(eng):
    return [dict(c._d) for c in eng.caches]


def _decoded_ups(transcript, decode):
    return [(np.asarray(m.meta["idx"]).tolist(), decode(m.payload))
            for m in transcript if m.kind == "c_up"]


def _ref_decode(payload):
    if isinstance(payload, tuple):
        q, scale = payload
        return np.asarray(q, np.float32) * np.float32(scale), float(scale)
    return np.asarray(payload).astype(np.float32), None


def _port_decode(payload):
    if isinstance(payload, tuple):
        q, scale = payload
        return q.astype(np.float32) * np.float32(scale), float(scale)
    if payload.dtype == np.uint16:
        return (payload.astype(np.uint32) << 16).view(np.float32), None
    return payload, None


@pytest.mark.parametrize("slots", [1, 8])
@pytest.mark.parametrize("codec", CODECS)
@pytest.mark.parametrize("kind", ["lr", "fcn"])
def test_serving_equals_the_reference(kind, codec, slots):
    """20 requests (mid-stream admission past 8 slots) on the same blocks:
    the port's predictions are the reference's, and every recorded c_up
    decodes to the reference's values within the codec's tolerance."""
    spec = _spec(codec, kind)
    ids = np.random.default_rng(2).integers(0, 64, 20)
    pp = (_ref_lr_params(ref_build_problem(spec)) if kind == "lr" else None)
    ref_ch, ch = RefRecordingChannel(), RecordingChannel()
    ref = _ref_engine(spec, ids, slots=slots, party_params=pp,
                      channel=ref_ch)
    blocks, w0 = _blocks(ref)
    eng = _engine(spec, ids, slots=slots, party_params=blocks, w0=w0,
                  channel=ch)
    assert _preds(eng) == _preds(ref)
    if kind == "lr":
        assert set(_preds(eng).values()) <= {-1.0, 1.0}
    assert eng.metrics() == ref.metrics()
    got = _decoded_ups(ch.transcript, _port_decode)
    want = _decoded_ups(ref_ch.transcript, _ref_decode)
    assert [i for i, _ in got] == [i for i, _ in want]
    for (_, (g, g_scale)), (_, (w, w_scale)) in zip(got, want):
        if codec == "f32":
            np.testing.assert_allclose(g, w, rtol=F32_RTOL, atol=1e-7)
        elif codec == "bf16":
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30)))
                          - 7)
            assert np.all(np.abs(g - w) <= ulp), np.abs(g - w).max()
        else:
            assert abs(g_scale - w_scale) <= F32_RTOL * w_scale
            assert np.all(np.abs(g - w) <= w_scale), np.abs(g - w).max()


@pytest.mark.parametrize("codec", ["f32", "bf16"])
@pytest.mark.parametrize("kind", ["lr", "fcn"])
def test_batched_is_sequential_bitwise(kind, codec):
    """Batched serving (20 requests > 8 slots) is the one-at-a-time engine
    bit for bit: the predictions and every cached c value. The single-row
    forward makes batching purely a wire concern (int8's per-message
    scale is the exception the reference has too)."""
    spec = _spec(codec, kind)
    ids = np.random.default_rng(2).integers(0, 64, 20)
    eng_b = _engine(spec, ids, slots=8)
    eng_1 = _engine(spec, ids, slots=1)
    assert _preds(eng_b) == _preds(eng_1)
    assert len(eng_b.completed) == 20 and eng_b.steps < eng_1.steps
    for cb, c1 in zip(_cache_values(eng_b), _cache_values(eng_1)):
        assert sorted(cb) == sorted(c1)
        assert np.array_equal(
            np.asarray([cb[k] for k in sorted(cb)], np.float32).view(np.int32),
            np.asarray([c1[k] for k in sorted(c1)], np.float32).view(np.int32))


@pytest.mark.parametrize("codec", CODECS)
def test_fused_is_unfused_bitwise(codec):
    """The fused encode (the defended_encode kernel's plain version here,
    keyless) serves bitwise the unfused codec: predictions, cached values
    and every recorded payload."""
    ids = np.random.default_rng(4).integers(0, 64, 20)
    runs = []
    for fused in (False, True):
        ch = RecordingChannel()
        eng = _engine(_spec(codec, "fcn", fused=fused), ids, channel=ch)
        runs.append((eng, ch))
    (eng_u, ch_u), (eng_f, ch_f) = runs
    assert _preds(eng_f) == _preds(eng_u)
    assert _cache_values(eng_f) == _cache_values(eng_u)
    for a, b in zip(ch_f.transcript, ch_u.transcript):
        pa = a.payload if isinstance(a.payload, tuple) else (a.payload,)
        pb = b.payload if isinstance(b.payload, tuple) else (b.payload,)
        assert all(np.asarray(x).dtype == np.asarray(y).dtype
                   and np.array_equal(np.asarray(x), np.asarray(y))
                   for x, y in zip(pa, pb))


def test_f32_lr_serving_is_model_predict_bitwise():
    """f32 serving is the centralized ``model.predict``, sign for sign:
    the wire adds nothing to an uncompressed release."""
    spec = _spec()
    pp = [params_from_numpy(_to_numpy(p), "cpu")
          for p in _ref_lr_params(ref_build_problem(spec))]
    ids = np.arange(16)
    eng = _engine(spec, ids, party_params=pp)
    prob = build_problem(spec, "cpu")
    server_key, _, _ = async_host.trainer_keys(prob.seed, 4)
    stacked = {"w": torch.stack([p["w"] for p in pp])}
    local = prob.model.predict(prob.model.init_server(server_key, "cpu"),
                               stacked, prob.X[torch.as_tensor(ids)])
    served = np.asarray([_preds(eng)[i] for i in range(16)], np.float32)
    assert set(served) <= {-1.0, 1.0}
    np.testing.assert_array_equal(local.numpy(), served)


def test_answer_cache_hits_and_version_bump_as_the_reference():
    """8 users, 3 visits: visits 2 and 3 hit for every party. Rotating
    party 0's block bumps its version: the same ids miss, re-query and
    reflect the new block. Hit and miss counts, the analytic bytes and the
    predictions are the reference's."""
    spec = _spec()
    ref_pp = _ref_lr_params(ref_build_problem(spec))
    ids = np.concatenate([np.arange(8)] * 3)
    ref = _ref_engine(spec, ids, party_params=ref_pp)
    pp = [params_from_numpy(_to_numpy(p), "cpu") for p in ref_pp]
    eng = _engine(spec, ids, party_params=pp)
    m = eng.metrics()
    assert m["cache_hits"] == 2 * 8 * 4 and m["cache_misses"] == 8 * 4
    assert eng._analytic == ref._analytic == {"serve_down": 4 * 8 * 4,
                                              "c_up": 4 * 8 * 4}
    first = _preds(eng)
    assert all(first[i] == first[i + 8] == first[i + 16] for i in range(8))
    ref.set_party_params(0, {"w": -ref_pp[0]["w"]}, version=1)
    eng.set_party_params(0, {"w": -pp[0]["w"]}, version=1)
    for e, req in ((ref, RefServeRequest), (eng, ServeRequest)):
        for i, sid in enumerate(np.arange(8)):
            e.submit(req(rid=100 + i, sample_id=int(sid)))
        e.run()
        e.validate_wire()
    assert eng.metrics() == ref.metrics()
    assert eng._analytic == ref._analytic
    assert _preds(eng) == _preds(ref)
    assert any(_preds(eng)[100 + i] != first[i] for i in range(8))


@pytest.mark.parametrize("codec", CODECS)
def test_bytes_per_prediction_is_the_analytic_formula(codec):
    """Full batches, no cache: measured bytes per prediction is the closed
    form, the reference engine's too."""
    spec = _spec(codec)
    eng = _engine(spec, np.arange(32), slots=8, cache=0)
    ref = _ref_engine(spec, np.arange(32), slots=8, cache=0)
    assert eng.metrics()["bytes_per_prediction"] == \
        serving_bytes_per_prediction(8, 4, codec) == \
        ref.metrics()["bytes_per_prediction"]


def test_serving_transcript_passes_the_privacy_audits():
    """A recorded serving transcript is auditable with the training attacks
    unchanged, as the reference's: ids and function values exposed, no
    gradients or params, one c_up per serve_down, and label inference
    reads the batched answers, with the reference's numbers."""
    spec = _spec()
    ref_pp = _ref_lr_params(ref_build_problem(spec))
    ref_ch, ch = RefRecordingChannel(), RecordingChannel()
    ref = _ref_engine(spec, np.arange(16), party_params=ref_pp,
                      channel=ref_ch)
    blocks, w0 = _blocks(ref)
    eng = _engine(spec, np.arange(16), party_params=blocks, w0=w0,
                  channel=ch)
    assert len(eng.completed) == 16
    exp = serving_exposure_from_transcript(ch.transcript)
    assert exp == ref_serving_exposure(ref_ch.transcript)
    assert exp["serve_query_ids"] and exp["function_values"]
    assert not exp["intermediate_grads"] and not exp["model_params"]
    assert exp["messages"]["c_up"] == exp["messages"]["serve_down"]
    prob = build_problem(spec, "cpu")
    atk = label_inference_from_uploads(ch.transcript, prob.y)
    assert atk == ref_label_inference_from_uploads(
        ref_ch.transcript, ref_build_problem(spec).y)
    assert atk["samples"] == 16 and 0.0 <= atk["accuracy"] <= 1.0


def test_serving_rejects_a_dp_defended_exchange():
    spec = _spec()
    spec["vfl"]["dp"] = {"epsilon": 2.0, "clip": 1.0,
                         "noise_multiplier": 1.0}
    with pytest.raises(ValueError, match="deterministic keyless"):
        FederatedServingEngine.from_problem(build_problem(spec, "cpu"))


# ------------------------------------------------------------- launcher --

def _log_fields(text, prefix):
    """The key=value fields of the log line starting with ``prefix``, the
    elapsed time left out."""
    line = next(ln for ln in text.splitlines() if ln.startswith(prefix))
    return [f for f in line.split()[2:] if not f.startswith("t=")]


def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = main(argv)
    return out, buf.getvalue()


SERVE = ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "vfl-zoo",
         "--parties", "4", "--serve", "8", "--serve-batch", "4"]


@pytest.mark.parametrize("extra", [["--network", "wan"], ["--codec", "int8"]],
                         ids=["wan", "int8"])
def test_launcher_serve_logs_the_references_numbers(extra):
    """``--serve 8 --serve-batch 4`` on the reduced vfl-zoo serves 8, with
    the reference launcher's bytes per prediction, and under ``--network
    wan`` its priced wire_s, p50 and p99."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    ref_out, ref_log = _run(ref_train.main, SERVE + extra)
    out, log = _run(train.main, SERVE + extra + ["--device", "cpu"])
    assert ref_out == 8.0 and out["served"] == 8.0
    assert _log_fields(log, "[serve:") == _log_fields(ref_log, "[serve:")
    if extra[0] == "--network":
        assert out["wire_s"] > 0 and out["p99_s"] >= out["p50_s"] > 0


def test_launcher_vfl_zoo_network_prices_the_references_wire():
    """vfl-zoo training with ``--network wan`` logs the reference's
    wire_s, wire_up_mb and wire_down_bytes."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    argv = ["--arch", "qwen1.5-0.5b", "--reduced", "--mode", "vfl-zoo",
            "--steps", "2", "--batch-size", "2", "--seq-len", "16",
            "--network", "wan"]
    _, ref_log = _run(ref_train.main, argv)
    out, log = _run(train.main, argv + ["--device", "cpu"])
    want = _log_fields(ref_log.splitlines()[-1], "[train:")
    assert _log_fields(log.splitlines()[-1], "[train:") == want
    assert want[0] == "network=wan" and out["wire_s"] > 0


@pytest.mark.parametrize("extra,names", [
    (["--serve", "4", "--mode", "lm"], "--serve"),
    (["--serve", "0"], "--serve"),
    (["--serve", "4", "--dropout-at", "2"], "--dropout-at"),
    (["--serve", "4", "--resume", "--ckpt-dir", "d"], "--resume"),
    (["--serve", "4", "--dp-epsilon", "2", "--dp-clip", "1"],
     "--dp-epsilon"),
    (["--serve-batch", "4"], "--serve-batch")],
    ids=["not-vfl-zoo", "zero", "dropout-at", "resume", "dp-epsilon",
         "batch-without-serve"])
def test_launcher_serve_parse_errors_are_the_references(extra, names,
                                                         capsys):
    """The reference's serving parse errors exit 2 in both launchers,
    before anything is built, each naming the flag at fault."""
    from repro.launch import train as ref_train
    from repro_torch.launch import train
    base = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced"]
    for parse in (ref_train.parse_args, train.parse_args):
        with pytest.raises(SystemExit) as exc:
            parse(base + extra)
        assert exc.value.code == 2
        assert names in capsys.readouterr().err
