"""The port's privacy audits (core/privacy.py) on the CPU: every function,
on transcripts the port records, against the reference's functions on the
reference's transcripts of the same setup and seeds
(benchmarks/bench_privacy.py's ``record_transcripts`` and
``record_aligned_zoo``; the port's twins are chip_smoke.py's, which the
card runs too). The label-inference accuracies, the feature-inference
ratio and flags, the reverse-multiplication flags and reasons and the
exposures are exact, with BENCH_privacy.json's numbers (tig_acc 1.000 on
grad_down, zoo_acc 0.500 on loss_down, zoo_ratio 0.358); the backdoor's
cosines and deviation norms within 1e-5. Payloads that arrive as tensors
or as bf16 bit patterns decode as the server decodes them."""
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import privacy as ref_privacy
from repro.core import wire as ref_wire
from repro_torch.core import privacy, wire
from repro_torch.utils import prng

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402
from benchmarks import bench_privacy  # noqa: E402

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

KEYS = chip_smoke.BACKDOOR_KEYS
FRAMEWORKS = ("zoo-vfl", "tig", "tg")


@pytest.fixture(scope="module")
def audits():
    """Both packages' transcripts and Theorem-1 numbers."""
    r_zoo, r_tig, r_y = bench_privacy.record_transcripts()
    r_aligned = bench_privacy.record_aligned_zoo()
    p_zoo, p_tig, p_y = chip_smoke.record_transcripts("cpu")
    p_aligned = chip_smoke.record_aligned_zoo("cpu")
    ref = chip_smoke.audit_numbers(ref_privacy, r_zoo, r_tig, r_aligned, r_y,
                                   [jax.random.key(s) for s in range(KEYS)])
    port = chip_smoke.audit_numbers(privacy, p_zoo, p_tig, p_aligned, p_y,
                                    [prng.key(s) for s in range(KEYS)])
    return {"ref": ref, "port": port,
            "ref_t": (r_zoo, r_tig, r_aligned, r_y),
            "port_t": (p_zoo, p_tig, p_aligned, p_y)}


def test_recorded_traffic_is_the_references(audits):
    """Same kinds, endpoints, rounds, sizes and sample ids, message for
    message, in both transcripts of each framework."""
    for a, b in zip(audits["port_t"][:3], audits["ref_t"][:3]):
        assert [(m.kind, m.sender, m.receiver, m.round, m.nbytes)
                for m in a] == [(m.kind, m.sender, m.receiver, m.round,
                                 m.nbytes) for m in b]
        assert all(np.array_equal(np.asarray(x.meta["idx"]),
                                  np.asarray(y.meta["idx"]))
                   for x, y in zip(a, b) if x.meta is not None)
    port = audits["port"]
    assert port["msgs"] == audits["ref"]["msgs"] == {"zoo": 288, "tig": 288}
    assert port["kinds"] == audits["ref"]["kinds"]


def test_label_inference_is_the_references(audits):
    port, ref = audits["port"], audits["ref"]
    assert port["label_tig"] == ref["label_tig"]
    assert port["label_zoo"] == ref["label_zoo"]
    assert port["label_tig"]["accuracy"] == 1.0
    assert port["label_tig"]["observable"] == "grad_down"
    assert port["label_zoo"]["accuracy"] == 0.5
    assert port["label_zoo"]["observable"] == "loss_down"
    assert port["uploads_zoo"] == ref["uploads_zoo"]


def test_feature_inference_is_the_references(audits):
    port, ref = audits["port"], audits["ref"]
    assert port["feature_inference"] == ref["feature_inference"]
    assert round(port["feature_inference"]["ratio"], 3) == 0.358
    assert not port["feature_inference"]["solvable"]
    assert port["param_leak_recovery_err"] < 1e-9
    assert port["param_leak_recovery_err"] == ref["param_leak_recovery_err"]


def test_reverse_multiplication_is_the_references(audits):
    port, ref = audits["port"], audits["ref"]
    assert port["rma_tig"] == ref["rma_tig"]
    assert port["rma_tig"]["feasible"]
    assert port["rma_zoo"] == ref["rma_zoo"] == {
        "feasible": False, "reason": "no grad_down on the wire"}
    np.testing.assert_allclose(port["rma_tig_recovered"],
                               ref["rma_tig_recovered"], rtol=1e-5,
                               atol=1e-5)


def test_backdoor_replay_is_the_references(audits):
    """The gradient replay steers exactly; the scalar replay's cosine to
    the target and its deviation norm, over 20 keys, within 1e-5."""
    port, ref = audits["port"], audits["ref"]
    assert port["backdoor_tig"] == ref["backdoor_tig"]
    assert port["backdoor_tig"]["direction_control"]
    assert chip_smoke.audits_agree(port, ref, rtol=1e-5)
    cos = np.mean([b["cos_to_target"] for b in port["backdoor_zoo"]])
    assert cos < 1.0 / np.sqrt(4096)


@pytest.mark.parametrize("seed", [0, 7])
def test_backdoor_update_influence_draws_jax_directions(seed):
    """The directions are ``prng.normal``, bitwise jax's: the deviation
    and the cosine of the primitive within 1e-6 of the reference's."""
    got = privacy.backdoor_update_influence(5e-2, 1e-3, 0.71, 0.69, 4096,
                                            key=prng.key(seed))
    want = ref_privacy.backdoor_update_influence(
        5e-2, 1e-3, 0.71, 0.69, 4096, key=jax.random.key(seed))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_exposure_from_transcripts_is_the_references(audits):
    port, ref = audits["port"], audits["ref"]
    assert port["exposure"] == ref["exposure"]
    assert not port["exposure"]["zoo"]["intermediate_grads"]
    assert port["exposure"]["tig"]["intermediate_grads"]


@pytest.mark.parametrize("framework", FRAMEWORKS)
def test_exposure_report_is_the_references(framework):
    assert privacy.exposure_report(framework) == \
        ref_privacy.exposure_report(framework)


@pytest.mark.parametrize("framework", FRAMEWORKS)
def test_canonical_round_is_the_references(framework):
    """Kinds, endpoints, rounds and bytes of each framework's canonical
    round, at a batch and block width past one."""
    kw = dict(rnd=3, m=2, batch=5, c_dim=2, d_l=7)
    got = wire.canonical_round(framework, **kw)
    want = ref_wire.canonical_round(framework, **kw)
    assert [(m.kind, m.sender, m.receiver, m.round, m.nbytes) for m in got] \
        == [(m.kind, m.sender, m.receiver, m.round, m.nbytes) for m in want]
    with pytest.raises(ValueError):
        wire.canonical_round("split-nn")


def _upload(payload, idx, m=0):
    return wire.Message.make("c_up", wire.party(m), wire.SERVER, 0, payload,
                             meta={"idx": idx})


def test_payloads_decode_as_the_server_decodes_them():
    """A c_up payload as f32, as the port's bf16 wire (uint16 patterns),
    as int8 values and scale, and as tensors (a card's payload reaches
    the audits the same way): each decodes to the reference's decoding of
    the reference's wire of the same values."""
    c = np.random.default_rng(0).normal(size=8).astype(np.float32)
    bf = torch.from_numpy(c).to(torch.bfloat16)
    ref_bf = np.asarray(jax.numpy.asarray(c).astype(jax.numpy.bfloat16))
    q = np.round(c / (np.abs(c).max() / 127)).astype(np.int8)
    scale = np.float32(np.abs(c).max() / 127)
    cases = [
        (c, c), (torch.from_numpy(c), c),
        (bf.view(torch.int16).numpy().view(np.uint16), ref_bf), (bf, ref_bf),
        ((q, np.asarray(scale)), (q, scale)),
        ((torch.from_numpy(q), torch.tensor(scale)), (q, scale)),
    ]
    for got, want in cases:
        a = privacy._decode_c_payload(got)
        b = ref_privacy._decode_c_payload(want)
        assert a.dtype == np.float32 and np.array_equal(a, b)


def test_attacks_read_tensor_payloads_and_meta():
    """A transcript whose payloads, ids and labels are tensors gives the
    attacks the numbers of its numpy twin."""
    rng = np.random.default_rng(1)
    y = np.sign(rng.normal(size=32)).astype(np.float32)
    np_t, t_t = wire.Transcript(), wire.Transcript()
    for m in range(2):
        for r in range(3):
            idx = rng.integers(0, 32, 8)
            c = rng.normal(size=8).astype(np.float32)
            g = rng.normal(size=8).astype(np.float32)
            for t, conv in ((np_t, np.asarray), (t_t, torch.from_numpy)):
                t.append(_upload(conv(c), conv(idx), m))
                t.append(wire.Message.make("grad_down", wire.SERVER,
                                           wire.party(m), r, conv(g),
                                           meta={"idx": conv(idx)}))
    y_t = torch.from_numpy(y)
    assert privacy.label_inference_from_uploads(t_t, y_t) == \
        privacy.label_inference_from_uploads(np_t, y)
    assert privacy.label_inference_attack(t_t, y_t) == \
        privacy.label_inference_attack(np_t, y)
    assert privacy.feature_inference_from_transcript(t_t, 4) == \
        privacy.feature_inference_from_transcript(np_t, 4)
    assert privacy.replay_backdoor_attack(t_t, 5e-2, 1e-3, 64) == \
        privacy.replay_backdoor_attack(np_t, 5e-2, 1e-3, 64)
