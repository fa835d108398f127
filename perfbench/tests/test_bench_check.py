"""The w0 numbers of ``perfbench/check.py`` on updates stored in bf16: a
coefficient off by a factor moves fewer elements across a rounding step,
which the joined cosine reads and the cosine over the shared elements
barely does; a direction drawn from another key, or an update left out,
reads about 1."""
import torch

from perfbench import check


PARTY = [("parties.p", torch.zeros(8))], [("parties.p", torch.ones(8))]


def _update(w, u, coef):
    return [("w0.w", w)], [("w0.w", (w.float() - 7.5e-5 * coef * u)
                            .to(torch.bfloat16))]


def _numbers(prog_update, ref_update):
    grad = {"parties.p": 1.0, "w0.w": 1.0}
    side = {"losses": [1.0], "grad": grad, "change": grad}
    return check.numbers(
        {**side, "first_update": tuple(a + b for a, b in zip(prog_update,
                                                             PARTY))},
        {**side, "first_update": tuple(a + b for a, b in zip(ref_update,
                                                             PARTY))})


def test_w0_numbers_on_bf16_updates():
    g = torch.Generator().manual_seed(3)
    w = (0.02 * torch.randn(1 << 16, generator=g)).to(torch.bfloat16)
    u = torch.randn(1 << 16, generator=g)
    ref = _update(w, u, 0.6)
    same = _numbers(_update(w, u, 0.6), ref)
    assert same["w0_dir_gap"] < 1e-12 and same["w0_shared_dir_gap"] < 1e-12
    scaled = _numbers(_update(w, u, -0.2), ref)
    assert scaled["w0_dir_gap"] > 0.2
    assert scaled["w0_shared_dir_gap"] < 0.05
    other = _numbers(_update(w, torch.randn(1 << 16, generator=g), 0.6), ref)
    assert other["w0_shared_dir_gap"] > 0.9
    unchanged = _numbers(([("w0.w", w)], [("w0.w", w.clone())]), ref)
    assert unchanged["w0_dir_gap"] == unchanged["w0_shared_dir_gap"] == 1.0
    assert unchanged["party_dir_gap"] < 1e-12
