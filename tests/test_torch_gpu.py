"""The CUDA kernels against their plain torch versions, bitwise, on the
card. No jax here: the machine with the card has none. Without a CUDA
device every test skips (the kernels have no CPU mode); run them there
with ``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import DPConfig
from repro_torch.kernels import fused_round, zo_update
from repro_torch.utils import prng

pytestmark = [pytest.mark.torch, pytest.mark.gpu]

MECHS = [None, "gaussian", "laplace"]
CODECS = ["f32", "bf16", "int8"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same_bits(a, b):
    if isinstance(a, tuple):
        return all(_same_bits(x, y) for x, y in zip(a, b))
    view = {4: torch.int32, 2: torch.int16, 1: torch.int8}[a.element_size()]
    return a.dtype == b.dtype and torch.equal(a.view(view), b.view(view))


@pytest.mark.parametrize("n", [5000, 1 << 20])
@pytest.mark.parametrize("mech", MECHS)
@pytest.mark.parametrize("codec", CODECS)
def test_defended_encode_kernel_bitwise_vs_plain(cuda, codec, mech, n):
    c = 2.0 * torch.randn(n, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(n))
    dp = None if mech is None else DPConfig(
        noise_multiplier=1.3, clip=1.0, mechanism=mech)
    dpb = None if dp is None else prng.bits((1, 2), (n,), cuda)
    rnb = prng.bits((3, 4), (n,), cuda) if codec == "int8" else None
    n0 = fused_round.defended_encode.launches
    got = fused_round.defended_encode(c, dpb, rnb, dp, codec)
    assert fused_round.defended_encode.launches == n0 + 1
    want = fused_round._encode_math(fused_round._defend_math(c, dpb, dp),
                                    rnb, codec)
    assert _same_bits(got, want)


@pytest.mark.parametrize("n", [1, 10, 80, 128, 4097, 12544])
def test_zo_update_kernel_bitwise_vs_plain(cuda, n):
    rng = np.random.default_rng(n)
    w = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(cuda)
    b = prng.bits((5, n), (n,), cuda)
    for scale in (-5e-2, 3.7e-4):
        assert _same_bits(zo_update.zo_update(w, b, scale),
                          zo_update.zo_update_plain(w, b, scale))


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    w = torch.zeros(8, device=cuda)
    b = torch.zeros(8, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        zo_update.zo_update(w.double(), b, 1.0)
    with pytest.raises(ValueError):
        zo_update.zo_update(w, b[:4], 1.0)
    with pytest.raises(ValueError):
        fused_round.defended_encode(w, b.long(), None,
                                    DPConfig(noise_multiplier=1.0, clip=1.0),
                                    "f32")
