"""The port's kernel modules against the reference's kernels.

On the CPU each wrapper runs its plain torch version, which is held
bitwise against the reference's ``defended_encode`` (impl="xla" and the
Pallas kernel in interpret mode) and ``zo_update_pallas`` on identical
numpy payloads and bits. The CUDA kernels themselves are held against
the plain versions on the card (tests/test_torch_gpu.py and
chip_smoke.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import DPConfig as RefDPConfig
from repro.kernels import fused_round as ref_fr
from repro.kernels.zo_update import zo_update_pallas
from repro_torch.configs import DPConfig
from repro_torch.kernels import fused_round, prng_draw, zo_update
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
# small tensors: torch's intra-op thread pool only adds overhead here, and
# the test workers already share the cores
torch.set_num_threads(1)

MECHS = [None, "gaussian", "laplace"]
CODECS = ["f32", "bf16", "int8"]


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    c = (2.0 * rng.standard_normal(n)).astype(np.float32)
    dpb = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    rnb = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    return c, dpb, rnb


def _t(bits):
    return torch.from_numpy(bits.view(np.int32).copy())


def _as_bits(x):
    """Any wire leaf (jax or torch, f32/bf16/int8) as comparable ints."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    return x.view({4: np.int32, 2: np.int16, 1: np.int8}[x.itemsize])


def _assert_wire_equal(ref, got):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for a, b in zip(ref, got):
            _assert_wire_equal(a, b)
        return
    np.testing.assert_array_equal(_as_bits(ref), _as_bits(got))


@pytest.mark.parametrize("mech", MECHS)
@pytest.mark.parametrize("codec", CODECS)
def test_defended_encode_plain_bitwise_vs_reference(codec, mech):
    # 2500 = two full 1024 blocks plus a padded tail in the Pallas kernel
    n = 2500
    c, dpb, rnb = _inputs(n, 0)
    ref_dp = None if mech is None else RefDPConfig(
        noise_multiplier=1.3, clip=1.0, mechanism=mech)
    dp = None if mech is None else DPConfig(
        noise_multiplier=1.3, clip=1.0, mechanism=mech)
    j_dpb = None if mech is None else jnp.asarray(dpb)
    j_rnb = jnp.asarray(rnb) if codec == "int8" else None
    got = fused_round.defended_encode(
        torch.from_numpy(c), None if mech is None else _t(dpb),
        _t(rnb) if codec == "int8" else None, dp, codec)
    for impl in ("xla", "pallas"):
        ref = ref_fr.defended_encode(jnp.asarray(c), j_dpb, j_rnb, ref_dp,
                                     codec, impl=impl)
        _assert_wire_equal(ref, got)


def test_defended_encode_int8_without_rounding_key():
    c, _, _ = _inputs(1000, 1)
    ref = ref_fr.defended_encode(jnp.asarray(c), None, None, None, "int8")
    got = fused_round.defended_encode(torch.from_numpy(c), None, None, None,
                                      "int8")
    _assert_wire_equal(ref, got)


def test_defended_encode_clip_only():
    """sigma = 0: clip, no draw (the oracle skips it too)."""
    c, _, rnb = _inputs(700, 2)
    ref = ref_fr.defended_encode(
        jnp.asarray(c), None, jnp.asarray(rnb),
        RefDPConfig(noise_multiplier=0.0, clip=0.5), "int8")
    got = fused_round.defended_encode(
        torch.from_numpy(c), None, _t(rnb),
        DPConfig(noise_multiplier=0.0, clip=0.5), "int8")
    _assert_wire_equal(ref, got)


@pytest.mark.parametrize("n", [3, 257, 1000, 4097])
def test_zo_update_plain_bitwise_vs_pallas(n):
    rng = np.random.default_rng(n)
    w = rng.standard_normal(n).astype(np.float32)
    b = rng.integers(0, 1 << 32, n, dtype=np.uint32)
    for scale in (np.float32(-5e-2), np.float32(2e-2) * np.float32(0.731)):
        ref = zo_update_pallas(jnp.asarray(w), jnp.asarray(b),
                               jnp.asarray(scale))
        got = zo_update.zo_update(torch.from_numpy(w), _t(b), scale)
        np.testing.assert_array_equal(np.asarray(ref).view(np.int32),
                                      got.numpy().view(np.int32))


def test_wrappers_take_the_plain_version_only_on_cpu():
    """A CPU tensor runs the plain version and counts no launch; any other
    device is a kernel launch or an error, never a fallback. The same for
    the draw kernel's wrapper (``prng.draw``) and the prng entry points
    that call it; the draw kernel's own launch raises on the CPU."""
    counters = (zo_update.zo_update, fused_round.defended_encode,
                prng_draw.draw)
    before = tuple(f.launches for f in counters)
    w = torch.zeros(4)
    b = torch.zeros(4, dtype=torch.int32)
    dp = DPConfig(noise_multiplier=1.0, clip=1.0)
    zo_update.zo_update(w, b, 1.0)
    fused_round.defended_encode(w, None, None, None, "f32")
    fused_round.defended_encode_keyed(w, (1, 2), (3, 4), dp, "int8")
    for mode in prng_draw.MODES:
        prng.draw((1, 2), (4,), mode, "cpu")
    prng.bits((1, 2), (4,), "cpu")
    prng.normal((1, 2), (4,), "cpu")
    for dist in ("gaussian", "uniform", "rademacher"):
        prng.sample_direction((1, 2), (4,), dist, "cpu")
    assert tuple(f.launches for f in counters) == before
    meta_w = torch.zeros(4, device="meta")
    with pytest.raises(ValueError):
        zo_update.zo_update(meta_w, b.to("meta"), 1.0)
    with pytest.raises(ValueError):
        fused_round.defended_encode(meta_w, None, None, None, "f32")
    with pytest.raises(ValueError):
        fused_round.defended_encode_keyed(meta_w, (1, 2), (3, 4), dp, "int8")
    for mode in prng_draw.MODES:
        for draw in (prng.draw, prng_draw.draw):
            with pytest.raises(ValueError):
                draw((1, 2), (4,), mode, "meta")
        with pytest.raises(ValueError):
            prng_draw.draw((1, 2), (4,), mode, "cpu")
    with pytest.raises(ValueError):
        prng.bits((1, 2), (4,), "meta")
    for dist in ("gaussian", "uniform", "rademacher"):
        with pytest.raises(ValueError):
            prng.sample_direction((1, 2), (4,), dist, "meta")
