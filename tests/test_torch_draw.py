"""The device generator's plain versions on the CPU: the draw kernel's
counter ranges against jax's threefry2x32 on the same counters, the keyed
defended encode against the reference's ``encode_up_fused``, a model of
the int8 kernel's work split, and the build hash over local headers. The
kernels themselves are held against these plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.extend.random import threefry_2x32

from repro.configs import DPConfig as RefDPConfig
from repro.core.exchange import ZOExchange as RefExchange
from repro.kernels import fused_round as ref_fr
from repro_torch.configs import DPConfig
from repro_torch.core.exchange import ZOExchange
from repro_torch.kernels import build, fused_round
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

M32 = (1 << 32) - 1


def _jax_words(k, counters):
    """x0 ^ x1 of threefry2x32(k, hi32(i), lo32(i)) for each 64-bit counter
    i, from jax's own block function (which splits its count array into
    the x0 half and the x1 half)."""
    c = np.asarray(counters, dtype=np.uint64)
    hi = (c >> np.uint64(32)).astype(np.uint32)
    lo = (c & np.uint64(M32)).astype(np.uint32)
    out = np.asarray(threefry_2x32(jnp.asarray(k, jnp.uint32),
                                   jnp.asarray(np.concatenate([hi, lo]))))
    return (out[:len(c)] ^ out[len(c):]).view(np.int32)


@pytest.mark.parametrize("offset", [0, 12544, (1 << 32) - 5,
                                    (3 << 32) + 7, (1 << 62) - 3])
@pytest.mark.parametrize("k", [(0, 0), (0, 42), (0x9E3779B9, 0x7F4A7C15)])
def test_bits_plain_over_a_counter_range_equals_jax_threefry(k, offset):
    """Counters with hi32 != 0 too, and a range that crosses 2^32."""
    n = 37
    got = prng.bits_plain(k, (n,), "cpu", offset)
    want = _jax_words(k, [offset + i for i in range(n)])
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mode", ["bits", "normal", "rademacher"])
def test_a_range_draw_is_the_slice_of_the_whole_draw(mode):
    k = prng.fold_in(prng.key(5), 3)
    whole = prng.draw(k, (40, 25), mode, "cpu").reshape(-1)
    part = prng.draw(k, (7, 43), mode, "cpu", offset=613)
    np.testing.assert_array_equal(
        whole[613:613 + 301].numpy().view(np.int32),
        part.reshape(-1).numpy().view(np.int32))


def test_draw_plain_is_the_eager_chain():
    k = prng.key(9)
    b = prng.bits(k, (5, 7), "cpu")
    np.testing.assert_array_equal(
        prng.draw(k, (5, 7), "normal", "cpu").numpy().view(np.int32),
        prng.normal_from_bits(b).numpy().view(np.int32))
    np.testing.assert_array_equal(
        prng.normal_plain(k, (5, 7), "cpu").numpy(),
        prng.normal(k, (5, 7), "cpu").numpy())
    np.testing.assert_array_equal(
        prng.sample_direction(k, (5, 7), "rademacher", "cpu").numpy(),
        prng.rademacher_from_bits(b).numpy())
    with pytest.raises(ValueError, match="mode"):
        prng.draw(k, (3,), "uniform", "cpu")


# (dp mechanism, noise multiplier): none, gaussian, laplace, clip only
DEFENSES = [(None, None), ("gaussian", 1.3), ("laplace", 1.3),
            ("gaussian", 0.0)]


def _exchanges(codec, mech, sigma):
    ref_dp = dp = None
    if mech is not None:
        ref_dp = RefDPConfig(noise_multiplier=sigma, clip=0.8, mechanism=mech)
        dp = DPConfig(noise_multiplier=sigma, clip=0.8, mechanism=mech)
    return (RefExchange(mu=5e-2, codec=codec, dp=ref_dp, fused=True),
            ZOExchange(mu=5e-2, codec=codec, dp=dp, fused=True))


def _wire_bits(x):
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.uint16)
    return x.view({4: np.int32, 2: np.uint16, 1: np.int8}[x.itemsize])


def _assert_wire_equal(ref, got):
    if isinstance(ref, tuple):
        assert isinstance(got, tuple) and len(got) == len(ref)
        for a, b in zip(ref, got):
            _assert_wire_equal(a, b)
        return
    if got.dtype == torch.bfloat16:
        got = got.view(torch.int16)
    np.testing.assert_array_equal(_wire_bits(ref), _wire_bits(got.numpy()))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("mech,sigma", DEFENSES,
                         ids=["none", "gaussian", "laplace", "clip_only"])
@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_keyed_encode_bitwise_vs_reference_encode_up_fused(codec, mech,
                                                           sigma, impl):
    """encode_up_fused(ex, c, key) from keys on the CPU against the
    reference's one-dispatch encode (its XLA chain, and its Pallas kernel in
    interpret mode); 2500 = two Pallas blocks and a padded tail."""
    ref_ex, ex = _exchanges(codec, mech, sigma)
    c = (1.5 * np.random.default_rng(3).standard_normal((4, 625))).astype(
        np.float32)
    k = jax.random.fold_in(jax.random.key(7), 2)
    ref = ref_fr.encode_up_fused(ref_ex, jnp.asarray(c), k, impl=impl,
                                 interpret=True)
    got = fused_round.encode_up_fused(ex, torch.from_numpy(c),
                                      prng.fold_in(prng.key(7), 2))
    _assert_wire_equal(jax.tree.map(np.asarray, ref), got)


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_keyed_int8_encode_without_a_key_rounds_to_even(impl):
    ref_ex, ex = _exchanges("int8", None, None)
    c = np.random.default_rng(4).standard_normal(1000).astype(np.float32)
    ref = ref_fr.encode_up_fused(ref_ex, jnp.asarray(c), None, impl=impl,
                                 interpret=True)
    got = fused_round.encode_up_fused(ex, torch.from_numpy(c), None)
    _assert_wire_equal(jax.tree.map(np.asarray, ref), got)


@pytest.mark.parametrize("codec", ["f32", "bf16", "int8"])
def test_keyed_encode_is_the_bits_encode_on_the_keys_bits(codec):
    c = torch.from_numpy(np.random.default_rng(5).standard_normal(777)
                         .astype(np.float32))
    dp = DPConfig(noise_multiplier=0.9, clip=1.0, mechanism="laplace")
    dk, rk = (3, 4), (5, 6)
    got = fused_round.defended_encode_keyed(c, dk, rk, dp, codec)
    want = fused_round.defended_encode(
        c, prng.bits(dk, c.shape, "cpu"),
        prng.bits(rk, c.shape, "cpu") if codec == "int8" else None, dp, codec)
    for a, b in zip(want if codec == "int8" else (want,),
                    got if codec == "int8" else (got,)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="DPConfig"):
        fused_round.defended_encode_keyed(c, dk, rk, None, codec)


# ---- the int8 kernel's work split (csrc/defended_encode.cu) ----------------

def _int8_split(n, max_grid, capacity, threads):
    """launch_int8's grid and int8_kernel's index sets: per block, the
    elements it keeps and, in 4-groups strided over all threads, its share
    of the rest (recomputed after the barrier)."""
    blocks = max_grid
    per = -(-n // blocks)
    per = -(-per // 4) * 4
    per = max(per, 4 * threads)
    per = min(per, capacity)
    blocks = min(blocks, -(-n // per))
    resident = min(n, blocks * per)
    kept, rest = [], []
    for b in range(blocks):
        base = b * per
        kept.append(np.arange(base, min(base + per, resident))
                    if base < resident else np.arange(0))
        mine = []
        for t in range(threads):
            for i in range(resident + 4 * (b * threads + t), n,
                           4 * blocks * threads):
                mine.extend(range(i, min(i + 4, n)))
        rest.append(np.asarray(mine, dtype=np.int64))
    return kept, rest


def _int8_model(d, r, kept, rest):
    """q and scale as the kernel forms them: a slot per block (the max bit
    pattern of |x| over what it keeps and its share of the rest), every
    block's max over the slots, then the quantize."""
    bits = d.abs().view(torch.int32).numpy()
    slots = [max(bits[k].max(initial=0), bits[s].max(initial=0))
             for k, s in zip(kept, rest)]
    a = torch.tensor(max(slots), dtype=torch.int32).view(torch.float32)
    qscale = torch.clamp(a, min=1e-12) / torch.tensor(127.0)
    q = torch.empty(d.shape, dtype=torch.int8)
    for idx in kept + rest:
        idx = torch.from_numpy(idx)
        x = torch.floor(d[idx] / qscale + prng.uniform_from_bits(r[idx]))
        q[idx] = torch.clamp(x, -127, 127).to(torch.int8)
    return q, qscale


@pytest.mark.parametrize("n,max_grid,capacity,threads", [
    (1000, 3, 64, 8),      # 192 kept, the rest swept again
    (1003, 5, 48, 4),      # a ragged rest
    (130, 6, 64, 8),       # all kept: two blocks, the last ragged
    (2048, 264, 28000, 512),   # the D7 payload: one block
    (1 << 14, 4, 1024, 64)])   # 4096 kept, 12288 swept again
def test_int8_work_split_model_matches_the_plain_version(n, max_grid,
                                                         capacity, threads):
    kept, rest = _int8_split(n, max_grid, capacity, threads)
    every = np.concatenate(kept + rest)
    np.testing.assert_array_equal(np.sort(every), np.arange(n))
    c = torch.from_numpy((2.0 * np.random.default_rng(n).standard_normal(n))
                         .astype(np.float32))
    dp = DPConfig(noise_multiplier=1.3, clip=1.0)
    dk, rk = (1, n), (2, n)
    d = fused_round._defend_math(c, prng.bits(dk, (n,), "cpu"), dp)
    q, scale = _int8_model(d, prng.bits(rk, (n,), "cpu"), kept, rest)
    want_q, want_scale = fused_round.defended_encode_keyed(c, dk, rk, dp,
                                                           "int8")
    assert torch.equal(q, want_q)
    assert scale.view(torch.int32) == want_scale.view(torch.int32)


# ---- the build -------------------------------------------------------------

def test_build_hash_covers_the_included_headers(tmp_path, monkeypatch):
    names = {p.name for p in build.sources("defended_encode")}
    assert names == {"defended_encode.cu", "prng.cuh"}
    assert {p.name for p in build.sources("prng_draw")} == \
        {"prng_draw.cu", "prng.cuh"}
    assert [p.name for p in build.sources("zo_update")] == ["zo_update.cu"]
    for name in ("prng_draw.cu", "prng.cuh"):
        (tmp_path / name).write_bytes((build.CSRC / name).read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    monkeypatch.setattr(build, "_toolchain", lambda: b"nvcc")
    before = build._target("prng_draw")
    with open(tmp_path / "prng.cuh", "a") as f:
        f.write("// edited\n")
    assert build._target("prng_draw") != before
    assert "prng_draw" in build.KERNELS


def test_build_keeps_nvccs_output_beside_the_library(tmp_path, monkeypatch):
    """A finished build saves nvcc's output (ptxas's register and spill
    report) beside its library; a cached library is read back with it and
    not compiled again, and one without its output is built anew."""
    import subprocess
    import sys
    import time
    out = tmp_path / "libprng_draw-0123456789ab.so"
    tmp = out.with_suffix(".1.tmp")
    proc = subprocess.Popen(
        [sys.executable, "-c", "import sys; print('ptxas info: Used 40 "
         "registers'); open(sys.argv[1], 'w').write('elf')", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    build._finish("prng_draw", (proc, tmp, out, time.perf_counter()))
    assert out.read_text() == "elf" and not tmp.exists()
    monkeypatch.setattr(build, "_target", lambda name: out)
    assert build._start("prng_draw") is None
    assert build.build_output("prng_draw") == "ptxas info: Used 40 registers\n"
    out.with_suffix(".log").unlink()
    monkeypatch.setattr(build, "_nvcc", lambda: sys.executable)
    monkeypatch.setattr(build, "NVCC_FLAGS", ("-c", "pass"))
    job = build._start("prng_draw")
    assert job is not None
    job[0].communicate()
