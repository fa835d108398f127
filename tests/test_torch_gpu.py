"""The CUDA kernels against their plain torch versions on the card:
defended_encode (from keys and from bits), the draw kernel and zo_update
bitwise, dual_matmul and flash_attention
within a stated tolerance (their sums run in another order than the
plain versions') and bitwise where only their own order is involved, and
a reduced vfl-zoo step on the card against the same step on the CPU,
the flash_attention backward kernel (and the forward's lse and positions)
against their plain versions, first-order LM training on the card
against the CPU,
LM serving (decode, sampling, the engine) on the card against the CPU,
and the MoE dispatch (deterministic, ties to the lower expert) and the
moe, vlm and audio families' decode on the card against the CPU.
No jax here: the machine with the card has none. Without a CUDA
device every test skips (the kernels have no CPU mode); run them there
with ``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import DPConfig
from repro_torch.kernels import (dual_matmul, flash_attention, fused_round,
                                 ops, prng_draw, zo_update)
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


# (dp mechanism, noise multiplier): none, gaussian, laplace, clip only
DEFENSES = [(None, None), ("gaussian", 1.3), ("laplace", 1.3),
            ("gaussian", 0.0)]


def _plain_keyed(c, dk, rk, dp, codec):
    """The plain chain on the eager bits of the same keys."""
    dpb = None if dk is None else prng.bits_plain(dk, c.shape, c.device)
    rnb = None if rk is None else prng.bits_plain(rk, c.shape, c.device)
    return fused_round._encode_math(fused_round._defend_math(c, dpb, dp),
                                    rnb, codec)


# D7's payload (one block), 2^21 (the vfl-zoo payload: kept on chip), 2^24
# (past what the grid keeps: the second sweep), a ragged 2^20 + 3
@pytest.mark.parametrize("n", [2048, 1 << 21, 1 << 24, (1 << 20) + 3])
@pytest.mark.parametrize("mech,sigma", DEFENSES,
                         ids=["none", "gaussian", "laplace", "clip_only"])
@pytest.mark.parametrize("codec", CODECS)
def test_defended_encode_from_keys_bitwise_vs_plain(cuda, codec, mech, sigma,
                                                    n):
    c = 2.0 * torch.randn(n, device=cuda,
                          generator=torch.Generator(cuda).manual_seed(n))
    dp = None if mech is None else DPConfig(
        noise_multiplier=sigma, clip=1.0, mechanism=mech)
    dk = None if dp is None or sigma == 0.0 else (11, n)
    rk = (12, n) if codec == "int8" else None
    n0 = fused_round.defended_encode.launches
    d0 = prng_draw.draw.launches
    got = fused_round.defended_encode_keyed(c, dk, rk, dp, codec)
    assert fused_round.defended_encode.launches == n0 + 1
    assert prng_draw.draw.launches == d0
    assert _same_bits(got, _plain_keyed(c, dk, rk, dp, codec))


@pytest.mark.parametrize("n", [2048, 5000, 1 << 24])
def test_defended_encode_int8_from_keys_without_a_rounding_key(cuda, n):
    c = torch.randn(n, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3))
    for dp in (None, DPConfig(noise_multiplier=1.0, clip=0.5)):
        dk = None if dp is None else (4, 5)
        got = fused_round.defended_encode_keyed(c, dk, None, dp, "int8")
        assert _same_bits(got, _plain_keyed(c, dk, None, dp, "int8"))


@pytest.mark.parametrize("codec", CODECS)
def test_defended_encode_takes_an_unaligned_payload(cuda, codec):
    """A contiguous view one element into its storage: 4-byte loads."""
    base = torch.randn(4097, device=cuda,
                       generator=torch.Generator(cuda).manual_seed(4))
    c = base[1:]
    assert c.data_ptr() % 16 != 0 and c.is_contiguous()
    dp = DPConfig(noise_multiplier=1.3, clip=1.0)
    rk = (2, 2) if codec == "int8" else None
    got = fused_round.defended_encode_keyed(c, (1, 1), rk, dp, codec)
    assert _same_bits(got, _plain_keyed(c, (1, 1), rk, dp, codec))
    dpb = prng.bits((1, 1), c.shape, cuda)
    rnb = prng.bits(rk, c.shape, cuda) if rk else None
    assert _same_bits(fused_round.defended_encode(c, dpb, rnb, dp, codec),
                      got)


@pytest.mark.parametrize("n", [1, 10, 80, 128, 2048, 12544, 32768, 1 << 24,
                               38895616, 155582464])
@pytest.mark.parametrize("mode", ["bits", "normal", "rademacher"])
def test_draw_kernel_bitwise_vs_the_eager_chain(cuda, mode, n):
    """D7's leaf sizes (the tail alone at 1), vfl-zoo's party leaves, up to
    qwen1.5-0.5b's embedding (151936 x 1024)."""
    k = prng.fold_in(prng.key(n), 1)
    n0 = prng_draw.draw.launches
    got = prng_draw.draw(k, (n,), mode, cuda)
    assert prng_draw.draw.launches == n0 + 1
    want = prng.draw_plain(k, (n,), mode, cuda)
    assert got.dtype == want.dtype and _same_bits(got, want)


@pytest.mark.parametrize("mode", ["bits", "normal", "rademacher"])
def test_draw_kernel_across_counter_2_to_the_32(cuda, mode):
    k = (0x12345678, 0x9ABCDEF0)
    for offset, n in (((1 << 32) - 1000, 5003), ((7 << 32) - 2, 7)):
        got = prng_draw.draw(k, (n,), mode, cuda, offset=offset)
        assert _same_bits(got, prng.draw_plain(k, (n,), mode, cuda,
                                               offset))


def test_prng_entry_points_are_one_draw_launch_each(cuda):
    k, shape = prng.key(3), (98, 128)
    for fn, want in (
            (lambda: prng.bits(k, shape, cuda), prng.bits_plain),
            (lambda: prng.normal(k, shape, cuda), prng.normal_plain),
            (lambda: prng.sample_direction(k, shape, "gaussian", cuda),
             prng.normal_plain),
            (lambda: prng.sample_direction(k, shape, "rademacher", cuda),
             lambda *a: prng.rademacher_from_bits(prng.bits_plain(*a)))):
        n0 = prng_draw.draw.launches
        got = fn()
        assert prng_draw.draw.launches == n0 + 1
        assert _same_bits(got, want(k, shape, cuda))
    n0 = prng_draw.draw.launches
    u = prng.sample_direction(k, shape, "uniform", cuda)
    assert prng_draw.draw.launches == n0 + 1
    assert u.shape == shape and bool(torch.isfinite(u).all())


def test_draw_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError):
        prng_draw.draw((1, 2), (4,), "uniform", cuda)
    with pytest.raises(ValueError):
        prng_draw.draw((1, 2), (4,), "bits", cuda, offset=(1 << 64) - 2)
    assert prng_draw.draw((1, 2), (0, 3), "bits", cuda).shape == (0, 3)


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


def _dual_inputs(cuda, M, K, N, dtype, seed):
    g = torch.Generator(cuda).manual_seed(seed)
    x = torch.randn(M, K, device=cuda, generator=g).to(dtype)
    w = torch.randn(K, N, device=cuda, generator=g).to(dtype)
    u = torch.randn(K, N, device=cuda, generator=g)
    return x, w, u


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# f32: both sides sum the same f32 products, in another order (<= a few
# ulps of the largest output); bf16: outputs rounded to 8 mantissa bits,
# so one rounding apart at most (the reference's bf16 tolerance)
DUAL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


# the D7 and async shapes, the reference bench's, ragged ones, a deep one,
# M below one 64-row tile, N not a multiple of 8, K = 8j - 1 and 8j + 1
@pytest.mark.parametrize("M,K,N", [(2048, 98, 128), (64, 98, 128),
                                   (256, 1024, 512), (1000, 98, 130),
                                   (1, 1, 1), (65, 17, 63),
                                   (4096, 4096, 512), (37, 98, 128),
                                   (300, 63, 45), (129, 97, 131),
                                   (2048, 4095, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dual_matmul_kernel_vs_plain(cuda, M, K, N, dtype):
    x, w, u = _dual_inputs(cuda, M, K, N, dtype, seed=M + K + N)
    n0 = ops.dual_matmul.launches
    y0, y1 = ops.dual_matmul(x, w, u, 1e-3)
    assert ops.dual_matmul.launches == n0 + 1
    r0, r1 = dual_matmul.dual_matmul_plain(x, w, u, 1e-3)
    torch.cuda.synchronize()
    assert y0.dtype == y1.dtype == dtype and y0.shape == (M, N)
    assert _rel_err(y0, r0) <= DUAL_TOL[dtype]
    assert _rel_err(y1, r1) <= DUAL_TOL[dtype]


@pytest.mark.parametrize("party", [1, 2])
def test_dual_matmul_kernel_takes_a_column_slice_of_x(cuda, party):
    """Party p's block X[:, 98p:98(p+1)] of the D7 features: party 2's base
    is 16-byte aligned, party 1's is 8 bytes off (392 bytes in)."""
    X, w, u = _dual_inputs(cuda, 512, 784, 128, torch.float32, seed=1)
    x = X[:, 98 * party:98 * (party + 1)]
    got = ops.dual_matmul(x, w[:98].contiguous(),
                                  u[:98].contiguous(), 5e-2)
    want = ops.dual_matmul(x.contiguous(), w[:98].contiguous(),
                                   u[:98].contiguous(), 5e-2)
    assert all(_same_bits(a, b) for a, b in zip(got, want))


def test_dual_matmul_runs_on_the_tensor_cores(cuda):
    """The built library's SASS holds HGMMA (wgmma) instructions."""
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).exists():
        pytest.skip("needs cuobjdump to read the library's SASS")
    build.load("dual_matmul")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build._target("dual_matmul"))],
                          capture_output=True, text=True, check=True).stdout
    assert "HGMMA" in sass


def test_dual_matmul_perturbed_product_is_exact(cuda):
    """y1 of dual(x, w, u, mu) is bitwise y0 of dual(x, w_p, 0, mu), where
    w_p comes from the zo_update kernel at scale -mu: the kernel forms
    w + mu*u as zo_update does and sums both accumulators alike."""
    x, w, _ = _dual_inputs(cuda, 2048, 98, 128, torch.float32, seed=2)
    b = prng.bits((5, 6), w.shape, cuda)
    mu = 1e-3
    w_p = zo_update.zo_update(w, b, -float(np.float32(mu)))
    _, y1 = ops.dual_matmul(x, w, prng.rademacher_from_bits(b), mu)
    y0_p, _ = ops.dual_matmul(x, w_p, torch.zeros_like(w), mu)
    assert _same_bits(y1, y0_p)


@pytest.mark.parametrize("direction", ["uniform", "gaussian"])
def test_fcn_pair_is_exact_at_the_unfused_perturbation(cuda, direction):
    """The unfused exchange forms w_p = w + mu*d in torch; the FCN's pair
    has the kernel form w1 + mu*u1 itself. Both must be the same f32
    weights, so c_hat is the tower at the party's own w_p."""
    from repro_torch.configs import PaperFCNConfig, VFLConfig
    from repro_torch.core.exchange import ZOExchange
    from repro_torch.core.vfl import PaperFCNModel

    model = PaperFCNModel(PaperFCNConfig(num_features=784, num_parties=8))
    w_m = model.init_party(prng.key(3), 2, cuda)
    ex = ZOExchange.from_config(VFLConfig(num_parties=8, direction=direction,
                                          mu=1e-3, fused=False))
    w_p, u = ex.perturb(w_m, prng.key(4))
    g = torch.Generator(cuda).manual_seed(5)
    x_m = model.slice_features(torch.rand(64, 784, device=cuda, generator=g),
                               2)
    _, y1 = ops.dual_matmul(x_m, w_m["w1"], u["w1"], ex.mu)
    y0_p, _ = ops.dual_matmul(x_m, w_p["w1"], torch.zeros_like(u["w1"]),
                              ex.mu)
    assert _same_bits(y1, y0_p)
    _, c_hat = model.party_forward_pair(w_m, w_p, u, x_m, 2, ex.mu)
    assert _same_bits(c_hat, model._tower_head(w_p, y0_p))


def test_dual_matmul_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, w, u = _dual_inputs(cuda, 8, 4, 8, torch.float32, seed=3)
    with pytest.raises(TypeError):
        ops.dual_matmul(x.double(), w.double(), u, 1.0)
    with pytest.raises(TypeError):
        ops.dual_matmul(x, w, u.bfloat16(), 1.0)
    with pytest.raises(ValueError):
        ops.dual_matmul(x, w[:3], u[:3], 1.0)
    with pytest.raises(ValueError):
        ops.dual_matmul(x, w.t().contiguous().t(), u, 1.0)
    with pytest.raises(ValueError):
        ops.dual_matmul(x.cpu(), w, u, 1.0)


# f32: max |kernel - plain| / max |plain| <= 1e-5, the sums in another
# order (the online softmax over tiles against one softmax per row). bf16,
# element by element: the kernel rounds its f32 result once, so each output
# is within half a bf16 ulp (2^-8 of its size) of the plain version's f32
# result before the cast, plus the f32 bound for the order of the sums.
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 256, 4, 4, 64),
                                         (1, 200, 8, 2, 128),
                                         (1, 1000, 4, 1, 64),
                                         (1, 1000, 8, 2, 128),
                                         (2, 129, 4, 2, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_vs_plain(cuda, B, S, H, KV, hd, causal,
                                         dtype):
    g = torch.Generator(cuda).manual_seed(S + H)
    q, k, v = (torch.randn(B, S, n, hd, device=cuda, generator=g).to(dtype)
               for n in (H, KV, KV))
    n0 = flash_attention.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=causal)
    assert flash_attention.flash_attention.launches == n0 + 1
    want = flash_attention.flash_attention_plain(q, k, v, causal)
    rel = float((got.float() - want.float()).abs().max()
                / want.float().abs().max())
    assert rel <= FLASH_TOL[dtype]
    if dtype == torch.bfloat16:
        want32 = flash_attention.flash_attention_plain(
            q.float(), k.float(), v.float(), causal)
        allowed = 2.0 ** -8 * want32.abs() \
            + FLASH_TOL[torch.float32] * want32.abs().max()
        assert bool(((got.float() - want32).abs() <= allowed).all())


def test_flash_attention_kernels_run_on_the_tensor_cores(cuda):
    """Each of the built forward library's kernel functions (bf16 and f32,
    hd 64 and 128, with and without positions) holds HGMMA (wgmma)
    instructions in its own SASS; each bf16 function of the backward's
    two passes holds HGMMA and UTMALDG (TMA loads), each f32 one HGMMA
    (3xTF32)."""
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).exists():
        pytest.skip("needs cuobjdump to read the library's SASS")

    def functions(lib):
        build.load(lib)
        sass = subprocess.run([cuobjdump, "-sass", str(build._target(lib))],
                              capture_output=True, text=True,
                              check=True).stdout
        return {chunk.split("\n", 1)[0]: chunk
                for chunk in sass.split("Function : ")[1:]}

    for lib, kernel, ops in (
            ("flash_attention", "flash_attention_f32_kernel", ("HGMMA",)),
            ("flash_attention", "flash_attention_bf16_kernel", ("HGMMA",)),
            ("flash_attention_bwd", "flash_attention_bwd_bf16_dq_kernel",
             ("HGMMA", "UTMALDG")),
            ("flash_attention_bwd", "flash_attention_bwd_bf16_dkdv_kernel",
             ("HGMMA", "UTMALDG")),
            ("flash_attention_bwd", "flash_attention_bwd_f32_dq_kernel",
             ("HGMMA",)),
            ("flash_attention_bwd", "flash_attention_bwd_f32_dkdv_kernel",
             ("HGMMA",))):
        # hd 64 and 128, each without and with explicit positions
        mine = [text for name, text in functions(lib).items()
                if kernel in name]
        assert len(mine) == 4 and all(op in text for text in mine
                                      for op in ops)


def test_flash_attention_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros(1, 8, 4, 64, device=cuda)
    with pytest.raises(TypeError):
        ops.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(TypeError):
        ops.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError):
        h32 = torch.zeros(1, 8, 4, 32, device=cuda)
        ops.flash_attention(h32, h32, h32)
    with pytest.raises(ValueError):
        ops.flash_attention(q, q.cpu(), q)
    t = torch.zeros(1, 8, 64, 4, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError):
        ops.flash_attention(t, t, t)


def test_flash_attention_bf16_refuses_hd96_and_views(cuda):
    """hd 96 and a view of one fused projection raise in bf16 too: no
    path goes back to another kernel or to the plain version."""
    n0 = flash_attention.flash_attention.launches
    h96 = torch.zeros(1, 8, 4, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(h96, h96, h96)
    qkv = torch.zeros(1, 8, 12, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(qkv[:, :, :4], qkv[:, :, 4:8], qkv[:, :, 8:])
    assert flash_attention.flash_attention.launches == n0


def test_reduced_vfl_zoo_steps_on_the_card_match_the_cpu(cuda):
    """3 fused int8 asyrevel steps of reduced qwen1.5-0.5b: the card
    (kernels) against the CPU (plain versions), from the same keys. An ulp
    of c can flip an int8 stochastic rounding, so losses get 1e-3."""
    from repro_torch.launch import train
    argv = ["--arch", "qwen1.5-0.5b", "--mode", "vfl-zoo", "--reduced",
            "--steps", "3", "--batch-size", "2", "--seq-len", "64",
            "--fused", "--codec", "int8", "--lr", "1e-2", "--log-every",
            "100"]
    n0 = flash_attention.flash_attention.launches
    d0 = prng_draw.draw.launches
    on_card = train.main(argv)["h"]
    assert flash_attention.flash_attention.launches == n0 + 3 * 3 * 2
    # the initial weights (the server's embedding, 7 matrices in each of 2
    # layers, and 4 parties' embedding slice, w1 and w2), then 17 gaussian
    # directions a step
    assert prng_draw.draw.launches == d0 + (1 + 7 * 2 + 3 * 4) + 3 * 17
    on_cpu = train.main(argv + ["--device", "cpu"])["h"]
    assert max(abs(a - b) for a, b in zip(on_card, on_cpu)) < 1e-3


def _reduced_bf16_h(device):
    from repro_torch.configs import VFLConfig, get_config
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.train import make_batch_arrays
    from repro_torch.models.model import build_model
    cfg = get_config("qwen1.5-0.5b", reduced=True).replace(dtype="bfloat16")
    vfl = VFLConfig(num_parties=4, mu=1e-3, lr_party=1e-2, lr_server=1e-2 / 4,
                    fused=True, codec="int8")
    _, init, step = step_lib.make_vfl_zoo_step(build_model(cfg), vfl)
    state = init(prng.key(0), device)
    data = make_batch_arrays(cfg, 64, 64, 0, device)
    rng = np.random.default_rng(0)
    h = []
    for _ in range(3):
        idx = torch.as_tensor(rng.integers(0, 64, 2), device=device)
        state, loss = step(state, {k: a[idx] for k, a in data.items()})
        h.append(float(loss))
    return h


def test_reduced_bf16_vfl_zoo_steps_on_the_card_match_the_cpu(cuda):
    """The same in bf16, the dtype of the full-size run: the first h is one
    forward (moved roundings spread through the layers: 2e-3), the later
    ones follow ZO coefficients that divide such gaps by mu (5e-2), the
    tolerances tests/test_torch_bf16.py holds the CPU port to."""
    on_card, on_cpu = _reduced_bf16_h(cuda), _reduced_bf16_h("cpu")
    gaps = [abs(a - b) for a, b in zip(on_card, on_cpu)]
    assert gaps[0] < 2e-3 and max(gaps) < 5e-2


# ------------------------------------- scan trainer and K-direction round --

def _small_fcn(q=2, d=32, n=256):
    from repro_torch.configs import PaperFCNConfig
    from repro_torch.core.vfl import PaperFCNModel
    rng = np.random.default_rng(0)
    X = rng.random((n, d)).astype(np.float32)
    y = rng.integers(0, 10, n).astype(np.int32)
    model = PaperFCNModel(PaperFCNConfig(num_features=d, num_parties=q,
                                         party_hidden=16))
    return model, X, y


def _defended(q, K, fused):
    from repro_torch.configs import VFLConfig
    return VFLConfig(num_parties=q, direction="rademacher", mu=5e-2,
                     lr_party=2e-2, lr_server=1e-2, codec="int8",
                     dp=DPConfig(noise_multiplier=1.3, clip=1.0),
                     fused=fused, num_directions=K)


def _launch_counts():
    return (fused_round.defended_encode.launches,
            zo_update.zo_update.launches, dual_matmul.dual_matmul.launches,
            prng_draw.draw.launches)


@pytest.mark.parametrize("algorithm", ["asyrevel", "synrevel"])
def test_scan_fused_k_directions_bitwise_unfused_with_exact_launches(
        cuda, algorithm):
    """train with K = 3 on the defended FCN: per step the fused run makes
    q + P*K defended_encode launches (the stale c's and the c_hat's, P the
    perturbing parties: 1 or q) and a draw and a zo_update for each of the
    P*K*4 + 2 perturbed leaves; the unfused run draws those leaves'
    directions and two bit streams per release. Both draw each step's
    batch indices as two bit streams. Fused losses and state are bitwise
    the unfused run's."""
    from repro_torch.core import asyrevel
    from repro_torch.utils import trees
    q, K, steps = 2, 3, 4
    P = 1 if algorithm == "asyrevel" else q
    leaves, releases = P * K * 4 + 2, q + P * K
    model, X, y = _small_fcn(q)
    runs = {}
    for fused in (True, False):
        n0 = _launch_counts()
        state, h = asyrevel.train(model, _defended(q, K, fused),
                                  {"x": X, "y": y}, prng.key(1), steps, 16,
                                  algorithm=algorithm)
        torch.cuda.synchronize()
        got = tuple(b - a for a, b in zip(n0, _launch_counts()))
        init = 2 * q + 1                 # each party's w1, w2; the server's w
        want = ((steps * releases, steps * leaves, 0,
                 steps * (leaves + 2) + init) if fused else
                (0, 0, 0, steps * (leaves + 2 * releases + 2) + init))
        assert got == want
        assert bool(torch.isfinite(h).all())
        runs[fused] = (state, h)
    (sf, hf), (su, hu) = runs[True], runs[False]
    assert _same_bits(hf, hu)
    for a, b in ((sf.w0, su.w0), (sf.parties, su.parties),
                 (sf.hist, su.hist)):
        assert all(_same_bits(x, z) for x, z in zip(trees.leaves(a),
                                                    trees.leaves(b)))


def test_host_round_k_directions_fused_bitwise_unfused(cuda):
    """run_serial with K = 3: a dual_matmul per direction, 1 + K
    defended_encode launches a fused round, fused bitwise unfused."""
    from repro_torch.core.async_host import HostAsyncTrainer
    q, K, rounds = 2, 3, 3
    model, X, y = _small_fcn(q)
    out = {}
    for fused in (True, False):
        tr = HostAsyncTrainer(model, _defended(q, K, fused), X, y,
                              batch_size=16, seed=0, compute_cost_s=0.0)
        n0 = _launch_counts()
        res = tr.run_serial(rounds)
        got = tuple(b - a for a, b in zip(n0, _launch_counts()))
        updates, leaves = rounds * q, K * 4 + 2
        assert got == ((updates * (1 + K), updates * leaves, updates * K,
                        updates * leaves) if fused else
                       (0, 0, updates * K, updates * (leaves + 2 * (1 + K))))
        assert (res.bytes_up, res.bytes_down) == (
            updates * (1 + K) * (16 + 4), updates * (1 + K) * 4)
        out[fused] = (tr, [h for _, h in res.history])
    (tf, hf), (tu, hu) = out[True], out[False]
    assert hf == hu
    for m in range(q):
        assert all(_same_bits(tf.party_w[m][k], tu.party_w[m][k])
                   for k in tf.party_w[m])
    assert all(_same_bits(tf.server.w0[k], tu.server.w0[k])
               for k in tf.server.w0)


@pytest.mark.parametrize("shape,minval,maxval", [
    ((2048,), 0, 60_000), ((64,), 0, 300), ((9,), -5, 7), ((1,), 0, 1)])
def test_randint_on_the_card_bitwise_the_host_draw(cuda, shape, minval,
                                                   maxval):
    """randint_on, two draw-kernel launches and int64 ops on the card,
    gives exactly the host's randint (the plain version)."""
    k = prng.fold_in(prng.key(3), 7)
    n0 = prng_draw.draw.launches
    got = prng.randint_on(k, shape, minval, maxval, cuda)
    assert prng_draw.draw.launches - n0 == 2
    assert got.device.type == "cuda" and got.dtype == torch.int64
    assert got.cpu().reshape(-1).tolist() == prng.randint(k, shape, minval,
                                                          maxval)


# ------------------------------------------------------------ LM serving --

LM_FAMILIES = ["qwen1.5-0.5b", "rwkv6-1.6b", "hymba-1.5b"]


def _decode_logits(arch, device, steps=10, **replace):
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch, reduced=True).replace(**replace)
    model = build_model(cfg)
    params = model.init(prng.key(1), device)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, steps))
    cache = model.init_cache(params, 2, 16)
    rows = []
    for pos in range(steps):
        lg, cache = model.decode_step(
            params, cache, torch.as_tensor(toks[:, pos:pos + 1],
                                           device=device), pos)
        rows.append(lg)
    return torch.cat(rows, dim=1).cpu(), model, params, toks


@pytest.mark.parametrize("kv", ["model", "int8"])
@pytest.mark.parametrize("arch", LM_FAMILIES)
def test_reduced_decode_on_the_card_matches_the_cpu(cuda, arch, kv):
    """10 decode steps of each family, reduced f32, both cache dtypes: the
    card within 1e-4 of the CPU port (TF32 off; the sums' order differs)."""
    on_card = _decode_logits(arch, cuda, kv_cache_dtype=kv)[0]
    on_cpu = _decode_logits(arch, "cpu", kv_cache_dtype=kv)[0]
    assert float((on_card - on_cpu).abs().max()) <= 1e-4


def test_reduced_dense_forward_on_the_card_matches_its_decode(cuda):
    """The dense forward runs the f32 flash_attention kernel (one launch a
    layer); token-by-token decode within the reference's 2e-4."""
    dec, model, params, toks = _decode_logits("qwen1.5-0.5b", cuda)
    n0 = flash_attention.flash_attention.launches
    t = torch.as_tensor(toks, device=cuda)
    full, _ = model.forward(params, {"tokens": t, "targets": t})
    assert flash_attention.flash_attention.launches == n0 + 2
    assert float((full.cpu() - dec).abs().max()) <= 2e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sampling_on_the_card_bitwise_the_host(cuda, dtype):
    """``categorical_rows``: one draw launch a keyed row on the card, the
    Gumbel chain and the argmax equal to the CPU's on the same logits (an
    empty row draws nothing)."""
    logits = torch.randn(4, 151936, generator=torch.Generator().manual_seed(
        0)).to(dtype)
    keys = [prng.fold_in(prng.key(11), r) for r in (3, 9)] + [None,
                                                              (5, 7)]
    d0 = prng_draw.draw.launches
    on_card = prng.categorical_rows(keys, logits.to(cuda))
    assert prng_draw.draw.launches == d0 + 3
    on_cpu = prng.categorical_rows(keys, logits)
    assert torch.equal(on_card.cpu()[[0, 1, 3]], on_cpu[[0, 1, 3]])
    g = prng.gumbel(keys[0], (1000,), cuda, dtype).cpu()
    assert torch.isfinite(g).all()
    assert _same_bits(g, prng.gumbel(keys[0], (1000,), "cpu", dtype))


def test_engine_on_the_card_gives_the_cpus_tokens(cuda):
    """Continuous batching (6 requests at 2 slots) of reduced qwen, greedy
    and sampled: the card's tokens equal the CPU port's (the logits sit
    ~1e-6 apart; chip_smoke.py's phase 12 holds every family to the
    margin rule), and sampled tokens at 2 slots equal those at 3."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    from repro_torch.serving import Request, ServingEngine
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = build_model(cfg)
    rng = np.random.default_rng(0)
    reqs = [(rid, rng.integers(0, 512, int(rng.integers(3, 10))),
             int(rng.integers(2, 7))) for rid in range(6)]

    def run(device, greedy, slots=2):
        eng = ServingEngine(model, model.init(prng.key(0), device),
                            slots=slots, max_len=32, greedy=greedy, seed=11,
                            device=device)
        for rid, prompt, n in reqs:
            eng.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
        return {r.rid: r.out_tokens for r in eng.run()}
    for greedy in (True, False):
        assert run(cuda, greedy) == run("cpu", greedy)
    assert run(cuda, False) == run(cuda, False, slots=3)


# ---------------------------------------------- the moe, vlm and audio --

NEW_FAMILIES = ["qwen3-moe-30b-a3b", "phi3.5-moe-42b-a6.6b", "chameleon-34b",
                "whisper-small"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_dispatch_on_the_card_is_deterministic(cuda, dtype):
    """qwen3-moe's routing (128 experts, top 8) at d 256 over 4096 tokens,
    experts 1 and 2 with the same router column: two calls bitwise equal
    (the scatter and the gather use no atomics), every tie to the lower
    expert, the routes the CPU's wherever the top 9 probabilities are
    apart (or exactly tied), the output within 1e-5 (f32) or 2e-2 (bf16)
    of the CPU's over its largest entry."""
    from repro_torch.configs import MoEConfig, get_config
    from repro_torch.models import moe
    cfg = get_config("qwen3-moe-30b-a3b", reduced=True).replace(
        d_model=256, moe=MoEConfig(128, 8, 64),
        dtype="float32" if dtype == torch.float32 else "bfloat16")
    p = moe.moe_init(prng.key(3), cfg, "cpu", dtype)
    p["router"][:, 2] = p["router"][:, 1]
    x = torch.randn(4, 1024, 256, generator=torch.Generator().manual_seed(
        4)).to(dtype)
    pc = {k: v.to(cuda) for k, v in p.items()}
    a, aux_a = moe.moe_apply(pc, cfg, x.to(cuda))
    b, aux_b = moe.moe_apply(pc, cfg, x.to(cuda))
    assert _same_bits(a, b) and _same_bits(aux_a, aux_b)
    probs, _, idx = moe.route(pc, cfg, x.to(cuda).reshape(-1, 256))
    probs, idx = probs.cpu(), idx.cpu()
    assert torch.equal(probs[:, 1], probs[:, 2])
    rows = [r.tolist() for r in idx]
    assert not any(2 in r and 1 not in r for r in rows)
    assert all(r.index(1) < r.index(2) for r in rows if 2 in r)
    _, _, want_idx = moe.route(p, cfg, x.reshape(-1, 256))
    top = torch.sort(probs, dim=-1, descending=True).values[:, :9]
    gap = top[:, :-1] - top[:, 1:]
    decided = ((gap > 1e-6 * top[:, :1]) | (gap == 0)).all(dim=1)
    assert float(decided.float().mean()) >= 0.9
    assert torch.equal(idx[decided], want_idx[decided])
    want, want_aux = moe.moe_apply(p, cfg, x)
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    assert float((a.cpu().float() - want.float()).abs().max()) <= \
        tol * float(want.float().abs().max())
    assert abs(float(aux_a) - float(want_aux)) <= 1e-6


@pytest.mark.parametrize("arch", NEW_FAMILIES)
def test_new_families_decode_on_the_card_matches_the_cpu(cuda, arch):
    """Each new architecture reduced (f32): the forward (the f32
    flash_attention kernel, one launch a layer, whisper's encoder's too)
    and 10 decode steps from ``init_cache`` (whisper's frames encoded into
    the cross K/V) within 1e-4 of the CPU port."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, (2, 10))
    frames = rng.normal(size=(2, cfg.encoder_frames, cfg.d_model)).astype(
        np.float32)
    out = {}
    for device in (cuda, torch.device("cpu")):
        params = model.init(prng.key(1), device)
        t = torch.as_tensor(toks, device=device)
        batch = {"tokens": t, "targets": t}
        if cfg.enc_dec:
            batch["frames"] = torch.as_tensor(frames, device=device)
        if cfg.frontend == "vq_stub":
            batch["modality_mask"] = (t % 3 == 0).long()
        n0 = flash_attention.flash_attention.launches
        full, _ = model.forward(params, batch)
        if device.type == "cuda":
            assert flash_attention.flash_attention.launches - n0 == \
                cfg.num_layers + cfg.num_encoder_layers
        cache = model.init_cache(params, 2, 16, frames=batch.get("frames"))
        rows = []
        for pos in range(10):
            lg, cache = model.decode_step(params, cache, t[:, pos:pos + 1],
                                          pos)
            rows.append(lg)
        out[device.type] = (full.cpu(), torch.cat(rows, dim=1).cpu())
    for a, b in zip(out["cuda"], out["cpu"]):
        assert float((a - b).abs().max()) <= 1e-4


# the backward kernel against flash_attention_bwd_plain: f32 within 1e-4 of
# each gradient's largest magnitude (the sums in other orders over S), bf16
# within 2e-2 (bf16 inputs, each output rounded once)
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel(got, want) -> float:
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


# (1, 900, ...): the last kv block's second consumer warpgroup holds no row;
# (4, 2048, 16, 16, 64): the lm shape (qwen1.5-0.5b, batch 4)
@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 256, 4, 4, 64),
                                         (1, 200, 8, 2, 128),
                                         (2, 129, 4, 2, 64),
                                         (1, 1000, 8, 2, 128),
                                         (1, 900, 4, 2, 128),
                                         (4, 2048, 16, 16, 64)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_vs_plain(cuda, B, S, H, KV, hd,
                                                  causal, dtype):
    """dq, dk, dv of the kernel against the plain backward from the same
    forward output and lse; two calls bitwise (no atomics); the forward
    with lse gives the forward-only launch's output bitwise, its lse the
    plain row logsumexp within 1e-5."""
    g = torch.Generator(cuda).manual_seed(S + H + 7)
    q, do = (torch.randn(B, S, H, hd, device=cuda, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    out, lse = flash_attention._launch_fwd(q, k, v, causal, None, True)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal))
    _, want_lse = flash_attention.flash_attention_plain(q, k, v, causal,
                                                        return_lse=True)
    assert float((lse - want_lse).abs().max()) <= 1e-5 * float(
        want_lse.abs().max())
    n0 = flash_attention.flash_attention_bwd.launches
    got = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, causal)
    again = flash_attention.flash_attention_bwd(q, k, v, out, do, lse, causal)
    assert flash_attention.flash_attention_bwd.launches == n0 + 2
    want = flash_attention.flash_attention_bwd_plain(q, k, v, out, do, lse,
                                                     causal)
    for a, b, w in zip(got, again, want):
        assert torch.equal(a, b) and a.dtype == dtype
        assert _rel(a, w) <= BWD_TOL[dtype]


def test_flash_attention_bwd_bf16_raises_on_a_misaligned_operand(cuda):
    """The bf16 backward's TMA needs 16-byte aligned operands: a contiguous
    view that starts 2 bytes into its storage is refused by the kernel's
    launcher, and the wrapper raises, launching nothing and falling back
    to nothing."""
    B, S, H, hd = 1, 64, 2, 64
    g = torch.Generator(cuda).manual_seed(11)
    q, k, v, do = (torch.randn(B, S, H, hd, device=cuda, generator=g)
                   .bfloat16() for _ in range(4))
    out, lse = flash_attention._launch_fwd(q, k, v, True, None, True)
    odd = torch.empty(q.numel() + 1, device=cuda, dtype=torch.bfloat16)
    odd = odd[1:].view(q.shape)
    odd.copy_(do)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    n0 = flash_attention.flash_attention_bwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        flash_attention.flash_attention_bwd(q, k, v, out, odd, lse, True)
    assert flash_attention.flash_attention_bwd.launches == n0


def test_flash_attention_bwd_f32_raises_on_a_misaligned_operand(cuda):
    """The f32 backward's producer loads 16 bytes at a time: a contiguous
    view that starts 4 bytes into its storage is refused by the kernel's
    launcher, and the wrapper raises, launching nothing and falling back
    to nothing."""
    B, S, H, hd = 1, 64, 2, 64
    g = torch.Generator(cuda).manual_seed(12)
    q, k, v, do = (torch.randn(B, S, H, hd, device=cuda, generator=g)
                   for _ in range(4))
    out, lse = flash_attention._launch_fwd(q, k, v, True, None, True)
    odd = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    odd.copy_(do)
    assert odd.is_contiguous() and odd.data_ptr() % 16 != 0
    n0 = flash_attention.flash_attention_bwd.launches
    with pytest.raises(RuntimeError, match="launch failed"):
        flash_attention.flash_attention_bwd(q, k, v, out, odd, lse, True)
    assert flash_attention.flash_attention_bwd.launches == n0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hd", [64, 128])
def test_flash_attention_positions_and_blind_rows_on_the_card(cuda, dtype,
                                                              hd):
    """Explicit q and kv positions, some rows seeing no key: the forward
    and the gradients through autograd against the plain versions; a
    blind row is the mean of v and passes no gradient to q."""
    B, S, H, KV = 2, 300, 4, 2
    g = torch.Generator(cuda).manual_seed(hd)
    q, do = (torch.randn(B, S, H, hd, device=cuda, generator=g).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(B, S, KV, hd, device=cuda, generator=g).to(dtype)
            for _ in range(2))
    qp = torch.randint(0, S, (B, S), device=cuda, generator=g)
    kp = torch.randint(5, S, (B, S), device=cuda, generator=g)
    qp[0, 3] = 1
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = ops.flash_attention(*leaves, True, qp, kp)
    out.backward(do)
    want, lse = flash_attention.flash_attention_plain(q, k, v, True, qp,
                                                      True, kp)
    assert _rel(out.detach(), want) <= BWD_TOL[dtype]
    mean = v[0].float().mean(0).repeat_interleave(H // KV, 0)
    assert float((out.detach()[0, 3].float() - mean).abs().max()) <= \
        BWD_TOL[dtype] * float(mean.abs().max()) + 1e-6
    grads = flash_attention.flash_attention_bwd_plain(
        q, k, v, want, do, lse, True, qp, kp)
    for t, w in zip(leaves, grads):
        assert _rel(t.grad, w) <= BWD_TOL[dtype]
    assert float(leaves[0].grad[0, 3].abs().max()) == 0.0


def test_lm_train_steps_on_the_card_match_the_cpu(cuda):
    """Reduced qwen1.5-0.5b (f32), 3 Adam steps of make_train_step from one
    state on the card and on the CPU: each step's loss within 1e-4, with
    one forward and one backward flash_attention launch a layer a step (2
    layers, no remat in the reduced config), and finite params."""
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.train import make_batch_arrays
    from repro_torch.models.model import build_model
    from repro_torch.utils import trees
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = build_model(cfg)
    states = {d: step_lib.make_train_state(model, prng.key(0), d)
              for d in ("cpu", cuda)}
    data = make_batch_arrays(cfg, 4, 64, 0, "cpu")
    step = step_lib.make_train_step(model)
    f0 = flash_attention.flash_attention.launches
    b0 = flash_attention.flash_attention_bwd.launches
    for s in range(3):
        batch = {k: a[s:s + 2] for k, a in data.items()}
        losses = {}
        for d in states:
            states[d], (loss, _) = step(
                states[d], {k: a.to(d) for k, a in batch.items()})
            losses[d] = float(loss)
        assert abs(losses["cpu"] - losses[cuda]) <= 1e-4
    assert flash_attention.flash_attention.launches - f0 == 3 * 2
    assert flash_attention.flash_attention_bwd.launches - b0 == 3 * 2
    assert all(bool(torch.isfinite(b).all())
               for b in trees.leaves(states[cuda].params))
