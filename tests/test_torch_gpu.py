"""The CUDA kernels against their plain torch versions on the card:
defended_encode and zo_update bitwise, dual_matmul and flash_attention
within a stated tolerance (their sums run in another order than the
plain versions') and bitwise where only their own order is involved, and
a reduced vfl-zoo step on the card against the same step on the CPU. No jax here: the machine with the card has none. Without a CUDA
device every test skips (the kernels have no CPU mode); run them there
with ``PYTHONPATH=src python -m pytest -q tests/test_torch_gpu.py``."""
import numpy as np
import pytest
import torch

from repro_torch.configs import DPConfig
from repro_torch.kernels import (dual_matmul, flash_attention, fused_round,
                                 ops, zo_update)
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
    """Each of the built library's kernel functions (bf16 and f32, hd 64
    and 128) holds HGMMA (wgmma) instructions in its own SASS."""
    import shutil
    import subprocess
    from pathlib import Path

    from repro_torch.kernels import build
    cuobjdump = shutil.which("cuobjdump") or str(
        Path(build._nvcc()).parent / "cuobjdump")
    if not Path(cuobjdump).exists():
        pytest.skip("needs cuobjdump to read the library's SASS")
    build.load("flash_attention")
    sass = subprocess.run([cuobjdump, "-sass",
                           str(build._target("flash_attention"))],
                          capture_output=True, text=True, check=True).stdout
    funcs = {chunk.split("\n", 1)[0]: chunk
             for chunk in sass.split("Function : ")[1:]}
    for kernel in ("flash_attention_f32_kernel",
                   "flash_attention_bf16_kernel"):
        mine = [text for name, text in funcs.items() if kernel in name]
        assert len(mine) == 2 and all("HGMMA" in text for text in mine)


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
    on_card = train.main(argv)["h"]
    assert flash_attention.flash_attention.launches == n0 + 3 * 3 * 2
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
