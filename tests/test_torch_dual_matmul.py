"""The port's dual_matmul and the FCN's two tower evaluations against the
reference.

On the CPU the wrapper runs its plain torch version, held here against
the reference's Pallas ``dual_matmul`` (interpret mode) on identical
numpy inputs, with the reference test's tolerances; the CUDA kernel is
held against the plain version on the card (tests/test_torch_gpu.py and
chip_smoke.py). ``PaperFCNModel.party_forward_pair`` is held bitwise to
two ``party_forward`` calls and, within f32 matmul tolerance, to the
reference's one-dispatch party evaluation ``_party_fused_jit``. The CUDA
kernel's 3xTF32 arithmetic, which no CPU runs, is emulated here on the
bits and held to the reference's oracle with the card's 1e-5 check."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import PaperFCNConfig as RefFCNConfig
from repro.configs import VFLConfig as RefVFLConfig
from repro.core.async_host import _party_fused_jit
from repro.core.vfl import PaperFCNModel as RefFCN
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro_torch.configs import PaperFCNConfig, PaperLRConfig, VFLConfig
from repro_torch.core.exchange import ZOExchange
from repro_torch.core.vfl import PaperFCNModel, PaperLRModel
from repro_torch.interop import params_from_numpy
from repro_torch.kernels import dual_matmul, ops, zo_update
from repro_torch.utils import prng

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

SHAPES = [(128, 128, 128), (256, 512, 384), (128, 1024, 256),
          (512, 256, 128)]
# the reference test's tolerances: f32 sums in another order (2e-4), and
# bf16 outputs rounded to 8 bits of mantissa (2e-2)
TOL = {"f32": 2e-4, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(M, K, N, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32),
            rng.standard_normal((K, N)).astype(np.float32))


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("M,K,N", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_plain_dual_matmul_matches_reference_kernel(M, K, N, dtype):
    x, w, u = _inputs(M, K, N, seed=M + K + N)
    jdt, tdt = DTYPES[dtype]
    r0, r1 = ref_ops.dual_matmul(jnp.asarray(x).astype(jdt),
                                 jnp.asarray(w).astype(jdt), jnp.asarray(u),
                                 mu=1e-2, bm=128, bn=128, bk=128)
    n0 = ops.dual_matmul.launches
    y0, y1 = ops.dual_matmul(torch.from_numpy(x).to(tdt),
                             torch.from_numpy(w).to(tdt),
                             torch.from_numpy(u), 1e-2)
    assert ops.dual_matmul.launches == n0      # CPU: no launch
    assert y0.dtype == y1.dtype == tdt and y0.shape == (M, N)
    tol = TOL[dtype]
    np.testing.assert_allclose(_np(y0), np.asarray(r0, np.float32),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(y1), np.asarray(r1, np.float32),
                               atol=tol, rtol=tol)


def test_plain_dual_matmul_ragged_shape_matches_reference_oracle():
    """The main path's K = 98 and a ragged N: the Pallas kernel takes only
    tile multiples, so this holds the plain version to the reference's
    pure-jnp oracle."""
    x, w, u = _inputs(100, 98, 130, seed=7)
    r0, r1 = ref_kernels.dual_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(u), mu=1e-3)
    y0, y1 = dual_matmul.dual_matmul_plain(*map(torch.from_numpy, (x, w, u)),
                                           1e-3)
    np.testing.assert_allclose(_np(y0), np.asarray(r0), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(_np(y1), np.asarray(r1), atol=2e-4, rtol=2e-4)


def test_dual_matmul_difference_is_the_perturbation_product():
    """y1 - y0 = mu * x @ u, the two-point numerator (the reference's
    test_dual_matmul_perturbation_direction)."""
    x, w, u = _inputs(128, 256, 128, seed=4)
    mu = 1e-3
    y0, y1 = ops.dual_matmul(*map(torch.from_numpy, (x, w, u)), mu)
    np.testing.assert_allclose(_np(y1 - y0), mu * (x @ u), atol=1e-4)


def test_perturbed_product_is_the_product_at_the_perturbed_weights():
    """The plain version forms w + mu*u as the zo_update kernel's plain
    version does at scale -mu, so y1 is bitwise x @ w_p."""
    x, w, _ = _inputs(64, 98, 128, seed=5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    b = prng.bits((1, 2), wt.shape, "cpu")
    mu = 1e-3
    w_p = zo_update.zo_update(wt, b, -float(np.float32(mu)))
    _, y1 = ops.dual_matmul(xt, wt, prng.rademacher_from_bits(b), mu)
    y0_p, _ = ops.dual_matmul(xt, w_p, torch.zeros_like(wt), mu)
    assert torch.equal(y1, y0_p)


# The f32 CUDA kernel's numerics (3xTF32), emulated in plain torch: each
# f32 operand split into hi = tf32(a) and lo = tf32(a - hi), both rounded as
# cvt.rna.tf32.f32 rounds (to nearest, ties away from zero, 10 mantissa
# bits), w + mu*u formed in f32 before its split, and x.w = x_hi.w_hi +
# x_hi.w_lo + x_lo.w_hi with exact products. Held to the reference's oracle
# with the card check's tolerance; one tf32 product (x_hi.w_hi) is the
# control that must miss it.
DUAL_TOL_F32 = 1e-5        # chip_smoke.py and tests/test_torch_gpu.py


def _tf32(a: torch.Tensor) -> torch.Tensor:
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a: torch.Tensor):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _three_tf32(x, w, u, mu, products=3):
    wp = w + torch.as_tensor(np.float32(mu)) * u
    xh, xl = _split(x)
    out = []
    for b in (w, wp):
        bh, bl = _split(b)
        terms = [(xh, bh), (xh, bl), (xl, bh)][:products]
        out.append(sum(a.double() @ c.double() for a, c in terms).float())
    return out


def _rel_to_reference(got, x, w, u, mu):
    want = ref_kernels.dual_matmul_ref(jnp.asarray(x), jnp.asarray(w),
                                       jnp.asarray(u), mu=mu)
    scale = max(float(np.abs(np.asarray(y)).max()) for y in want)
    return max(float(np.abs(g.numpy() - np.asarray(y)).max())
               for g, y in zip(got, want)) / scale


SPLIT_SHAPES = [(2048, 98, 128), (512, 4096, 256), (300, 97, 45)]


@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
def test_three_tf32_products_hold_the_f32_tolerance(M, K, N):
    x, w, u = _inputs(M, K, N, seed=M + K)
    got = _three_tf32(*map(torch.from_numpy, (x, w, u)), 1e-3)
    assert _rel_to_reference(got, x, w, u, 1e-3) <= DUAL_TOL_F32


@pytest.mark.parametrize("M,K,N", SPLIT_SHAPES)
def test_one_tf32_product_misses_the_f32_tolerance(M, K, N):
    x, w, u = _inputs(M, K, N, seed=M + K)
    got = _three_tf32(*map(torch.from_numpy, (x, w, u)), 1e-3, products=1)
    assert _rel_to_reference(got, x, w, u, 1e-3) > 10 * DUAL_TOL_F32


def test_tf32_rounding_is_to_nearest_ties_away():
    """The bit trick is cvt.rna.tf32.f32: 10 mantissa bits kept, a half ulp
    rounds away from zero, and a - hi is exact in f32."""
    ulp = 2.0 ** -10
    a = torch.tensor([1 + ulp / 2, 1 + ulp / 2 - 2 ** -23, -(1 + ulp / 2),
                      1 + 3 * ulp / 2, 3.0, 0.0], dtype=torch.float32)
    hi = _tf32(a)
    assert hi.tolist() == [1 + ulp, 1.0, -(1 + ulp), 1 + 2 * ulp, 3.0, 0.0]
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        10000).astype(np.float32))
    xh, xl = _split(x)
    assert torch.equal((xh.double() + (x - xh).double()).float(), x)
    assert float(((x.double() - xh.double() - xl.double()).abs()
                  / x.double().abs()).max()) <= 2.0 ** -21


def _truncate_to_f32(s: torch.Tensor) -> torch.Tensor:
    f = s.float()
    over = f.double().abs() > s.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def _tensor_core_sum(x, w, stage_k):
    """x.w as the kernel sums it, under a model of the tensor cores: each k8
    step's 3 products are added into the wgmma accumulator exactly and the
    result truncated to f32; every stage_k of k the accumulator is added
    into an f32 total with round-to-nearest and restarted."""
    xh, xl = _split(x)
    wh, wl = _split(w)
    total = torch.zeros(x.shape[0], w.shape[1])
    for s0 in range(0, x.shape[1], stage_k):
        acc = torch.zeros_like(total)
        for k0 in range(s0, min(s0 + stage_k, x.shape[1]), 8):
            k = slice(k0, k0 + 8)
            for a, b in ((xh, wh), (xh, wl), (xl, wh)):
                acc = _truncate_to_f32(acc.double()
                                       + a[:, k].double() @ b[k].double())
        total = total + acc
    return total


@pytest.mark.parametrize("stage_k,within", [(32, True), (4096, False)])
def test_per_stage_totals_keep_a_truncating_accumulator_within_tolerance(
        stage_k, within):
    """A 4096-deep sum: with the kernel's 32-deep stages added into f32
    totals the truncation stays within the f32 tolerance; one accumulator
    over all of K (the control) drifts past it."""
    x, w, _ = _inputs(64, 4096, 64, seed=9)
    got = _tensor_core_sum(torch.from_numpy(x), torch.from_numpy(w), stage_k)
    want = x.astype(np.float64) @ w.astype(np.float64)
    rel = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
    assert (rel <= DUAL_TOL_F32) == within


def test_ops_zo_update_matches_reference_pytree_wrapper():
    rng = np.random.default_rng(3)
    params = {"a": rng.standard_normal((7, 5)).astype(np.float32),
              "b": rng.standard_normal(1000).astype(np.float32)}
    bits = {k: rng.integers(0, 1 << 32, v.shape, dtype=np.uint32)
            for k, v in params.items()}
    want = ref_ops.zo_update({k: jnp.asarray(v) for k, v in params.items()},
                             {k: jnp.asarray(v) for k, v in bits.items()},
                             3.7e-4)
    got = ops.zo_update({k: torch.from_numpy(v) for k, v in params.items()},
                        {k: torch.from_numpy(v.view(np.int32))
                         for k, v in bits.items()}, 3.7e-4)
    for k in params:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


# ------------------------------------------ the FCN's two tower evaluations --

def _fcn_setup(direction, fused, seed=0):
    q, d, hidden, B = 2, 196, 32, 64
    rng = np.random.default_rng(seed)
    X = rng.random((B, d)).astype(np.float32)
    cfg = dict(num_features=d, num_parties=q, party_hidden=hidden)
    ref_model = RefFCN(RefFCNConfig(**cfg))
    w_ref = ref_model.init_party(jax.random.key(seed + 1), 1)
    kw = dict(num_parties=q, direction=direction, mu=1e-3, fused=fused)
    return (X, ref_model, w_ref, RefVFLConfig(**kw),
            PaperFCNModel(PaperFCNConfig(**cfg)), VFLConfig(**kw))


@pytest.mark.parametrize("direction,fused", [("gaussian", False),
                                             ("uniform", False),
                                             ("rademacher", True)])
def test_party_forward_pair_bitwise_equals_two_forwards(direction, fused):
    X, _, w_ref, _, model, vfl = _fcn_setup(direction, fused)
    w_m = params_from_numpy(jax.tree.map(np.asarray, w_ref), "cpu")
    x_m = model.slice_features(torch.from_numpy(X), 1)
    w_p, u = ZOExchange.from_config(vfl).perturb(w_m, prng.key(11))
    c, c_hat = model.party_forward_pair(w_m, w_p, u, x_m, 1, vfl.mu)
    assert torch.equal(c, model.party_forward(w_m, x_m, 1))
    assert torch.equal(c_hat, model.party_forward(w_p, x_m, 1))


@pytest.mark.parametrize("direction,fused", [("gaussian", False),
                                             ("uniform", False),
                                             ("rademacher", True)])
def test_party_forward_pair_matches_reference_party_eval(direction, fused):
    """The port's perturb + pair against the reference's
    ``_party_fused_jit`` on the same params, features and key."""
    X, ref_model, w_ref, ref_vfl, model, vfl = _fcn_setup(direction, fused)
    x_ref = ref_model.slice_features(jnp.asarray(X), 1)
    rc, rc_hat, _, _, _ = _party_fused_jit(ref_model, ref_vfl, w_ref, x_ref,
                                           jax.random.key(11), 1)
    w_m = params_from_numpy(jax.tree.map(np.asarray, w_ref), "cpu")
    x_m = model.slice_features(torch.from_numpy(X), 1)
    w_p, u = ZOExchange.from_config(vfl).perturb(w_m, prng.key(11))
    c, c_hat = model.party_forward_pair(w_m, w_p, u, x_m, 1, vfl.mu)
    # f32 matmuls in another order than XLA's (and, for the uniform
    # sphere, the norm's sum): ulps of the O(1) tower outputs
    np.testing.assert_allclose(c.numpy(), np.asarray(rc), rtol=0, atol=1e-5)
    np.testing.assert_allclose(c_hat.numpy(), np.asarray(rc_hat), rtol=0,
                               atol=1e-5)


def test_uniform_direction_matches_reference():
    from repro.utils.prng import sample_direction as ref_sample
    for shape in [(98, 128), (128,), (1,)]:
        want = np.asarray(ref_sample(jax.random.key(5), shape, "uniform"))
        got = prng.sample_direction(prng.key(5), shape, "uniform", "cpu")
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
        assert np.isclose(float((got ** 2).sum()), np.prod(shape),
                          rtol=1e-5)


def test_lr_model_keeps_the_default_pair():
    model = PaperLRModel(PaperLRConfig(num_features=16, num_parties=2))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((8, 8)).astype(np.float32))
    w = {"w": torch.from_numpy(rng.standard_normal(8).astype(np.float32))}
    u = {"w": torch.ones(8)}
    w_p = {"w": w["w"] + 1e-3 * u["w"]}
    c, c_hat = model.party_forward_pair(w, w_p, u, x, 0, 1e-3)
    assert torch.equal(c, model.party_forward(w, x, 0))
    assert torch.equal(c_hat, model.party_forward(w_p, x, 0))
