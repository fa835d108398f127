"""The port's flash_attention against the reference.

On the CPU the wrapper runs its plain torch version, held here against
the reference's ``ref.flash_attention_ref`` (any S) and its Pallas
``ops.flash_attention`` in interpret mode (S a multiple of the block) on
identical numpy inputs, with the reference tests' tolerances; the CUDA
kernel is held against the plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py). The bf16 kernel's way with
p (split into two bf16 halves for the p.v product) is emulated here and
held to the reference's oracle within the card's element bound."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_kernels
from repro.models.attention import blocked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# the reference tests' tolerances: f32 sums in another order (2e-5, as in
# tests/test_kernels.py::test_flash_matches_model_blocked_attention), and
# bf16 outputs rounded to 8 bits of mantissa (2e-2)
TOL = {"f32": 2e-5, "bf16": 2e-2}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(B, S, H, KV, hd, dt, seed):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((B, S, n, hd)).astype(np.float32)
            for n in (H, KV, KV)]
    jx = [jnp.asarray(a).astype(DTYPES[dt][0]) for a in arrs]
    tx = [torch.from_numpy(a).to(DTYPES[dt][1]) for a in arrs]
    return jx, tx


def _ref_bh(q, k, v, causal):
    """ref.flash_attention_ref over (B*H, S, hd), GQA by repeat, back to
    (B, S, H, hd)."""
    B, S, H, hd = q.shape
    G = H // k.shape[2]

    def bh(t):
        return t.transpose(0, 2, 1, 3).reshape(B * H, S, hd)
    o = ref_kernels.flash_attention_ref(
        bh(q), bh(jnp.repeat(k, G, 2)), bh(jnp.repeat(v, G, 2)),
        causal=causal)
    return o.reshape(B, H, S, hd).transpose(0, 2, 1, 3)


def _close(got, want, dt):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dt], rtol=TOL[dt])


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2), (8, 2)])
@pytest.mark.parametrize("S", [64, 100])
def test_plain_matches_the_reference_oracle(S, H, KV, causal, dt):
    """MHA and GQA with G = 2 and 4, causal and full, f32 and bf16, and a
    ragged S (the Pallas kernel asserts S % 128 == 0; the oracle and the
    port take any S)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, S, H, KV, 64, dt, S + H + KV)
    n0 = fa.flash_attention.launches
    got = ops.flash_attention(tq, tk, tv, causal=causal)
    assert fa.flash_attention.launches == n0     # the CPU runs no kernel
    assert got.dtype == tq.dtype and got.shape == tq.shape
    _close(got, _ref_bh(jq, jk, jv, causal), dt)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("H,KV,hd", [(4, 2, 64), (4, 1, 128)])
def test_plain_matches_the_pallas_kernel_interpreted(H, KV, hd, causal, dt):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 128, H, KV, hd, dt, hd + KV)
    want = ref_ops.flash_attention(jq, jk, jv, causal=causal, bq=64, bkv=64)
    _close(ops.flash_attention(tq, tk, tv, causal=causal), want, dt)


def test_plain_matches_the_models_blocked_attention():
    """The reference model's own attention (what attn_apply replaces)."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(2, 96, 4, 2, 64, "f32", 3)
    want = blocked_attention(jq, jk, jv, causal=True, kv_block=32)
    _close(ops.flash_attention(tq, tk, tv, causal=True), want, "f32")


def _views_of_one_projection():
    rng = np.random.default_rng(4)
    qkv = torch.from_numpy(rng.standard_normal((2, 40, 8 * 64))
                           .astype(np.float32))
    return (qkv[..., :4 * 64].unflatten(-1, (4, 64)),
            qkv[..., 4 * 64:6 * 64].unflatten(-1, (2, 64)),
            qkv[..., 6 * 64:].unflatten(-1, (2, 64)))


def test_plain_takes_strided_views():
    """q, k, v as slices of one fused projection."""
    q, k, v = _views_of_one_projection()
    assert torch.equal(fa.flash_attention_plain(q, k, v),
                       fa.flash_attention_plain(q.contiguous(),
                                                k.contiguous(),
                                                v.contiguous()))


def test_wrapper_refuses_views_on_every_device():
    """The kernel reads contiguous q, k, v; the wrapper refuses a view on
    the CPU too, so both devices take the same inputs."""
    q, k, v = _views_of_one_projection()
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_attention(q.contiguous(), k.contiguous(), v)


def test_wrapper_rejects_mismatched_heads():
    q = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 3, 64),
                            torch.zeros(1, 8, 3, 64))
    with pytest.raises(ValueError):
        ops.flash_attention(q, torch.zeros(1, 8, 2, 64),
                            torch.zeros(1, 8, 2, 32))


# The bf16 CUDA kernel's numerics, emulated in plain torch: q.k in f32 (the
# tensor cores' bf16 x bf16 products are exact in f32), the online softmax
# over kv tiles of the kernel's height in base 2 with f32 m, l and p, l
# summed from the f32 p, p split into bf16 p_hi + p_lo for the p.v
# products (each exact in f32, summed in f32), and one rounding of acc / l
# to bf16. Held element by element to the reference's f32 oracle on the
# same bf16 inputs, with the element bound the card checks: |got - want32|
# <= 2^-8 |want32| + 1e-5 max |want32|.
def _kernel_emulation(q, k, v, causal, split):
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    bkv = 128 if hd == 64 else 64
    c = torch.tensor(np.float32(np.float32(1 / np.sqrt(hd))
                                * np.float32(np.log2(np.e))))
    qf = q.float().transpose(1, 2)                          # (B, H, S, hd)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    m = torch.full((B, H, S, 1), fa.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    acc = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bkv):
        s = qf @ kf[:, :, k0:k0 + bkv].transpose(-1, -2)
        if causal:
            cols = torch.arange(k0, min(k0 + bkv, S))[None, :]
            s = torch.where(cols > rows, torch.tensor(fa.NEG_INF), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        p = torch.exp2(s * c - m_new)
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        vt = vf[:, :, k0:k0 + bkv]
        p_hi = p.bfloat16().float()
        pv = p_hi @ vt
        if split:
            pv = pv + (p - p_hi).bfloat16().float() @ vt
        acc = acc * corr + pv
        m = m_new
    return (acc / l.clamp_min(1e-30)).transpose(1, 2).bfloat16()


def _element_ratio(got, want32):
    allowed = 2.0 ** -8 * want32.abs() + 1e-5 * want32.abs().max()
    return float(((got.float() - want32).abs() / allowed).max())


@pytest.mark.parametrize("S,H,KV,hd,causal", [(1024, 2, 2, 64, True),
                                              (512, 2, 1, 128, False),
                                              (1000, 4, 2, 64, True)])
def test_split_p_keeps_the_bf16_element_bound(S, H, KV, hd, causal):
    """p = bf16(p) + bf16(p - bf16(p)) keeps every output within half a
    bf16 ulp of the f32 result; p rounded once to bf16 (the control) does
    not, so the check sees the error the split removes."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, S, H, KV, hd, "bf16", S + hd)
    f32 = [jnp.asarray(a, jnp.float32) for a in (jq, jk, jv)]
    want32 = torch.from_numpy(np.array(_ref_bh(*f32, causal)))
    assert _element_ratio(_kernel_emulation(tq, tk, tv, causal, True),
                          want32) <= 1.0
    assert _element_ratio(_kernel_emulation(tq, tk, tv, causal, False),
                          want32) > 1.0
