"""The port's flash_attention against the reference.

On the CPU the wrapper runs its plain torch version, held here against
the reference's ``ref.flash_attention_ref`` (any S) and its Pallas
``ops.flash_attention`` in interpret mode (S a multiple of the block) on
identical numpy inputs, with the reference tests' tolerances; the CUDA
kernel is held against the plain version on the card
(tests/test_torch_gpu.py and chip_smoke.py). The bf16 kernel's way with
p (split into two bf16 halves for the p.v product) is emulated here and
held to the reference's oracle within the card's element bound, and so
is the f32 kernel's 3xTF32 arithmetic with the tensor cores' truncating
sums, within the card's f32 tolerance; the f32 kernel's hand-off of p
from the q.k accumulators to the p.v fragments is checked against the
PTX fragment layouts."""
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


# The f32 CUDA kernel's numerics (3xTF32 on the tensor cores), emulated in
# plain torch: q, k, p and v each split into hi = tf32(a) and lo = tf32(a -
# hi), rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero,
# 10 mantissa bits); each product hi.hi + hi.lo + lo.hi per k8 step, every
# product added exactly into the accumulator and the sum truncated to f32
# (the tensor cores' way, as tests/test_torch_dual_matmul.py models it);
# q.k into fresh accumulators per 32-deep chunk of hd, added in f32; the
# online softmax over the kernel's kv tiles in base 2 with f32 m, l and p;
# each tile's p.v into fresh
# accumulators folded into the f32 totals as o = fma(o, corr, o_t). Held to
# the reference's oracle with the card check's tolerance; one tf32 product
# each for q.k and p.v is the control that must miss it.
FLASH_TOL_F32 = 1e-5       # chip_smoke.py and tests/test_torch_gpu.py


def _tf32(a: torch.Tensor) -> torch.Tensor:
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split(a: torch.Tensor):
    hi = _tf32(a)
    return hi, _tf32(a - hi)


def _truncate_to_f32(s: torch.Tensor) -> torch.Tensor:
    f = s.float()
    over = f.double().abs() > s.abs()
    f[over] = torch.nextafter(f[over], torch.zeros_like(f[over]))
    return f


def _tensor_core_product(a, b, products):
    """a @ b over the last two dims as the kernel forms it: per k8 step the
    first ``products`` of hi.hi, hi.lo, lo.hi, each added exactly into the
    accumulator and the sum truncated to f32."""
    ah, al = _split(a)
    bh, bl = _split(b)
    terms = [(ah, bh), (ah, bl), (al, bh)][:products]
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in terms:
            acc = _truncate_to_f32(acc + x[..., k0:k0 + 8].double()
                                   @ y[..., k0:k0 + 8, :].double()).double()
    return acc.float()


def _f32_kernel_emulation(q, k, v, causal, products=3, qk_chunk=32):
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    bkv = 64 if hd == 64 else 32
    c = torch.tensor(np.float32(np.float32(1 / np.sqrt(hd))
                                * np.float32(np.log2(np.e))))
    qf = q.transpose(1, 2)                                  # (B, H, S, hd)
    kf = k.repeat_interleave(G, 2).transpose(1, 2)
    vf = v.repeat_interleave(G, 2).transpose(1, 2)
    m = torch.full((B, H, S, 1), fa.NEG_INF)
    l = torch.zeros((B, H, S, 1))
    o = torch.zeros((B, H, S, hd))
    rows = torch.arange(S)[:, None]
    for k0 in range(0, S, bkv):
        kt, vt = kf[:, :, k0:k0 + bkv], vf[:, :, k0:k0 + bkv]
        s = sum(_tensor_core_product(
            qf[..., d0:d0 + qk_chunk],
            kt[..., d0:d0 + qk_chunk].transpose(-1, -2), products)
            for d0 in range(0, hd, qk_chunk))
        if causal:
            cols = torch.arange(k0, k0 + kt.shape[2])[None, :]
            s = torch.where(cols > rows, torch.tensor(fa.NEG_INF), s)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True) * c)
        # p = 2^fma(s, c, -m): one rounding of s * c - m
        p = torch.exp2((s.double() * c.double() - m_new.double()).float())
        corr = torch.exp2(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        o_t = _tensor_core_product(p, vt, products)
        o = (o.double() * corr.double() + o_t.double()).float()
        m = m_new
    return (o / l.clamp_min(1e-30)).transpose(1, 2)


def _rel_to_the_oracle(got, jq, jk, jv, causal):
    want = np.asarray(_ref_bh(jq, jk, jv, causal))
    return float(np.abs(got.numpy() - want).max() / np.abs(want).max())


F32_EMULATION_CASES = [(1024, 2, 2, 64, True), (512, 2, 1, 128, False),
                       (1000, 4, 2, 64, True), (300, 2, 2, 128, True)]


@pytest.mark.parametrize("S,H,KV,hd,causal", F32_EMULATION_CASES)
def test_three_tf32_products_hold_the_f32_tolerance(S, H, KV, hd, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, S, H, KV, hd, "f32", S + hd)
    got = _f32_kernel_emulation(tq, tk, tv, causal)
    assert _rel_to_the_oracle(got, jq, jk, jv, causal) <= FLASH_TOL_F32


@pytest.mark.parametrize("S,H,KV,hd,causal", F32_EMULATION_CASES)
def test_one_tf32_product_misses_the_f32_tolerance(S, H, KV, hd, causal):
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, S, H, KV, hd, "f32", S + hd)
    got = _f32_kernel_emulation(tq, tk, tv, causal, products=1)
    assert _rel_to_the_oracle(got, jq, jk, jv, causal) > FLASH_TOL_F32


def test_qk_chunks_halve_the_truncation_of_one_accumulator_over_hd():
    """Full attention at hd 128, where max |out| is small: one truncating
    accumulator over hd spends about half the f32 tolerance in this model,
    the kernel's 32-deep chunks about half as much."""
    (jq, jk, jv), (tq, tk, tv) = _inputs(1, 512, 2, 1, 128, "f32", 640)
    chunks = _rel_to_the_oracle(_f32_kernel_emulation(tq, tk, tv, False),
                                jq, jk, jv, False)
    one = _rel_to_the_oracle(_f32_kernel_emulation(tq, tk, tv, False,
                                                   qk_chunk=128),
                             jq, jk, jv, False)
    assert chunks < one / 1.5 and one > FLASH_TOL_F32 / 3


# Where the f32 kernel's p fragments and v^T meet (csrc/flash_attention.cu,
# F32Consumer::split_p and VT::store), after the PTX ISA's figures for
# wgmma: thread (warp w, lane ln) of a warpgroup, t = ln % 4, r0 = 16w + ln
# // 4; the m64nN f32 accumulator holds d[4j + 2i + e] = (row r0 + 8i,
# column 8j + 2t + e); the m64k8 tf32 A fragment wants a[x] = (row r0 + 8
# (x % 2), column t + 4 (x // 2)); a K-major B operand under the 128-byte
# swizzle holds (k, n) of the tile at n * 128 + ((k / 4) ^ (n % 8)) * 16 +
# (k % 4) * 4 within its 32-deep chunk, and k8 step kk starts (kk % 4) * 32
# bytes in.
def _vt_offset(n, kv, hd):
    """VT::store's byte offset of v^T's (n, kv) within its tile."""
    j, e = kv // 8, kv % 8
    return ((j // 4) * hd * 128 + n * 128
            + (((2 * (j % 4) + e % 2) ^ (n % 8)) << 4) + (e // 2) * 4)


def _b_offset(kk, c, n, hd):
    """The byte wgmma reads for (k = c, n) of k8 step kk of the K-major
    v^T operand."""
    k = (kk % 4) * 8 + c
    return (kk // 4) * hd * 128 + n * 128 + (((k // 4) ^ (n % 8)) << 4) \
        + (k % 4) * 4


def _p_fragments(p, kv_of_column):
    """The A operand of each k8 step that split_p hands wgmma, from the
    accumulator registers d of each thread, (steps, 64, 8)."""
    steps = p.shape[1] // 8
    A = torch.full((steps, 64, 8), float("nan"))
    for w in range(4):
        for ln in range(32):
            t, r0 = ln % 4, 16 * w + ln // 4
            d = {4 * j + 2 * i + e: p[r0 + 8 * i, 8 * j + 2 * t + e]
                 for j in range(steps) for i in range(2) for e in range(2)}
            for j in range(steps):
                a = (d[4 * j], d[4 * j + 2], d[4 * j + 1], d[4 * j + 3])
                for x in range(4):
                    A[j, r0 + 8 * (x % 2), t + 4 * (x // 2)] = a[x]
    # every fragment column x of every row is the kv column kv_of_column[x]
    for j in range(steps):
        for x in range(8):
            assert torch.equal(A[j, :, x], p[:, 8 * j + kv_of_column[x]])
    return A


@pytest.mark.parametrize("hd,bkv", [(64, 64), (128, 32)])
def test_p_fragments_meet_the_permuted_vt_rows(hd, bkv):
    """p goes from the q.k accumulators into the p.v A fragments with no
    shuffle, fragment column c holding kv 2c (c < 4) or 2(c - 4) + 1; v^T's
    rows stored in that order make the product the plain p @ v, bitwise in
    f32 on integer-valued inputs. In kv's own order (the control) it is
    not."""
    rng = np.random.default_rng(hd)
    p = torch.from_numpy(rng.integers(-8, 9, (64, bkv)).astype(np.float32))
    v = torch.from_numpy(rng.integers(-8, 9, (bkv, hd)).astype(np.float32))
    perm = [2 * c if c < 4 else 2 * (c - 4) + 1 for c in range(8)]
    A = _p_fragments(p, perm)
    # v^T as VT::store lays it out, read back as wgmma reads B
    smem = {}
    for n in range(hd):
        for kv in range(bkv):
            smem[_vt_offset(n, kv, hd)] = v[kv, n]
    assert len(smem) == hd * bkv                 # no two elements collide
    Bop = torch.tensor([[[float(smem[_b_offset(kk, c, n, hd)])
                          for n in range(hd)] for c in range(8)]
                        for kk in range(bkv // 8)])
    for kk in range(bkv // 8):
        assert torch.equal(Bop[kk], v[8 * kk + torch.tensor(perm)])
    got = sum(A[kk] @ Bop[kk] for kk in range(bkv // 8))
    assert torch.equal(got, p @ v)
    Bnat = torch.stack([v[8 * kk:8 * kk + 8] for kk in range(bkv // 8)])
    assert not torch.equal(sum(A[kk] @ Bnat[kk] for kk in range(bkv // 8)),
                           p @ v)
