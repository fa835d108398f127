"""The f32 attention backward kernel's arithmetic on the CPU.

``flash_attention_bwd_f32`` (csrc/flash_attention_bwd.cu) runs every
product as 3xTF32 on Hopper's tensor cores. It cannot run here, so its
arithmetic is emulated in plain torch. The emulation is held to
``flash_attention_bwd_plain`` and to ``jax.vjp`` of the reference's
``blocked_attention`` on the same numpy inputs, within the card check's
1e-4 of each gradient's largest magnitude. One tf32 product per product,
the control, misses that. A layout test shows where the accumulators of
ds, p^T and ds^T meet the transposed operands' permuted rows.

The kernel's arithmetic, as emulated:
- each f32 operand is split into hi = tf32(a) and lo = tf32(a - hi),
  rounded as cvt.rna rounds; each product is hi.hi + hi.lo + lo.hi per k8
  step, each term added exactly into the accumulator and the sum
  truncated to f32 (tests/test_torch_flash.py's model of the tensor
  cores);
- s = q.k and dp = dO.v over hd run each 32-deep chunk into fresh
  accumulators, added in f32;
- D = dO . o in f32; p = 2^(s c + off) with c = scale log2(e) and off =
  -lse log2(e) rounded once (the kernel's fma), -inf for a row that saw no
  key; masked keys p = 0; ds = p (dp - D); p^T gains 1/S on a row that saw
  no key;
- dq: each kv tile of the dq pass (64 rows at hd 64, 32 at hd 128) runs ds
  . k into fresh accumulators, added into the f32 total in order, times
  scale at the end;
- dk and dv: per kv head, the q tiles (32 rows at hd 64, 16 at hd 128) of
  each query head in turn; each tile's p^T . dO and ds^T . q run into
  fresh accumulators added into the f32 totals in order, dk times scale.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.attention import blocked_attention
from repro_torch.kernels import flash_attention as fa
from test_torch_flash import (_b_offset, _p_fragments, _split,
                              _tensor_core_product, _truncate_to_f32,
                              _vt_offset)

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

# chip_smoke.FLASH_BWD_TOL["f32"] and tests/test_torch_gpu.py's BWD_TOL
BWD_TOL_F32 = 1e-4


def _tiles(hd):
    """(the dq pass's kv rows a tile, the dk/dv pass's q rows a tile), as
    the kernel's DqF32 and KvF32 set them."""
    return (64, 32) if hd == 64 else (32, 16)


def _f32_bwd_emulation(q, k, v, o, do, lse, causal, positions=None,
                       kv_positions=None, products=3):
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    bkv, bq = _tiles(hd)
    scale = np.float32(1.0 / np.sqrt(hd))
    log2e = np.float32(np.log2(np.e))
    c = float(np.float32(scale * log2e))
    qf = q.transpose(1, 2)                                  # (B, H, S, hd)
    kf = k.repeat_interleave(G, 2).transpose(1, 2)
    vf = v.repeat_interleave(G, 2).transpose(1, 2)
    dof = do.transpose(1, 2)

    def over_hd(a, b):
        out = None
        for d0 in range(0, hd, 32):
            part = _tensor_core_product(
                a[..., d0:d0 + 32], b[..., d0:d0 + 32].transpose(-1, -2),
                products)
            out = part if out is None else out + part
        return out

    s, dp = over_hd(qf, kf), over_hd(dof, vf)
    D = (dof * o.transpose(1, 2)).sum(-1, keepdim=True)
    blind = (lse < fa.MASKED_LSE)[..., None]
    off = torch.where(blind, torch.tensor(-np.inf),
                      lse[..., None] * torch.tensor(-log2e))
    p = torch.exp2((s.double() * c + off.double()).float())
    if causal:
        if positions is None:
            keep = torch.ones(S, S, dtype=torch.bool).tril()
        else:
            kp = positions if kv_positions is None else kv_positions
            keep = (kp[:, None, :] <= positions[:, :, None])[:, None]
        p = torch.where(keep, p, torch.zeros(()))
    ds = p * (dp - D)
    p_dv = p + torch.where(blind, torch.tensor(np.float32(1.0) / S),
                           torch.zeros(()))

    dq = torch.zeros(B, H, S, hd)
    for k0 in range(0, S, bkv):
        dq = dq + _tensor_core_product(ds[..., k0:k0 + bkv],
                                       kf[:, :, k0:k0 + bkv], products)
    dq = dq * torch.tensor(scale)

    def per_kv_head(t):
        return t.reshape(B, KV, G, *t.shape[2:])
    pT = per_kv_head(p_dv.transpose(-1, -2))
    dsT = per_kv_head(ds.transpose(-1, -2))
    qg, dog = per_kv_head(qf), per_kv_head(dof)
    dk = torch.zeros(B, KV, S, hd)
    dv = torch.zeros(B, KV, S, hd)
    for g in range(G):
        for u in range(math.ceil(S / bq)):
            r = slice(u * bq, (u + 1) * bq)
            dv = dv + _tensor_core_product(pT[:, :, g, :, r], dog[:, :, g, r],
                                           products)
            dk = dk + _tensor_core_product(dsT[:, :, g, :, r], qg[:, :, g, r],
                                           products)
    dk = dk * torch.tensor(scale)
    return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


def _positions(B, S, seed):
    """q positions with repeats and out of order, and kv positions of their
    own from 5 up, so that the rows placed at 2 see no key."""
    rng = np.random.default_rng(seed)
    qp = rng.integers(0, S, (B, S)).astype(np.int32)
    kp = rng.integers(5, S, (B, S)).astype(np.int32)
    qp[0, :3] = 2
    return qp, kp


def _case(B, S, H, KV, hd, causal, positions, products=3):
    """(the emulated gradients, the plain backward's, jax.vjp's of
    blocked_attention) from one set of numpy inputs."""
    arrs = _inputs(B, S, H, KV, hd, S + hd + H)
    q, k, v, do = map(torch.from_numpy, arrs)
    qp = kp = None
    if positions:
        qp, kp = _positions(B, S, S)
    tqp, tkp = (None, None) if qp is None else \
        (torch.from_numpy(qp), torch.from_numpy(kp))
    o, lse = fa.flash_attention_plain(q, k, v, causal, tqp, True, tkp)
    if positions:
        assert bool((lse < fa.MASKED_LSE).any())
    got = _f32_bwd_emulation(q, k, v, o, do, lse, causal, tqp, tkp,
                             products)
    plain = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal, tqp,
                                         tkp)
    extra = {} if qp is None else {"q_positions": jnp.asarray(qp),
                                   "kv_positions": jnp.asarray(kp)}
    _, vjp = jax.vjp(lambda a, b, cc: blocked_attention(
        a, b, cc, causal=causal, kv_block=8, **extra),
        *map(jnp.asarray, arrs[:3]))
    ref = [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(do))]
    return got, plain, ref


def _worst(got, want) -> float:
    return max(float((g - w).abs().max() / w.abs().max())
               for g, w in zip(got, want))


# (B, S, H, KV, hd, causal, positions): causal GQA and full at hd 64 and
# 128, ragged S, explicit q and kv positions with rows that see no key, and
# a 512-deep causal GQA case at each hd (4 query heads a kv head: the dk/dv
# totals run over 2048 q rows)
CASES = [(1, 256, 4, 2, 64, True, False),
         (1, 200, 4, 4, 64, False, False),
         (1, 200, 4, 2, 128, True, False),
         (1, 160, 8, 2, 128, False, False),
         (2, 200, 4, 2, 64, True, True),
         (2, 136, 4, 2, 128, True, True),
         (1, 512, 4, 1, 64, True, False),
         (1, 512, 4, 1, 128, True, False)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,positions", CASES)
def test_three_tf32_products_hold_the_backward_tolerance(
        B, S, H, KV, hd, causal, positions):
    """The emulated gradients within 1e-4 of each gradient's largest
    magnitude of the plain backward and of the reference's autodiff.
    Measured here: at most 3.0e-6 against the plain backward and 3.1e-6
    against the reference (full GQA at hd 128), a margin of 32x; the plain
    backward and the reference agree to 1.6e-6."""
    got, plain, ref = _case(B, S, H, KV, hd, causal, positions)
    assert _worst(got, plain) <= BWD_TOL_F32
    assert _worst(got, ref) <= BWD_TOL_F32
    assert _worst(plain, ref) <= BWD_TOL_F32


@pytest.mark.parametrize("B,S,H,KV,hd,causal,positions",
                         [CASES[0], CASES[3], CASES[4]])
def test_one_tf32_product_misses_the_backward_tolerance(
        B, S, H, KV, hd, causal, positions):
    """hi.hi alone for every product (plain TF32): the gradients miss 1e-4
    of their largest (measured 5.9e-4 to 1.0e-3)."""
    got, plain, _ = _case(B, S, H, KV, hd, causal, positions, products=1)
    assert _worst(got, plain) > BWD_TOL_F32


def _into(acc, a, b):
    """acc + a @ b in 3xTF32 as _tensor_core_product forms it, with the
    running sum kept in one truncating accumulator."""
    ah, al = _split(a)
    bh, bl = _split(b)
    acc = acc.double()
    for k0 in range(0, a.shape[-1], 8):
        for x, y in ((ah, bh), (ah, bl), (al, bh)):
            acc = _truncate_to_f32(acc + x[..., k0:k0 + 8].double()
                                   @ y[..., k0:k0 + 8, :].double()).double()
    return acc.float()


def test_one_accumulator_over_the_q_tiles_spends_the_margin():
    """Why each q tile's p^T . dO and ds^T . q run into fresh accumulators:
    summed into one truncating accumulator over all of a kv head's q tiles
    (4096 q rows: 8 query heads of S 512, hd 128, causal), dk and dv land
    more than a quarter of the 1e-4 tolerance from the plain backward
    (measured 3.9e-5 and 5.3e-5), where the kernel's scheme stays near
    2e-6 (the cases above). s and dp are exact here: only the second
    stage's sums are under test."""
    B, S, H, KV, hd = 1, 512, 8, 1, 128
    q, k, v, do = map(torch.from_numpy, _inputs(B, S, H, KV, hd, 3))
    o, lse = fa.flash_attention_plain(q, k, v, True, None, True)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, True)
    scale = np.float32(1.0 / np.sqrt(hd))
    c = float(np.float32(scale * np.float32(np.log2(np.e))))
    qf, dof = q.transpose(1, 2), do.transpose(1, 2)
    kf = k.repeat_interleave(H, 2).transpose(1, 2)
    vf = v.repeat_interleave(H, 2).transpose(1, 2)
    off = lse[..., None] * torch.tensor(-np.float32(np.log2(np.e)))
    p = torch.exp2(((qf @ kf.transpose(-1, -2)).double() * c
                    + off.double()).float())
    p = torch.where(torch.ones(S, S, dtype=torch.bool).tril(), p,
                    torch.zeros(()))
    D = (dof * o.transpose(1, 2)).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - D)
    bq = _tiles(hd)[1]
    dk = dv = torch.zeros(B, S, hd)
    for g in range(H):
        for u in range(S // bq):
            r = slice(u * bq, (u + 1) * bq)
            dv = _into(dv, p[:, g, r].transpose(-1, -2), dof[:, g, r])
            dk = _into(dk, ds[:, g, r].transpose(-1, -2), qf[:, g, r])
    dk = dk * torch.tensor(scale)
    assert _worst([dk[:, :, None]], want[1:2]) > BWD_TOL_F32 / 4
    assert _worst([dv[:, :, None]], want[2:3]) > BWD_TOL_F32 / 4


# Where each accumulator meets its transposed operand in the f32 backward
# (csrc/flash_attention_bwd.cu, `split_frags` and `Cols::store`): ds (q rows
# x kv) with k^T in the dq pass, p^T and ds^T (kv rows x q) with dO^T and
# q^T in the dk/dv pass. The accumulator's columns are the next product's
# k; a thread holds columns 2t and 2t + 1 of each k8 step where the tf32 A
# fragment wants t and t + 4, so Cols::store lays each transposed operand's
# rows out in that order: fragment column c holds row 2c (c < 4) or 2(c -
# 4) + 1 of its k8 step, at tests/test_torch_flash.py's _vt_offset, one
# 128-byte row (32 of k) per n; a 16-row operand fills half of each row.
@pytest.mark.parametrize("hd,rows,what", [(64, 64, "ds . k"),
                                          (128, 32, "ds . k"),
                                          (64, 32, "p^T . dO"),
                                          (128, 16, "ds^T . q")])
def test_accumulators_meet_the_permuted_transposed_rows(hd, rows, what):
    """The A fragments taken from a 64 x ``rows`` accumulator with no
    shuffle, against the transposed operand as Cols::store lays it out and
    wgmma reads it, give the plain product bitwise on integer-valued
    inputs; the operand in its own row order (the control) does not."""
    rng = np.random.default_rng(hd + rows)
    acc = torch.from_numpy(rng.integers(-8, 9, (64, rows)).astype(np.float32))
    b = torch.from_numpy(rng.integers(-8, 9, (rows, hd)).astype(np.float32))
    perm = [2 * c if c < 4 else 2 * (c - 4) + 1 for c in range(8)]
    A = _p_fragments(acc, perm)
    smem = {}
    for n in range(hd):
        for r in range(rows):
            smem[_vt_offset(n, r, hd)] = b[r, n]
    assert len(smem) == hd * rows
    assert max(smem) < max(rows, 32) * hd * 4       # Cols::BYTES
    Bop = torch.tensor([[[float(smem[_b_offset(kk, c, n, hd)])
                          for n in range(hd)] for c in range(8)]
                        for kk in range(rows // 8)])
    got = sum(A[kk] @ Bop[kk] for kk in range(rows // 8))
    assert torch.equal(got, acc @ b)
    Bnat = torch.stack([b[8 * kk:8 * kk + 8] for kk in range(rows // 8)])
    assert not torch.equal(sum(A[kk] @ Bnat[kk] for kk in range(rows // 8)),
                           acc @ b)
