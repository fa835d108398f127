"""The gradient of the port's flash_attention on the CPU: ``FlashAttentionFn``
(the plain forward with its row logsumexp, then
``flash_attention_bwd_plain``) against ``jax.vjp`` of the reference's
``blocked_attention`` (what the reference's LM training differentiates)
and of ``ref.flash_attention_ref``, and against ``torch.autograd`` of
``flash_attention_plain``: causal, full, GQA, ragged S, explicit positions
and rows that see no key. The CUDA backward kernel is held against
``flash_attention_bwd_plain`` on the card (tests/test_torch_gpu.py,
chip_smoke.py).

Tolerance: each gradient within 2e-5 of its largest magnitude (the
reference tests' f32 attention tolerance, tests/test_torch_flash.py: f32
sums in another order than XLA's); bf16 within 2e-2."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as ref_kernels
from repro.models.attention import blocked_attention
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

TOL = {"f32": 2e-5, "bf16": 2e-2}


def _inputs(B, S, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd),
                      (B, S, H, hd))]


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _port_vjp(q, k, v, do, causal, positions=None, kv_positions=None,
              dtype=torch.float32):
    tq, tk, tv = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal, positions, kv_positions)
    out.backward(torch.from_numpy(do).to(dtype))
    return out, tq.grad, tk.grad, tv.grad


# (B, S, H, KV, hd, causal): MHA causal and full, GQA 4/2 and 8/2 at hd 64
# and 128, ragged S (37, 40 over the reference's kv blocks)
CASES = [(2, 32, 4, 4, 64, True), (2, 32, 4, 4, 64, False),
         (2, 40, 4, 2, 64, True), (1, 37, 8, 2, 128, True),
         (1, 37, 8, 2, 128, False)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal", CASES)
def test_gradient_equals_the_vjp_of_blocked_attention(B, S, H, KV, hd,
                                                      causal):
    q, k, v, do = _inputs(B, S, H, KV, hd, 0)
    want, vjp = jax.vjp(lambda a, b, c: blocked_attention(
        a, b, c, causal=causal, kv_block=8), *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    out, *got = _port_vjp(q, k, v, do, causal)
    assert out.grad_fn is not None
    _close(out, want, TOL["f32"])
    for g, w in zip(got, grads):
        _close(g, w, TOL["f32"])


@pytest.mark.parametrize("see_nothing", [False, True])
def test_explicit_positions_against_blocked_attention(see_nothing):
    """Positions with repeats and out of order, as the model passes them
    (one tensor for q and kv); with kv positions of their own, some rows
    see no key: every score stays at the -1e30 sentinel, the row takes
    the mean of v and passes no gradient to q or k, as the reference's
    autodiff does."""
    B, S, H, KV, hd = 2, 40, 4, 2, 64
    q, k, v, do = _inputs(B, S, H, KV, hd, 1)
    rng = np.random.default_rng(2)
    qp = rng.integers(0, 30, (B, S)).astype(np.int32)
    kp = qp
    if see_nothing:
        kp = rng.integers(5, 30, (B, S)).astype(np.int32)
        qp[0, 5], qp[1, :3] = 2, 0
    want, vjp = jax.vjp(lambda a, b, c: blocked_attention(
        a, b, c, causal=True, kv_block=8, q_positions=jnp.asarray(qp),
        kv_positions=jnp.asarray(kp)), *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    out, *got = _port_vjp(q, k, v, do, True, torch.from_numpy(qp),
                          None if not see_nothing else torch.from_numpy(kp))
    _close(out, want, TOL["f32"])
    for g, w in zip(got, grads):
        _close(g, w, TOL["f32"])
    if see_nothing:
        np.testing.assert_allclose(out.detach().numpy()[0, 5],
                                   np.repeat(v[0].mean(0), H // KV, 0),
                                   atol=1e-6)
        assert float(got[0][0, 5].abs().max()) == 0.0
        _, lse = fa.flash_attention_plain(
            *(torch.from_numpy(a) for a in (q, k, v)), True,
            torch.from_numpy(qp), True, torch.from_numpy(kp))
        blind = qp < kp.min(axis=1, keepdims=True)       # (B, S)
        assert blind[0, 5] and blind[1, :3].all()
        np.testing.assert_array_equal(
            (lse < fa.MASKED_LSE).numpy(),
            np.broadcast_to(blind[:, None, :], (B, H, S)))


@pytest.mark.parametrize("causal", [True, False])
def test_gradient_equals_the_vjp_of_the_oracle(causal):
    """ref.flash_attention_ref over (B*H, S, hd), the Pallas kernel's
    oracle, with GQA by repeat."""
    B, S, H, KV, hd = 2, 24, 4, 2, 64
    q, k, v, do = _inputs(B, S, H, KV, hd, 3)
    G = H // KV

    def bh(t):
        return t.transpose(0, 2, 1, 3).reshape(-1, S, hd)

    def f(a, b, c):
        o = ref_kernels.flash_attention_ref(
            bh(a), bh(jnp.repeat(b, G, 2)), bh(jnp.repeat(c, G, 2)),
            causal=causal)
        return o.reshape(B, H, S, hd).transpose(0, 2, 1, 3)
    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    out, *got = _port_vjp(q, k, v, do, causal)
    _close(out, want, TOL["f32"])
    for g, w in zip(got, grads):
        _close(g, w, TOL["f32"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_gradient_equals_autograd_of_the_plain_version(causal, dtype):
    """torch.autograd through flash_attention_plain's softmax: the same
    function, differentiated by torch."""
    dt = {"f32": torch.float32, "bf16": torch.bfloat16}[dtype]
    q, k, v, do = _inputs(2, 33, 8, 2, 64, 4)
    out, *got = _port_vjp(q, k, v, do, causal, dtype=dt)
    tq, tk, tv = (torch.from_numpy(a).to(dt).requires_grad_(True)
                  for a in (q, k, v))
    want = fa.flash_attention_plain(tq, tk, tv, causal)
    want.backward(torch.from_numpy(do).to(dt))
    assert torch.equal(out, want)
    for g, w in zip(got, (tq.grad, tk.grad, tv.grad)):
        assert g.dtype == dt
        _close(g, w.float().numpy(), TOL[dtype])


def test_the_wrapper_routes_through_the_function_only_under_grad():
    """With grad mode on and an input requiring grad the output carries
    FlashAttentionFn's grad_fn; otherwise the forward-only path runs, the
    same numbers without a graph."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 64, 5))
    plain = ops.flash_attention(q, k, v)
    assert plain.grad_fn is None
    for which in range(3):
        args = [q, k, v]
        args[which] = args[which].clone().requires_grad_(True)
        out = ops.flash_attention(*args)
        assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
        assert torch.equal(out.detach(), plain)
        with torch.no_grad():
            assert ops.flash_attention(*args).grad_fn is None
    with pytest.raises(ValueError, match="kv_positions"):
        ops.flash_attention(q, k, v, kv_positions=torch.zeros(1, 16))
    with pytest.raises(ValueError, match="positions"):
        ops.flash_attention(q, k, v, positions=torch.zeros(1, 15))


def test_lse_is_the_row_logsumexp_of_the_forwards_scores():
    """The lse the Function saves: logsumexp over each row of s = q.k /
    sqrt(hd) with the mask at -1e30, (B, H, S) f32; and the backward from
    it through flash_attention_bwd (the CPU takes the plain version)."""
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(2, 20, 4, 2, 64, 6))
    out, lse = fa.flash_attention_plain(q, k, v, True, return_lse=True)
    kx = k.repeat_interleave(2, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, kx) / 8.0
    s = torch.where(torch.ones(20, 20, dtype=torch.bool).tril(), s,
                    torch.full((), -1e30))
    assert lse.shape == (2, 4, 20) and lse.dtype == torch.float32
    torch.testing.assert_close(lse, torch.logsumexp(s, -1), rtol=0,
                               atol=1e-6)
    got = fa.flash_attention_bwd(q, k, v, out, do, lse, True)
    want = fa.flash_attention_bwd_plain(q, k, v, out, do, lse, True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# The bf16 CUDA backward's numerics (csrc/flash_attention_bwd.cu, the
# tensor-core kernels), emulated in plain torch f32: bf16 inputs; s = q.k
# and dp = dO.v with exact products and f32 sums; D = dO . o from the bf16
# output; p = 2^(s c + off) with c = scale log2(e) and off = -lse log2(e)
# in f32 (one rounding, the kernel's fma; -inf for a row that saw no key);
# masked keys p = 0; ds = p (dp - D); p (plus 1/S on a row that saw no
# key) and ds rounded once to bf16 before the three second-stage products;
# dq and dk times scale; every output rounded once to bf16.
def _bf16_bwd_emulation(q, k, v, o, do, lse, causal, positions=None,
                        kv_positions=None):
    B, S, H, hd = q.shape
    G = H // k.shape[2]
    scale = np.float32(1.0 / np.sqrt(hd))
    log2e = np.float32(np.log2(np.e))
    c = float(np.float32(scale * log2e))
    qf = q.float().transpose(1, 2)                          # (B, H, S, hd)
    kf = k.float().repeat_interleave(G, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(G, 2).transpose(1, 2)
    dof = do.float().transpose(1, 2)
    s = qf @ kf.transpose(-1, -2)
    dp = dof @ vf.transpose(-1, -2)
    D = (dof * o.float().transpose(1, 2)).sum(-1, keepdim=True)
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
    ds = (p * (dp - D)).bfloat16().float()
    p_dv = (p + torch.where(blind, torch.tensor(np.float32(1.0) / S),
                            torch.zeros(()))).bfloat16().float()
    dq = (ds @ kf) * scale
    dk = (ds.transpose(-1, -2) @ qf) * scale
    dv = p_dv.transpose(-1, -2) @ dof
    grads = [g.transpose(1, 2) for g in (dq, dk, dv)]       # (B, S, H, hd)
    for i in (1, 2):
        grads[i] = grads[i].reshape(B, S, H // G, G, hd).sum(3)
    return [g.bfloat16() for g in grads]


# (B, S, H, KV, hd, causal, positions): causal GQA 8/2 and full at hd 64
# and 128, S 512 and 1024; a ragged S of 200; explicit q and kv positions
# with rows that see no key
BF16_BWD_CASES = [(1, 512, 8, 2, 64, True, False),
                  (1, 1024, 8, 2, 64, True, False),
                  (1, 512, 8, 2, 128, False, False),
                  (1, 1024, 4, 4, 128, True, False),
                  (2, 200, 4, 2, 64, True, False),
                  (2, 200, 4, 2, 128, False, False),
                  (2, 256, 4, 2, 128, True, True)]


@pytest.mark.parametrize("B,S,H,KV,hd,causal,positions", BF16_BWD_CASES)
def test_bf16_backward_kernel_numerics_within_the_card_tolerance(
        B, S, H, KV, hd, causal, positions):
    """p and ds rounded once to bf16 for the second-stage products keep
    each gradient within 2e-2 of its largest magnitude of the plain
    backward (the card check's tolerance, chip_smoke.FLASH_BWD_TOL and
    tests/test_torch_gpu.py's BWD_TOL). Measured here: MARGIN."""
    q, k, v, do = (torch.from_numpy(a).bfloat16()
                   for a in _inputs(B, S, H, KV, hd, S + hd))
    qp = kp = None
    if positions:
        rng = np.random.default_rng(7)
        qp = torch.from_numpy(rng.integers(0, S, (B, S)))
        kp = torch.from_numpy(rng.integers(5, S, (B, S)))
        qp[0, :3] = 2
    o, lse = fa.flash_attention_plain(q, k, v, causal, qp, True, kp)
    if positions:
        assert bool((lse < fa.MASKED_LSE).any())
    got = _bf16_bwd_emulation(q, k, v, o, do, lse, causal, qp, kp)
    want = fa.flash_attention_bwd_plain(q, k, v, o, do, lse, causal, qp, kp)
    for g, w in zip(got, want):
        rel = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max())
        print(rel)
        assert rel <= TOL["bf16"]


def test_the_backward_library_hashes_its_header_and_binds_its_entries():
    """The backward's source includes csrc/hopper.cuh, which the build's
    hash covers; each C entry takes as many arguments as its ctypes
    signature declares, both the records' scratch after dv."""
    import re

    from repro_torch.kernels import build
    assert [p.name for p in build.sources("flash_attention_bwd")] == \
        ["flash_attention_bwd.cu", "hopper.cuh"]
    src = (build.CSRC / "flash_attention_bwd.cu").read_text()
    sigs = build._SIGNATURES["flash_attention_bwd"]
    for fn, argtypes in sigs.items():
        params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1)
        assert len(params.split(",")) == len(argtypes)
    for fn in ("flash_attention_bwd_f32", "flash_attention_bwd_bf16"):
        params = re.search(rf'extern "C" int {fn}\(([^)]*)\)', src).group(1)
        names = [p.split()[-1].lstrip("*") for p in params.split(",")]
        assert names[names.index("dv") + 1] == "scratch"


@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "rwkv6-1.6b", "hymba-1.5b",
                                  "whisper-small", "qwen3-moe-30b-a3b"])
def test_flash_layers_counts_the_models_flash_attention_calls(arch,
                                                              monkeypatch):
    """chip_smoke.flash_layers, which its launch formulas and phase 14 (c)'s
    exact count of backward launches read, is the number of
    ops.flash_attention calls in one loss of each family's reduced model
    (the encoder's too; none for an ssm or under a sliding window)."""
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.launch import steps as step_lib
    from repro_torch.launch.train import make_batch_arrays
    from repro_torch.models.model import build_model
    from repro_torch.utils import prng

    cfg = get_config(arch, reduced=True)
    model = build_model(cfg)
    cpu = torch.device("cpu")
    params = step_lib.make_train_state(model, prng.key(0), cpu).params
    batch = make_batch_arrays(cfg, 1, 16, 0, cpu)
    calls = []
    real = ops.flash_attention
    monkeypatch.setattr(ops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    with torch.no_grad():
        model.loss(params, batch)
    assert len(calls) == cs.flash_layers(cfg)
    assert cs.flash_layers(cfg) == {"rwkv6-1.6b": 0, "hymba-1.5b": 0,
                                    "whisper-small": 4}.get(arch, 2)
