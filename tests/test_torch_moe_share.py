"""The port's expert layer on a share of the experts (``cfg.moe.held``,
``sharding.rules.expert_shard``), at a small size on the CPU, seeded.

- Every expert held: ``moe_init`` and ``moe_apply`` bitwise the layer as
  it was before it knew of shares (a frozen copy below), in f32 and bf16.
- A share: its stacks bitwise rows [first, first + count) of the uncut
  init under the same key, and within INIT_TOL of the benchmark's
  plain reference of the share (``perfbench/reference/moe_share.py``,
  whose gaussian map is torch's erfinv, the port's a polynomial); its
  output within OUT_TOL of the reference's on the same weights, its aux
  loss the uncut layer's.
- The shares of a layer (4 of 16 experts each) add up to the uncut layer,
  the port's and the reference's, with the aux loss counted once.
- A share refuses to run as one of several ranks.
- The spans and counts: a traced vfl-zoo step records moe.route,
  moe.dispatch, moe.experts and moe.combine at depth 2 in each server
  forward and moe.held, moe.kept and moe.slots for each call; an untraced
  call runs the same ops as one with the instrumentation taken out.
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import obs
from repro_torch.configs import MoEConfig, MoEShard, VFLConfig, get_config
from repro_torch.launch import steps as step_lib
from repro_torch.models import moe
from repro_torch.models.layers import silu
from repro_torch.models.model import build_model
from repro_torch.sharding import rules
from repro_torch.utils import prng

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from perfbench.reference import model as M  # noqa: E402
from perfbench.reference import moe_share as R  # noqa: E402

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

E, K, D, F_EXP, CARDS = 16, 4, 64, 32, 4
# the layer's output against the reference's, over its largest entry: f32
# products and sums in other orders (the port's test_torch_moe bound)
OUT_TOL = 1e-5
# the init's draws: the reference maps bits to gaussians with torch's
# erfinv, the port with its polynomial (5.8e-6 apart at most, relative,
# over 2^22 words; the most in the tails)
INIT_TOL = 1e-5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _cfg(dtype="float32", E=E, K=K, capacity_factor=1.25):
    return get_config("qwen3-moe-30b-a3b", reduced=True).replace(
        d_model=D, dtype=dtype,
        moe=MoEConfig(E, K, F_EXP, capacity_factor=capacity_factor))


def _shape(cfg):
    m = cfg.moe
    return M.Shape(d=cfg.d_model, layers=1, heads=cfg.num_heads,
                   kv_heads=cfg.num_kv_heads, head_dim=cfg.resolved_head_dim,
                   d_ff=1, vocab=cfg.vocab_size, rope_theta=cfg.rope_theta,
                   eps=cfg.norm_eps, tied=False, qkv_bias=False,
                   qk_norm=cfg.qk_norm, experts=m.num_experts, top_k=m.top_k,
                   d_expert=m.d_ff_expert, capacity_factor=m.capacity_factor,
                   aux_coef=m.router_aux_coef, dtype=torch.float32)


def _x(seed, B=2, S=24, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, S, D), generator=g).to(dtype)


# --------------------------------------------- the layer as it was before --

def _parent_moe_init(key, cfg, device, dtype):
    """``moe_init`` before shares: the whole (E, ...) stacks."""
    from repro_torch.models.layers import dense_init
    d, m = cfg.d_model, cfg.moe
    E, f = m.num_experts, m.d_ff_expert
    ks = prng.split(key, 4)

    def draw(k, shape, fan_in):
        div = torch.full((), float(np.float32(np.sqrt(fan_in))),
                         device=device)
        return (prng.normal(k, shape, device) / div).to(dtype)
    return {"router": dense_init(ks[0], d, E, device, scale=0.02,
                                 dtype=dtype),
            "w_gate": draw(ks[1], (E, d, f), d),
            "w_up": draw(ks[2], (E, d, f), d),
            "w_down": draw(ks[3], (E, f, d), f)}


def _parent_moe_apply(p, cfg, x):
    """``moe_apply`` before shares, line for line."""
    B, S, d = x.shape
    m = cfg.moe
    E, K = m.num_experts, m.top_k
    N = B * S
    xf = x.reshape(N, d)
    probs, gates, expert_idx = moe.route(p, cfg, xf)
    counts = torch.bincount(expert_idx.reshape(-1), minlength=E)
    f = counts.float() / N
    P = torch.mean(probs, dim=0)
    aux = m.router_aux_coef * E * torch.sum(f * P)
    C = moe.capacity(cfg, N)
    flat_idx = expert_idx.reshape(-1)
    pos = moe.positions(flat_idx, E)
    keep = pos < C
    gate_flat = gates.reshape(-1) * keep
    tok_ids = torch.arange(N, device=x.device).repeat_interleave(K)
    dest = torch.where(keep, flat_idx * C + pos,
                       torch.full_like(pos, E * C))
    buf = torch.zeros((E * C + 1, d), dtype=x.dtype, device=x.device)
    buf[dest] = xf[tok_ids]
    buf = buf[:E * C].view(E, C, d)
    h = silu(torch.bmm(buf, p["w_gate"])) * torch.bmm(buf, p["w_up"])
    y = torch.bmm(h, p["w_down"]).view(E * C, d)
    safe = flat_idx * C + torch.where(keep, pos, torch.full_like(pos, C - 1))
    out_k = (y[safe] * gate_flat[:, None].to(x.dtype)).view(N, K, d)
    out = torch.zeros((N, d), dtype=x.dtype, device=x.device)
    for k in range(K):
        out = out + out_k[:, k]
    return out.reshape(B, S, d), aux


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("E,K,cf", [(4, 2, 1.25), (16, 4, 1.25),
                                    (16, 4, 0.25)])
def test_every_expert_held_is_bitwise_the_parent(dtype, E, K, cf):
    cfg = _cfg(dtype, E, K, cf)
    assert cfg.moe.held == (0, E)
    want = _parent_moe_init(prng.key(7), cfg, "cpu", DTYPES[dtype])
    got = moe.moe_init(prng.key(7), cfg, "cpu", DTYPES[dtype])
    for k in want:
        assert torch.equal(got[k], want[k]), k
    x = _x(3, dtype=DTYPES[dtype])
    out, aux = moe.moe_apply(got, cfg, x)
    out_p, aux_p = _parent_moe_apply(want, cfg, x)
    assert torch.equal(out, out_p) and torch.equal(aux, aux_p)


# ------------------------------------------------------------ the rule --

def test_expert_shard_divides_the_experts():
    cfg = _cfg()
    shares = [rules.expert_shard(cfg, CARDS, r).moe for r in range(CARDS)]
    assert [s.held for s in shares] == [(0, 4), (4, 4), (8, 4), (12, 4)]
    assert all(isinstance(s, MoEShard) and s.num_experts == E
               and s.top_k == K for s in shares)
    assert rules.expert_shard(cfg, 1, 0) is cfg
    with pytest.raises(ValueError):
        rules.expert_shard(cfg, 3, 0)
    with pytest.raises(ValueError):
        rules.expert_shard(cfg, 4, 4)
    with pytest.raises(ValueError):
        MoEShard(E, K, F_EXP, first=14, count=4)
    cut = 3 * (E - 4) * D * F_EXP * cfg.num_layers
    assert rules.expert_shard(cfg, CARDS, 2).num_params() == \
        cfg.num_params() - cut


# -------------------------------------------------- share and reference --

def _share(cfg, r):
    return rules.expert_shard(cfg, CARDS, r)


def _ref_layer(seed, cfg, share):
    """The reference's layer from key ``seed`` and the key the port's
    ``moe_init`` is handed inside it (``layer_init``'s ks[1])."""
    k = prng.key(seed)
    p = R._layer(k, _shape(cfg), R.Share(*share), "cpu")
    return p, prng.split(k, 4)[1]


@pytest.mark.parametrize("r", range(CARDS))
def test_share_init_is_the_slice_of_the_uncut_draw(r):
    cfg = _cfg()
    sc = _share(cfg, r)
    first, n = sc.moe.held
    whole = moe.moe_init(prng.key(5), cfg, "cpu", torch.float32)
    got = moe.moe_init(prng.key(5), sc, "cpu", torch.float32)
    assert torch.equal(got["router"], whole["router"])
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(got[k], whole[k][first:first + n]), k
    # the reference's share: its own uncut layer's rows, and the port's
    ref, k_moe = _ref_layer(11, cfg, (first, n))
    ref_whole = M._layer(prng.key(11), _shape(cfg), "cpu")
    port = moe.moe_init(k_moe, sc, "cpu", torch.float32)
    for k in ("w_gate", "w_up", "w_down"):
        assert torch.equal(ref["moe"][k],
                           ref_whole["moe"][k][first:first + n]), k
        torch.testing.assert_close(port[k], ref["moe"][k], rtol=INIT_TOL,
                                   atol=0)
    assert torch.equal(ref["moe"]["router"], ref_whole["moe"]["router"])
    torch.testing.assert_close(port["router"], ref["moe"]["router"],
                               rtol=INIT_TOL, atol=0)
    rest = [k for k in ref_whole if k != "moe"]
    assert sorted(ref) == sorted(ref_whole)
    for (n, a), (_, b) in zip(M.leaves({k: ref[k] for k in rest}),
                              M.leaves({k: ref_whole[k] for k in rest})):
        assert torch.equal(a, b), n


def _close(got, want):
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= OUT_TOL * scale


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_shares_against_the_reference_and_their_sum(seed):
    """Each share against the reference's share on the same weights; the
    four shares' outputs summed against the uncut layer, the port's and
    the reference's; the aux loss, the same from every share, once."""
    cfg = _cfg()
    p = moe.moe_init(prng.key(seed), cfg, "cpu", torch.float32)
    x = _x(seed + 10)
    sh = _shape(cfg)
    whole, aux = moe.moe_apply(p, cfg, x)
    ref_whole, ref_aux = M.moe(p, x, sh, M.F32)
    total, ref_total = torch.zeros_like(x), torch.zeros_like(x)
    for r in range(CARDS):
        sc = _share(cfg, r)
        first, n = sc.moe.held
        ps = moe.moe_init(prng.key(seed), sc, "cpu", torch.float32)
        out, a = moe.moe_apply(ps, sc, x)
        ref, ref_a = R.moe(ps, x, sh, R.Share(first, n), M.F32)
        _close(out, ref)
        assert torch.equal(a, aux)
        torch.testing.assert_close(ref_a, ref_aux, rtol=0, atol=0)
        total, ref_total = total + out, ref_total + ref
    _close(total, whole)
    _close(ref_total, ref_whole)
    _close(total + aux, ref_whole + ref_aux)
    torch.testing.assert_close(aux, ref_aux, rtol=1e-6, atol=1e-6)


def test_a_share_drops_at_capacity_like_the_whole_layer():
    """Capacity and queue positions come from all E experts: at a
    capacity factor of 0.25 the shares' sum is still the uncut layer."""
    cfg = _cfg(capacity_factor=0.25)
    p = moe.moe_init(prng.key(4), cfg, "cpu", torch.float32)
    x = _x(9)
    whole, _ = moe.moe_apply(p, cfg, x)
    total = sum(moe.moe_apply(moe.moe_init(prng.key(4), _share(cfg, r),
                                           "cpu", torch.float32),
                              _share(cfg, r), x)[0] for r in range(CARDS))
    _close(total, whole)


def test_a_share_refuses_several_ranks(monkeypatch):
    cfg, sc = _cfg(), _share(_cfg(), 1)
    p = moe.moe_init(prng.key(0), sc, "cpu", torch.float32)
    x = _x(0)
    dist = torch.distributed
    monkeypatch.setattr(dist, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 2)
    for call in (lambda: moe.moe_apply(p, sc, x),
                 lambda: moe.moe_init(prng.key(0), sc, "cpu",
                                      torch.float32)):
        with pytest.raises(RuntimeError,
                           match="exchange between expert shards"):
            call()
    whole = moe.moe_init(prng.key(0), cfg, "cpu", torch.float32)
    moe.moe_apply(whole, cfg, x)                        # every expert: runs
    monkeypatch.setattr(dist, "get_world_size", lambda *a: 1)
    moe.moe_apply(p, sc, x)


# ------------------------------------------------- spans and counts --

MOE_SPANS = ["moe.route", "moe.dispatch", "moe.experts", "moe.combine"]


@pytest.fixture
def _no_tracer():
    obs.configure(None)
    with obs.trace("unprofiled"):
        pass
    yield
    obs.configure(None)


def test_traced_zoo_step_records_the_moe_spans_and_counts(_no_tracer):
    cfg = rules.expert_shard(_cfg().replace(num_layers=2, vocab_size=64),
                             CARDS, 1)
    vfl = VFLConfig(num_parties=4, mu=1e-3, lr_party=1e-2, lr_server=2.5e-3,
                    fused=True, codec="int8")
    _, init, step = step_lib.make_vfl_zoo_step(build_model(cfg), vfl)
    g = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (2, 16), generator=g)
    batch = {"tokens": toks, "targets": torch.roll(toks, -1, dims=1)}
    state = init(prng.key(0), torch.device("cpu"))
    plain, _ = step(state, batch)
    with profile(activities=[ProfilerActivity.CPU]):
        traced, h = step(state, batch)
    assert torch.equal(traced.w0["layers"]["moe"]["w_up"],
                       plain.w0["layers"]["moe"]["w_up"])
    spans = obs.profiled_spans()
    fwd = [s for s in spans if s.name == "vfl.server_forward"]
    assert len(fwd) == 3 and {s.depth for s in fwd} == {1}
    got = [s for s in spans if s.name.startswith("moe.")]
    assert len(got) == 3 * cfg.num_layers * len(MOE_SPANS)
    assert {s.depth for s in got} == {2}
    assert {s.step for s in got} == {state.step}
    for f in fwd:
        inside = [s.name for s in got if f.t0_ns <= s.t0_ns <= s.t1_ns
                  <= f.t1_ns]
        assert inside == MOE_SPANS * cfg.num_layers
    counts = obs.profiled_counts()
    names = [c.name for c in counts]
    assert names == ["moe.held", "moe.kept", "moe.slots"] * (
        3 * cfg.num_layers)
    C = moe.capacity(cfg, toks.numel())
    for held, kept, slots in zip(*[iter(counts)] * 3):
        assert held.step == state.step and slots.value == 4 * C
        assert 0 < kept.value <= min(held.value, slots.value)
    # a new stretch (a span that found the profiler off, then one that
    # finds it on) starts with no counts, as with no spans
    with obs.trace("unprofiled"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with obs.trace("other"):
            pass
    assert obs.profiled_counts() == ()


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _ops_of(call):
    with _Ops() as mode:
        out = call()
    return mode.ops, out


@pytest.mark.parametrize("share", [False, True])
def test_untraced_call_runs_no_more_ops(share, monkeypatch, _no_tracer):
    cfg = _cfg()
    if share:
        cfg = _share(cfg, 2)
    p = moe.moe_init(prng.key(1), cfg, "cpu", torch.float32)
    x = _x(5)
    ops, (out, aux) = _ops_of(lambda: moe.moe_apply(p, cfg, x))
    monkeypatch.setattr(moe, "trace", lambda name, **kw: obs._NULL_SPAN)
    monkeypatch.setattr(moe, "profiled_count", lambda name, value: None)
    bare, (out_b, aux_b) = _ops_of(lambda: moe.moe_apply(p, cfg, x))
    assert ops == bare
    assert torch.equal(out, out_b) and torch.equal(aux, aux_b)


def test_capacity_is_the_whole_layers():
    cfg = _cfg()
    N = 48
    assert moe.capacity(_share(cfg, 3), N) == moe.capacity(cfg, N) == \
        max(math.ceil(N * K / E * 1.25), 4)
