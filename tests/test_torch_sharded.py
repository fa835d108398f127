"""The port's data-parallel path against the reference's, on the CPU under
gloo: the data group (launch/mesh.py), the batch rule (sharding/rules.py),
the sharded pieces of core/asyrevel.py (``PmeanVFLModel``,
``ShardFoldedExchange``, ``shard_wrap``, ``train_sharded``), the sharded
vfl-zoo step (launch/steps.py) and the launcher's ``--data-parallel``.

* World 1, in this process on a gloo group of one: ``train_sharded`` is
  bitwise ``train`` (the reference's acceptance invariant,
  tests/test_scale.py) and follows the reference's ``train_sharded`` on a
  1-device mesh; the sharded vfl-zoo step is bitwise the unsharded one.
* World 2, two rank processes (``mesh.spawn_ranks``), once for the module:
  each step from the reference's own state within ``STEP_TOL`` of the
  reference's sharded step, which runs on one device under ``jax.vmap``
  with ``axis_name="data"`` (binding ``lax.pmean`` and ``lax.axis_index``,
  two shards of the batch); the free run within ``TRAJ_TOL`` of the
  reference's; the ranks' states bitwise equal; every collective a
  one-element ``all_reduce``, as many as the server forwards (synrevel
  too); fused bitwise unfused.
* The shard fold: each rank's int8 rounding and DP noise bitwise the
  reference's ``ShardFoldedExchange`` for that shard.

The sizes, seeds and tolerances are tests/test_torch_scan.py's. The
launcher's ``--data-parallel`` is tests/test_torch_sharded_launch.py's.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import DPConfig as RefDPConfig
from repro.core import asyrevel as ref_asy
from repro.core.exchange import ZOExchange as RefExchange
from repro.sharding.rules import batch_pspecs as ref_batch_pspecs
from repro_torch.configs import DPConfig, VFLConfig, get_config
from repro_torch.core import asyrevel
from repro_torch.core.exchange import ZOExchange, to_host
from repro_torch.interop import asy_state_from_numpy
from repro_torch.launch import mesh
from repro_torch.launch import steps as step_lib
from repro_torch.models.model import build_model
from repro_torch.sharding.rules import DATA, batch_pspecs, shard_batch
from repro_torch.utils import prng, trees
from test_torch_scan import FIRST_TOL, SEED, STEP_TOL, TRAJ_TOL, _case, _np

pytestmark = pytest.mark.torch
torch.set_num_threads(1)

WORLD = 2
SPAWN_TIMEOUT_S = 240.0


# ------------------------------------------------------------- helpers ----

def _states_bitwise(a, b) -> bool:
    return a.step == b.step and all(
        torch.equal(x.view(torch.int32), y.view(torch.int32))
        for ta, tb in ((a.w0, b.w0), (a.parties, b.parties),
                       (a.hist, b.hist))
        for x, y in zip(trees.leaves(ta), trees.leaves(tb)))


def _max_gap(ref_state, state) -> float:
    gap = 0.0
    for ref_tree, tree in ((ref_state.parties, state.parties),
                           (ref_state.w0, state.w0)):
        for a, b in zip(jax.tree.leaves(ref_tree), trees.leaves(tree)):
            gap = max(gap, float(np.max(np.abs(b.numpy() - np.asarray(a)))))
    return gap


def _ref_sharded_step(ref_model, rv, alg, world=WORLD):
    """The reference's sharded step on one device: ``asyrevel_step`` (or
    ``synrevel_step``) on ``PmeanVFLModel`` and ``ShardFoldedExchange``
    under ``vmap`` over ``world`` batch shards named "data"; the state
    goes in whole, and each shard's new state comes out."""
    pm = ref_asy.PmeanVFLModel(ref_model, "data")
    ex = ref_asy.ShardFoldedExchange(RefExchange.from_config(rv), "data")
    fn = ref_asy.asyrevel_step if alg == "asyrevel" else \
        ref_asy.synrevel_step
    return jax.jit(jax.vmap(lambda st, b: fn(pm, rv, st, b, ex),
                            in_axes=(None, 0), axis_name="data"))


def _ref_shards(data, idx, world=WORLD):
    return jax.tree.map(lambda a: a[idx].reshape(
        (world, len(idx) // world) + a.shape[1:]), data)


def _first_shard(tree):
    """Shard 0 of the reference's sharded output, after checking every
    shard holds the same bits (the replicated state)."""
    def one(a):
        a_np = np.asarray(jax.random.key_data(a) if
                          jnp.issubdtype(a.dtype, jax.dtypes.prng_key)
                          else a)
        for r in range(1, a_np.shape[0]):
            np.testing.assert_array_equal(a_np[r], a_np[0])
        return a[0]
    return jax.tree.map(one, tree)


COLLECTIVES = ("all_reduce", "broadcast", "all_gather",
               "all_gather_into_tensor", "reduce", "reduce_scatter",
               "reduce_scatter_tensor", "all_to_all", "all_to_all_single",
               "scatter", "gather", "send", "recv", "isend", "irecv",
               "broadcast_object_list", "all_gather_object")


def _record_collectives() -> list:
    """Wrap every collective of torch.distributed in this process to
    record (name, elements of its first tensor)."""
    calls = []
    for name in COLLECTIVES:
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def rec(*a, _fn=fn, _name=name, **k):
            t = a[0] if a else next(iter(k.values()), None)
            calls.append((_name, t.numel() if isinstance(t, torch.Tensor)
                          else None))
            return _fn(*a, **k)
        setattr(dist, name, rec)
    return calls


def _count_server_forwards(model) -> list:
    count = [0]
    inner = model.server_forward

    def counted(*a, **k):
        count[0] += 1
        return inner(*a, **k)
    model.server_forward = counted
    return count


# ------------------------------------------------------- the world-2 run --

# (case of test_torch_scan.py, steps): the quickstart's LR (f32) and the
# defended fused int8 FCN at K 2, each step from the reference's state and
# free; synrevel (q + 2 server forwards a step) on the FCN, the port's
# ranks only
REF_CASES = (("lr-asy-k1", 40), ("fcn-int8-asy-k2", 15))
SYN_CASE = ("fcn-int8-syn-k1", 5)


def _against_the_reference(name, steps, group, calls):
    """Walk the reference's sharded trajectory: at each step the port's
    sharded step from the reference's state on the rank's half of the
    batch (the gaps to the reference's step), and the reference's h (the
    free run's yardstick). Then the port's own free run,
    ``train_sharded``."""
    ref_model, model, rv, pv, alg, _, batch, x, y, _ = _case(name)
    key = jax.random.key(SEED)
    st = ref_asy.init_state(ref_model, rv, key)
    ref_step = _ref_sharded_step(ref_model, rv, alg)
    keys = jax.random.split(jax.random.fold_in(key, 7), steps)
    data = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
    pmodel, ex, world = asyrevel.shard_wrap(
        model, ZOExchange.from_config(pv), group)
    local = batch // world
    h_gap = p_gap = 0.0
    want = []
    for t in range(steps):
        idx = np.asarray(jax.random.randint(keys[t], (batch,), 0, len(y)))
        state = asy_state_from_numpy(
            _np(st.w0), _np(st.parties), _np(st.hist), int(st.step),
            np.asarray(jax.random.key_data(st.key)), "cpu")
        st, h = ref_step(st, _ref_shards(data, idx))
        st, h = _first_shard(st), _first_shard(h)
        want.append(float(h))
        mine = idx[group.rank * local:(group.rank + 1) * local]
        state, th = asyrevel.STEP_FNS[alg](
            pmodel, pv, state, {"x": torch.from_numpy(x[mine]),
                                "y": torch.from_numpy(y[mine])}, ex)
        assert state.step == int(st.step)
        h_gap = max(h_gap, abs(float(th) - float(h)))
        p_gap = max(p_gap, _max_gap(st, state))
    run = _free_run(name, steps, group, calls)
    run.update(h_gap=h_gap, p_gap=p_gap, want=np.array(want, np.float32))
    return run


def _free_run(name, steps, group, calls, fused=None):
    """``train_sharded`` of a case on this rank: its losses, its state's
    digest, the collectives it issued and its server forwards."""
    _, model, _, pv, alg, _, batch, x, y, _ = _case(name)
    if fused is not None:
        pv = dataclasses.replace(pv, fused=fused)
    forwards = _count_server_forwards(model)
    del calls[:]
    reduces = group.all_reduces
    state, losses = asyrevel.train_sharded(
        model, pv, {"x": x, "y": y}, prng.key(SEED), steps, batch,
        algorithm=alg, group=group)
    return {"losses": losses.numpy(), "digest": asyrevel.state_digest(state),
            "collectives": list(calls), "server_forwards": forwards[0],
            "all_reduces": group.all_reduces - reduces}


def _world2_rank(rank, world, rendezvous):
    group = mesh.make_data_mesh(world, rank, rendezvous, device="cpu")
    calls = _record_collectives()
    try:
        runs = {name: _against_the_reference(name, steps, group, calls)
                for name, steps in REF_CASES}
        runs["synrevel"] = _free_run(*SYN_CASE, group, calls)
        runs["unfused"] = _free_run(REF_CASES[1][0], REF_CASES[1][1], group,
                                    calls, fused=False)
        return {"runs": runs, "backend": group.backend,
                "device": str(group.device)}
    finally:
        group.close()


@pytest.fixture(scope="module")
def world2():
    return mesh.spawn_ranks(_world2_rank, WORLD, timeout_s=SPAWN_TIMEOUT_S)


@pytest.mark.parametrize("name", [c[0] for c in REF_CASES])
def test_world2_steps_from_the_references_state(world2, name):
    """Each step from the reference's state at that step, each rank on its
    half of the batch the reference's train draws: h (the global mean)
    and the new state within STEP_TOL of the reference's sharded step."""
    *_, tol = _case(name)
    h_tol, p_tol = STEP_TOL[tol]
    for r in range(WORLD):
        got = world2[r]["runs"][name]
        assert got["h_gap"] <= h_tol and got["p_gap"] <= p_tol, \
            (r, got["h_gap"], got["p_gap"])


@pytest.mark.parametrize("name", [c[0] for c in REF_CASES])
def test_world2_free_run_follows_the_references(world2, name):
    _, _, _, pv, *_ = _case(name)
    for r in range(WORLD):
        run = world2[r]["runs"][name]
        got, want = run["losses"], run["want"]
        assert got.shape == want.shape
        assert abs(got[0] - want[0]) <= FIRST_TOL
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=TRAJ_TOL[pv.codec])
        assert len(set(got.tolist())) > len(got) // 2      # it trains


@pytest.mark.parametrize("run", [c[0] for c in REF_CASES]
                         + ["synrevel", "unfused"])
def test_world2_ranks_hold_the_same_bits_with_no_parameter_collective(
        world2, run):
    """Every rank's final state and losses are bitwise every other's, and
    the only collectives are one-element all_reduces, one per server
    forward (the group's count agrees)."""
    runs = [w["runs"][run] for w in world2]
    for r, got in enumerate(runs):
        assert got["digest"] == runs[0]["digest"], r
        np.testing.assert_array_equal(got["losses"].view(np.int32),
                                      runs[0]["losses"].view(np.int32))
        assert got["server_forwards"] > 0
        assert got["collectives"] == \
            [("all_reduce", 1)] * got["server_forwards"]
        assert got["all_reduces"] == got["server_forwards"]
    assert world2[0]["backend"] == "gloo" and world2[0]["device"] == "cpu"


def test_world2_fused_is_bitwise_unfused(world2):
    for w in world2:
        fused, unfused = w["runs"][REF_CASES[1][0]], w["runs"]["unfused"]
        assert fused["digest"] == unfused["digest"]
        np.testing.assert_array_equal(fused["losses"].view(np.int32),
                                      unfused["losses"].view(np.int32))


# ----------------------------------------------------------- world 1 -----

@pytest.fixture(scope="module")
def group1():
    group = mesh.make_data_mesh(1, device="cpu")
    yield group
    group.close()


W1_CASES = ["lr-asy-k1", "lr-syn-k1", "fcn-int8-asy-k2",
            "fcn-int8-unfused-syn-k2"]
W1_STEPS = 15


@pytest.mark.parametrize("name", W1_CASES)
def test_train_sharded_at_one_rank_is_bitwise_train(group1, name):
    """asyrevel and synrevel x (f32, K 1) and (int8, K 2), as the
    reference's tests/test_scale.py pins its 1-device mesh: the same
    losses and state, bit for bit; one all_reduce a server forward."""
    _, model, _, pv, alg, _, batch, x, y, _ = _case(name)
    state, losses = asyrevel.train(model, pv, {"x": x, "y": y},
                                   prng.key(SEED), W1_STEPS, batch,
                                   algorithm=alg, device="cpu")
    forwards = _count_server_forwards(model)
    reduces = group1.all_reduces
    s_state, s_losses = asyrevel.train_sharded(
        model, pv, {"x": x, "y": y}, prng.key(SEED), W1_STEPS, batch,
        algorithm=alg, group=group1)
    assert torch.equal(losses.view(torch.int32), s_losses.view(torch.int32))
    assert _states_bitwise(state, s_state)
    assert asyrevel.state_digest(state) == asyrevel.state_digest(s_state)
    assert group1.all_reduces - reduces == forwards[0] > 0


@pytest.mark.parametrize("name", ["lr-asy-k1", "fcn-int8-asy-k2"])
def test_train_sharded_at_one_rank_follows_the_references(group1, name):
    ref_model, model, rv, pv, alg, _, batch, x, y, _ = _case(name)
    _, want = ref_asy.train_sharded(
        ref_model, rv, {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        jax.random.key(SEED), steps=W1_STEPS, batch_size=batch,
        algorithm=alg, mesh=jax.make_mesh((1,), ("data",),
                                          devices=jax.devices()[:1]))
    _, got = asyrevel.train_sharded(model, pv, {"x": x, "y": y},
                                    prng.key(SEED), W1_STEPS, batch,
                                    algorithm=alg, group=group1)
    want, got = np.asarray(want), got.numpy()
    assert abs(got[0] - want[0]) <= FIRST_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=TRAJ_TOL[pv.codec])


def test_sharded_zoo_step_at_one_rank_is_bitwise_the_unsharded_step(group1):
    """launch/steps.py's sharded step wraps the same asyrevel_step; at one
    rank h and the state are the unsharded step's, bit for bit (the
    reference's tests/test_scale.py pin), fused int8 included."""
    cfg = get_config("qwen1.5-0.5b", reduced=True)
    model = build_model(cfg)
    vfl = VFLConfig(num_parties=4, mu=1e-3, lr_party=1e-3,
                    lr_server=1e-3 / 4, fused=True, codec="int8")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 8)))
    batch = {"tokens": toks, "targets": toks}
    _, init, step = step_lib.make_vfl_zoo_step(model, vfl)
    _, init_s, step_s = step_lib.make_vfl_zoo_step(model, vfl, group1)
    state = init(prng.key(0), "cpu")
    assert _states_bitwise(state, init_s(prng.key(0), "cpu"))
    s1, h1 = step(state, batch)
    s2, h2 = step_s(state, batch)
    assert torch.equal(h1.view(torch.int32), h2.view(torch.int32))
    assert _states_bitwise(s1, s2)


def test_shard_wrap_folds_only_past_one_rank(group1):
    ex = ZOExchange(mu=1e-3, codec="int8")
    model = types.SimpleNamespace(num_parties=2)
    _, same, world = asyrevel.shard_wrap(model, ex, group1)
    assert same is ex and world == 1
    two = types.SimpleNamespace(world=2, rank=1)
    pm, folded, world = asyrevel.shard_wrap(model, ex, two)
    assert isinstance(folded, asyrevel.ShardFoldedExchange) and world == 2
    assert folded.rank == 1 and folded.meter is None
    assert (folded.codec, folded.dp, folded.fused) == (ex.codec, ex.dp,
                                                       ex.fused)
    assert isinstance(pm, asyrevel.PmeanVFLModel)
    k = prng.key(3)
    assert ex._codec_key(k) == k
    assert folded._codec_key(k) == prng.fold_in(k, 1) != k
    assert folded._codec_key(None) is None


# ---------------------------------------------------------- shard fold ----

FOLD_CASES = [("int8", None), ("int8", "gaussian"), ("int8", "laplace"),
              ("f32", "gaussian")]


@pytest.mark.parametrize("codec,mech", FOLD_CASES)
def test_shard_folded_release_is_the_references_for_each_rank(codec, mech):
    """Each shard's upload of its own slice: the reference's
    ShardFoldedExchange under vmap against the port's for that rank, wire
    bits equal (int8 rounding from the rank-folded codec key, DP noise from
    the rank-folded noise key), the port's fused release and its unfused
    one both; the two ranks' draws differ on the same payload."""
    dp_kw = None if mech is None else dict(noise_multiplier=1.3, clip=1.0,
                                           mechanism=mech)
    ref_ex = ref_asy.ShardFoldedExchange(
        RefExchange(mu=1e-3, codec=codec,
                    dp=RefDPConfig(**dp_kw) if dp_kw else None), "data")
    c = (1.5 * np.random.default_rng(0).standard_normal((WORLD, 300))
         ).astype(np.float32)
    k = jax.random.fold_in(jax.random.key(7), 1)
    pk = prng.fold_in(prng.key(7), 1)
    want = jax.vmap(lambda cs: ref_ex.encode_up(cs, k),
                    axis_name="data")(jnp.asarray(c))
    want_keys = np.asarray(jax.vmap(lambda _: jax.random.key_data(
        ref_ex._codec_key(k)), axis_name="data")(jnp.arange(WORLD)))

    def release(r, fused, payload):
        ex = asyrevel.ShardFoldedExchange(ZOExchange(
            mu=1e-3, codec=codec, fused=fused,
            dp=DPConfig(**dp_kw) if dp_kw else None), r)
        assert ex._codec_key(pk) == tuple(int(v) for v in want_keys[r])
        return jax.tree.leaves(to_host(ex.encode_up(
            torch.from_numpy(payload), pk)))

    for r in range(WORLD):
        for fused in (False, True):
            for got, ref in zip(release(r, fused, c[r]),
                                jax.tree.leaves(want)):
                np.testing.assert_array_equal(
                    np.asarray(got).reshape(-1).view(np.uint8),
                    np.asarray(ref)[r].reshape(-1).view(np.uint8))
    q0, q1 = (release(r, False, c[0])[0] for r in range(WORLD))
    assert (np.asarray(q0) != np.asarray(q1)).any()


# ------------------------------------------------------------- the rule ---

def test_batch_rule_is_the_references():
    """A leading dim divisible by the world size shards (rank r its r-th
    contiguous slice), any other leaf stays whole: the reference's
    batch_pspecs on a 1-D "data" mesh of that size."""
    batch = {"tokens": torch.arange(24).reshape(4, 6),
             "targets": torch.arange(24).reshape(4, 6) + 100,
             "odd": torch.arange(6).reshape(3, 2),
             "scalar": torch.tensor(7)}
    for world in (1, 2, 4, 3):
        fake_mesh = types.SimpleNamespace(axis_names=("data",),
                                          devices=np.empty((world,)))
        ref = ref_batch_pspecs(
            {k: np.asarray(v) for k, v in batch.items()}, fake_mesh,
            batch_axes=("data",))
        specs = batch_pspecs(batch, world)
        assert {k: (DATA if tuple(v) else None) for k, v in ref.items()} \
            == specs
        for rank in range(world):
            part = shard_batch(batch, rank, world)
            for k, v in batch.items():
                if specs[k] is None:
                    assert part[k] is v
                else:
                    n = v.shape[0] // world
                    assert torch.equal(part[k], v[rank * n:(rank + 1) * n])


# ------------------------------------------------------------- the group --

def test_data_group_arguments_and_devices():
    with pytest.raises(ValueError, match="rank 2"):
        mesh.make_data_mesh(2, 2, "file:///nonexistent")
    with pytest.raises(ValueError, match="rendezvous"):
        mesh.make_data_mesh(2, 0, None, device="cpu")
    assert mesh.rank_device(3, "cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh.rank_device(0)
