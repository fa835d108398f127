"""AsyREVEL, the device-level trainer step (Algorithm 1), as the
reference's core/asyrevel.py runs it inside its scan:

  * the party params stacked over a leading q axis,
  * a (tau+1)-slot ring buffer of PAST party params: at step t the
    activated party m_t ~ Categorical(p) (Assumption 3) sees the OTHER
    parties' outputs computed from params delayed by tau_j <= tau
    (Assumption 4),
  * the server params w_0.

Each step is the paper's message pattern: party m uploads (c_m, c_hat_m)
through the exchange's codec, the server computes h, h_bar, h_hat and
returns (h, h_bar); party m forms the two-point estimate and updates w_m;
the server forms Eq. (17) and updates w_0. The round itself (perturb,
codec, coefficient, apply) is core/exchange.py's ZOExchange.

``synrevel_step`` is the synchronous counterpart: every party (and the
server) computes fresh c's, perturbs and updates each step. ``train`` runs
either step over random minibatches, as the reference's jitted
``lax.scan`` does, in a Python loop on the device: the same batch keys
(``split(fold_in(key, 7), steps)``), the same indices (``randint``) drawn
and gathered on the device one step at a time, and the per-step h kept as
device tensors and stacked once at the end, so no step waits for the
device.

The steps are functional, like the reference's: each returns a new state
and leaves the old one as it was. The activation and delay draws are
jax's categorical and randint on the step's keys (utils/prng.py), q + 1
values made on the host, so m_t and the delays are Python ints. Every
model of core/vfl.py runs here, ``num_directions`` K >= 1 (core/exchange.py).

The sharded path is the reference's data-parallel scan on
``torch.distributed`` (launch/mesh.py's ``DataGroup``): ``train_sharded``
draws each step's global batch indices on every rank and steps on the
rank's contiguous slice; ``PmeanVFLModel`` turns each server loss into
the global batch mean (an ``all_reduce`` and a division), so every rank
forms the same coefficients and the replicated parameters stay bitwise
equal with no collective on a parameter; ``ShardFoldedExchange`` folds
the rank into every stochastic stream of an upload (``shard_wrap``, only
for more than one rank). At one rank it is bitwise ``train``.
"""
from __future__ import annotations

import hashlib
from typing import NamedTuple

import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.core.exchange import ZOExchange
from repro_torch.obs import trace
from repro_torch.utils import prng, trees, xla_math
from repro_torch.utils.device import resolve_device


class AsyState(NamedTuple):
    w0: dict
    parties: dict          # stacked (q, ...)
    hist: dict             # ring buffer (tau+1, q, ...)
    step: int
    key: tuple             # the run's key, a (k0, k1) uint32 pair


def _gather_party(tree, m: int):
    return trees.tree_map(lambda a: a[m], tree)


def _stale_parties(hist, slots):
    """hist leaves: (tau+1, q, ...); slots: q ints -> (q, ...) params, row
    j taken from slot slots[j]. The rows are views stacked in one copy, so
    no index tensor crosses to the device."""
    return trees.tree_map(
        lambda h: torch.stack([h[s, j] for j, s in enumerate(slots)]), hist)


def init_state(model, vfl: VFLConfig, key, device) -> AsyState:
    k0, k1 = prng.split(key)
    w0 = model.init_server(k0, device)
    parties = model.init_parties_stacked(k1, device)
    hist = trees.tree_map(
        lambda a: a.unsqueeze(0).expand(
            (vfl.max_delay + 1,) + tuple(a.shape)).clone(), parties)
    return AsyState(w0, parties, hist, 0, tuple(key))


def _activation_probs(vfl: VFLConfig) -> torch.Tensor:
    if vfl.activation_probs is not None:
        p = torch.tensor(vfl.activation_probs, dtype=torch.float32)
        return p / p.sum()
    return torch.full((vfl.num_parties,), 1.0 / vfl.num_parties,
                      dtype=torch.float32)


def draw_party_and_delays(vfl: VFLConfig, state: AsyState):
    """The step's activated party m_t and per-party delays, as the
    reference draws them: categorical over log p, randint in [0, tau],
    the activated party's own delay set to 0."""
    key = prng.fold_in(state.key, state.step)
    m_t = prng.categorical(prng.fold_name(key, "party"),
                           xla_math.log(_activation_probs(vfl)))
    delays = prng.randint(prng.fold_name(key, "delay"), (vfl.num_parties,),
                          0, vfl.max_delay + 1)
    delays[m_t] = 0                 # a party's own params are fresh
    return m_t, delays


def asyrevel_step(model, vfl: VFLConfig, state: AsyState, batch,
                  ex: ZOExchange | None = None):
    """One AsyREVEL iteration (Algorithm 1 lines 2-11). Returns
    (new_state, h). Its phases are spans (``obs.trace``, ``step`` the
    state's), which tile it: zoo.draws, zoo.party_up, zoo.server_fwd,
    zoo.party_estimate, zoo.party_update, zoo.server_update,
    zoo.hist_write."""
    with trace("zoo.draws", step=state.step):
        ex = ex if ex is not None else ZOExchange.from_config(vfl)
        tau = vfl.max_delay
        key = prng.fold_in(state.key, state.step)
        k_u, k_u0, k_c = (prng.fold_name(key, s)
                          for s in ("u", "u0", "codec"))
        # --- Assumption 3: activated party; Assumption 4: bounded delays
        m_t, delays = draw_party_and_delays(vfl, state)
        # w^{t-delta} = params after step t-1-delta; hist[s] holds the
        # params written at the end of the latest step with
        # step % (tau+1) == s
        slots = [(state.step - 1 - d) % (tau + 1) for d in delays]

    # --- steps 4-5: the c table the server holds is what survived the
    # up-link codec, one message (party) at a time -------------------------
    with trace("zoo.party_up", step=state.step):
        x = model.party_args(batch)
        stale = _stale_parties(state.hist, slots)
        cs = model.all_party_outputs(stale, x)
        cs = model.map_party_outputs(
            cs, lambda c, m: ex.roundtrip_up(c, prng.fold_in(k_c, m)))
        w_m = _gather_party(state.parties, m_t)
        x_m = model.slice_features(x, m_t)

    with trace("zoo.server_fwd", step=state.step):
        y = model.server_args(batch)
        h = model.server_forward(state.w0, cs, y)           # h_{i,m}
        reg0 = model.regularizer(w_m)

    with trace("zoo.party_estimate", step=state.step):
        def f_of(w_m_pert, k_dir):
            c_hat = model.party_forward(w_m_pert, x_m, m_t)
            c_hat = ex.roundtrip_up(c_hat,
                                    prng.fold_name(k_dir, "codec_hat"))
            cs_hat = model.replace_party_output(cs, c_hat, m_t)
            h_bar = model.server_forward(state.w0, cs_hat, y)  # h-bar_{i,m}
            return h_bar + vfl.lam * model.regularizer(w_m_pert)

        g_m = ex.party_gradient(w_m, k_u, h + vfl.lam * reg0, f_of)

    # --- steps 6-7: party update (Eq. 15) ----------------------------------
    with trace("zoo.party_update", step=state.step):
        parties = ex.apply_block(state.parties, m_t, g_m, vfl.lr_party)

    # --- steps 9-11: server's own estimate + update (Eq. 17) ---------------
    with trace("zoo.server_update", step=state.step):
        if vfl.perturb_server:
            w0 = ex.server_update(
                state.w0, k_u0, h,
                lambda w0p: model.server_forward(w0p, cs, y),  # h-hat_{i,m}
                vfl.lr_server)
        else:
            w0 = state.w0

    with trace("zoo.hist_write", step=state.step):
        slot = state.step % (tau + 1)

        def write(hbuf, p):
            out = hbuf.clone()
            out[slot] = p
            return out
        hist = trees.tree_map(write, state.hist, parties)
        return AsyState(w0, parties, hist, state.step + 1, state.key), h


def synrevel_step(model, vfl: VFLConfig, state: AsyState, batch,
                  ex: ZOExchange | None = None):
    """Synchronous counterpart: every round ALL parties (and the server)
    compute fresh c's, perturb, and update together; no staleness.
    Returns (new_state, h)."""
    ex = ex if ex is not None else ZOExchange.from_config(vfl)
    key = prng.fold_in(state.key, state.step)
    k_c = prng.fold_name(key, "codec")
    x = model.party_args(batch)
    y = model.server_args(batch)
    cs = model.all_party_outputs(state.parties, x)
    cs = model.map_party_outputs(
        cs, lambda c, m: ex.roundtrip_up(c, prng.fold_in(k_c, m)))
    h = model.server_forward(state.w0, cs, y)

    new_parties = state.parties
    for m in range(vfl.num_parties):
        w_m = _gather_party(state.parties, m)
        x_m = model.slice_features(x, m)

        def f_of(w_m_pert, k_dir, m=m, x_m=x_m):
            c_hat = model.party_forward(w_m_pert, x_m, m)
            # k_dir already encodes the party (derived from k_u) and the
            # direction, so every upload gets its own rounding draw
            c_hat = ex.roundtrip_up(c_hat, prng.fold_name(k_dir, "codec_hat"))
            h_bar = model.server_forward(
                state.w0, model.replace_party_output(cs, c_hat, m), y)
            return h_bar + vfl.lam * model.regularizer(w_m_pert)

        g_m = ex.party_gradient(w_m, prng.fold_name(key, f"u{m}"),
                                h + vfl.lam * model.regularizer(w_m), f_of)
        new_parties = ex.apply_block(new_parties, m, g_m, vfl.lr_party)

    if vfl.perturb_server:
        w0 = ex.server_update(
            state.w0, prng.fold_name(key, "u0"), h,
            lambda w0p: model.server_forward(w0p, cs, y), vfl.lr_server)
    else:
        w0 = state.w0
    return AsyState(w0, new_parties, state.hist, state.step + 1,
                    state.key), h


STEP_FNS = {"asyrevel": asyrevel_step, "synrevel": synrevel_step}


def batch_indices(key, t: int, batch_size: int, n: int, device):
    """Step t's minibatch indices, as the reference's ``train`` draws
    them: randint(k_t, (batch_size,), 0, n) with k_t = split(fold_in(key,
    7), steps)[t], an int64 tensor drawn on ``device``."""
    return prng.randint_on(prng.split_at(prng.fold_in(key, 7), t),
                           (batch_size,), 0, n, device)


def train(model, vfl: VFLConfig, data, key, steps: int, batch_size: int,
          algorithm: str = "asyrevel", device=None):
    """``steps`` iterations of ``algorithm`` ("asyrevel" or "synrevel")
    over random minibatches of ``data``, from ``init_state(key)``.

    data: dict of arrays (numpy or tensors) with a shared leading sample
    dim, moved to ``device`` once. ``device=None`` is the GPU and raises
    without one; ``"cpu"`` runs the kernels' plain versions. Returns
    (final_state, per-step losses as one tensor on the device)."""
    if algorithm not in STEP_FNS:
        raise ValueError(f"unknown algorithm {algorithm!r}; have "
                         f"{sorted(STEP_FNS)}")
    device = resolve_device(device)
    data = {k: torch.as_tensor(a).to(device) for k, a in data.items()}
    n = next(iter(data.values())).shape[0]
    state = init_state(model, vfl, key, device)
    step_fn, ex = STEP_FNS[algorithm], ZOExchange.from_config(vfl)
    losses = []
    for t in range(steps):
        idx = batch_indices(key, t, batch_size, n, device)
        batch = {k: a[idx] for k, a in data.items()}
        state, h = step_fn(model, vfl, state, batch, ex)
        losses.append(h)
    return state, torch.stack(losses)


def state_digest(state: AsyState) -> str:
    """sha256 of a state's bits: the step, then every leaf of w0, the
    party blocks and the ring buffer in flatten order (equal digests,
    bitwise equal states)."""
    h = hashlib.sha256(str(state.step).encode())
    for tree in (state.w0, state.parties, state.hist):
        for t in trees.leaves(tree):
            h.update(t.detach().cpu().contiguous().reshape(-1)
                     .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


# ------------------------------------------------- sharded scale path -----

class PmeanVFLModel:
    """Data-parallel view of a VFL model on one rank of ``group``: every
    method is the wrapped model's but ``server_forward``, which returns
    the GLOBAL batch-mean loss, the rank's loss summed over the ranks
    (``group.all_reduce_sum``) and divided by the world size as a device
    tensor (a true division, as the reference's ``pmean``; CUDA divides by
    a Python scalar through its reciprocal). Every rank gets the same
    bits, so every rank forms the same two-point coefficients; the c
    values never leave their rank."""

    def __init__(self, inner, group):
        self.inner = inner
        self.group = group
        self.num_parties = inner.num_parties

    def server_forward(self, w0, cs, y):
        total = self.group.all_reduce_sum(self.inner.server_forward(w0, cs,
                                                                    y))
        return total / torch.full((), self.group.world, dtype=total.dtype,
                                  device=total.device)

    def __getattr__(self, name):
        return getattr(self.inner, name)


class ShardFoldedExchange(ZOExchange):
    """The exchange of one rank of a data group of more than one: folds
    the rank into ``_codec_key``, so the per-rank slices of one upload
    draw independent int8 rounding and, through ``_dp_key``, independent
    DP noise, fused or not (the same replicated step key would otherwise
    hand every rank the same draws). Keeps the base's codec, DP and
    ``fused``, and meters nothing. Only for more than one rank:
    fold_in(key, 0) is not the identity."""

    def __init__(self, base: ZOExchange, rank: int):
        super().__init__(mu=base.mu, direction=base.direction,
                         lam=base.lam, num_directions=base.num_directions,
                         seed_replay=base.seed_replay, codec=base.codec,
                         meter=None, dp=base.dp, fused=base.fused)
        self.rank = int(rank)

    def _codec_key(self, key):
        if key is None:
            return None
        return prng.fold_in(key, self.rank)


def shard_wrap(model, ex: ZOExchange, group):
    """The one place the sharded wrapping is decided: ``(pmodel, ex,
    world)``, the pmean view of ``model`` and, only when ``group`` has
    more than one rank, the shard-folded exchange (at one rank the
    sharded path stays bitwise the unsharded one). ``train_sharded`` and
    launch/steps.py's ``make_vfl_zoo_step`` both call it."""
    if group.world > 1:
        ex = ShardFoldedExchange(ex, group.rank)
    return PmeanVFLModel(model, group), ex, group.world


def train_sharded(model, vfl: VFLConfig, data, key, steps: int,
                  batch_size: int, algorithm: str = "asyrevel", group=None,
                  device=None):
    """Data-parallel ``train`` on one rank of ``group`` (launch/mesh.py;
    every rank calls it with the same arguments): each step draws the
    global batch indices as ``train`` does and takes the rank's slice
    ``[r B / world, (r + 1) B / world)``, and the step runs on the wrapped
    model and exchange of ``shard_wrap``. ``device`` defaults to the
    rank's. Returns, on every rank, the replicated final state and the
    per-step global losses. At one rank it is bitwise ``train``; at more,
    the losses are the mean of the ranks' means, another order of the
    same sum, and each rank's int8 and DP draws are its own."""
    if algorithm not in STEP_FNS:
        raise ValueError(f"unknown algorithm {algorithm!r}; have "
                         f"{sorted(STEP_FNS)}")
    if group is None:
        raise ValueError("train_sharded runs on a data group "
                         "(launch/mesh.make_data_mesh)")
    world, r = group.world, group.rank
    if batch_size % world:
        raise ValueError(f"batch_size={batch_size} must divide over the "
                         f"{world} ranks")
    local = batch_size // world
    device = resolve_device(group.device if device is None else device)
    data = {k: torch.as_tensor(a).to(device) for k, a in data.items()}
    n = next(iter(data.values())).shape[0]
    state = init_state(model, vfl, key, device)
    pmodel, ex, _ = shard_wrap(model, ZOExchange.from_config(vfl), group)
    step_fn = STEP_FNS[algorithm]
    losses = []
    for t in range(steps):
        idx = batch_indices(key, t, batch_size, n, device)
        idx = idx[r * local:(r + 1) * local]
        batch = {k: a[idx] for k, a in data.items()}
        state, h = step_fn(pmodel, vfl, state, batch, ex)
        losses.append(h)
    return state, torch.stack(losses)
