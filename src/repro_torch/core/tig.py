"""TIG baseline: split learning that Transmits the Intermediate Gradient
(Liu et al. 2019a; Vepakomma et al. 2018), the paper's comparison
framework, as the reference's core/tig.py.

The structure is ZOO-VFL's (party towers -> server head), but the server
sends dL/dc_m back to party m, which chain-rules it through its local
model. Two consequences the paper measures:
  * TIG cannot train black-box models (no gradient exists through a black
    box): ``tig_train`` and ``HostTIGTrainer`` raise on black_box;
  * its per-round down-link is the intermediate gradient, B values, where
    ZOO-VFL sends scalars (Table 3).

Two executors:
  * ``tig_train``: the device trainer (convergence curves), a loop over
    steps on the device where the reference scans, the activated party
    m_t drawn as the port's asyrevel draws it;
  * ``HostTIGTrainer``: the host executor that routes every boundary
    crossing through core/wire.py and emits the ``grad_down`` Messages the
    privacy audits (core/privacy.py) read.

TIG is first order: the gradients come from ``torch.autograd.grad``
where the reference takes ``jax.grad`` and ``jax.vjp``. No kernel runs
here; the towers are plain products, as in the reference. autograd sums
in another order than XLA, so trajectories hold the reference's to a
tolerance, not bitwise.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.configs.base import VFLConfig
from repro_torch.core.async_host import party_rng_seed
from repro_torch.core.asyrevel import _activation_probs
from repro_torch.core.vfl import VFLModel
from repro_torch.core.wire import (SERVER, Channel, InMemoryChannel, Message,
                                   party, party_index)
from repro_torch.utils import prng, trees, xla_math
from repro_torch.utils.device import resolve_device


class TIGState(NamedTuple):
    w0: dict
    parties: dict          # stacked (q, ...)
    step: int
    key: tuple             # the run's key, a (k0, k1) uint32 pair


class BlackBoxError(RuntimeError):
    pass


BLACK_BOX = ("TIG requires dL/dc_m from the server and dc_m/dw_m through "
             "the local model; neither exists for black-box models. "
             "(ZOO-VFL/AsyREVEL needs only the function values.)")


def _leaves_with_grad(tree):
    """Detached copies of the tree's leaves that require grad, and the
    tree rebuilt on them."""
    ls = [a.detach().requires_grad_(True) for a in trees.leaves(tree)]
    return ls, trees.unflatten(tree, ls)


def _grads(out, leaves_):
    """d out / d leaves; a leaf the output does not reach gets zeros (the
    FCN's regularizer is the constant 0)."""
    if not torch.is_tensor(out) or not out.requires_grad:
        return [torch.zeros_like(a) for a in leaves_]
    gs = torch.autograd.grad(out, leaves_, allow_unused=True)
    return [torch.zeros_like(a) if g is None else g
            for a, g in zip(leaves_, gs)]


def tig_step(model: VFLModel, vfl: VFLConfig, state: TIGState, batch):
    """Asynchronous split-learning step: one party per iteration gets its
    intermediate gradient from the server and backprops locally. Returns
    (new_state, h)."""
    key = prng.fold_in(state.key, state.step)
    # Assumption 3's activation distribution, shared with AsyREVEL
    # (core/asyrevel.py), so baseline and treatment sample parties alike
    m_t = prng.categorical(prng.fold_name(key, "party"),
                           xla_math.log(_activation_probs(vfl)))
    x = model.party_args(batch)
    y = model.server_args(batch)

    w_leaves, w_m = _leaves_with_grad(
        trees.tree_map(lambda a: a[m_t], state.parties))
    s_leaves, w0 = _leaves_with_grad(state.w0)
    with torch.enable_grad():
        with torch.no_grad():
            cs = model.all_party_outputs(state.parties, x)
        c_m = model.party_forward(w_m, model.slice_features(x, m_t), m_t)
        cs = model.replace_party_output(cs, c_m, m_t)
        h = (model.server_forward(w0, cs, y)
             + vfl.lam * model.regularizer(w_m))
        g = _grads(h, w_leaves + s_leaves)
    g_m = trees.unflatten(w_m, g[:len(w_leaves)])
    g_0 = trees.unflatten(w0, g[len(w_leaves):])

    def add_row(a, gg):
        out = a.clone()
        out[m_t] = a[m_t] + (-vfl.lr_party * gg).to(a.dtype)
        return out
    parties = trees.tree_map(add_row, state.parties, g_m)
    w0_new = trees.tree_map(
        lambda a, gg: (a - vfl.lr_server * gg).to(a.dtype), state.w0, g_0)
    return TIGState(w0_new, parties, state.step + 1, state.key), h.detach()


def tig_train(model: VFLModel, vfl: VFLConfig, data, key, steps: int,
              batch_size: int, black_box: bool = False, device=None):
    """Train with TIG: ``steps`` iterations over random minibatches of
    ``data`` (a dict of arrays with a shared leading sample dim, moved to
    ``device`` once; None = the card), with the reference's keys (init
    split(key), batch keys split(fold_in(key, 11), steps)) and indices
    drawn on the device. Returns (final_state, per-step losses as one
    tensor). Black-box models raise: the intermediate gradient does not
    exist, the failure the paper's Fig. 3 shows."""
    if black_box:
        raise BlackBoxError(BLACK_BOX)
    device = resolve_device(device)
    data = {k: torch.as_tensor(a).to(device) for k, a in data.items()}
    n = next(iter(data.values())).shape[0]
    k0, k1 = prng.split(key)
    state = TIGState(model.init_server(k0, device),
                     model.init_parties_stacked(k1, device), 0, key)
    keys = prng.split(prng.fold_in(key, 11), steps)
    losses = []
    for k in keys:
        idx = prng.randint_on(k, (batch_size,), 0, n, device)
        state, h = tig_step(model, vfl, state,
                            {name: a[idx] for name, a in data.items()})
        losses.append(h)
    return state, torch.stack(losses)


# ------------------------------------------------------ host executor -----

def _tig_serve(model, w0, cs, y, lr_server: float):
    """Server side of one TIG round: loss, the per-sample intermediate
    gradient dL/dcs, and the server's own first-order update."""
    s_leaves, w0g = _leaves_with_grad(w0)
    csg = cs.detach().requires_grad_(True)
    with torch.enable_grad():
        h = model.server_forward(w0g, csg, y)
        *g0, g_cs = torch.autograd.grad(h, s_leaves + [csg])
    w0_new = trees.unflatten(w0, [(a - lr_server * g).to(a.dtype) for a, g
                                  in zip(trees.leaves(w0), g0)])
    return h.detach(), g_cs, w0_new


def _tig_party_apply(model, vfl: VFLConfig, w_m, x_m, g_c, m: int):
    """Party-side chain rule: pull the received intermediate gradient back
    through the local tower (the vjp), plus the private regularizer's
    gradient, and take the first-order step."""
    w_leaves, wg = _leaves_with_grad(w_m)
    with torch.enable_grad():
        out = model.party_forward(wg, x_m, m)
        g_w = torch.autograd.grad(out, w_leaves, grad_outputs=g_c,
                                  allow_unused=True)
        g_reg = _grads(model.regularizer(wg), w_leaves)
    g_w = [torch.zeros_like(a) if g is None else g
           for a, g in zip(w_leaves, g_w)]
    return trees.unflatten(w_m, [
        (a - vfl.lr_party * (g + vfl.lam * gr)).to(a.dtype)
        for a, g, gr in zip(trees.leaves(w_m), g_w, g_reg)])


class HostTIGTrainer:
    """Split-learning host executor over the wire layer, on one device.

    The shape of ``async_host.HostAsyncTrainer`` (a c table of the latest
    party outputs, per-party rounds, a shared channel), with TIG's
    protocol: party m uploads ``c_up``; the server replies with the
    per-sample intermediate gradient ``grad_down`` = dL/dc_m plus a
    monitoring ``loss_down`` scalar; the party chain-rules the gradient
    through its private tower. Every crossing is a typed Message with a
    host payload, so a ``RecordingChannel`` yields the transcript the
    privacy audits read: a ``grad_down`` stream here against a
    function-value stream for ZOO-VFL, on the same data and seeds.

    Scheduling is the deterministic serial round robin (``run``). ``dp``
    (a resolved DPConfig) defends the up-link with clip-then-noise
    (dp/mechanisms.py, keyed off (seed, party, round), so the numpy batch
    stream is untouched and dp=None stays exact); the grad_down leak is a
    down-link property it cannot touch. ``device=None`` is the card.
    """

    def __init__(self, model: VFLModel, vfl: VFLConfig, X, y,
                 batch_size: int = 32, seed: int = 0,
                 channel: Channel | None = None, black_box: bool = False,
                 sampler: str = "random", dp=None, device=None):
        if black_box:
            raise BlackBoxError(BLACK_BOX)
        assert sampler in ("random", "full")
        self.device = resolve_device(device)
        self.model, self.vfl = model, vfl
        self.X = torch.tensor(np.asarray(X, np.float32), device=self.device)
        self.y = np.asarray(y)
        self.y_dev = torch.as_tensor(self.y, device=self.device)
        self.batch_size = batch_size
        self.seed = seed
        self.sampler = sampler
        self.channel = channel if channel is not None else InMemoryChannel()
        q = model.num_parties
        keys = prng.split(prng.key(seed), q + 1)
        self.w0 = model.init_server(keys[0], self.device)
        self.party_w = [model.init_party(keys[m + 1], m, self.device)
                        for m in range(q)]
        self.c_table = np.zeros((len(self.y), q), np.float32)
        self.history: list[float] = []
        self._party_round = [0] * q
        self.dp = dp if (dp is not None and dp.enabled) else None

    def party_step(self, m: int, idx: np.ndarray):
        """One TIG round for party m: c_up -> (grad_down, loss_down) ->
        local backprop. Returns the round's loss."""
        from repro_torch.dp.mechanisms import defend_payload

        idx = np.asarray(idx)
        rnd = self._party_round[m]
        self._party_round[m] += 1
        x_m = self.model.slice_features(
            self.X[torch.as_tensor(idx, device=self.device)], m)
        with torch.no_grad():
            c_dev = self.model.party_forward(self.party_w[m], x_m, m)
        if self.dp is not None:
            k = prng.fold_name(prng.fold_in(
                prng.key(party_rng_seed(self.seed, m)), rnd), "dp_noise")
            c_dev = defend_payload(c_dev, k, self.dp)
        c = c_dev.float().cpu().numpy()
        me = party(m)
        msg_c = self.channel.send(Message.make(
            "c_up", me, SERVER, rnd, c, meta={"idx": idx}))

        # ---- server side -------------------------------------------------
        sm = party_index(msg_c.sender)
        sidx = msg_c.meta["idx"]
        self.c_table[sidx, sm] = np.asarray(msg_c.payload, np.float32)
        cs = torch.from_numpy(self.c_table[sidx]).to(self.device)
        y = self.y_dev[torch.as_tensor(sidx, device=self.device)]
        h, g_cs, self.w0 = _tig_serve(self.model, self.w0, cs, y,
                                      self.vfl.lr_server)
        g_m = g_cs[:, sm].float().cpu().numpy()      # dL/dc_m per sample
        h = float(h)
        self.history.append(h)
        msg_g = self.channel.send(Message.make(
            "grad_down", SERVER, me, rnd, g_m, meta={"idx": sidx}))
        msg_h = self.channel.send(Message.make(
            "loss_down", SERVER, me, rnd, (h,)))

        # ---- party side: chain rule through the private tower ------------
        g_c = torch.from_numpy(np.asarray(msg_g.payload)).to(self.device)
        self.party_w[m] = _tig_party_apply(
            self.model, self.vfl, self.party_w[m], x_m, g_c, m)
        return msg_h.scalars()[0]

    def run(self, rounds: int):
        """Deterministic serial round robin over parties, the reference
        schedule, as HostAsyncTrainer.run_serial's."""
        q = self.model.num_parties
        rngs = [np.random.default_rng(party_rng_seed(self.seed, m))
                for m in range(q)]
        n = len(self.y)
        for _ in range(rounds):
            for m in range(q):
                if self.sampler == "full":
                    idx = np.arange(min(self.batch_size, n))
                else:
                    idx = rngs[m].integers(0, n, self.batch_size)
                self.party_step(m, idx)
        return self.history
