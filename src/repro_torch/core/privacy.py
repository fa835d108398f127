"""Privacy security of ZOO-VFL (Theorem 1): attacks on recorded traffic,
as the reference's core/privacy.py.

Every attack here is a function of a ``core/wire.py`` Transcript filtered
to its threat model's OBSERVABLE VIEW, what crossed the wire in a recorded
executor run:

  * honest-but-curious party  -> ``curious_view``: the messages on its own
    links (its uploads and the server's replies to it);
  * curious server            -> its own view (every up-link);
  * colluding parties         -> ``colluding_view``: the pooled union of
    the colluders' views;
  * malicious party           -> the full curious view PLUS an injection
    capability (it may forge or replay messages; ``replay_backdoor_attack``).

Both sides of each attack are measured from transcripts of the two host
executors on the same data and seeds: against TIG/TG-style traffic
(``grad_down``/``param_down`` observed) the attack succeeds; against
ZOO-VFL traffic (function values only: ``c_up``, ``c_hat_up``,
``loss_down``) it collapses to chance or is unidentifiable. A federated
serving transcript (``serve_down`` queries, ``c_up`` answers) is audited
by ``serving_exposure_from_transcript``.

Attacks (paper Section 2.3):
  1. feature inference, honest-but-curious (Gu 2020 / Yang 2019b);
  2. label inference (Liu 2020) from the intermediate gradient, against
     the batch-mean losses ZOO-VFL sends down;
  3. reverse multiplication (Weng 2020, colluding), which needs the
     transmitted gradient;
  4. gradient-replacement backdoor (Liu 2020, malicious), replaying a
     recorded down-link message.

The attacks are numpy on the host. A payload or meta value that arrives
as a tensor (on the card or not) is brought to the host first, and a bf16
payload (uint16 bit patterns on the port's wire) decodes as the server
decodes it. ``backdoor_update_influence`` draws its directions through
``utils.prng.normal``, bitwise jax's.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import wire
from repro_torch.core.wire import Transcript, canonical_round
from repro_torch.utils import prng


def _host(x) -> np.ndarray:
    """A payload or meta leaf as a host numpy array: tensors come off
    their device (bf16 as f32 values), numpy and scalars pass through."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


# ------------------------------------------------------ threat-model views -

def curious_view(transcript: Transcript, endpoint: str) -> Transcript:
    """Honest-but-curious adversary at ``endpoint`` (a party name from
    ``wire.party(m)`` or ``wire.SERVER``): it observes exactly the
    messages on its own links."""
    return transcript.view(endpoint)


def colluding_view(transcript: Transcript, parties) -> Transcript:
    """Colluding parties pool their individual views (Weng 2020's RMA
    setting); the result is still only their own links — collusion does
    not conjure messages nobody received."""
    return transcript.pooled_view([wire.party(m) for m in parties])


# ---------------------------------------------------------------- attack 1 -

def feature_inference_attack(z_rounds, x_dim: int):
    """Least-squares recovery of x from observed per-round z_i = w_t^T x_i.

    z_rounds: (T, n) observations for T rounds, n samples — the adversary
    ALSO needs the w_t to set up the linear system; under ZOO-VFL it does not
    have them, so the best it can do is treat w_t as unknowns too:
    T*n equations, T*d + n*d unknowns -> underdetermined for d > 1.
    Returns the (under)determination ratio; < 1 means provably unsolvable.
    """
    T, n = z_rounds.shape
    equations = T * n
    unknowns = T * x_dim + n * x_dim
    return equations / unknowns


def feature_inference_with_grads(ws, zs, x_true):
    """The SAME attack when the framework leaks w_t (TG-style): now it is an
    ordinary linear solve — returns the recovery error (≈0 => leak)."""
    W = np.stack(ws)                     # (T, d)
    z = np.stack(zs)                     # (T, n)
    x_rec, *_ = np.linalg.lstsq(W, z, rcond=None)   # (d, n)
    err = np.linalg.norm(x_rec.T - x_true) / np.linalg.norm(x_true)
    return float(err)


def feature_inference_from_transcript(transcript: Transcript, x_dim: int,
                                      m: int = 0) -> dict:
    """Curious-server feature inference against party m, from its recorded
    up-link. The adversary counts what it actually observed: every
    (round, sample) c value is one equation; the unknowns are the n
    distinct samples' features plus — unless ``param_down`` leaked the
    party parameters — one w_t per observed round. Returns the
    equations/unknowns ratio (< 1: provably underdetermined) and whether
    the system is solvable."""
    view = curious_view(transcript, wire.SERVER)
    ups = view.filter(kind="c_up", sender=wire.party(m))
    sample_ids: set = set()
    equations = 0
    for msg in ups:
        idx = _host(msg.meta["idx"]).reshape(-1)
        sample_ids.update(int(i) for i in idx)
        equations += idx.size
    T, n = len(ups), len(sample_ids)
    params_leak = "param_down" in transcript.kinds()
    unknowns = n * x_dim + (0 if params_leak else T * x_dim)
    ratio = equations / max(unknowns, 1)
    return {"rounds": T, "samples": n, "equations": equations,
            "unknowns": unknowns, "ratio": ratio,
            "params_leaked": params_leak,
            "solvable": params_leak or ratio >= 1.0}


# ---------------------------------------------------------------- attack 2 -

def label_inference_from_intermediate_grads(g, y_true):
    """TIG leak: for CE-style losses, dL/dH_i is negative on the true-label
    coordinate (softmax(p)-onehot(y)) or sign-coupled to y in the binary
    case. Returns attack accuracy (1.0 => total leak)."""
    g = _host(g)
    if g.ndim == 1:                       # binary: g_i = -y * sigma(-y z)
        pred = -np.sign(g)
        return float(np.mean(pred == np.sign(_host(y_true))))
    pred = np.argmin(g, axis=-1)          # multiclass: most-negative coord
    return float(np.mean(pred == _host(y_true)))


def label_inference_from_function_values(h, y_true, rng=None):
    """ZOO-VFL observable: per-round scalars h (and h_bar). They aggregate
    over the whole minibatch and are label-permutation symmetric — the
    adversary's best estimator is chance. We simulate the strongest simple
    adversary (threshold on h) and return its accuracy."""
    rng = rng or np.random.default_rng(0)
    h = np.asarray(h, np.float64)
    y = np.sign(_host(y_true))
    # h is a SINGLE scalar per round shared by all samples in the batch:
    # any per-sample decision derived from it is constant within the batch.
    thresh = np.median(h)
    pred = np.where(h[:, None] > thresh, 1.0, -1.0)
    acc = np.mean(pred == y[None, :])
    return float(acc)


def _decode_c_payload(payload) -> np.ndarray:
    """Decode a recorded c_up wire payload codec-agnostically: f32 arrays
    as they are, bf16 (uint16 bit patterns on the host wire) widened to
    f32, the int8 codec's (values, scale) pair rescaled. The adversary
    sees the wire object, so it decodes like the server."""
    if isinstance(payload, (tuple, list)) and len(payload) == 2 \
            and np.ndim(_host(payload[1])) == 0:
        q, scale = (_host(p) for p in payload)
        return q.astype(np.float32) * np.float32(scale)
    p = _host(payload)
    if p.dtype == np.uint16:
        return (p.astype(np.uint32) << 16).view(np.float32)
    return p.astype(np.float32)


def label_inference_from_uploads(transcript: Transcript, y_true) -> dict:
    """Curious SERVER-side label inference from the up-link itself: the
    per-sample c values are partial logits (c_{i,m} = F_m(x_{i,m})), so
    an adversary at the seam — a compromised server-side component, or
    anyone reading the recorded up-link before label custody — sums each
    sample's freshest per-party c values and thresholds the result. On a
    trained model this reads the prediction (hence the label) straight
    off the wire; it is THE attack the codec-seam DP defense (dp/) is
    calibrated against, and its accuracy against epsilon is the measured
    privacy side of the defense's frontier. Sign convention follows
    the paper's LR loss log(1+exp(-y z)): positive aggregate -> y=+1."""
    ups = transcript.view(wire.SERVER).filter(kind="c_up")
    latest: dict[tuple, float] = {}
    for msg in ups:
        m = wire.party_index(msg.sender)
        vals = _decode_c_payload(msg.payload).reshape(-1)
        idx = _host(msg.meta["idx"]).reshape(-1)
        for i, v in zip(idx, vals):
            latest[(int(i), m)] = float(v)
    samples = sorted({i for i, _ in latest})
    parties = sorted({m for _, m in latest})
    if not samples:
        return {"accuracy": 0.5, "samples": 0, "messages": 0,
                "observable": "c_up"}
    y = np.sign(_host(y_true).astype(np.float64))
    logits = np.array([sum(latest.get((i, m), 0.0) for m in parties)
                       for i in samples])
    pred = np.where(logits >= 0, 1.0, -1.0)
    acc = float(np.mean(pred == y[np.asarray(samples)]))
    return {"accuracy": acc, "samples": len(samples),
            "messages": len(ups), "observable": "c_up"}


def label_inference_attack(transcript: Transcript, y_true,
                           m: int = 0) -> dict:
    """Honest-but-curious party m infers training labels from its OWN
    down-link. If the framework sent it intermediate gradients
    (``grad_down``), each per-sample gradient votes for a label; if it
    only ever received scalar losses (``loss_down``), the strongest
    simple estimator thresholds the loss series. Returns the accuracy
    and which observable it came from."""
    view = curious_view(transcript, wire.party(m))
    y_true = _host(y_true)
    grads = view.filter(kind="grad_down", receiver=wire.party(m))
    if len(grads):
        hits = total = 0
        for msg in grads:
            idx = _host(msg.meta["idx"]).reshape(-1)
            acc = label_inference_from_intermediate_grads(
                _host(msg.payload), y_true[idx])
            hits += acc * idx.size
            total += idx.size
        return {"accuracy": hits / max(total, 1), "observable": "grad_down",
                "messages": len(grads)}
    losses = view.filter(kind="loss_down", receiver=wire.party(m))
    h = np.asarray([msg.scalars()[0] for msg in losses])
    return {"accuracy": label_inference_from_function_values(h, y_true),
            "observable": "loss_down", "messages": len(losses)}


# ---------------------------------------------------------------- attack 3 -

def reverse_multiplication_attack(z_t, z_tm1, eta, g_t=None):
    """RMA: x_i = (z_{t-1,i} - z_{t,i}) / (eta * g_t). Feasible ONLY with
    g_t. Returns recovered x when g_t is given, else None (ZOO-VFL case:
    the quantity the attack divides by was never transmitted)."""
    if g_t is None:
        return None
    return (_host(z_tm1) - _host(z_t)) / (eta * _host(g_t))


def reverse_multiplication_from_transcript(transcript: Transcript,
                                           eta: float,
                                           colluders=(0,)) -> dict:
    """Colluding RMA against the first colluder's block: find two
    successive ``c_up`` rounds sharing sample ids and the ``grad_down``
    between them, then divide. Without a transmitted gradient the divisor
    was never on the wire — the pooled view cannot supply it and the
    attack returns recovered=None."""
    m = colluders[0]
    view = colluding_view(transcript, colluders)
    ups = list(view.filter(kind="c_up", sender=wire.party(m)))
    grads = {msg.round: msg
             for msg in view.filter(kind="grad_down",
                                    receiver=wire.party(m))}
    for prev, cur in zip(ups, ups[1:]):
        i_prev = _host(prev.meta["idx"]).reshape(-1)
        i_cur = _host(cur.meta["idx"]).reshape(-1)
        if not np.array_equal(i_prev, i_cur):
            continue
        g_msg = grads.get(prev.round)
        if g_msg is None:
            return {"recovered": None, "feasible": False,
                    "reason": "no grad_down on the wire"}
        rec = reverse_multiplication_attack(
            _host(cur.payload), _host(prev.payload), eta,
            g_t=_host(g_msg.payload))
        return {"recovered": rec, "feasible": True, "round": prev.round}
    return {"recovered": None, "feasible": False,
            "reason": "no aligned successive rounds observed"}


# ---------------------------------------------------------------- attack 4 -

def backdoor_update_influence(lr: float, mu: float, h_replay: float,
                              h_true: float, w_dim: int, key=None):
    """Gradient-replacement backdoor, adapted to what a malicious party CAN
    do in ZOO-VFL: replay a stale/forged scalar h. The induced parameter
    deviation is ||lr * ((h_replay-h_true)/mu) * u|| with u RANDOM — the
    adversary cannot point it at a trigger direction. Returns (norm of the
    deviation, cosine similarity to an adversary-chosen target direction).
    """
    key = key if key is not None else prng.key(0)
    k1, k2 = prng.split(key)
    u = prng.normal(k1, (w_dim,), "cpu")
    target = prng.normal(k2, (w_dim,), "cpu")
    # the Python-float factor meets the f32 draw as an f32 scalar, as a
    # weakly typed jax scalar does
    dev = float(np.float32(lr * (h_replay - h_true) / mu)) * u
    cos = torch.dot(dev, target) / (torch.linalg.norm(dev)
                                    * torch.linalg.norm(target) + 1e-12)
    return float(torch.linalg.norm(dev)), float(torch.abs(cos))


def replay_backdoor_attack(transcript: Transcript, lr: float, mu: float,
                           w_dim: int, m: int = 0, key=None) -> dict:
    """Malicious party m: full curious view PLUS injection — it replays a
    stale recorded down-link message in place of the fresh one (the
    injection hook; the forged message is what gradient-replacement
    backdoors do to ``grad_down`` traffic). When the only replayable
    observable is a ``loss_down`` scalar, the induced deviation is a
    random-direction nudge with |cos| ~ 1/sqrt(d) to ANY attacker target:
    no direction control. When ``grad_down`` is on the wire the attacker
    replays the gradient itself and steers the update exactly (cos = 1 to
    the recorded direction)."""
    view = curious_view(transcript, wire.party(m))
    grads = view.filter(kind="grad_down", receiver=wire.party(m))
    if len(grads):
        g = _host(grads[0].payload).astype(np.float64).reshape(-1)
        # replaying the recorded gradient reproduces it exactly: the
        # victim's update direction IS the attacker-chosen payload
        cos = 1.0 if np.linalg.norm(g) > 0 else 0.0
        return {"observable": "grad_down", "direction_control": True,
                "cos_to_target": cos}
    losses = view.filter(kind="loss_down", receiver=wire.party(m))
    h = [msg.scalars()[0] for msg in losses]
    if len(h) < 2:
        raise ValueError("transcript too short for a replay attack")
    dev, cos = backdoor_update_influence(lr, mu, h_replay=h[0],
                                         h_true=h[-1], w_dim=w_dim,
                                         key=key)
    return {"observable": "loss_down", "direction_control": False,
            "cos_to_target": cos, "deviation_norm": dev}


# ----------------------------------------------------------------- serving -

def serving_exposure_from_transcript(transcript: Transcript) -> dict:
    """Threat-model coverage of the federated INFERENCE round
    (serving/federated.py): what a recorded serving transcript exposes.

    The server->party ``serve_down`` query carries only int32 sample ids
    — the entity alignment every VFL round already presumes both
    endpoints share (the same class of protocol context as the ``idx``
    meta on training uploads), never features, labels, or model state.
    The party's batched answer is an ordinary ``c_up``, so a curious
    adversary at the seam observes exactly the upload class the attacks
    above already read: ``label_inference_from_uploads`` runs UNCHANGED
    on a serving transcript (its per-sample c values are partial logits
    of the served predictions), and the feature-inference counting of
    ``feature_inference_from_transcript`` applies as-is. No gradient,
    parameter, or label ever rides the serving round."""
    kinds = transcript.kinds()
    return {
        "serve_query_ids": "serve_down" in kinds,
        "function_values": "c_up" in kinds,
        "intermediate_grads": "grad_down" in kinds,    # never in serving
        "model_params": "param_down" in kinds,         # never in serving
        "messages": {k: len(transcript.filter(kind=k).messages)
                     for k in sorted(kinds)},
    }


# ---------------------------------------------------------------- exposure -

def exposure_from_transcript(transcript: Transcript) -> dict:
    """Paper Table 1, derived from the observed message kinds instead of a
    hard-coded table: what this transcript structurally exposed.
    ``local_grads`` is exposed when parameter blocks crossed the wire in
    two or more rounds — successive snapshots reveal the applied gradient
    as (w_t - w_{t-1}) / lr (the RMA argument)."""
    kinds = transcript.kinds()
    param_rounds = {msg.round for msg in transcript
                    if msg.kind == "param_down"}
    return {
        "model_params": "param_down" in kinds,
        "intermediate_grads": "grad_down" in kinds,
        "local_grads": len(param_rounds) >= 2,
        "function_values": bool(kinds & {"loss_down", "c_up", "c_hat_up"}),
    }


def exposure_report(framework: str) -> dict:
    """Table-1 exposure of a framework NAME: generate its canonical
    per-round wire pattern (core/wire.py) for two rounds and derive the
    exposure from the kinds that cross — the structural claim, computed
    the same way as for a recorded transcript."""
    t = Transcript()
    for rnd in range(2):
        for msg in canonical_round(framework, rnd=rnd):
            t.append(msg)
    return exposure_from_transcript(t)
