"""Online health engine: score streaming trace records against anomaly
detectors and emit structured alerts with (party, round) identities.

The engine is transport-agnostic pure-Python state over the tracer's
record schema (obs/tracer.py): feed it records one at a time — live from
``obs.monitor.MonitorServer`` as they arrive over the side socket, or
post-hoc by replaying merged trace files (``obs.live --snapshot``). It
never touches the protocol: detectors read the same out-of-band records
the Perfetto merge reads, so arming them cannot perturb a single bit of
the run (pinned by the monitored-parity tests).

Detectors (thresholds documented in docs/observability.md):

  straggler    party_round EWMA >> median of the other parties' EWMAs
  divergence   loss gauge went non-finite, or rose for ``patience``
               consecutive observations above ``factor`` x running min
  dp_burn      cumulative epsilon overran the calibrated target, or the
               current burn slope projects past it with margin before
               the expected release count is reached
  byte_drift   a wire kind's nbytes changed from its analytic (or
               first-seen) per-kind size — payload shape drift
  rtt          heartbeat RTT degraded far beyond its own baseline
  chain_decay  party->wire->server chain completeness (the >=95%
               acceptance metric, computed online with a settle window)

False-positive discipline: every detector has warmup/settle guards and
fires once per (detector, identity) episode — the straggler e2e test
pins that a clean run raises ZERO alerts on the same seeds.
"""
from __future__ import annotations

import math
from collections import defaultdict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional


@dataclass
class Alert:
    """One structured anomaly: which detector, who, when, how bad."""
    detector: str
    severity: str               # "warning" | "critical"
    message: str
    party: Optional[int] = None
    round: Optional[int] = None
    value: float = 0.0
    threshold: float = 0.0

    def asdict(self) -> dict:
        d = {"detector": self.detector, "severity": self.severity,
             "message": self.message, "value": float(self.value),
             "threshold": float(self.threshold)}
        if self.party is not None:
            d["party"] = int(self.party)
        if self.round is not None:
            d["round"] = int(self.round)
        return d


def _finite(v) -> bool:
    try:
        return math.isfinite(float(v))
    except (TypeError, ValueError):
        return False


# ---------------------------------------------------------------------------
# detectors
# ---------------------------------------------------------------------------

class StragglerDetector:
    """Per-party LOCAL round-latency EWMA vs the median of the others.

    Scores ``party_round`` minus the round's ``party_wait_reply`` — the
    time the party itself spent computing/stalling, not the time it
    waited on the server. The distinction is what makes the detector
    work under the serial dispatch schedule, where one slow party
    head-of-line-blocks the whole federation and every party's raw
    round duration equalizes: the straggler's round is local time, the
    victims' rounds are wait time.

    The first ``skip_first`` rounds per party are ignored outright (jit
    compilation lands there for every party and would poison the EWMA),
    then ``warmup`` samples must accumulate before scoring. A party is a
    straggler when its EWMA exceeds ``factor`` x the median of the other
    warmed-up parties AND the absolute gap exceeds ``min_gap_s`` — the
    ratio alone would flag microsecond jitter between healthy parties.
    Fires once per episode; re-arms when the party drops back under half
    the firing threshold."""

    name = "straggler"

    def __init__(self, factor: float = 3.0, min_gap_s: float = 0.05,
                 alpha: float = 0.3, warmup: int = 3, skip_first: int = 1):
        self.factor = factor
        self.min_gap_s = min_gap_s
        self.alpha = alpha
        self.warmup = warmup
        self.skip_first = skip_first
        self._ewma: Dict[int, float] = {}
        self._count: Dict[int, int] = defaultdict(int)
        self._wait: Dict[tuple, float] = {}
        self._pid: Dict[int, object] = {}
        self._fired: set = set()

    def feed(self, rec: dict) -> List[Alert]:
        if rec.get("ev") != "span" or "party" not in rec:
            return []
        m = int(rec["party"])
        if rec.get("name") == "party_wait_reply":
            # nested span: ends (and therefore arrives) before its round
            self._wait[(m, rec.get("round"))] = float(rec["dur"])
            return []
        if rec.get("name") != "party_round":
            return []
        pid = rec.get("pid")
        if pid is not None and self._pid.get(m, pid) != pid:
            # rejoin: a fresh process re-pays jit compilation, so the
            # skip_first/warmup discipline starts over for this party
            self._count[m] = 0
        self._pid[m] = pid
        self._count[m] += 1
        wait = self._wait.pop((m, rec.get("round")), 0.0)
        if self._count[m] <= self.skip_first:
            return []
        dur = max(0.0, float(rec["dur"]) - wait)
        prev = self._ewma.get(m)
        self._ewma[m] = dur if prev is None else \
            self.alpha * dur + (1 - self.alpha) * prev
        if self._count[m] - self.skip_first < self.warmup:
            return []
        others = [e for p, e in self._ewma.items()
                  if p != m and self._count[p] - self.skip_first
                  >= self.warmup]
        if not others:
            return []
        ref = sorted(others)[len(others) // 2]
        thresh = max(self.factor * ref, ref + self.min_gap_s)
        if self._ewma[m] > thresh:
            if m in self._fired:
                return []
            self._fired.add(m)
            return [Alert(
                self.name, "warning",
                f"party {m} local round EWMA {self._ewma[m]:.3f}s vs "
                f"peer median {ref:.3f}s (> {self.factor:.1f}x and "
                f"+{self.min_gap_s:.2f}s)",
                party=m, round=int(rec.get("round", -1)),
                value=self._ewma[m], threshold=thresh)]
        if m in self._fired and self._ewma[m] < 0.5 * thresh:
            self._fired.discard(m)           # recovered: re-arm
        return []


class DivergenceDetector:
    """Loss-trend / NaN divergence on ``loss`` gauges (and any metric
    record carrying an ``h`` objective). Non-finite fires critically at
    once; a finite loss must sit above ``factor`` x its running minimum
    for ``patience`` consecutive observations to fire — a noisy but
    descending ZO trajectory never does."""

    name = "divergence"

    def __init__(self, factor: float = 2.0, patience: int = 3,
                 floor: float = 1e-9):
        self.factor = factor
        self.patience = patience
        self.floor = floor
        self._min: Dict[Optional[int], float] = {}
        self._bad: Dict[Optional[int], int] = defaultdict(int)
        self._fired: set = set()

    def _value(self, rec: dict):
        if rec.get("ev") == "gauge" and rec.get("name") == "loss":
            return rec.get("value")
        if rec.get("ev") == "metric" and "h" in rec:
            return rec.get("h")
        return None

    def feed(self, rec: dict) -> List[Alert]:
        v = self._value(rec)
        if v is None:
            return []
        key = rec.get("party")
        rnd = int(rec.get("round", rec.get("step", -1)))
        if not _finite(v):
            if ("nan", key) in self._fired:
                return []
            self._fired.add(("nan", key))
            return [Alert(self.name, "critical",
                          f"non-finite loss ({v!r})",
                          party=key, round=rnd, value=float("nan"))]
        v = float(v)
        lo = self._min.get(key)
        if lo is None or v < lo:
            self._min[key] = v
            self._bad[key] = 0
            return []
        thresh = max(self.factor * lo, self.floor)
        if v > thresh:
            self._bad[key] += 1
            if self._bad[key] >= self.patience and \
                    ("trend", key) not in self._fired:
                self._fired.add(("trend", key))
                return [Alert(
                    self.name, "warning",
                    f"loss {v:.4g} > {self.factor:.1f}x running min "
                    f"{lo:.4g} for {self._bad[key]} consecutive reads",
                    party=key, round=rnd, value=v, threshold=thresh)]
        else:
            self._bad[key] = 0
        return []


class DPBurnDetector:
    """DP epsilon burn-rate vs the calibrated per-party target.

    Two triggers on ``dp_epsilon`` gauges: (a) overrun — the cumulative
    spend exceeded ``target`` x ``overrun_margin`` (critical); (b)
    projection — after ``warmup_frac`` of the expected releases, the
    CURRENT slope extrapolated to the expected release count lands past
    ``target`` x ``proj_margin`` (warning). RDP epsilon is concave in
    the release count, so a linear projection from the current slope
    OVERestimates the final spend — ``proj_margin`` absorbs exactly that
    bias, which is why a correctly calibrated run (final spend inside
    [0.95 target, target]) stays silent."""

    name = "dp_burn"

    def __init__(self, target: Optional[float] = None,
                 expected_releases: Optional[int] = None,
                 overrun_margin: float = 1.02, proj_margin: float = 1.5,
                 warmup_frac: float = 0.25):
        self.target = target
        self.expected = expected_releases
        self.overrun_margin = overrun_margin
        self.proj_margin = proj_margin
        self.warmup_frac = warmup_frac
        self._prev: Dict[Optional[int], tuple] = {}   # party -> (rel, eps)
        self._fired: set = set()

    def feed(self, rec: dict) -> List[Alert]:
        if rec.get("ev") != "gauge" or rec.get("name") != "dp_epsilon":
            return []
        if self.target is None or not _finite(self.target):
            return []
        party = rec.get("party")
        eps = float(rec["value"])
        rel = int(rec.get("releases", 0))
        out: List[Alert] = []
        if eps > self.target * self.overrun_margin and \
                ("overrun", party) not in self._fired:
            self._fired.add(("overrun", party))
            out.append(Alert(
                self.name, "critical",
                f"epsilon {eps:.3f} overran target {self.target:.3f}",
                party=party, round=rec.get("round"),
                value=eps, threshold=self.target * self.overrun_margin))
        prev = self._prev.get(party)
        self._prev[party] = (rel, eps)
        if (self.expected and prev is not None
                and rel > prev[0]
                and rel >= self.warmup_frac * self.expected
                and rel < self.expected):
            slope = (eps - prev[1]) / (rel - prev[0])
            proj = eps + slope * (self.expected - rel)
            thresh = self.target * self.proj_margin
            if proj > thresh and ("proj", party) not in self._fired:
                self._fired.add(("proj", party))
                out.append(Alert(
                    self.name, "warning",
                    f"burn rate projects epsilon {proj:.3f} at "
                    f"{self.expected} releases (target {self.target:.3f})",
                    party=party, value=proj, threshold=thresh))
        return out


class ByteDriftDetector:
    """Measured-vs-analytic per-kind wire bytes. ``expected`` maps kind
    -> analytic nbytes (from the VFL spec's wire model); kinds absent
    from the map baseline on their first-seen size. Receiver-side
    re-accounting records (observed=True) are skipped — they duplicate
    the send-side bytes. Serving payloads legitimately vary with batch
    occupancy, so serving monitors construct the engine with this
    detector disabled."""

    name = "byte_drift"

    def __init__(self, expected: Optional[Dict[str, int]] = None):
        self.expected: Dict[str, int] = dict(expected or {})
        self._fired: set = set()

    def feed(self, rec: dict) -> List[Alert]:
        if rec.get("ev") != "wire" or rec.get("observed"):
            return []
        kind = rec["kind"]
        nbytes = int(rec["nbytes"])
        want = self.expected.get(kind)
        if want is None:
            self.expected[kind] = nbytes       # first-seen baseline
            return []
        if nbytes == int(want) or kind in self._fired:
            return []
        self._fired.add(kind)
        return [Alert(
            self.name, "warning",
            f"wire kind '{kind}' measured {nbytes} B vs expected "
            f"{int(want)} B (sender {rec.get('sender')})",
            round=rec.get("round"), value=nbytes, threshold=want)]


class RttDetector:
    """Heartbeat-RTT degradation vs the peer's own baseline (median of
    the first ``baseline_n`` samples). Fires when an RTT exceeds both
    ``factor`` x baseline and ``min_rtt_s`` — the absolute floor keeps
    loopback-microsecond noise from tripping the ratio."""

    name = "rtt"

    def __init__(self, factor: float = 4.0, min_rtt_s: float = 0.25,
                 baseline_n: int = 3):
        self.factor = factor
        self.min_rtt_s = min_rtt_s
        self.baseline_n = baseline_n
        self._samples: Dict[str, List[float]] = defaultdict(list)
        self._baseline: Dict[str, float] = {}
        self._fired: set = set()

    def feed(self, rec: dict) -> List[Alert]:
        if rec.get("ev") != "histo" or rec.get("name") != "heartbeat_rtt_s":
            return []
        peer = str(rec.get("peer"))
        v = float(rec["value"])
        base = self._baseline.get(peer)
        if base is None:
            xs = self._samples[peer]
            xs.append(v)
            if len(xs) >= self.baseline_n:
                self._baseline[peer] = sorted(xs)[len(xs) // 2]
            return []
        thresh = max(self.factor * base, self.min_rtt_s)
        if v > thresh:
            if peer in self._fired:
                return []
            self._fired.add(peer)
            return [Alert(
                self.name, "warning",
                f"heartbeat RTT to {peer} hit {v:.3f}s "
                f"(baseline {base:.4f}s)",
                value=v, threshold=thresh)]
        if peer in self._fired and v < 0.5 * thresh:
            self._fired.discard(peer)
        return []


class ChainDecayDetector:
    """Online chain completeness: every ``server_handle`` for round r
    checks the chain of round ``r - settle`` (party_round span + c_up
    wire + server_handle) — the settle window absorbs cross-socket
    arrival skew. Fires when the running completeness over at least
    ``min_checked`` chains decays below ``threshold`` (95% is the
    acceptance gate); re-arms on recovery."""

    name = "chain_decay"

    def __init__(self, threshold: float = 0.95, settle: int = 2,
                 min_checked: int = 5):
        self.threshold = threshold
        self.settle = settle
        self.min_checked = min_checked
        self._party: set = set()
        self._wire: set = set()
        self._server: set = set()
        self._checked = 0
        self._complete = 0
        self._fired = False

    def feed(self, rec: dict) -> List[Alert]:
        ev = rec.get("ev")
        if ev == "span" and rec.get("name") == "party_round" \
                and "party" in rec:
            self._party.add((int(rec["party"]), int(rec["round"])))
            return []
        if ev == "wire" and rec.get("kind") == "c_up" \
                and not rec.get("observed"):
            sender = str(rec.get("sender", ""))
            if sender.startswith("party:"):
                self._wire.add((int(sender.split(":", 1)[1]),
                                int(rec["round"])))
            return []
        if ev != "span" or rec.get("name") != "server_handle" \
                or "party" not in rec:
            return []
        ident = (int(rec["party"]), int(rec["round"]))
        self._server.add(ident)
        due = (ident[0], ident[1] - self.settle)
        if due[1] < 0:
            return []
        self._checked += 1
        if due in self._party and due in self._wire and due in self._server:
            self._complete += 1
        frac = self._complete / self._checked
        if self._checked >= self.min_checked and frac < self.threshold:
            if self._fired:
                return []
            self._fired = True
            return [Alert(
                self.name, "warning",
                f"chain completeness decayed to {frac:.1%} "
                f"({self._complete}/{self._checked} checked)",
                party=due[0], round=due[1],
                value=frac, threshold=self.threshold)]
        if self._fired and frac >= self.threshold:
            self._fired = False
        return []


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

class HealthEngine:
    """Feed records, collect alerts, expose a dashboard snapshot.

    Construct directly for full control over detector tuning, or via
    ``engine_from_spec`` to derive the DP target / expected releases /
    analytic byte sizes from the run's spec. Thread-compatible: callers
    that feed from multiple reader threads (obs.monitor) serialize
    around their own lock."""

    def __init__(self, detectors: Optional[list] = None, *,
                 dp_target: Optional[float] = None,
                 dp_expected_releases: Optional[int] = None,
                 expected_bytes: Optional[Dict[str, int]] = None,
                 byte_drift: bool = True):
        if detectors is None:
            detectors = [
                StragglerDetector(),
                DivergenceDetector(),
                DPBurnDetector(target=dp_target,
                               expected_releases=dp_expected_releases),
                RttDetector(),
                ChainDecayDetector(),
            ]
            if byte_drift:
                detectors.insert(3, ByteDriftDetector(expected_bytes))
        self.detectors = detectors
        self.alerts: List[Alert] = []
        self.records = 0
        self._parties: Dict[int, dict] = defaultdict(lambda: {
            "rounds": 0, "ewma_s": None, "staleness_max": 0,
            "rtt_s": None, "epsilon": None, "loss": None,
            "_handle_ts": deque(maxlen=16),
        })

    # -- streaming ----------------------------------------------------------
    def feed(self, rec: dict) -> List[Alert]:
        self.records += 1
        self._observe(rec)
        out: List[Alert] = []
        for det in self.detectors:
            out.extend(det.feed(rec))
        self.alerts.extend(out)
        return out

    def _observe(self, rec: dict) -> None:
        ev = rec.get("ev")
        name = rec.get("name")
        party = rec.get("party")
        if party is None:
            return
        try:
            st = self._parties[int(party)]
        except (TypeError, ValueError):
            return
        if ev == "span" and name == "server_handle":
            st["rounds"] = max(st["rounds"], int(rec["round"]) + 1)
            st["_handle_ts"].append(float(rec["ts"]))
        elif ev == "span" and name == "party_round":
            dur = float(rec["dur"])
            prev = st["ewma_s"]
            st["ewma_s"] = dur if prev is None else 0.3 * dur + 0.7 * prev
        elif ev == "histo" and name == "staleness":
            st["staleness_max"] = max(st["staleness_max"],
                                      int(rec["value"]))
        elif ev == "histo" and name == "heartbeat_rtt_s":
            st["rtt_s"] = float(rec["value"])
        elif ev == "gauge" and name == "dp_epsilon":
            st["epsilon"] = float(rec["value"])
        elif ev == "gauge" and name == "loss":
            st["loss"] = float(rec["value"])

    # -- dashboard ----------------------------------------------------------
    def snapshot(self) -> dict:
        parties = {}
        for m in sorted(self._parties):
            st = self._parties[m]
            ts = st["_handle_ts"]
            rate = None
            if len(ts) >= 2 and ts[-1] > ts[0]:
                rate = (len(ts) - 1) / (ts[-1] - ts[0])
            parties[str(m)] = {
                "rounds": st["rounds"],
                "rate_per_s": rate,
                "ewma_s": st["ewma_s"],
                "staleness_max": st["staleness_max"],
                "rtt_s": st["rtt_s"],
                "epsilon": st["epsilon"],
                "loss": st["loss"],
            }
        return {"records": self.records,
                "parties": parties,
                "alerts": [a.asdict() for a in self.alerts]}


def engine_from_spec(spec: dict, rounds: int, *,
                     byte_drift: bool = True) -> HealthEngine:
    """A HealthEngine tuned from a federation spec (the dict the harness
    and launch CLI already build): the DP burn detector gets the
    calibrated per-party epsilon target and the expected release count
    (rounds x (1 + num_directions) uploads per party under AsyREVEL's
    one-loss-plus-K-perturbations round shape)."""
    vfl = dict(spec.get("vfl") or {})
    dp = vfl.get("dp")
    if dp is not None and not isinstance(dp, dict):
        import dataclasses
        dp = dataclasses.asdict(dp)
    target = (dp or {}).get("epsilon")
    expected = None
    if target is not None and _finite(target):
        target = float(target)
        k = int(vfl.get("num_directions", 1) or 1)
        expected = int(rounds) * (1 + k)
    else:
        target = None
    return HealthEngine(dp_target=target, dp_expected_releases=expected,
                        byte_drift=byte_drift)
