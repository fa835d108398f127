"""RDP / moments accounting for the codec-seam releases: the port's own
copy of the reference's dp/accountant.py (numpy and math only), function
for function, so a calibrated sigma and a spent epsilon are the same
float64 numbers in both packages (docs/dp.md).

Release schedule
----------------

One party round uploads (1 + K) payloads (the base c plus one c_hat per
direction), every entry clipped to C and noised with scale sigma*C
(mechanisms.py). Sample i contributes one entry per payload, so a run of
T rounds is a SEQUENTIAL composition of N = T * (1 + K) mechanism
applications on that sample's data — per party. Across the M parties the
feature blocks are DISJOINT (vertical partition): party m's releases are
the only ones that depend on x_i^{(m)}, so the M parties compose in
PARALLEL and the per-party epsilon IS the guarantee for each feature
block (``composition='parallel'``, the default). A worst-case adversary
model that charges every party's releases against one budget is
available as ``composition='sequential'``.

Mechanisms (sensitivity Delta = C, noise scale sigma*C, so everything
below is in units of the noise multiplier sigma):

  gaussian  RDP(alpha) = alpha / (2 sigma^2) per release (Mironov 2017),
            composed additively over N releases, then converted to
            (eps, delta)-DP by eps = min_alpha [N*RDP(alpha)
            + log(1/delta)/(alpha - 1)] over a standard alpha grid.
  laplace   RDP(alpha) of Lap(b = sigma*Delta) (Mironov 2017, Table II):
            (1/(alpha-1)) * log( alpha/(2 alpha - 1) * e^{(alpha-1)/sigma}
            + (alpha-1)/(2 alpha - 1) * e^{-alpha/sigma} ),
            same composition/conversion (tighter than basic pure-DP
            composition N/sigma, which is also reported as a cap).

Subsampling amplification (opt-in via ``DPConfig.sample_rate``): the
minibatch draw is already random, and Poisson subsampling at rate q
amplifies the per-release gaussian guarantee
(``rdp_subsampled_gaussian``, MTZ19/WBK19 integer-alpha bound, capped by
the unamplified curve). ``sample_rate=None`` keeps the pre-existing
conservative accounting bit-for-bit, so previously calibrated sigmas and
their pins are untouched.

``calibrate`` inverts ``account`` by bisection (eps is strictly
decreasing in sigma); ``resolve_dp`` fills ``DPConfig.noise_multiplier``
from the target epsilon once the round budget is known, and
``resolve_spec_dp`` does the same on a runtime problem spec so every OS
process of a federation derives the identical sigma.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.configs.base import DPConfig

# Mironov-style grid: fine near 1 (small-eps regime), coarse tail for
# high-noise runs.
DEFAULT_ALPHAS = tuple(
    [1.0 + x / 10.0 for x in range(1, 20)]
    + list(range(3, 33)) + [40, 48, 64, 96, 128, 192, 256, 384, 512, 1024])


def rdp_gaussian(alpha: float, sigma: float) -> float:
    """Per-release Renyi-DP of N(0, (sigma*Delta)^2) at sensitivity Delta."""
    return alpha / (2.0 * sigma * sigma)


def rdp_laplace(alpha: float, sigma: float) -> float:
    """Per-release Renyi-DP of Lap(sigma*Delta) at sensitivity Delta
    (Mironov 2017, Table II), in log-space for numeric safety."""
    inv = 1.0 / sigma
    a = math.log(alpha / (2.0 * alpha - 1.0)) + (alpha - 1.0) * inv
    b = math.log((alpha - 1.0) / (2.0 * alpha - 1.0)) - alpha * inv
    return np.logaddexp(a, b) / (alpha - 1.0)


def rdp_subsampled_gaussian(alpha: float, sigma: float,
                            sample_rate: float) -> float:
    """Per-release RDP of the Poisson-subsampled Gaussian mechanism.

    Privacy amplification by subsampling (Mironov-Talwar-Zhang 2019 /
    Wang-Balle-Kasiviswanathan 2019): with each sample entering a release
    independently with probability q, integer alpha >= 2 satisfies

      RDP(alpha) = 1/(alpha-1) * log sum_{k=0}^{alpha}
                   C(alpha,k) (1-q)^{alpha-k} q^k e^{k(k-1)/(2 sigma^2)}

    evaluated in log-space (lgamma binomials + logaddexp). q=1 recovers
    the unsubsampled alpha/(2 sigma^2) exactly; non-integer or alpha < 2
    grid points return inf (the conversion just skips them). The result
    is additionally capped by the unamplified curve — subsampling never
    hurts, and the cap keeps the bound safe at any q."""
    if sample_rate >= 1.0:
        return rdp_gaussian(alpha, sigma)
    base = rdp_gaussian(alpha, sigma)
    if alpha < 2 or abs(alpha - round(alpha)) > 1e-9:
        return math.inf
    a = int(round(alpha))
    log_q = math.log(sample_rate)
    log_1mq = math.log1p(-sample_rate)
    c = 1.0 / (2.0 * sigma * sigma)
    terms = [
        (math.lgamma(a + 1) - math.lgamma(k + 1) - math.lgamma(a - k + 1))
        + (a - k) * log_1mq + k * log_q + k * (k - 1) * c
        for k in range(a + 1)
    ]
    val = float(np.logaddexp.reduce(terms)) / (a - 1.0)
    return min(val, base)


_RDP = {"gaussian": rdp_gaussian, "laplace": rdp_laplace}


class RDPAccountant:
    """Composes per-release RDP over a release schedule and converts to
    (eps, delta)-DP at the end — the moments-accountant workflow."""

    def __init__(self, mechanism: str = "gaussian", alphas=DEFAULT_ALPHAS):
        if mechanism not in _RDP:
            raise ValueError(f"unknown mechanism {mechanism!r}; "
                             f"have {sorted(_RDP)}")
        self.mechanism = mechanism
        self.alphas = tuple(float(a) for a in alphas)
        self._rdp = np.zeros(len(self.alphas))       # composed RDP curve

    def step(self, sigma: float, releases: int = 1,
             sample_rate: float = 1.0) -> "RDPAccountant":
        """Charge ``releases`` applications at noise multiplier sigma.
        ``sample_rate`` < 1 applies Poisson-subsampling amplification
        (gaussian mechanism only)."""
        if sigma <= 0:
            raise ValueError("sigma must be > 0 to account (sigma=0 is "
                             "not differentially private)")
        if sample_rate is None:
            sample_rate = 1.0
        if not 0.0 < sample_rate <= 1.0:
            raise ValueError(
                f"sample_rate must be in (0, 1], got {sample_rate}")
        if sample_rate < 1.0:
            if self.mechanism != "gaussian":
                raise ValueError(
                    "subsampled amplification is only implemented for the "
                    "gaussian mechanism")
            per = np.array([rdp_subsampled_gaussian(a, sigma, sample_rate)
                            for a in self.alphas])
        else:
            per = np.array([_RDP[self.mechanism](a, sigma)
                            for a in self.alphas])
        self._rdp = self._rdp + releases * per
        return self

    def epsilon(self, delta: float) -> float:
        """The composed (eps, delta) guarantee: optimal-alpha conversion."""
        alphas = np.array(self.alphas)
        eps = self._rdp + math.log(1.0 / delta) / (alphas - 1.0)
        return float(np.min(eps))


def releases_per_party(rounds: int, num_directions: int = 1) -> int:
    """One round = (1 + K) defended uploads."""
    return int(rounds) * (1 + int(num_directions))


def account(sigma: float, rounds: int, delta: float,
            num_directions: int = 1, parties: int = 1,
            mechanism: str = "gaussian",
            composition: str = "parallel",
            sample_rate: float = 1.0) -> float:
    """(eps) spent by a T-round run at noise multiplier ``sigma``.

    ``composition='parallel'`` (default) returns the per-party epsilon —
    the actual guarantee for each disjoint vertical feature block;
    'sequential' charges all M parties' releases against one budget (a
    colluding-release worst case that ignores disjointness).
    ``sample_rate`` < 1 credits the Poisson minibatch draw (privacy
    amplification by subsampling)."""
    n = releases_per_party(rounds, num_directions)
    if composition == "sequential":
        n *= int(parties)
    elif composition != "parallel":
        raise ValueError(f"unknown composition {composition!r}; "
                         f"have parallel, sequential")
    return RDPAccountant(mechanism).step(
        sigma, n, sample_rate=sample_rate).epsilon(delta)


def calibrate(epsilon: float, delta: float, rounds: int,
              num_directions: int = 1, parties: int = 1,
              mechanism: str = "gaussian",
              composition: str = "parallel",
              sigma_bounds=(1e-3, 1e6), tol: float = 1e-4,
              sample_rate: float = 1.0) -> float:
    """The inverse: smallest noise multiplier whose accounted epsilon is
    <= the target. Bisection on the strictly-decreasing eps(sigma). With
    ``sample_rate`` < 1 the amplified curve needs strictly LESS noise at
    equal (eps, delta, T) — tests pin that monotonicity."""
    if not (epsilon > 0 and math.isfinite(epsilon)):
        raise ValueError(f"calibrate needs a finite positive epsilon, "
                         f"got {epsilon}")

    def eps_of(s):
        return account(s, rounds, delta, num_directions, parties,
                       mechanism, composition, sample_rate)

    lo, hi = sigma_bounds
    if eps_of(hi) > epsilon:
        raise ValueError(
            f"target epsilon={epsilon} unreachable even at sigma={hi}")
    if eps_of(lo) <= epsilon:
        return lo
    while hi - lo > tol * max(1.0, lo):
        mid = math.sqrt(lo * hi)              # log-space bisection
        if eps_of(mid) <= epsilon:
            hi = mid
        else:
            lo = mid
    return hi


def resolve_dp(dp: DPConfig | None, rounds: int,
               num_directions: int = 1, parties: int = 1) -> DPConfig | None:
    """Fill ``noise_multiplier`` from the target epsilon for a known
    round budget. Identity for None / disabled (eps=inf) configs, so
    resolving the undefended path is always safe. A config carrying BOTH
    a finite target and a pre-set sigma is RE-VERIFIED against this
    round budget — a sigma that under-delivers the advertised epsilon
    (e.g. calibrated for a shorter run) raises instead of silently
    running with a vacuous guarantee."""
    if dp is None or not dp.enabled:
        return dp
    q = dp.sample_rate if dp.sample_rate is not None else 1.0
    if dp.noise_multiplier is not None:
        if dp.epsilon is not None and math.isfinite(dp.epsilon):
            spent = account(dp.noise_multiplier, rounds, dp.delta,
                            num_directions, parties, dp.mechanism,
                            sample_rate=q)
            if spent > dp.epsilon * (1.0 + 1e-9) + 1e-9:
                raise ValueError(
                    f"noise_multiplier={dp.noise_multiplier:.4g} spends "
                    f"eps={spent:.4g} over {rounds} rounds — more than "
                    f"the advertised target epsilon={dp.epsilon:.4g}; "
                    f"recalibrate for this round budget")
        return dp
    sigma = calibrate(dp.epsilon, dp.delta, rounds, num_directions,
                      parties, dp.mechanism, sample_rate=q)
    return dataclasses.replace(dp, noise_multiplier=sigma)


def resolve_spec_dp(spec: dict, rounds: int) -> dict:
    """Resolve the ``spec['vfl']['dp']`` entry of a runtime problem spec
    (the reference's runtime/problem.py) in the parent, so the server and
    every party process receive the SAME pre-calibrated noise multiplier.
    Returns a new spec; the input is not mutated."""
    vfl = spec.get("vfl") or {}
    dp = vfl.get("dp")
    if dp is None:
        return spec
    if isinstance(dp, dict):
        dp = DPConfig(**dp)
    dp = resolve_dp(dp, rounds,
                    num_directions=int(vfl.get("num_directions", 1)),
                    parties=int(spec.get("parties", 2)))
    out = dict(spec)
    out["vfl"] = dict(vfl)
    out["vfl"]["dp"] = dataclasses.asdict(dp) if dp is not None else None
    return out
