"""XLA's f32 ``log``, ``log1p`` and ``erf_inv``, bit for bit, in torch.

``jax.random.normal`` and ``jax.random.laplace`` reach these three
functions, and the reference pins its DP noise bitwise on them. torch's
own ``log``/``log1p``/``erfinv`` are different approximations (they agree
with XLA on 82%, 89% and 33% of f32 inputs), so the port carries XLA's
formulas as the XLA CPU backend emits them:

  log      the Cephes logf polynomial (mantissa in [sqrt(1/2), sqrt(2)),
           degree-8 polynomial in three Horner strands joined by x^3),
           with the multiply-adds the backend contracts into FMAs;
  log1p    for |x| < sqrt(2)-1: x + (x^3 * P(x)/Q(x) - x^2/2) with the
           Cephes degree-6 P and Q by Horner with FMA; otherwise
           log(1 + x);
  erf_inv  Giles' single-precision polynomial: w = -log1p(-x*x), then a
           degree-8 Horner in w - 2.5 (w < 5) or sqrt(w) - 3, with FMA.

Every FMA goes through ``fma32``, which is exact on any device: the
product of two f32 values is exact in f64, the f64 sum is then rounded
to odd (TwoSum gives its error), and f64 -> f32 rounding of a
round-to-odd value equals one correctly rounded f32 FMA. The CUDA kernels
carry the same formulas with ``__fmaf_rn`` (kernels/csrc/prng.cuh, shared
by defended_encode.cu and prng_draw.cu).
"""
from __future__ import annotations

import torch

_INF = float("inf")

# Cephes logf
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1,
          -1.2420140846E-1, 1.4249322787E-1, -1.6668057665E-1,
          2.0000714765E-1, -2.4999993993E-1, 3.3333331174E-1)
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375
_SQRTHF = 0.707106781186547524
_MIN_NORM = 1.17549435e-38                      # 0x00800000
_INV_EXP_MASK = ~0x7F800000                     # as int32
_HALF_BITS = 0x3F000000                         # 0.5

# Cephes log1p, P/Q on |x| < sqrt(2) - 1
_LOG1P_P = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
            6.5787325942061044846969E0, 2.9911919328553073277375E1,
            6.0949667980987787057556E1, 5.7112963590585538103336E1,
            2.0039553499201281259648E1)
_LOG1P_Q = (1.0, 1.5062909083469192043167E1, 8.3047565967967209469434E1,
            2.2176239823732856465394E2, 3.0909872225312059774938E2,
            2.1642788614495947685003E2, 6.0118660497603843919306E1)
_LOG1P_SMALL = 0.41421356237309504880           # sqrt(2) - 1

# Giles, "Approximating the erfinv function" (single precision)
_ERFINV_LT = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE = (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682)


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def fma32(a, b, c) -> torch.Tensor:
    """Correctly rounded f32 a*b + c (one rounding), on any device."""
    ref = next(t for t in (a, b, c) if isinstance(t, torch.Tensor))
    a64, b64, c64 = (_f32(t, ref).double() for t in (a, b, c))
    p = a64 * b64                       # exact: 24 + 24 bits < 53
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)   # TwoSum: s + err == p + c exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, _f32(_INF, ref).double(),
                         _f32(-_INF, ref).double())
    s = torch.where((err != 0) & even, torch.nextafter(s, toward), s)
    return s.float()


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 sqrt. torch's CPU f32 sqrt is not (MKL's
    vector sqrt is off by an ulp on ~0.8% of inputs); the f64 root
    rounded to f32 is, because a double rounding of a square root can
    never straddle an f32 midpoint."""
    return torch.sqrt(x.double()).float()


def _horner_fma(coeffs, x: torch.Tensor) -> torch.Tensor:
    p = _f32(coeffs[0], x).expand_as(x)
    for c in coeffs[1:]:
        p = fma32(p, x, c)
    return p


def log(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 log (Cephes logf, FMA-contracted)."""
    x = x.float()
    xc = torch.clamp(x, min=_MIN_NORM)
    xb = xc.view(torch.int32)
    e = (xb >> 23) - 127
    m = ((xb & _INV_EXP_MASK) | _HALF_BITS).view(torch.float32)
    e = _f32(1.0, x) + e.float()
    small = m < _f32(_SQRTHF, x)
    zero = _f32(0.0, x)
    t = (m - 1.0) + torch.where(small, m, zero)   # exact
    e = e - torch.where(small, _f32(1.0, x), zero)
    x2 = t * t
    x3 = x2 * t
    y = _horner_fma(_LOG_P[0:3], t)
    y1 = _horner_fma(_LOG_P[3:6], t)
    y2 = _horner_fma(_LOG_P[6:9], t)
    y = fma32(x3, y, y1)
    y = fma32(x3, y, y2)
    y = fma32(y, x3, _f32(_LOG_Q1, x) * e)
    r = (t - 0.5 * x2) + y                        # 0.5 * x2 is exact
    r = fma32(_f32(_LOG_Q2, x), e, r)
    # XLA ORs an all-ones mask into invalid lanes: the NaN is 0xFFFFFFFF
    nan = torch.full((), -1, dtype=torch.int32, device=x.device)
    r = torch.where((x < 0) | torch.isnan(x), nan.view(torch.float32), r)
    r = torch.where(x == _INF, _f32(_INF, x), r)
    # XLA CPU treats subnormal inputs as zero: log -> -inf
    return torch.where(torch.abs(x) < _MIN_NORM, _f32(-_INF, x), r)


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA CPU's f32 log1p: the Cephes rational on |x| < sqrt(2) - 1,
    log(1 + x) elsewhere."""
    x = x.float()
    x2 = x * x
    r = _horner_fma(_LOG1P_P, x) / _horner_fma(_LOG1P_Q, x)
    s = (x * x2) * r
    small = fma32(_f32(-0.5, x), x2, s)           # -0.5 * x2 is exact
    return torch.where(torch.abs(x) < _f32(_LOG1P_SMALL, x), x + small,
                       log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 erf_inv (Giles' polynomial, FMA Horner)."""
    x = x.float()
    w = -log1p(-(x * x))
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt_rn(w) - 3.0)
    p = torch.where(lt, _f32(_ERFINV_LT[0], x), _f32(_ERFINV_GE[0], x))
    for c_lt, c_ge in zip(_ERFINV_LT[1:], _ERFINV_GE[1:]):
        p = fma32(p, w, torch.where(lt, _f32(c_lt, x), _f32(c_ge, x)))
    return torch.where(torch.abs(x) == 1.0, x * _INF, p * x)
