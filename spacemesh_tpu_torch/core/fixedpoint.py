"""Deterministic fixed-point binomial sampling for committee eligibility
(port of ``spacemesh_tpu/core/fixedpoint.py``, whole).

The reference draws an identity's hare seat count from the binomial CDF
over its weight (reference hare3/eligibility/oracle.go:324-375 with the
spacemeshos/fixed package): the identity runs ``n = weight`` Bernoulli
trials at ``p = committee_size / total_weight``; its VRF output supplies a
uniform fraction and the count is the inverse-CDF sample

    x = min { k : BinCDF(n, p, k) > vrf_frac }

so E[count] = committee_size * w_i / W with the true binomial variance —
the committee-size analysis the protocol's safety margins depend on.
The validator recomputes the same x from the same inputs
(oracle.go:297-340: accept iff BinCDF(n,p,x-1) <= vrf_frac < BinCDF(n,p,x),
which is exactly "x equals the sample").

All arithmetic is integer fixed-point at 2**SCALE_BITS so prover and
validator agree bit-for-bit on every platform. Python's big ints make the
intermediate products exact; the only rounding is the explicit >> at each
multiply, identical everywhere.

Deviations from the reference, documented:
- 128 fractional bits (the reference's fixed package uses fewer), so
  (1-p)^n underflows only when the identity's expected seat count exceeds
  ~88 (it would need >11% of total weight at committee 800);
- on that underflow the sample saturates to round(n*p) deterministically
  instead of panicking (oracle.go:311-321 wraps a recover() around it) —
  a whale that deep is eligible with near-certainty either way;
- the scan is capped at 2**16 - 1 matching the reference's uint16 count.
"""

from __future__ import annotations

SCALE_BITS = 128
ONE = 1 << SCALE_BITS
COUNT_CAP = (1 << 16) - 1


def _mul(a: int, b: int) -> int:
    return (a * b) >> SCALE_BITS


def _div(a: int, b: int) -> int:
    return (a << SCALE_BITS) // b


def fixed_pow(base: int, e: int) -> int:
    """base**e by squaring, base in fixed point, e a non-negative int."""
    acc = ONE
    while e:
        if e & 1:
            acc = _mul(acc, base)
        base = _mul(base, base)
        e >>= 1
    return acc


def frac_from_bytes(b: bytes) -> int:
    """First 8 bytes of a VRF output -> uniform fraction in [0, ONE).

    Mirrors the reference's calcVrfFrac (oracle.go:208, fixed.FracFromBytes
    over sig[:8], little-endian)."""
    return int.from_bytes(b[:8], "little") << (SCALE_BITS - 64)


def binomial_count(n: int, p_num: int, p_den: int, frac: int) -> int:
    """Inverse-CDF sample of Binomial(n, p_num/p_den) at ``frac``.

    ``frac`` is fixed-point in [0, ONE). Walks the pmf recurrence
    pmf(k+1) = pmf(k) * (n-k)/(k+1) * p/(1-p) accumulating the CDF until
    it exceeds frac — counts are << 2**16 in practice so the walk is
    short (same shape as the reference's CalcEligibility loop,
    oracle.go:368-375).
    """
    if n <= 0 or p_num <= 0:
        return 0
    if p_num >= p_den:
        return min(n, COUNT_CAP)
    p = _div(p_num, p_den)
    q = ONE - p
    pmf = fixed_pow(q, n)
    if pmf == 0:
        # (1-p)^n underflowed 128 fractional bits: expected count > ~88.
        # Deterministic saturation (documented deviation, see module doc).
        return min((n * p_num + p_den // 2) // p_den, COUNT_CAP)
    cdf = pmf
    x = 0
    while cdf <= frac and x < min(n, COUNT_CAP):
        pmf = _div(_mul(pmf * (n - x), p) // (x + 1), q)
        x += 1
        cdf += pmf
        if pmf == 0 and cdf <= frac:
            # right-tail underflow: every remaining pmf term is below
            # resolution; frac can never be reached. The sample is in the
            # far tail — saturate at the cap the same way both sides.
            return min(n, COUNT_CAP)
    return x


def bin_cdf(n: int, p_num: int, p_den: int, x: int) -> int:
    """BinCDF(n, p, x) in fixed point (test/diagnostic surface)."""
    if x < 0:
        return 0
    if n <= 0 or p_num <= 0:
        return ONE
    if p_num >= p_den:
        return ONE if x >= n else 0
    p = _div(p_num, p_den)
    q = ONE - p
    pmf = fixed_pow(q, n)
    cdf = pmf
    for k in range(min(x, n)):
        pmf = _div(_mul(pmf * (n - k), p) // (k + 1), q)
        cdf += pmf
    return min(cdf, ONE)
