# Copied from statmc_tpu/denoise/ttest.py (numpy host code; imports rewritten, behaviour unchanged).
"""Student-t quantiles for the statistical filter.

The reference's CUDA kernel embeds precomputed quantile tables at
significance alpha = 0.005 (variants 0.002 / 0.05 for figure
reproduction) indexed by degrees of freedom (README "Comparisons";
stat_denoiser.cu is out of tree).  We generate the same tables at import
time with Hill's algorithm (AS 396) for the inverse t CDF plus the
Acklam rational approximation for the normal quantile -- no SciPy
dependency, accurate to ~1e-6 over the df range that matters.
"""
from __future__ import annotations

import numpy as np

MAX_DF = 256  # df beyond this uses the asymptotic (normal) quantile


def _norm_ppf(p):
    """Acklam's inverse normal CDF approximation (|err| < 1.2e-8)."""
    p = np.asarray(p, np.float64)
    a = [-3.969683028665376e+01, 2.209460984245205e+02,
         -2.759285104469687e+02, 1.383577518672690e+02,
         -3.066479806614716e+01, 2.506628277459239e+00]
    b = [-5.447609879822406e+01, 1.615858368580409e+02,
         -1.556989798598866e+02, 6.680131188771972e+01,
         -1.328068155288572e+01]
    c = [-7.784894002430293e-03, -3.223964580411365e-01,
         -2.400758277161838e+00, -2.549732539343734e+00,
         4.374664141464968e+00, 2.938163982698783e+00]
    d = [7.784695709041462e-03, 3.224671290700398e-01,
         2.445134137142996e+00, 3.754408661907416e+00]
    plow, phigh = 0.02425, 1 - 0.02425

    def tail(q):
        num = ((((c[0] * q + c[1]) * q + c[2]) * q + c[3]) * q + c[4]) * q + c[5]
        den = (((d[0] * q + d[1]) * q + d[2]) * q + d[3]) * q + 1
        return num / den

    out = np.empty_like(p)
    lo = p < plow
    hi = p > phigh
    mid = ~(lo | hi)
    q = np.sqrt(-2 * np.log(np.where(lo, p, 0.5)))
    out[lo] = tail(q)[lo]
    q = np.sqrt(-2 * np.log(np.where(hi, 1 - p, 0.5)))
    out[hi] = -tail(q)[hi]
    pm = np.where(mid, p, 0.5)
    q = pm - 0.5
    r = q * q
    num = ((((a[0] * r + a[1]) * r + a[2]) * r + a[3]) * r + a[4]) * r + a[5]
    den = (((((b[0] * r + b[1]) * r + b[2]) * r + b[3]) * r + b[4]) * r + 1)
    out[mid] = (num * q / den)[mid]
    return out


def t_ppf(p: float, df: np.ndarray) -> np.ndarray:
    """Hill's AS 396 inverse Student-t (two-tail aware via symmetry)."""
    df = np.asarray(df, np.float64)
    x = _norm_ppf(np.full_like(df, float(p)))
    g1 = (x**3 + x) / 4.0
    g2 = (5 * x**5 + 16 * x**3 + 3 * x) / 96.0
    g3 = (3 * x**7 + 19 * x**5 + 17 * x**3 - 15 * x) / 384.0
    g4 = (79 * x**9 + 776 * x**7 + 1482 * x**5 - 1920 * x**3 - 945 * x) / 92160.0
    t = x + g1 / df + g2 / df**2 + g3 / df**3 + g4 / df**4
    # Closed forms for df=1,2; Newton refinement on the exact CDF for the
    # small-df range where Hill's expansion drifts (matters at low spp:
    # n=4 samples => df=3).
    with np.errstate(divide="ignore"):
        t1 = np.tan(np.pi * (p - 0.5))  # df = 1 (Cauchy)
        a = 2.0 * p - 1.0
        t2 = a * np.sqrt(2.0 / np.maximum(1.0 - a * a, 1e-300))
    t = np.where(df == 1, t1, t)
    t = np.where(df == 2, t2, t)
    small = (df > 2) & (df <= 32)
    if np.any(small):
        ts = t.copy()
        for _ in range(32):  # bisection-safe Newton via secant on CDF
            cdf = _t_cdf(ts, df)
            pdf = _t_pdf(ts, df)
            step = np.where(pdf > 1e-300, (cdf - p) / np.maximum(pdf, 1e-300),
                            0.0)
            ts = ts - np.clip(step, -1.0, 1.0) * small
        t = np.where(small, ts, t)
    return t


def _betacf(a, b, x, iters=200):
    """Continued fraction for the incomplete beta (Numerical-Recipes
    style modified Lentz)."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = np.ones_like(x)
    d = 1.0 - qab * x / qap
    d = np.where(np.abs(d) < 1e-300, 1e-300, d)
    d = 1.0 / d
    h = d
    for m in range(1, iters + 1):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < 1e-300, 1e-300, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < 1e-300, 1e-300, c)
        d = 1.0 / d
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 + aa * d
        d = np.where(np.abs(d) < 1e-300, 1e-300, d)
        c = 1.0 + aa / c
        c = np.where(np.abs(c) < 1e-300, 1e-300, c)
        d = 1.0 / d
        h = h * d * c
    return h


def _betainc(a, b, x):
    from math import lgamma

    lg = np.vectorize(lgamma)
    x = np.clip(x, 1e-300, 1.0 - 1e-15)
    ln_bt = (lg(a + b) - lg(a) - lg(b) + a * np.log(x)
             + b * np.log1p(-x))
    bt = np.exp(ln_bt)
    use_direct = x < (a + 1.0) / (a + b + 2.0)
    res_direct = bt * _betacf(a, b, x) / a
    res_sym = 1.0 - bt * _betacf(b, a, 1.0 - x) / b
    return np.where(use_direct, res_direct, res_sym)


def _t_cdf(t, df):
    x = df / (df + t * t)
    tail = 0.5 * _betainc(df / 2.0, 0.5, x)
    return np.where(t >= 0, 1.0 - tail, tail)


def _t_pdf(t, df):
    from math import lgamma

    lg = np.vectorize(lgamma)
    c = np.exp(lg((df + 1) / 2.0) - lg(df / 2.0)) / np.sqrt(df * np.pi)
    return c * (1.0 + t * t / df) ** (-(df + 1) / 2.0)


def quantile_table(alpha: float = 0.005, max_df: int = MAX_DF) -> np.ndarray:
    """Two-sided critical values: table[df] = t_{1-alpha/2}(df), df 0..max.

    df=0 entries are set huge so that pixels with n<=1 accept everything
    (their variance estimate is undefined -- matches treating them as
    uninformative).
    """
    df = np.arange(0, max_df + 1, dtype=np.float64)
    q = np.empty_like(df)
    q[0] = 1e30
    q[1:] = t_ppf(1.0 - alpha / 2.0, df[1:])
    return q.astype(np.float32)
