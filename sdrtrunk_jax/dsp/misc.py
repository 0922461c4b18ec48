"""Miscellaneous filters: Goertzel tone power, IIR biquad, CMA equalizer,
IQ phase-imbalance correction, Hilbert real->complex transform.

Batched equivalents of the reference's one-off filters
(dsp/filter/GoertzelFilter.java:31, dsp/filter/iir/IIRBiQuadraticFilter.java:43,
dsp/filter/equalizer/CMAEqualizer.java:8,
dsp/filter/correction/IQCorrectionFilter.java:24,
dsp/filter/hilbert/HilbertTransform.java:25). Feedback structures (biquad,
CMA) are lax.scan with carried state so they vectorize across channels via
vmap; block-parallel ones (Goertzel, Hilbert) are plain batched expressions.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

from .iir import single_pole

__all__ = [
    "goertzel_power", "goertzel_magnitude",
    "biquad_design", "biquad_apply", "biquad_init",
    "cma_equalize", "cma_init",
    "iq_correction",
    "hilbert_taps", "real_to_complex",
]


# ---------------------------------------------------------------------------
# Goertzel tone detection
# ---------------------------------------------------------------------------

def goertzel_power(x: jnp.ndarray, frequency: float, sample_rate: float
                   ) -> jnp.ndarray:
    """Signal power at `frequency` over the block (GoertzelFilter.getPower).

    The Goertzel recurrence is just an O(N) single-bin DFT; on an
    accelerator the honest formulation is the batched inner product
    against the complex exponential — one fused pass, no sequential state. Accepts x of
    shape (..., N); reduces the last axis.
    """
    n = x.shape[-1]
    t = jnp.arange(n, dtype=jnp.float32)
    w = 2.0 * math.pi * frequency / sample_rate
    probe = jnp.exp(-1j * w * t)
    bin_val = jnp.sum(x.astype(jnp.complex64) * probe, axis=-1)
    return (jnp.abs(bin_val) ** 2) / (n * n)


def goertzel_magnitude(x: jnp.ndarray, frequency: float, sample_rate: float
                       ) -> jnp.ndarray:
    """Normalized tone magnitude (0..~1 for a full-scale tone)."""
    return 2.0 * jnp.sqrt(goertzel_power(x, frequency, sample_rate))


# ---------------------------------------------------------------------------
# IIR biquad (RBJ cookbook designs; transposed direct-form II scan)
# ---------------------------------------------------------------------------

def biquad_design(kind: str, frequency: float, sample_rate: float,
                  q: float = 0.7071) -> tuple[np.ndarray, np.ndarray]:
    """(b, a) coefficients for a 2nd-order section.

    kind: 'lowpass' | 'highpass' | 'bandpass' | 'notch'. Matches the filter
    types the reference's IIRBiQuadraticFilter provides
    (dsp/filter/iir/IIRBiQuadraticFilter.java:43).
    """
    w0 = 2.0 * math.pi * frequency / sample_rate
    cw, sw = math.cos(w0), math.sin(w0)
    alpha = sw / (2.0 * q)
    if kind == "lowpass":
        b = np.array([(1 - cw) / 2, 1 - cw, (1 - cw) / 2])
    elif kind == "highpass":
        b = np.array([(1 + cw) / 2, -(1 + cw), (1 + cw) / 2])
    elif kind == "bandpass":
        b = np.array([alpha, 0.0, -alpha])
    elif kind == "notch":
        b = np.array([1.0, -2 * cw, 1.0])
    else:
        raise ValueError(f"unknown biquad kind {kind!r}")
    a = np.array([1 + alpha, -2 * cw, 1 - alpha])
    return (b / a[0]).astype(np.float32), (a / a[0]).astype(np.float32)


def biquad_init(dtype=jnp.float32) -> jnp.ndarray:
    return jnp.zeros((2,), dtype)


def biquad_apply(x: jnp.ndarray, b, a, state: jnp.ndarray | None = None
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming biquad, transposed direct-form II.

    state carries (z1, z2); vmap over leading axes for multi-channel use.
    """
    if state is None:
        state = biquad_init(x.dtype)
    b = jnp.asarray(b, x.dtype)
    a = jnp.asarray(a, x.dtype)

    def step(z, xn):
        z1, z2 = z[0], z[1]
        yn = b[0] * xn + z1
        z1n = b[1] * xn - a[1] * yn + z2
        z2n = b[2] * xn - a[2] * yn
        return jnp.stack([z1n, z2n]), yn

    new_state, y = jax.lax.scan(step, state, x)
    return y, new_state


# ---------------------------------------------------------------------------
# CMA (constant-modulus) adaptive equalizer
# ---------------------------------------------------------------------------

def cma_init(tap_count: int = 11) -> jnp.ndarray:
    """Center-spike initialization (CMAEqualizer.java:8 uses taps[0]=1)."""
    taps = jnp.zeros((tap_count,), jnp.complex64)
    return taps.at[0].set(1.0 + 0.0j)


def cma_equalize(x: jnp.ndarray, taps: jnp.ndarray | None = None,
                 modulus: float = 1.0, mu: float = 0.001
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Constant-modulus blind equalizer over a complex stream.

    Per sample: y = taps . buf; e = y*(|y|^2 - modulus); taps -= mu*conj(buf)*e
    (the reference's error/update rule, CMAEqualizer.java updateTaps). The
    sample-recursive adaptation is a lax.scan carrying (taps, delay line);
    vmap across channels for batch operation.

    Returns (equalized stream, final taps).
    """
    if taps is None:
        taps = cma_init()
    n_taps = taps.shape[0]
    buf0 = jnp.zeros((n_taps,), jnp.complex64)

    def step(carry, xn):
        tps, buf = carry
        buf = jnp.concatenate([xn[None], buf[:-1]])
        y = jnp.sum(tps * buf)
        err = y * (jnp.abs(y) ** 2 - modulus)
        mag = jnp.abs(err)
        err = jnp.where(mag > 1.0, err / jnp.maximum(mag, 1e-12), err)
        tps = tps - mu * jnp.conj(buf) * err
        return (tps, buf), y

    (taps_out, _), y = jax.lax.scan(step, (taps.astype(jnp.complex64), buf0),
                                    x.astype(jnp.complex64))
    return y, taps_out


# ---------------------------------------------------------------------------
# IQ DC / imbalance correction
# ---------------------------------------------------------------------------

def iq_correction(x: jnp.ndarray, ratio: float = 1e-5,
                  state: jnp.ndarray | None = None
                  ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Remove slowly-tracked DC from each rail of a complex stream.

    Mirrors IQCorrectionFilter (dsp/filter/correction/IQCorrectionFilter.java:24):
    per-rail running mean with coupling `ratio`, subtracted from the signal.
    state = complex running mean. Returns (corrected, new state).
    """
    if state is None:
        state = jnp.asarray(0.0 + 0.0j, jnp.complex64)
    mean_i = single_pole(jnp.real(x), ratio, jnp.real(state))
    mean_q = single_pole(jnp.imag(x), ratio, jnp.imag(state))
    mean = (mean_i + 1j * mean_q).astype(jnp.complex64)
    return x - mean, mean[-1]


# ---------------------------------------------------------------------------
# Hilbert transform (real -> complex via fs/4 translated half-band filter)
# ---------------------------------------------------------------------------

def hilbert_taps(half_band: np.ndarray) -> tuple[int, float, np.ndarray]:
    """Convert a half-band low-pass into the fs/4 analytic-filter pair.

    Frequency-translating the half-band prototype by fs/4 (h[k] *
    exp(j*pi/2*(k-c))) zeroes every real coefficient except the center tap
    and keeps the odd imaginary ones — the construction the reference uses
    (dsp/filter/hilbert/HilbertTransform.java:25, per Lyons 3e s13.37).

    Returns (center_delay, center_gain, q_taps) where the in-phase path is
    the input delayed by center_delay scaled by center_gain and the
    quadrature path is convolution with q_taps (same length as half_band).
    """
    h = np.asarray(half_band, dtype=np.float64)
    n = len(h)
    if (n + 1) % 4:
        raise ValueError("half-band length N must satisfy (N+1) % 4 == 0")
    c = n // 2
    k = np.arange(n)
    # sign chosen so POSITIVE frequencies are kept (analytic signal): the
    # quadrature path must be +90 deg relative to the delayed in-phase path
    q = -2.0 * h * np.sin(0.5 * np.pi * (k - c))
    q[c] = 0.0
    return c, 2.0 * h[c], q.astype(np.float32)


def real_to_complex(x: jnp.ndarray, half_band: np.ndarray,
                    state: jnp.ndarray | None = None
                    ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Real samples -> analytic (complex) samples, suppressing negative
    frequencies, with streaming overlap-save state of len(taps)-1 samples.

    Output is the analytic signal of x (same rate, same band); downstream
    stages mix/decimate as needed.
    """
    c, gain, q = hilbert_taps(half_band)
    n_hist = len(q) - 1
    if state is None:
        state = jnp.zeros((n_hist,), x.dtype)
    xp = jnp.concatenate([state, x])
    # correlation: y_q[i] = sum_k q[k] * xp[i + k]  (convolve with reversed
    # taps); q is antisymmetric, and hilbert_taps' sign convention matches
    # this correlation form — change both together if either changes
    qt = jnp.asarray(q[::-1].copy())
    yq = jnp.convolve(xp, qt, mode="valid")
    yi = gain * xp[n_hist - c: n_hist - c + x.shape[0]]
    return (yi + 1j * yq).astype(jnp.complex64), xp[-n_hist:]
