"""Non-maximally-decimated polyphase filter-bank channelizer (M/2, 2x oversampled).

Batched reformulation of the reference's streaming NMDPFB
(dsp/filter/channelizer/ComplexPolyphaseChannelizerM2.java:64): instead of a
serpentine-shifted sample buffer with per-block MAC + remap + IFFT-per-block
on a side thread, we compute ALL output blocks of a time slice as one batched
expression:

    y[k, m] = sum_n h[n] * x[k*M/2 - n] * e^{-2 pi i m (k*M/2 - n) / M}

which factors (n = q*M + r) into
    u[k, r]  = sum_q h[q*M + r] * x[k*M/2 - q*M - r]      (branch filter)
    y[k, m]  = (-1)^{m*k} * M * IFFT_M(u[k, :])[m]         (phase alignment)

The branch filter splits by block parity into two depthwise convolutions over
reshaped views of the input (no gathers, static shapes), and the IFFT runs
batched over all blocks at once — XLA fuses the elementwise work and the
device executes one big batched FFT (cuFFT on the GPU) instead of K small
ones.

Channel m is centered at +m * (fs/M) (negative frequencies wrap), output rate
2*fs/M per channel. A tone at bin m's center appears at DC in channel m with
~unit gain.

Perfect-reconstruction prototype design: dsp.design.sinc_m2_channelizer.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from . import design

__all__ = ["Channelizer", "channelize", "channel_count_for_rate",
           "polyphase_branch_filters", "reference_channelize"]

def channel_count_for_rate(sample_rate: float,
                           channel_bandwidth: float = 12500.0) -> int:
    """channels = floor(fs / bw) rounded down to even
    (ComplexPolyphaseChannelizerM2.java:148-161; bandwidth is parameterized
    here where the reference hardcodes 25 kHz / claims 12.5 kHz)."""
    channels = int(sample_rate / channel_bandwidth)
    if channels % 2 != 0:
        channels -= 1
    return channels


def polyphase_branch_filters(taps: np.ndarray, channels: int) -> np.ndarray:
    """Reshape prototype h[n] -> hmat[q, r] = h[q*M + r], shape (T, M)."""
    taps = np.asarray(taps, dtype=np.float64)
    m = channels
    t = int(np.ceil(len(taps) / m))
    padded = np.zeros(t * m)
    padded[: len(taps)] = taps
    return padded.reshape(t, m)


@partial(jax.jit, static_argnames=("channels",))
def _channelize_core(xp: jnp.ndarray, hmat: jnp.ndarray, channels: int
                     ) -> jnp.ndarray:
    """Channelize a padded complex block.

    xp: complex64 (H + N,) where H = T*M history samples precede the block
        and N is a multiple of M (producing 2 output blocks per M samples).
    hmat: float32 (T, M) polyphase branches.
    Returns y: complex64 (K, M) with K = 2*N/M output blocks.
    """
    m = channels
    t = hmat.shape[0]
    hist = m * t                  # history length H
    n = xp.shape[0] - hist
    k = 2 * n // m                # output blocks (hop M/2)
    kp = k // 2                   # even/odd block count
    half = m // 2

    # Branch windows, newest-sample-first:
    #   W_even[p, s] = x[p*M - s]        (block j = 2p)
    #   W_odd [p, s] = x[p*M + M/2 - s]  (block j = 2p+1),  s = q*M + r.
    # On the reversed padded signal v[i] = xp[H + N - 1 - i] these windows
    # are contiguous ascending slices; because N % M == 0 their start offsets
    # align to M (after dropping M-1, resp. M/2-1, leading elements), so the
    # whole extraction is T static shifted slices of an (rows, M) reshape —
    # no gathers; XLA fuses the unrolled branch sums into one kernel.
    v = xp[::-1]
    rows = kp + t - 1
    v_even = v[m - 1:][: rows * m].reshape(rows, m)
    v_odd = v[half - 1:][: rows * m].reshape(rows, m)

    hq = hmat.astype(jnp.float32)

    def branch_sums(chunks):
        acc = hq[0] * chunks[0:kp]
        for q in range(1, t):
            acc = acc + hq[q] * chunks[q:q + kp]
        return acc[::-1]          # slice order is newest-block-first; flip

    ue = branch_sums(v_even)      # (kp, M) — blocks 0, 2, 4, ...
    uo = branch_sums(v_odd)       # (kp, M) — blocks 1, 3, 5, ...
    u = jnp.stack([ue, uo], axis=1).reshape(k, m)

    # IFFT aligns the per-channel carrier phases; odd blocks additionally
    # carry the M/2 hop's half-bin rotation (-1)^m (the reference's
    # top/middle block swap, ComplexPolyphaseChannelizerM2.java:244-293).
    y = jnp.fft.ifft(u, axis=-1) * m
    block_parity = (jnp.arange(k) & 1)[:, None]
    chan_parity = (jnp.arange(m) & 1)[None, :]
    sign = jnp.where((block_parity & chan_parity) == 1, -1.0, 1.0)
    return (y * sign).astype(jnp.complex64)


@dataclass
class Channelizer:
    """Streaming M/2 polyphase channelizer.

    Usage:
        ch = Channelizer.design(sample_rate=2_400_000, channel_bandwidth=12500)
        y, state = ch(x, state)        # x: (N,) complex64, N % M == 0
        # y: (2*N/M, M) complex64 — channel m centered at +m*fs/M

    State is the trailing T*M input samples so chunked streaming matches
    one-shot processing exactly (the overlap-save halo for time sharding).
    """
    channels: int
    sample_rate: float
    hmat: np.ndarray              # (T, M) float32 branch filters
    taps_per_channel: int

    @classmethod
    def design(cls, sample_rate: float, channel_bandwidth: float = 12500.0,
               taps_per_channel: int = 9, channels: int | None = None
               ) -> "Channelizer":
        if channels is None:
            channels = channel_count_for_rate(sample_rate, channel_bandwidth)
        if channels < 2 or channels % 2:
            raise ValueError(f"invalid channel count {channels}")
        spacing = sample_rate / channels
        proto = design.sinc_m2_channelizer(spacing, channels, taps_per_channel)
        hmat = polyphase_branch_filters(proto, channels).astype(np.float32)
        return cls(channels=channels, sample_rate=sample_rate, hmat=hmat,
                   taps_per_channel=hmat.shape[0])

    @classmethod
    def from_taps(cls, taps: np.ndarray, sample_rate: float, channels: int
                  ) -> "Channelizer":
        hmat = polyphase_branch_filters(taps, channels).astype(np.float32)
        return cls(channels=channels, sample_rate=sample_rate, hmat=hmat,
                   taps_per_channel=hmat.shape[0])

    @property
    def channel_spacing(self) -> float:
        return self.sample_rate / self.channels

    @property
    def channel_sample_rate(self) -> float:
        """Per-channel output rate: 2x oversampled (spacing * 2)."""
        return 2.0 * self.sample_rate / self.channels

    def init_state(self) -> jnp.ndarray:
        return jnp.zeros((self.taps_per_channel * self.channels,),
                         dtype=jnp.complex64)

    def center_frequency(self, channel_index: int) -> float:
        """Baseband center frequency of a channel (wraps to negative)."""
        m = channel_index % self.channels
        if m > self.channels // 2:
            m -= self.channels
        return m * self.channel_spacing

    def channel_for_frequency(self, frequency: float) -> int:
        """Nearest bin index for a baseband offset frequency."""
        m = int(round(frequency / self.channel_spacing))
        return m % self.channels

    def __call__(self, x: jnp.ndarray, state: jnp.ndarray | None = None
                 ) -> tuple[jnp.ndarray, jnp.ndarray]:
        if state is None:
            state = self.init_state()
        m = self.channels
        n = x.shape[0]
        if n % m:
            raise ValueError(f"block length {n} must be a multiple of M={m}")
        xp = jnp.concatenate([state, x.astype(jnp.complex64)])
        y = _channelize_core(xp, jnp.asarray(self.hmat), m)
        new_state = xp[-state.shape[0]:]
        return y, new_state


def channelize(x: jnp.ndarray, taps: np.ndarray, channels: int,
               sample_rate: float = 1.0) -> jnp.ndarray:
    """One-shot channelization with zero history (convenience for tests)."""
    ch = Channelizer.from_taps(taps, sample_rate, channels)
    y, _ = ch(x)
    return y


def reference_channelize(xp: np.ndarray, hmat: np.ndarray,
                         channels: int) -> np.ndarray:
    """Plain numpy float64 evaluation of _channelize_core's contract (the
    reference the device path is checked against):

        u[k, r] = sum_q hmat[q, r] * xp[H + k*M/2 - q*M - r]
        y[k, m] = (-1)^(m*k) * M * IFFT_M(u[k, :])[m]

    with H = T*M history samples leading xp. Returns complex128 (K, M)."""
    m = channels
    hmat = np.asarray(hmat, np.float64)
    xp = np.asarray(xp, np.complex128)
    t = hmat.shape[0]
    hist = t * m
    k = 2 * (xp.shape[0] - hist) // m
    base = hist + np.arange(k)[:, None] * (m // 2) - np.arange(m)[None, :]
    u = np.zeros((k, m), np.complex128)
    for q in range(t):
        u += hmat[q][None, :] * xp[base - q * m]
    y = np.fft.ifft(u, axis=1) * m
    parity = (np.arange(k)[:, None] * np.arange(m)[None, :]) & 1
    return np.where(parity == 1, -y, y)
