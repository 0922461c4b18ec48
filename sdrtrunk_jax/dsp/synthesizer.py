"""Two-channel M/2 synthesizer: re-join two adjacent 2x-oversampled
channelizer bins into one wider stream (perfect reconstruction).

Batched dual of the reference's TwoChannelSynthesizerM2
(dsp/filter/channelizer/TwoChannelSynthesizerM2.java:45): where the reference
runs a per-sample 2-point IFFT + serpentine buffer + alternating top/bottom
block swap + interleaved polyphase MAC (a polyphase filter structure at the
2x conceptual rate), the same goal against this package's channelizer
convention (dsp/channelizer.py: bin m centered at +m*fs/M, hop M/2) reduces
to a closed form with NO synthesis filter at all:

    z[k] = e^{-i pi k/2} c_m[k]  -  e^{+i pi k/2} c_{m+1}[k]

i.e. shift the lower bin down and the upper bin up by fs_ch/4 and sum. The
perfect-reconstruction property of the analysis prototype (H(nu) + H(nu-1)
= 1 across the bin overlap, the -6.02 dB band-edge design of
design.sinc_m2_channelizer) makes each bin's transition-band leakage of its
neighbor's signal add COHERENTLY with the neighbor's own contribution, so
the joint response is flat without any synthesis filtering; content from
non-adjacent bins is already at the prototype's stopband (~ -80 dB). The
inter-bin -1 is the residual phase between adjacent bins of our channelizer
(verified numerically across M in {8,16,32}, taps-per-channel in {9,11}).

Measured (tests/test_misc_dsp.py): unit gain flat across the joint 2-bin
band, exact frequency mapping z @ (nu - 1/2)*spacing for a tone at nu bins
above the lower bin center, ~ -108 dB leakage from non-adjacent bins —
exceeding the reference structure, whose synthesis prototype adds passband
droop.

Output runs at the channel rate (2x spacing), centered midway between the
two bins. Used by the channel-extraction layer for channels wider than one
bin (reference TwoChannelOutputProcessor,
dsp/filter/channelizer/output/TwoChannelOutputProcessor.java:26). For bin
pair (M-1, 0) the wrap is automatic (bin M == bin 0 mod M).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

__all__ = ["TwoChannelSynthesizer", "synthesize_two"]

# e^{-i pi k / 2} cycle
_ROT4 = np.array([1, -1j, -1, 1j], dtype=np.complex64)


def synthesize_two(c_lo: jnp.ndarray, c_hi: jnp.ndarray, state=None):
    """Combine adjacent bin streams (lower, upper) into one wide stream.

    c_lo/c_hi: (..., K) complex64 at the 2x-oversampled channel rate (equal
    shapes; leading axes broadcast, e.g. a batch of channel pairs).
    state: rotator index k0 (mod 4) or None.
    Returns (z, new_state); z centered midway between the two bins.
    """
    k = c_lo.shape[-1]
    if state is None:
        state = jnp.asarray(0, jnp.int32)
    idx = (state + jnp.arange(k)) % 4
    rot = jnp.asarray(_ROT4)[idx]            # e^{-i pi k/2}
    z = rot * c_lo.astype(jnp.complex64) \
        - jnp.conj(rot) * c_hi.astype(jnp.complex64)
    return z.astype(jnp.complex64), (state + k) % 4


@dataclass
class TwoChannelSynthesizer:
    """Streaming wrapper carrying the rotator phase across chunks.

    channel_sample_rate is informational (the output rate equals it).
    """
    channel_sample_rate: float

    def init_state(self):
        return jnp.asarray(0, jnp.int32)

    def __call__(self, c_lo, c_hi, state=None):
        return synthesize_two(c_lo, c_hi, state)


def synthesize_bank(u: np.ndarray, hmat: np.ndarray) -> np.ndarray:
    """Full M-channel polyphase SYNTHESIS bank: multiplex per-bin streams
    into one wideband signal — the exact dual of dsp/channelizer.py's
    analysis bank.

    The reference only ships the two-channel special case
    (TwoChannelSynthesizerM2.java:45) plus the prototype designer
    (FilterFactory.getSincM2Synthesizer:755); the full M-bin dual exists
    here as the signal-generation/test tier: analysis(synthesize_bank(u))
    returns u delayed by (T-1) blocks with ~unit gain (the PR property of
    the -6.02 dB prototype), so >=1000-channel live captures can be
    synthesized exactly for the bench and closed-loop tests.

    u: (K, M) complex — per-bin content at the channel hop rate (one
       (M,) vector per M/2-sample output hop; bin m centered at +m*fs/M,
       the analysis bank's convention).
    hmat: (T, M) float prototype branches (Channelizer.hmat).
    Returns x: (K*M/2 + (2*T-1)*M/2,) complex64 (overlap-add tail kept).

    Host-side NumPy: generation is not a hot path.
    """
    u = np.asarray(u)
    t_taps, m = hmat.shape
    k = u.shape[0]
    half = m // 2
    # v[k, r] = sum_m u[k,m] e^{+2 pi i m r / M}  (M-periodic in r);
    # the extra M/2 normalizes the analysis-of-synthesis round trip to
    # unit gain (measured 2/M without it, constant across M)
    v = np.fft.ifft(u, axis=1) * m * (m / 2.0)             # (K, M)
    # block k contributes g[j] * v[k, (k*M/2 + j) mod M] at output
    # t = k*M/2 + j; (k*M/2 + j) mod M toggles a half-bin roll by parity
    g = hmat.reshape(-1)                                   # (T*M,)
    v_even = np.tile(v, (1, t_taps))                       # (K, T*M)
    v_odd = np.tile(np.roll(v, -half, axis=1), (1, t_taps))
    par = (np.arange(k) & 1)[:, None]
    win = np.where(par == 1, v_odd, v_even) * g[None, :]   # (K, T*M)
    # overlap-add with hop M/2
    w3 = win.reshape(k, 2 * t_taps, half)
    acc = np.zeros((k + 2 * t_taps, half), np.complex128)
    for b in range(2 * t_taps):
        acc[b:b + k] += w3[:, b, :]
    return acc.reshape(-1).astype(np.complex64)
