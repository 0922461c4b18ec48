"""AFSK1200 correlation demodulator (MPT1327 and friends).

Batched reformulation of dsp/afsk/AFSK1200Decoder.java:42: resample the
8 kHz FM-demodulated audio to 7200 Hz (6 samples/symbol), correlate
against the 1200 Hz (mark / 1) and 1800 Hz (space / 0) tones, slice
mark>space, then run the same boolean symbol-timing scan as the LTR
decoder at 6 samples/symbol.

The tone correlators are plain convolutions with windowed complex
exponentials — fully parallel (the reference computes running
I/Q dot products per sample); only the symbol-timing loop is a scan.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import fir

__all__ = ["AFSK1200Demodulator", "AFSKState"]

SAMPLE_RATE = 7200.0
SPS = 6
MARK_HZ = 1200.0
SPACE_HZ = 1800.0
CORRELATION_PERIOD = SPS + 2   # AFSK1200Decoder.java:?? (8 samples)
AVERAGING_PERIOD = SPS + 1


class AFSKState(NamedTuple):
    resample: jnp.ndarray
    corr: jnp.ndarray            # correlator FIR history (float input)
    window: jnp.ndarray          # boolean decisions delay line
    sampling_point: jnp.ndarray


@dataclass
class AFSK1200Demodulator:
    input_rate: float = 8000.0
    timing_gain: float = 1.0 / 3.0
    invert: bool = False

    def __post_init__(self):
        if self.input_rate != 8000.0:
            raise ValueError("AFSK1200 expects 8 kHz input audio")
        self.up, self.down = 9, 10  # 8000 -> 7200
        self.rtaps = np.asarray(fir.resample_taps(self.up, self.down),
                                 jnp.float32)
        n = np.arange(CORRELATION_PERIOD)
        window = np.ones(CORRELATION_PERIOD)
        avg = np.ones(AVERAGING_PERIOD) / AVERAGING_PERIOD
        def tone_taps(freq):
            ph = 2.0 * np.pi * freq / SAMPLE_RATE * n
            c = (window * np.cos(ph)).astype(np.float32)
            s = (window * np.sin(ph)).astype(np.float32)
            return c, s
        self.mark_taps = tone_taps(MARK_HZ)
        self.space_taps = tone_taps(SPACE_HZ)
        self.avg_taps = np.asarray(avg, np.float32)
        # symbol-recovery geometry at 6 sps
        self.window_len = 2 * SPS
        self.int_sps = SPS
        self.half_sps = SPS // 2
        self.zc_len = SPS + 1
        self.zc_ideal = SPS / 2.0
        # total correlator history per branch
        self._corr_len = CORRELATION_PERIOD + AVERAGING_PERIOD - 1

    def init_state(self) -> AFSKState:
        return AFSKState(
            resample=fir.resample_init(len(self.rtaps), self.up,
                                       jnp.float32),
            corr=jnp.zeros((self._corr_len - 1,), jnp.float32),
            window=jnp.zeros((self.window_len,), jnp.int8),
            sampling_point=jnp.asarray(SPS + self.half_sps, jnp.float32),
        )

    def _correlate(self, padded: jnp.ndarray) -> jnp.ndarray:
        """padded: 7200 Hz audio with (corr_len-1) history samples
        prepended -> mark-minus-space correlation power, exact for every
        output past the history region (which the caller slices off)."""
        def power(taps):
            c, s = taps
            i = fir.fir_filter(padded, jnp.asarray(c))
            q = fir.fir_filter(padded, jnp.asarray(s))
            return i * i + q * q
        mark = fir.fir_filter(power(self.mark_taps), self.avg_taps)
        space = fir.fir_filter(power(self.space_taps), self.avg_taps)
        return (mark - space)[self._corr_len - 1:]

    def _step(self, carry, decision):
        window, sp = carry
        window = jnp.concatenate([window[1:], decision[None]])
        sp = sp - 1.0
        has_symbol = sp < 1.0
        votes = jax.lax.dynamic_slice_in_dim(
            window, self.half_sps, self.int_sps)
        bit = (jnp.sum(votes) > self.int_sps // 2).astype(jnp.int8)
        zc = jax.lax.dynamic_slice_in_dim(
            window, self.window_len - self.zc_len, self.zc_len)
        crossings = (zc[:-1] != zc[1:])
        count = jnp.sum(crossings)
        idx = jnp.argmax(crossings)
        err1 = (idx.astype(jnp.float32) + 0.5) - self.zc_ideal
        error = jnp.where(count == 1, err1, 0.0)
        sp_next = jnp.where(
            has_symbol, sp + SPS + error * self.timing_gain, sp)
        return (window, sp_next), (bit, has_symbol)

    def __call__(self, audio: jnp.ndarray, state: AFSKState | None = None):
        """8 kHz audio block -> (bits, valid, state). Block length must be
        a multiple of 10 (the resampler's `down`)."""
        if state is None:
            state = self.init_state()
        audio = audio.astype(jnp.float32)
        resampled = fir.polyphase_resample(
            audio, self.rtaps, self.up, self.down, state.resample)
        tpp = len(self.rtaps) // self.up
        rstate = jnp.concatenate([state.resample, audio])[-tpp:]
        padded = jnp.concatenate([state.corr, resampled])
        diff = self._correlate(padded)
        decisions = (diff > 0.0).astype(jnp.int8)
        if self.invert:
            decisions = 1 - decisions
        (window, sp), (bits, valid) = jax.lax.scan(
            self._step, (state.window, state.sampling_point), decisions)
        new_state = AFSKState(
            resample=rstate,
            corr=padded[-(self._corr_len - 1):],
            window=window, sampling_point=sp)
        return bits, valid, new_state
