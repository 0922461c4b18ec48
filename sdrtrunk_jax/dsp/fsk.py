"""Zero-crossing FSK symbol recovery (LTR / Passport sub-audible 300 baud).

Batched reformulation of the reference's LTRDecoder chain
(dsp/fsk/LTRDecoder.java:52: DC removal -> 300/500 Hz remez LPF -> >0
slicing -> SampleBuffer majority-vote symbol decision -> zero-crossing
timing error, dsp/fsk/ZeroCrossingErrorDetector.java:34,
dsp/fsk/SampleBuffer.java). The per-sample feedback loop becomes one
lax.scan step, vmappable across channels.

Geometry at 8 kHz / 300 baud (sps = 26.667): boolean delay line of
floor(2*sps) = 53 slicer decisions; symbol decision = majority vote over
the 27-sample window [13, 40) of the line (0.5..1.5 symbols back); timing
error = distance of the nearest zero crossing in the newest ceil(sps)=27
samples from the ideal mid-symbol crossing position sps/2.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from . import design, fir

__all__ = ["LTRFSKDemodulator", "LTRFSKState"]


class LTRFSKState(NamedTuple):
    window: jnp.ndarray         # (W,) int8 slicer decisions, newest at [-1]
    sampling_point: jnp.ndarray  # f32 mid-symbol counter
    dc: jnp.ndarray             # f32 DC-removal accumulator
    fir: jnp.ndarray            # LPF delay line


@dataclass
class LTRFSKDemodulator:
    sample_rate: float = 8000.0
    symbol_rate: float = 300.0
    timing_gain: float = 1.0 / 3.0   # COARSE_TIMING_GAIN (LTRDecoder.java)
    dc_ratio: float = 0.99999

    def __post_init__(self):
        self.sps = self.sample_rate / self.symbol_rate
        self.window_len = int(math.floor(2.0 * self.sps))
        self.int_sps = int(self.sps + 0.5)
        self.half_sps = int(self.sps / 2.0 + 0.5)
        self.zc_len = int(math.ceil(self.sps))
        self.zc_ideal = self.sps / 2.0
        self.taps = np.asarray(
            design.remez_lowpass(63, 300.0, 500.0, self.sample_rate,
                                 0.01, 0.03), jnp.float32)

    def init_state(self) -> LTRFSKState:
        return LTRFSKState(
            window=jnp.zeros((self.window_len,), jnp.int8),
            sampling_point=jnp.asarray(self.sps + self.half_sps, jnp.float32),
            dc=jnp.zeros((), jnp.float32),
            fir=fir.fir_init(len(self.taps), jnp.float32),
        )

    def _step(self, carry, x_t):
        window, sp = carry
        decision = (x_t > 0.0).astype(jnp.int8)
        window = jnp.concatenate([window[1:], decision[None]])
        sp = sp - 1.0
        has_symbol = sp < 1.0

        # majority vote over [half_sps, half_sps + int_sps)
        votes = jax.lax.dynamic_slice_in_dim(
            window, self.half_sps, self.int_sps)
        bit = (jnp.sum(votes) > self.int_sps // 2).astype(jnp.int8)

        # zero-crossing timing error over the newest zc_len decisions
        zc = jax.lax.dynamic_slice_in_dim(
            window, self.window_len - self.zc_len, self.zc_len)
        crossings = (zc[:-1] != zc[1:])
        count = jnp.sum(crossings)
        idx = jnp.argmax(crossings)          # first crossing
        rev_idx = (self.zc_len - 2
                   - jnp.argmax(crossings[::-1]))  # last crossing
        # error = detected - ideal: firing LATE means the boundary sits
        # closer to the window start (smaller index), so detected < ideal
        # and the negative error SHORTENS the next interval. (The opposite
        # sign — as a literal reading of ZeroCrossingErrorDetector.java
        # suggests — makes the loop a positive-feedback limit cycle.)
        err1 = (idx.astype(jnp.float32) + 0.5) - self.zc_ideal
        err2 = (rev_idx.astype(jnp.float32) + 0.5) - self.zc_ideal
        err_two = jnp.where(jnp.abs(err1) < jnp.abs(err2), err1, err2)
        error = jnp.where(count == 1, err1,
                          jnp.where(count == 2, err_two, 0.0))
        sp_next = jnp.where(
            has_symbol, sp + self.sps + error * self.timing_gain, sp)
        return (window, sp_next), (bit, has_symbol)

    def __call__(self, audio: jnp.ndarray, state: LTRFSKState | None = None):
        """Demodulate an 8 kHz audio block -> (bits, valid, state)."""
        if state is None:
            state = self.init_state()
        # single-pole DC removal: y[n] = x[n] - acc; acc += (1-r) * y[n]
        def dc_step(acc, x):
            y = x - acc
            return acc + (1.0 - self.dc_ratio) * y, y
        dc, no_dc = jax.lax.scan(dc_step, state.dc, audio)
        filtered, fir_state = fir.fir_apply(no_dc, self.taps, state.fir)
        (window, sp), (bits, valid) = jax.lax.scan(
            self._step, (state.window, state.sampling_point), filtered)
        return bits, valid, LTRFSKState(window, sp, dc, fir_state)
