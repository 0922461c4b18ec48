"""DQPSK symbol recovery as a carried-state scan (the hard kernel).

Batched reformulation of the reference's per-sample feedback chain
(dsp/psk/PSKDemodulator.java:101 receive -> CostasLoop de-rotation ->
InterpolatingSampleBuffer -> DQPSKDecisionDirectedSymbolEvaluator decision ->
timing/PLL feedback). The loop is inherently sequential per channel, so it
becomes ONE step per input sample with a small carried state, and
throughput comes from batching the step across >=hundreds of channels.

Two implementations of `batched` share the semantics below:

  * the XLA `lax.scan` in `_scan_batched` — the reference, and the CPU
    path. Its body is natively batched over channels: state vectors are
    (C,) and the delay-line window is carried as (W, C). The
    interpolator arm lookup bank[idx] is a gather (`jnp.take`), exact
    by construction;
  * the GPU kernel in dsp/psk_kernels.py, which runs the time loop
    inside one kernel with the state in registers (`impl`, below).

Semantics mirror the reference exactly (same update order, gains, clamps):
  * 2nd-order Costas loop: alpha/beta from loop BW 2*pi/300, damping
    sqrt(2)/2, freq clamp +/- 2*pi*(baud/2)/fs
    (dsp/psk/pll/CostasLoop.java:44-70,178-218)
  * interpolating buffer: sampling point decremented per sample, symbol when
    < 1.0; detected samples/symbol tracked +/-2% with gain 0.1*g^2; timing
    feedback adds detectedSPS + err*g (InterpolatingSampleBuffer.java:58-124)
  * decision-directed evaluator: quadrant decision, de-rotated quadrature as
    phase/timing error, error clip 0.3, PLL adjust clip 0.5
    (DQPSKDecisionDirectedSymbolEvaluator.java:61-105)

Dibit mapping (dsp/symbol/Dibit.java): 0=+1(+45deg) 1=+3(+135deg)
2=-1(-45deg) 3=-3(-135deg).

Each scan step emits (dibit, valid) — at most one symbol per sample. The
host (or downstream device code) compacts valid dibits.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .interpolator import CENTER, NSTEPS, interpolator_bank

__all__ = ["DQPSKDemodulator", "DQPSKState", "costas_gains",
           "GardnerDQPSKDemodulator", "GardnerState", "resolve_impl"]

TWO_PI = 2.0 * math.pi


IMPLS = ("auto", "xla", "kernel", "interpret")


def resolve_impl(impl: str) -> str:
    """The symbol-recovery path `batched` takes.

    "auto" is the GPU kernel (dsp/psk_kernels.py) when JAX's default
    backend is the GPU and the XLA scan otherwise; "xla" and "kernel"
    force a path; "interpret" runs the kernel in the Pallas interpreter
    (CPU tests). Nothing falls back: a kernel that fails to lower or
    compile raises.
    """
    if impl not in IMPLS:
        raise ValueError(f"unknown impl {impl!r}; expected one of {IMPLS}")
    if impl == "auto":
        return "kernel" if jax.default_backend() == "gpu" else "xla"
    return impl


def _batched(demod, x, state):
    impl = resolve_impl(demod.impl)
    if impl == "xla":
        return demod._scan_batched(x, state)
    from .psk_kernels import kernel_batched
    return kernel_batched(demod, x, state, interpret=(impl == "interpret"))


def costas_gains(loop_bandwidth: float = 300.0,
                 damping: float = math.sqrt(2.0) / 2.0) -> tuple[float, float]:
    """(alpha, beta) loop gains (CostasLoop.java:109-115)."""
    bw = TWO_PI / loop_bandwidth
    denom = 1.0 + 2.0 * damping * bw + bw * bw
    alpha = 4.0 * damping * bw / denom
    beta = 4.0 * bw * bw / denom
    return alpha, beta


def _wrap(phase: jnp.ndarray) -> jnp.ndarray:
    """CostasLoop phase wrap to +/-2pi (CostasLoop.java:150-160)."""
    phase = jnp.where(phase > TWO_PI, phase - TWO_PI, phase)
    return jnp.where(phase < -TWO_PI, phase + TWO_PI, phase)


def _normalize(z: jnp.ndarray) -> jnp.ndarray:
    """Unit-magnitude normalize with zero-safe guard (z * rsqrt(|z|^2)
    rather than z / sqrt(|z|^2): one fused rsqrt instead of
    sqrt + divide, measurably cheaper inside the per-sample scan)."""
    mag2 = (z.real * z.real + z.imag * z.imag).astype(jnp.float32)
    inv = jax.lax.rsqrt(jnp.maximum(mag2, 1e-30))
    return jnp.where(mag2 > 1e-24, z * inv, jnp.zeros_like(z))


_SQRT_HALF = math.sqrt(0.5)


def _derotated_quadrature(ci: jnp.ndarray, cq: jnp.ndarray) -> jnp.ndarray:
    """Imag part of symbol * conj(reference) where reference is the
    nearest ideal DQPSK point (pi/4 + k*pi/2).

    The reference constellation point lies in the symbol's own quadrant,
    so cos(ref) = sqrt(1/2)*sign(ci) and sin(ref) = sqrt(1/2)*sign(cq)
    exactly — the rotate-back collapses to
        imag = sqrt(1/2) * (cq*sign(ci) - ci*sign(cq))
    with no transcendentals (sign selection, not approximation). Signs
    follow the slicer's strict `> 0` convention (x <= 0 -> -1) so the
    boundary cases match the quadrant the dibit decision picked.
    """
    sgn_i = jnp.where(ci > 0.0, 1.0, -1.0)
    sgn_q = jnp.where(cq > 0.0, 1.0, -1.0)
    return _SQRT_HALF * (cq * sgn_i - ci * sgn_q)


def _arm_taps(bank: jnp.ndarray, mu: jnp.ndarray) -> jnp.ndarray:
    """Interpolator taps for fractional mu in [0, 1], batched over lanes.

    Selects arm idx = int(NSTEPS * mu) from the (NSTEPS+1, 8) bank
    (RealInterpolator.java:41 arm selection) with a gather: exact row
    selection, no matmul whose precision could round the taps.
    mu: (C,) -> taps (8, C).
    """
    idx = jnp.clip((NSTEPS * mu).astype(jnp.int32), 0, NSTEPS)      # (C,)
    return jnp.take(bank, idx, axis=0).T                             # (8, C)


def _tap_sum(taps: jnp.ndarray, w8: jnp.ndarray) -> jnp.ndarray:
    """sum_j taps[j] * w8[j] over the 8 taps, accumulated in tap order —
    the order the GPU kernel uses, so both round alike."""
    acc = taps[0] * w8[0]
    for j in range(1, taps.shape[0]):
        acc = acc + taps[j] * w8[j]
    return acc


class DQPSKState(NamedTuple):
    window: jnp.ndarray        # (W,) complex64 delay line, newest at [-1]
    sampling_point: jnp.ndarray  # f32
    detected_sps: jnp.ndarray    # f32
    pll_phase: jnp.ndarray       # f32
    pll_freq: jnp.ndarray        # f32
    prev_preceding: jnp.ndarray  # complex64
    prev_current: jnp.ndarray    # complex64


@dataclass
class DQPSKDemodulator:
    """Decision-directed DQPSK demod for constant-envelope 4-FSK (C4FM/DMR).

    sample_counter_gain: 0.3 for P25P1 (P25P1DecoderC4FM.java:48),
    0.4 for DMR (DMRDecoder.java:58).
    """
    sample_rate: float
    symbol_rate: float = 4800.0
    sample_counter_gain: float = 0.3
    loop_bandwidth: float = 300.0
    max_deviation: float = 0.02   # +/-2% samples-per-symbol tracking
    impl: str = "auto"            # batched() path, see resolve_impl

    def __post_init__(self):
        self.samples_per_symbol = self.sample_rate / self.symbol_rate
        if self.samples_per_symbol < 4.0:
            raise ValueError("need >= 4 samples/symbol for the 8-tap interpolator")
        self.window_len = int(math.floor(2.0 * self.samples_per_symbol))
        self.alpha, self.beta = costas_gains(self.loop_bandwidth)
        self.max_pll_freq = TWO_PI * (self.symbol_rate / 2.0) / self.sample_rate
        self.dsps_gain = 0.1 * self.sample_counter_gain ** 2
        self.bank = np.asarray(interpolator_bank())

    def init_state(self) -> DQPSKState:
        sps = self.samples_per_symbol
        return DQPSKState(
            window=jnp.zeros((self.window_len,), jnp.complex64),
            sampling_point=jnp.asarray(sps, jnp.float32),
            detected_sps=jnp.asarray(sps, jnp.float32),
            pll_phase=jnp.zeros((), jnp.float32),
            pll_freq=jnp.zeros((), jnp.float32),
            prev_preceding=jnp.zeros((), jnp.complex64),
            prev_current=jnp.zeros((), jnp.complex64),
        )

    def _step(self, state: DQPSKState, x_t: jnp.ndarray):
        """One sample across all channels: window (W, C), scalars (C,)."""
        sps_min = self.samples_per_symbol * (1.0 - self.max_deviation)
        sps_max = self.samples_per_symbol * (1.0 + self.max_deviation)
        g = self.sample_counter_gain
        bank = jnp.asarray(self.bank, jnp.float32)

        # --- PLL increment + mix (PSKDemodulator.java:101-110) ---
        phase = _wrap(state.pll_phase + state.pll_freq)
        mixed = x_t * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))

        window = jnp.concatenate([state.window[1:], mixed[None, :]])
        sampling_point = state.sampling_point - 1.0
        has_symbol = sampling_point < 1.0

        # --- interpolate current sample at mu = sampling_point ---
        mu = jnp.clip(sampling_point, 0.0, 1.0)
        taps = _arm_taps(bank, mu)                  # (8, C)
        w8 = window[:8]                             # (8, C)
        current = jax.lax.complex(_tap_sum(taps, w8.real),
                                  _tap_sum(taps, w8.imag))   # (C,)
        preceding = window[CENTER]

        # --- differential decode + normalize ---
        preceding_symbol = _normalize(preceding * jnp.conj(state.prev_preceding))
        current_symbol = _normalize(current * jnp.conj(state.prev_current))

        # --- quadrant decision (DQPSKDecisionDirectedSymbolEvaluator) ---
        ci, cq = current_symbol.real, current_symbol.imag
        pq = preceding_symbol.imag
        q_pos = cq > 0.0
        i_pos = ci > 0.0
        dibit = jnp.where(q_pos,
                          jnp.where(i_pos, 0, 1),
                          jnp.where(i_pos, 2, 3)).astype(jnp.int32)
        # timing polarity (DQPSKDecisionDirectedSymbolEvaluator.java:61-105):
        # +45/-45 (I>0) -> sign(pq > cq); +135/-135 (I<0) -> sign(pq < cq)
        polarity = jnp.where(i_pos, jnp.where(pq > cq, 1.0, -1.0),
                             jnp.where(pq < cq, 1.0, -1.0))
        # rotate current symbol back to 0 rad (transcendental-free)
        err = jnp.clip(_derotated_quadrature(ci, cq), -0.3, 0.3)
        err = jnp.where(jnp.isnan(err), 0.0, err)
        phase_error = -err
        timing_error = err * polarity

        # --- timing update (InterpolatingSampleBuffer.resetAndAdjust) ---
        detected = jnp.clip(state.detected_sps + timing_error * self.dsps_gain,
                            sps_min, sps_max)
        sp_new = sampling_point + detected + timing_error * g

        # --- PLL adjust (CostasLoop.adjust, error clipped 0.5) ---
        perr = jnp.clip(phase_error, -0.5, 0.5)
        freq = state.pll_freq + self.beta * perr
        phase2 = _wrap(phase + freq + self.alpha * perr)
        freq = jnp.clip(freq, -self.max_pll_freq, self.max_pll_freq)

        new_state = DQPSKState(
            window=window,
            sampling_point=jnp.where(has_symbol, sp_new, sampling_point),
            detected_sps=jnp.where(has_symbol, detected, state.detected_sps),
            pll_phase=jnp.where(has_symbol, phase2, phase),
            pll_freq=jnp.where(has_symbol, freq, state.pll_freq),
            prev_preceding=jnp.where(has_symbol, preceding,
                                     state.prev_preceding),
            prev_current=jnp.where(has_symbol, current, state.prev_current),
        )
        return new_state, (dibit, has_symbol)

    def batched(self, x: jnp.ndarray, state: DQPSKState
                ) -> tuple[jnp.ndarray, jnp.ndarray, DQPSKState]:
        """Demodulate a (C, T) block. Returns (dibits, valid, state),
        dibits/valid (C, T); state leaves carry a leading C axis
        (window (C, W)) — the layout WidebandReceiver broadcasts and
        checkpoints; the scan-internal layout is (W, C). The path
        follows `impl` (see resolve_impl)."""
        return _batched(self, x, state)

    def _scan_batched(self, x: jnp.ndarray, state: DQPSKState
                      ) -> tuple[jnp.ndarray, jnp.ndarray, DQPSKState]:
        """XLA lax.scan implementation of batched() (the reference)."""
        state = state._replace(window=state.window.T)      # (W, C)
        state, (dibits, valid) = jax.lax.scan(self._step, state, x.T)
        state = state._replace(window=state.window.T)      # (C, W)
        return dibits.T, valid.T, state

    def __call__(self, x: jnp.ndarray, state: DQPSKState | None = None
                 ) -> tuple[jnp.ndarray, jnp.ndarray, DQPSKState]:
        """Demodulate a 1-D block. Returns (dibits, valid_mask, state).

        dibits/valid are per input sample; dibits[i] is meaningful where
        valid[i]. Compact with dibits[valid] on host, or feed the (values,
        mask) pair to downstream device framing.
        """
        if state is None:
            state = self.init_state()
        bstate = jax.tree.map(lambda a: a[None], state)
        # per-channel path always uses the XLA scan: it is routinely
        # wrapped in an outer jax.vmap (tests, generic receivers)
        dibits, valid, bstate = self._scan_batched(x[None, :], bstate)
        state = jax.tree.map(lambda a: a[0], bstate)
        return dibits[0], valid[0], state


class GardnerState(NamedTuple):
    window: jnp.ndarray          # (W,) complex64 delay line, newest at [-1]
    sampling_point: jnp.ndarray  # f32
    detected_sps: jnp.ndarray    # f32
    pll_phase: jnp.ndarray       # f32
    pll_freq: jnp.ndarray        # f32
    prev_mid_sample: jnp.ndarray   # complex64 (raw interpolated, mu point)
    prev_cur_sample: jnp.ndarray   # complex64 (raw interpolated, +sps/2)
    prev_cur_symbol: jnp.ndarray   # complex64 (normalized differential)


@dataclass
class GardnerDQPSKDemodulator:
    """DQPSK demod with a Gardner timing error detector — the reference's
    choice for P25 Linear Simulcast Modulation and P25 Phase 2 HDQPSK
    (dsp/psk/DQPSKGardnerDemodulator.java:30-88,
    DQPSKGardnerSymbolEvaluator.java:63-106).

    Differences from the decision-directed core, mirrored exactly:
      * TWO interpolation points per symbol: the Gardner mid-point at the
        sampling point mu, and the symbol sample half a detected symbol
        period later (InterpolatingSampleBuffer.getMiddleSample:171-179
        interpolates at detectedSPS/2 — note it does not add mu).
      * both points are differentially decoded against their own previous
        raw samples and normalized, then the Gardner TED
        err = (prevSym.i - curSym.i)*mid.i + (prevSym.q - curSym.q)*mid.q
        clipped +/-0.3 drives timing; the quadrant decision + de-rotated
        quadrature of the symbol sample drives the PLL (clip 0.3) — same
        resetAndAdjust / CostasLoop.adjust updates as decision-directed.

    The amplitude-sensitive TED handles the intersymbol fading of
    simulcast channels where the decision-directed detector loses lock.

    State-format note: `window_len` (below) feeds the GardnerState window
    shape, so changing the formula invalidates previously saved
    checkpoints — runtime/checkpoint.py fingerprints leaf shapes, making
    a stale checkpoint fail loudly with a StateCheckpointError rather
    than restoring a misaligned delay line.

    Like DQPSKDemodulator, the scan body is natively batched: window
    (W, C), scalars (C,). The integer-base window fetch
    (InterpolatingSampleBuffer.getInphase:186-198: integer part moves the
    8-tap base, fractional part selects the arm) is a per-lane gather
    from the window, restricted to the statically feasible bases.
    """
    sample_rate: float
    symbol_rate: float = 4800.0
    sample_counter_gain: float = 0.3
    loop_bandwidth: float = 300.0
    max_deviation: float = 0.02
    impl: str = "auto"            # batched() path, see resolve_impl

    def __post_init__(self):
        self.samples_per_symbol = self.sample_rate / self.symbol_rate
        if self.samples_per_symbol < 4.0:
            raise ValueError("need >= 4 samples/symbol for the 8-tap interpolator")
        # window must cover the symbol-sample offset floor(sps_max/2) + 8
        # interpolator taps; 2*sps covers it for sps >= 4 with 2% deviation
        self.window_len = max(int(math.floor(2.0 * self.samples_per_symbol)),
                              int(self.samples_per_symbol * 1.02 / 2) + 9)
        self.alpha, self.beta = costas_gains(self.loop_bandwidth)
        self.max_pll_freq = TWO_PI * (self.symbol_rate / 2.0) / self.sample_rate
        self.dsps_gain = 0.1 * self.sample_counter_gain ** 2
        self.bank = np.asarray(interpolator_bank())
        # statically-feasible integer offsets for the two interpolation
        # points (exact, not an approximation): the Gardner mid-point's
        # offset is clip(sp, 0, 1) -> floor in {0, 1}; the symbol
        # point's offset is detected_sps/2 with detected_sps clipped to
        # [sps_min, sps_max]. The GPU kernel selects among only these
        # (+-1 f32 edge margin) bases, 2-3 per point at P25P2's
        # 16-sample window; lanes outside them read zeros on both paths.
        w = self.window_len
        sps_min = self.samples_per_symbol * (1.0 - self.max_deviation)
        sps_max = self.samples_per_symbol * (1.0 + self.max_deviation)
        self.mid_bases = tuple(range(0, min(w - 8, 1) + 1))
        lo = max(0, int(math.floor(sps_min / 2.0)) - 1)
        hi = min(w - 8, int(math.floor(sps_max / 2.0)) + 1)
        self.cur_bases = tuple(range(lo, hi + 1))

    def init_state(self) -> GardnerState:
        sps = self.samples_per_symbol
        return GardnerState(
            window=jnp.zeros((self.window_len,), jnp.complex64),
            sampling_point=jnp.asarray(sps, jnp.float32),
            detected_sps=jnp.asarray(sps, jnp.float32),
            pll_phase=jnp.zeros((), jnp.float32),
            pll_freq=jnp.zeros((), jnp.float32),
            prev_mid_sample=jnp.zeros((), jnp.complex64),
            prev_cur_sample=jnp.zeros((), jnp.complex64),
            prev_cur_symbol=jnp.zeros((), jnp.complex64),
        )

    def _interp(self, window: jnp.ndarray, offset: jnp.ndarray,
                bases: tuple) -> jnp.ndarray:
        """Interpolate at fractional `offset` samples into the (W, C)
        window, batched over channels: the integer part selects the
        8-tap base position, the fractional part the polyphase arm —
        both gathers. `bases` is the contiguous static range of feasible
        integer offsets (see __post_init__); a lane outside it reads
        zeros."""
        w = window.shape[0]
        k = jnp.floor(offset).astype(jnp.int32)
        mu = offset - k.astype(jnp.float32)
        base = jnp.clip(k, 0, w - 8)                    # (C,)
        taps = _arm_taps(jnp.asarray(self.bank, jnp.float32), mu)  # (8, C)
        rows = base[None, :] + jnp.arange(8)[:, None]   # (8, C)
        w8 = jnp.take_along_axis(window, rows, axis=0)  # (8, C)
        w8 = jnp.where((base >= bases[0]) & (base <= bases[-1]), w8, 0)
        return jax.lax.complex(_tap_sum(taps, w8.real),
                               _tap_sum(taps, w8.imag))

    def _step(self, state: GardnerState, x_t: jnp.ndarray):
        """One sample across all channels: window (W, C), scalars (C,)."""
        sps_min = self.samples_per_symbol * (1.0 - self.max_deviation)
        sps_max = self.samples_per_symbol * (1.0 + self.max_deviation)
        g = self.sample_counter_gain

        phase = _wrap(state.pll_phase + state.pll_freq)
        mixed = x_t * jax.lax.complex(jnp.cos(phase), jnp.sin(phase))

        window = jnp.concatenate([state.window[1:], mixed[None, :]])
        sampling_point = state.sampling_point - 1.0
        has_symbol = sampling_point < 1.0

        mu = jnp.clip(sampling_point, 0.0, 1.0)
        mid_sample = self._interp(window, mu, self.mid_bases)
        cur_sample = self._interp(window, state.detected_sps / 2.0,
                                  self.cur_bases)

        mid_symbol = _normalize(mid_sample * jnp.conj(state.prev_mid_sample))
        cur_symbol = _normalize(cur_sample * jnp.conj(state.prev_cur_sample))

        # --- Gardner TED (DQPSKGardnerSymbolEvaluator.setSymbols:63-70) ---
        prev = state.prev_cur_symbol
        terr = ((prev.real - cur_symbol.real) * mid_symbol.real +
                (prev.imag - cur_symbol.imag) * mid_symbol.imag)
        terr = jnp.clip(jnp.where(jnp.isnan(terr), 0.0, terr), -0.3, 0.3)

        # --- quadrant decision + phase error (same slicer as DD) ---
        ci, cq = cur_symbol.real, cur_symbol.imag
        q_pos = cq > 0.0
        i_pos = ci > 0.0
        dibit = jnp.where(q_pos,
                          jnp.where(i_pos, 0, 1),
                          jnp.where(i_pos, 2, 3)).astype(jnp.int32)
        perr_raw = -_derotated_quadrature(ci, cq)
        perr_raw = jnp.clip(jnp.where(jnp.isnan(perr_raw), 0.0, perr_raw),
                            -0.3, 0.3)

        detected = jnp.clip(state.detected_sps + terr * self.dsps_gain,
                            sps_min, sps_max)
        sp_new = sampling_point + detected + terr * g

        perr = jnp.clip(perr_raw, -0.5, 0.5)
        freq = state.pll_freq + self.beta * perr
        phase2 = _wrap(phase + freq + self.alpha * perr)
        freq = jnp.clip(freq, -self.max_pll_freq, self.max_pll_freq)

        new_state = GardnerState(
            window=window,
            sampling_point=jnp.where(has_symbol, sp_new, sampling_point),
            detected_sps=jnp.where(has_symbol, detected, state.detected_sps),
            pll_phase=jnp.where(has_symbol, phase2, phase),
            pll_freq=jnp.where(has_symbol, freq, state.pll_freq),
            prev_mid_sample=jnp.where(has_symbol, mid_sample,
                                      state.prev_mid_sample),
            prev_cur_sample=jnp.where(has_symbol, cur_sample,
                                      state.prev_cur_sample),
            prev_cur_symbol=jnp.where(has_symbol, cur_symbol,
                                      state.prev_cur_symbol),
        )
        return new_state, (dibit, has_symbol)

    def batched(self, x: jnp.ndarray, state: GardnerState
                ) -> tuple[jnp.ndarray, jnp.ndarray, GardnerState]:
        """Demodulate a (C, T) block; see DQPSKDemodulator.batched."""
        return _batched(self, x, state)

    def _scan_batched(self, x: jnp.ndarray, state: GardnerState
                      ) -> tuple[jnp.ndarray, jnp.ndarray, GardnerState]:
        """XLA lax.scan implementation of batched() (the reference)."""
        state = state._replace(window=state.window.T)
        state, (dibits, valid) = jax.lax.scan(self._step, state, x.T)
        state = state._replace(window=state.window.T)
        return dibits.T, valid.T, state

    def __call__(self, x: jnp.ndarray, state: GardnerState | None = None
                 ) -> tuple[jnp.ndarray, jnp.ndarray, GardnerState]:
        """Demodulate a 1-D block; see DQPSKDemodulator.__call__.

        Always the XLA scan: the per-channel path is routinely wrapped
        in an outer jax.vmap."""
        if state is None:
            state = self.init_state()
        bstate = jax.tree.map(lambda a: a[None], state)
        dibits, valid, bstate = self._scan_batched(x[None, :], bstate)
        state = jax.tree.map(lambda a: a[0], bstate)
        return dibits[0], valid[0], state
