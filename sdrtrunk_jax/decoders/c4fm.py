"""P25 Phase 1 C4FM decoder chain (device side, up to dibits).

Reference chain (module/decode/p25/phase1/P25P1DecoderC4FM.java:101):
    IQ 25-50 kHz -> remez baseband LPF (pass 5100 / stop 6500, ripple 0.01)
    -> power monitor -> feed-forward AGC (window 32)
    -> decision-directed DQPSK demod (PLL BW_300, timing gain 0.3) -> dibits

The message framing / NID detection that follows is host-side
(sdrtrunk_jax.protocol.p25p1).
"""
from __future__ import annotations

from dataclasses import dataclass

import jax.numpy as jnp
import numpy as np

from ..dsp import design
from ..dsp.psk import DQPSKDemodulator
from .dqpsk_chain import DQPSKChainDecoder


@dataclass(frozen=True)
class C4FMConfig:
    sample_rate: float = 25000.0
    symbol_rate: float = 4800.0
    # P25P1DecoderC4FM baseband filter spec (SURVEY.md section 2.7)
    pass_hz: float = 5100.0
    stop_hz: float = 6500.0
    sample_counter_gain: float = 0.3   # P25P1DecoderC4FM.java:48
    pll_bandwidth: float = 300.0       # PLLBandwidth.BW_300
    agc_window: int = 32


class C4FMDecoder(DQPSKChainDecoder):
    def __init__(self, config: C4FMConfig = C4FMConfig()):
        self.config = config
        self.baseband_taps = np.asarray(
            design.remez_lowpass(63, config.pass_hz, config.stop_hz,
                                 config.sample_rate, 0.01, 0.01), jnp.float32)
        self.demod = DQPSKDemodulator(
            sample_rate=config.sample_rate,
            symbol_rate=config.symbol_rate,
            sample_counter_gain=config.sample_counter_gain,
            loop_bandwidth=config.pll_bandwidth)
