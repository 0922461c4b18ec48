"""Shared DQPSK decoder chain: baseband FIR -> power monitor -> AGC ->
DQPSK symbol recovery.

Every DQPSK-family decoder in the reference composes the same front end
around its symbol-recovery core (P25P1DecoderC4FM.java:101,
DMRDecoder.java:54, P25P1DecoderLSM.java:52, P25P2DecoderHDQPSK.java:62):
a remez-designed baseband LPF, a power monitor, and a 32-sample
feed-forward AGC. Subclasses provide `baseband_taps`, `demod` (a
DQPSKDemodulator or GardnerDQPSKDemodulator) and `config.agc_window`.

Two entry points:
  * __call__(x (T,), state)        — per-channel, vmap-friendly
  * batched_call(x (C, T), state)  — the fast path WidebandReceiver uses:
    the front end is vmapped (convs/reduce_window batch natively) but the
    sequential symbol recovery runs the demod's natively-batched core
    (the GPU kernel on the GPU, the (W, C)-layout scan elsewhere).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..dsp import agc, demod, fir

__all__ = ["DQPSKChainDecoder"]


class DQPSKChainDecoder:
    """Base class; subclass __init__ must set self.config (with
    .agc_window), self.baseband_taps, self.demod. A subclass may set
    self.upsample = 2 to zero-stuff the channel stream before the
    baseband FIR (which then doubles as the interpolation filter) —
    the P25P2 path needs the reference's 50 kHz channel rate
    (ChannelSpecification minimum; at 25 kHz the 6000-baud Gardner
    loop runs at sps 4.17 and leaves ~0.5% residual dibit errors,
    at 50 kHz it is error-free)."""

    upsample = 1

    def init_state(self) -> dict:
        return {
            "fir": fir.fir_init(len(self.baseband_taps), jnp.complex64),
            "agc": agc.feed_forward_agc_init(self.config.agc_window),
            "power": jnp.zeros((), jnp.float32),
            "psk": self.demod.init_state(),
        }

    def _front(self, x: jnp.ndarray, state: dict):
        """FIR + power monitor + AGC for one channel."""
        if self.upsample > 1:
            up = self.upsample
            x = (jnp.zeros((x.shape[0] * up,), x.dtype)
                 .at[::up].set(x) * up)   # images removed by the LPF
        filtered, fir_state = fir.fir_apply(x, self.baseband_taps,
                                            state["fir"])
        power_trace, power_state = demod.power_db(
            filtered, 0.0004, state["power"])
        leveled, agc_state = agc.feed_forward_agc(
            filtered, state["agc"], self.config.agc_window)
        return (leveled, power_trace), {"fir": fir_state, "agc": agc_state,
                                        "power": power_state}

    def __call__(self, x: jnp.ndarray, state: dict) -> tuple[dict, dict]:
        (leveled, power_trace), front_state = self._front(
            x, {k: state[k] for k in ("fir", "agc", "power")})
        dibits, valid, psk_state = self.demod(leveled, state["psk"])
        outputs = {"dibits": dibits, "valid": valid,
                   "power_db": power_trace, "pll_freq": psk_state.pll_freq}
        return outputs, {**front_state, "psk": psk_state}

    def batched_call(self, x: jnp.ndarray, state: dict
                     ) -> tuple[dict, dict]:
        """Decode a (C, T) block; state leaves carry a leading C axis."""
        (leveled, power_trace), front_state = jax.vmap(self._front)(
            x, {k: state[k] for k in ("fir", "agc", "power")})
        dibits, valid, psk_state = self.demod.batched(leveled, state["psk"])
        outputs = {"dibits": dibits, "valid": valid,
                   "power_db": power_trace, "pll_freq": psk_state.pll_freq}
        return outputs, {**front_state, "psk": psk_state}
