"""WidebandReceiver: the flagship single-chip pipeline.

Wideband IQ -> polyphase channelize (all M bins) -> extract C channels ->
vmapped per-channel decoder (NBFM audio, or C4FM/DMR/P25P2 DQPSK symbol
recovery to dibits), one fused jitted graph.

This is the batched equivalent of a whole rack of the reference's per-channel
ProcessingChains (controller/channel/ChannelProcessingManager.java:290): the
reference runs ~dozens of channels per CPU core; here every stage is a
batched array op over >=1000 channels at once.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from .dsp.channelizer import Channelizer
from .dsp.extract import plan_channels

__all__ = ["WidebandReceiver", "MultibankReceiver",
           "make_channel_decoder"]


def make_channel_decoder(kind: str, sample_rate: float,
                         channel_bandwidth: float = 12500.0):
    """Per-channel decoder for a channelizer output stream (the role of
    DecoderFactory.getModules' primary-decoder dispatch,
    module/decode/DecoderFactory.java:117-183)."""
    if kind == "nbfm":
        from .decoders.nbfm import NBFMConfig, NBFMDecoder
        return NBFMDecoder(NBFMConfig(sample_rate=sample_rate,
                                      bandwidth=channel_bandwidth))
    if kind == "am":
        from .decoders.am import AMConfig, AMDecoder
        return AMDecoder(AMConfig(sample_rate=sample_rate))
    if kind in ("c4fm", "p25p1"):
        from .decoders.c4fm import C4FMConfig, C4FMDecoder
        return C4FMDecoder(C4FMConfig(sample_rate=sample_rate))
    if kind == "dmr":
        from .decoders.dmr import DMRConfig, DMRDecoder
        return DMRDecoder(DMRConfig(sample_rate=sample_rate))
    if kind in ("lsm", "p25p1-lsm"):
        from .decoders.lsm import LSMConfig, LSMDecoder
        return LSMDecoder(LSMConfig(sample_rate=sample_rate))
    if kind == "p25p2":
        from .decoders.p25p2 import P25P2Config, P25P2Decoder
        return P25P2Decoder(P25P2Config(sample_rate=sample_rate))
    if kind in ("ltr", "ltrnet", "passport"):
        from .decoders.ltr import LTRLiveDecoder
        return LTRLiveDecoder(sample_rate, channel_bandwidth)
    if kind == "mpt1327":
        from .decoders.ltr import MPT1327LiveDecoder
        return MPT1327LiveDecoder(sample_rate, channel_bandwidth)
    raise ValueError(f"unknown decoder kind {kind!r}")


def _dynamic_select_mix(y, rot, mixer_phase, bins, step_rad, m):
    """Traced-index bin selection + PR synthesis join + residual mix for
    a slot bank (shared by WidebandReceiver.build_dynamic and
    MultibankReceiver). The selection is a gather along the bin axis:
    bit-exact, and on the H100 (700 W) 0.096 ms at (10240, 1024) ->
    1023 slots against 1.11 ms for an exact (HIGHEST) one-hot matmul; a
    default-precision one-hot matmul runs in TF32 there and is not
    exact (PERF.md). Returns (streams (C, K), new_mixer_phase)."""
    from .dsp.synthesizer import _ROT4
    del m
    k = y.shape[0]
    lo = jnp.take(y, bins[:, 0], axis=1)               # (K, C)
    hi = jnp.take(y, bins[:, 1], axis=1)
    rot4 = jnp.asarray(_ROT4)[(rot + jnp.arange(k)) % 4]
    z = rot4[:, None] * lo - jnp.conj(rot4)[:, None] * hi
    streams = jnp.where((bins[:, 0] != bins[:, 1])[None, :], z, lo).T
    n = jnp.arange(k, dtype=jnp.float32)[None, :]
    angles = mixer_phase[:, None] + step_rad[:, None] * n
    streams = streams * jnp.exp(-1j * angles).astype(jnp.complex64)
    new_phase = jnp.mod(mixer_phase + step_rad * k, 2.0 * np.pi)
    return streams, new_phase


class MultibankReceiver:
    """Heterogeneous slot banks sharing ONE channelizer in one jitted
    graph: each bank runs a different protocol decoder over its slice of
    the slot axis (the reference freely mixes decoder types per channel,
    module/decode/DecoderFactory.java:117-183; here the mix is a static
    partition of the batched slot bank — BASELINE config 4's
    'P25 C4FM + DMR 4FSK + LTR analog decoded concurrently').

    banks: ordered [(kind, n_slots), ...]; slot index = bank-major.
    Outputs/state are keyed per bank as 'b<i>_<kind>'.
    """

    def __init__(self, sample_rate: float, banks, channel_bandwidth:
                 float = 12500.0, taps_per_channel: int = 9):
        self.channelizer = Channelizer.design(
            sample_rate, channel_bandwidth, taps_per_channel)
        rate = self.channelizer.channel_sample_rate
        self.banks = [
            (f"b{i}_{kind}", kind, int(n),
             make_channel_decoder(kind, rate, channel_bandwidth))
            for i, (kind, n) in enumerate(banks)]
        self.num_slots = sum(n for _, _, n, _ in self.banks)

    def decoder_for(self, key: str):
        return next(d for k2, _, _, d in self.banks if k2 == key)

    def slot_key(self, index: int) -> tuple[str, int]:
        """Global slot index -> (bank key, local index)."""
        off = 0
        for key, _, n, _ in self.banks:
            if index < off + n:
                return key, index - off
            off += n
        raise IndexError(index)

    def init_state(self) -> dict:
        state = {
            "chan": self.channelizer.init_state(),
            "mixer_phase": jnp.zeros((self.num_slots,), jnp.float32),
            "rot": jnp.zeros((), jnp.int32),
        }
        for key, _, n, dec in self.banks:
            dec0 = dec.init_state()
            state[key] = jax.tree.map(
                lambda a: jnp.broadcast_to(a, (n,) + a.shape), dec0)
        return state

    def build_dynamic(self):
        """step(x, state, bins (C,2), step_rad (C,)) ->
        ({bank_key: outputs}, state) — the multi-protocol analog of
        WidebandReceiver.build_dynamic."""
        ch = self.channelizer
        m = ch.channels
        hmat = np.asarray(ch.hmat)
        banks = self.banks

        from .dsp.channelizer import _channelize_core

        @jax.jit
        def run(x, state, bins, step_rad):
            if x.ndim == 2:
                x = jax.lax.complex(x[:, 0], x[:, 1])
            xp = jnp.concatenate([state["chan"], x.astype(jnp.complex64)])
            y = _channelize_core(xp, hmat, m)
            k = y.shape[0]
            streams, new_phase = _dynamic_select_mix(
                y, state["rot"], state["mixer_phase"], bins, step_rad, m)
            outputs = {}
            new_state = {
                "chan": xp[-state["chan"].shape[0]:],
                "mixer_phase": new_phase,
                "rot": (state["rot"] + k) % 4,
            }
            off = 0
            for key, _, n, dec in banks:
                vdecode = getattr(dec, "batched_call", None) or \
                    jax.vmap(dec.__call__)
                outs, dstate = vdecode(streams[off:off + n], state[key])
                outputs[key] = outs
                new_state[key] = dstate
                off += n
            return outputs, new_state

        return run


class WidebandReceiver:
    """Channelize + demodulate C channels from wideband IQ.

    decoder: "nbfm" (audio out) or "c4fm"/"dmr"/"p25p2" (dibits out), or
    any object with init_state()/__call__(x, state)->(outputs, state).

    Usage:
        rx = WidebandReceiver(sample_rate=12_800_000, channel_offsets=[...])
        step = rx.build()              # jitted: (x, state) -> (outputs, state)
        outputs, state = step(x, rx.init_state())
    """

    def __init__(self, sample_rate: float, channel_offsets,
                 channel_bandwidth: float = 12500.0, taps_per_channel: int = 9,
                 decoder: str = "nbfm", channel_bandwidths=None):
        """channel_bandwidths: optional per-channel bandwidth (scalar or
        list); channels wider than one bin are served by two adjacent bins
        through the PR synthesizer (TwoChannelOutputProcessor.java:26)."""
        self.channelizer = Channelizer.design(
            sample_rate, channel_bandwidth, taps_per_channel)
        self.plan = plan_channels(self.channelizer, channel_offsets,
                                  channel_bandwidths)
        if isinstance(decoder, str):
            decoder = make_channel_decoder(
                decoder, self.channelizer.channel_sample_rate,
                channel_bandwidth)
        self.decoder = decoder
        # natively-batched decoders (the DQPSK chains) skip vmap: their
        # symbol recovery runs batched over channels (the GPU kernel, or
        # the (W, C)-layout scan; see dsp/psk.py)
        self._vdecode = getattr(self.decoder, "batched_call", None) or \
            jax.vmap(self.decoder.__call__)

    @property
    def num_channels(self) -> int:
        return self.plan.count

    def init_state(self) -> dict:
        c = self.num_channels
        dec0 = self.decoder.init_state()
        dec = jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape), dec0)
        return {
            "chan": self.channelizer.init_state(),
            "mixer_phase": jnp.zeros((c,), jnp.float32),
            "rot": jnp.zeros((), jnp.int32),
            "dec": dec,
        }

    def build(self):
        ch = self.channelizer
        m = ch.channels
        # Closure constants stay host-side NumPy: a device array captured
        # as a jit constant would force a device->host copy at lowering.
        hmat = np.asarray(ch.hmat)
        bins = np.asarray(self.plan.bins)                 # (C, 2)
        wide = np.asarray(self.plan.wide)
        any_wide = bool(wide.any())
        step_rad = np.asarray(
            2.0 * np.pi * self.plan.offsets / self.plan.rate, np.float32)
        vdecode = self._vdecode

        from .dsp.channelizer import _channelize_core
        from .dsp.synthesizer import _ROT4

        # bins stay host-side CONSTANTS here (a fixed plan);
        # build_dynamic() takes them as runtime data for recompile-free
        # retuning.
        @jax.jit
        def run(x, state):
            # Accept complex IQ or float32 (n, 2) I/Q pairs (the wire
            # format of the live loop; complex is formed on device).
            if x.ndim == 2:
                x = jax.lax.complex(x[:, 0], x[:, 1])
            xp = jnp.concatenate([state["chan"], x.astype(jnp.complex64)])
            y = _channelize_core(xp, hmat, m)                  # (K, M)
            k = y.shape[0]
            lo = y[:, bins[:, 0]]                              # (K, C)
            if any_wide:
                hi = y[:, bins[:, 1]]
                rot = jnp.asarray(_ROT4)[
                    (state["rot"] + jnp.arange(k)) % 4][:, None]
                z = rot * lo - jnp.conj(rot) * hi
                streams = jnp.where(wide[None, :], z, lo).T    # (C, K)
            else:
                streams = lo.T
            n = jnp.arange(k, dtype=jnp.float32)[None, :]
            angles = state["mixer_phase"][:, None] + step_rad[:, None] * n
            streams = streams * jnp.exp(-1j * angles).astype(jnp.complex64)
            outputs, dec_state = vdecode(streams, state["dec"])
            new_state = {
                "chan": xp[-state["chan"].shape[0]:],
                "mixer_phase": jnp.mod(
                    state["mixer_phase"] + step_rad * k, 2.0 * np.pi),
                "rot": (state["rot"] + k) % 4,
                "dec": dec_state,
            }
            return outputs, new_state

        return run

    def build_dynamic(self):
        """Jitted step with the channel plan as RUNTIME DATA:

            step(x, state, bins, step_rad) -> (outputs, state)

        bins: int32 (C, 2) [lower, upper] bin pair per slot (equal for
        single-bin channels, adjacent for two-bin wide channels joined by
        the PR synthesizer); step_rad: float32 (C,)
        residual mixer step (radians/sample at the channel rate). Retuning
        a slot — the equivalent of ChannelProcessingManager starting a
        traffic channel (ChannelProcessingManager.java:290) — is just
        writing new values into these arrays: the compiled graph is
        reused, no retrace, no recompile. The reference pays a full
        ProcessingChain construction per grant; here a grant costs two
        array stores."""
        ch = self.channelizer
        m = ch.channels
        hmat = np.asarray(ch.hmat)
        vdecode = self._vdecode

        from .dsp.channelizer import _channelize_core

        @jax.jit
        def run(x, state, bins, step_rad):
            if x.ndim == 2:
                x = jax.lax.complex(x[:, 0], x[:, 1])
            xp = jnp.concatenate([state["chan"], x.astype(jnp.complex64)])
            y = _channelize_core(xp, hmat, m)                  # (K, M)
            k = y.shape[0]
            streams, new_phase = _dynamic_select_mix(
                y, state["rot"], state["mixer_phase"], bins, step_rad, m)
            outputs, dec_state = vdecode(streams, state["dec"])
            new_state = {
                "chan": xp[-state["chan"].shape[0]:],
                "mixer_phase": new_phase,
                "rot": (state["rot"] + k) % 4,
                "dec": dec_state,
            }
            return outputs, new_state

        return run

    def reset_slot(self, state: dict, slot: int) -> dict:
        """Fresh decoder/mixer state for one slot (the 'new ProcessingChain'
        moment of a traffic-channel start, minus the cost). Host-side
        control-plane op; cheap scatter on device."""
        dec0 = self.decoder.init_state()
        dec = jax.tree.map(lambda full, init: full.at[slot].set(init),
                           state["dec"], dec0)
        return {
            "chan": state["chan"],
            "mixer_phase": state["mixer_phase"].at[slot].set(0.0),
            "rot": state["rot"],
            "dec": dec,
        }

    def build_safe(self):
        """Float-pair variant: returns (jitted step, packed_state) where
        carried complex state crosses the jit boundary as float32 (...,2)
        pairs and the init state is built inside a jitted call (see
        parallel/boundary.py)."""
        from .parallel.boundary import complex_safe
        step = self.build()
        wrapped, packed0 = complex_safe(step, self.init_state)
        return jax.jit(wrapped), packed0

    def build_dynamic_safe(self):
        """Complex-safe build_dynamic: returns (jitted step, packed_state,
        reset_slot) where step(x_float_pairs, packed_state, bins, step_rad)
        carries state as float32 (..., 2) pairs, and reset_slot(state,
        slot) re-initializes one slot's decoder/mixer state ON the packed
        tree (the live Orchestrator's per-grant slot reset) — the
        float-pair boundary of build_safe applied to the retunable
        slot-bank graph."""
        from .parallel.boundary import complex_safe, pack_tree
        step = self.build_dynamic()
        wrapped, packed0 = complex_safe(step, self.init_state)
        dec0_packed = jax.jit(
            lambda: pack_tree(self.decoder.init_state()))()

        def reset_slot(state, slot):
            dec = jax.tree.map(lambda full, init: full.at[slot].set(init),
                               state["dec"], dec0_packed)
            return {
                "chan": state["chan"],
                "mixer_phase": state["mixer_phase"].at[slot].set(0.0),
                "rot": state["rot"],
                "dec": dec,
            }

        return jax.jit(wrapped), packed0, reset_slot
