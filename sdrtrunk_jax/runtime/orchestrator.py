"""Live runtime orchestrator: the continuous ring -> decode -> events ->
traffic-following loop.

Role of the reference's ChannelProcessingManager + ProcessingChain pair
(controller/channel/ChannelProcessingManager.java:290-483,
module/ProcessingChain.java:630): own the running channels, route decoded
messages into decoder states, react to traffic grants by STARTING new
channels mid-stream, and tear them down when calls end.

Batched redesign: the reference starts a thread-backed ProcessingChain
per channel; here ONE jitted slot-bank graph (WidebandReceiver
.build_dynamic) demodulates every slot each step, and "starting a
channel" is a host-side control-plane write of (bin, mixer step) into the
slot arrays plus a decoder-state reset — no recompile, no thread. The
host side of each slot (framer, message parsing, decoder state, audio
assembly) stays sequential Python exactly like the reference's message
layer, consuming the dense dibit arrays the device produced.

Time base is the SAMPLE CLOCK (samples_processed / sample_rate), not wall
time, so runs are deterministic and replayable (SURVEY.md §5 failure-
detection note: "deterministic replay from recorded IQ").
"""
from __future__ import annotations

import json
from dataclasses import dataclass

import numpy as np

from ..audio.mbe import FakeMBECodec, MBECodec
from ..receiver import MultibankReceiver, WidebandReceiver
from .events import DecodeEvent
from .identifiers import IdentifierCollection
from .metrics import FrequencyErrorMonitor
from .processors import (P25P1ChannelProcessor, P25P2ChannelProcessor,
                         make_channel_processor)
from .traffic import TrafficChannelManager

__all__ = ["ChannelSlot", "P25P1ChannelProcessor", "Orchestrator"]

# decoder kind -> traffic-manager protocol label
_PROTOCOL_LABELS = {
    "c4fm": "APCO25", "p25p1": "APCO25", "lsm": "APCO25",
    "p25p1-lsm": "APCO25", "dmr": "DMR", "p25p2": "APCO25-P2",
    "nbfm": "NBFM", "am": "AM", "ltr": "LTR", "ltrnet": "LTR-Net",
    "passport": "Passport", "mpt1327": "MPT1327",
}


@dataclass
class ChannelSlot:
    """One retunable channel slot of the running receiver."""
    index: int
    frequency_hz: float = 0.0
    name: str | None = None      # playlist channel name (pinned slots)
    processor: object | None = None
    is_control: bool = False
    active: bool = False
    activated_at: float = 0.0
    kind: str | None = None      # decoder kind (multibank receivers)
    bank_key: str | None = None  # device output/state key of the bank
    local: int = 0               # index within the bank


class Orchestrator:
    """Continuous decode loop with dynamic traffic-channel following.

    source: callable read(num_samples) -> np.complex64 array (shorter or
            None at end of stream) — RecordingTuner.read and the native
            ingest ring both satisfy this.
    center_frequency_hz: RF frequency at baseband 0 (maps the absolute
            frequencies in grants to channelizer offsets).
    control_offsets_hz: baseband offsets of the control channel(s); each
            gets a pinned slot with a TrafficChannelManager wired to
            activate/teardown the remaining slots.
    """

    def __init__(self, source, sample_rate: float,
                 center_frequency_hz: float,
                 control_offsets_hz, slots: int = 8,
                 channel_bandwidth: float = 12500.0,
                 decoder: str = "c4fm",
                 codec: MBECodec | None = None,
                 chunk_samples: int | None = None,
                 idle_teardown_seconds: float = 2.0,
                 metrics_sink=None,
                 ppm_correction: bool = True,
                 ppm_threshold: float = 0.4,
                 ppm_observation_seconds: float = 30.0,
                 control_rotation=None,
                 rotation_delay: float = 0.5,
                 event_log_path=None,
                 bank_mode: bool | None = None,
                 banks=None,
                 channel_map=None,
                 ingest_format: str = "auto",
                 audio_format: str = "mulaw8",
                 host_process: bool = False):
        """control_rotation: optional list of absolute candidate control
        frequencies — while the control slot fails to reach CONTROL
        state within rotation_delay, cycle through them
        (ChannelRotationMonitor.java role). event_log_path: optional
        .csv / .jsonl sink for every decode event
        (DecodeEventLogger.java role; EventLogConfig.decode_events).
        banks: optional ordered [(kind, n_slots), ...] heterogeneous
        protocol mix sharing one channelizer in one jitted graph
        (DecoderFactory.java:117-183 freely mixes decoder types; here
        the mix is a static slot partition — see MultibankReceiver).
        The control slot(s) live in the FIRST bank; grants activate free
        slots of that same kind. channel_map: FrequencyBand for MPT1327
        control slots (the reference's user channel map).

        ingest_format: 'auto' passes the source's format through (int8
        pairs / float pairs / complex). 'int4' requantizes ingest to
        PACKED 4-bit IQ (one byte/sample, 12.8 MB/s at 12.8 MHz) on
        the host and dequantizes on device — for constant-envelope FM
        families the ~25 dB quantization floor is far above the decode
        threshold (parity asserted in tests/test_orchestrator_bank),
        for links too slow for int8 (PCIe ingest keeps int8).

        control_offsets_hz entries may also be (offset_hz, kind) pairs:
        with `banks`, such an entry pins its slot in the named protocol
        bank instead of the first one (a heterogeneous playlist's
        auto-started channels, gui/SDRTrunk.java:281-300)."""
        if isinstance(control_offsets_hz, (int, float, np.floating)):
            control_offsets_hz = [control_offsets_hz]
        control_entries = [
            (float(e[0]), e[1]) if isinstance(e, tuple)
            else (float(e), None) for e in control_offsets_hz]
        control_offsets_hz = [off for off, _ in control_entries]
        self.banks = ([(k2, int(n)) for k2, n in banks]
                      if banks is not None else None)
        if self.banks is not None:
            if bank_mode:
                raise ValueError("banks and bank_mode are exclusive")
            bank_mode = False
            slots = sum(n for _, n in self.banks)
            decoder = self.banks[0][0]
        if slots < len(control_offsets_hz) + 1:
            raise ValueError("need at least one traffic slot")
        self.source = source
        self.sample_rate = float(sample_rate)
        self.center_frequency_hz = float(center_frequency_hz)
        self.codec = codec if codec is not None else FakeMBECodec()
        self.metrics_sink = metrics_sink
        self.channel_map = channel_map

        self.channel_bandwidth = float(channel_bandwidth)
        self.decoder_name = decoder
        if ingest_format not in ("auto", "int4"):
            raise ValueError(f"unknown ingest_format {ingest_format!r}")
        self.ingest_format = ingest_format
        if audio_format not in ("mulaw8", "int16"):
            raise ValueError(f"unknown audio_format {audio_format!r}")
        self.audio_format = audio_format
        if self.banks is not None:
            self.rx = MultibankReceiver(
                sample_rate, self.banks,
                channel_bandwidth=channel_bandwidth)
        else:
            self.rx = WidebandReceiver(
                sample_rate, [0.0] * slots,
                channel_bandwidth=channel_bandwidth, decoder=decoder)
        m = self.rx.channelizer.channels
        self.chunk_samples = (chunk_samples if chunk_samples is not None
                              else self._default_chunk(m))
        if self.chunk_samples % m != 0:
            raise ValueError(f"chunk_samples must be a multiple of {m}")

        # bank mode: at >=32 slots the per-slot host path (framer +
        # message decode per slot-chunk, ~1 ms each) cannot keep up; the
        # device additionally compacts + sync-correlates the dibit
        # streams and the host runs one P25P1BankFramer over the whole
        # bank (runtime/bank_processor.py). Same product surface
        # (events, audio, traffic following) — different scaling tier.
        # lsm/p25p1-lsm share P25P1 framing (Gardner demod, same sync
        # patterns), so they ride the P25P1 bank tier unchanged; the
        # analog-trunking kinds get the MIXED leg (voice + compacted
        # sub-audible/AFSK bits in one transfer)
        _MIXED_KINDS = ("ltr", "ltrnet", "passport", "mpt1327")
        _BANK_KINDS = ("c4fm", "p25p1", "lsm", "p25p1-lsm", "dmr",
                       "p25p2", "nbfm", "am") + _MIXED_KINDS
        if bank_mode is None:
            bank_mode = decoder in _BANK_KINDS and slots >= 32
        if bank_mode and decoder not in _BANK_KINDS:
            raise ValueError(f"bank_mode not supported for {decoder!r}")
        self.bank_mode = bank_mode
        self.bank_analog = bank_mode and decoder in ("nbfm", "am")
        self.bank_mixed = bank_mode and decoder in _MIXED_KINDS
        if host_process and (not bank_mode or self.bank_analog
                             or self.bank_mixed or banks is not None):
            raise ValueError("host_process requires a digital "
                             "single-kind bank mode")
        self.bank_proc = None
        self.bank_host = None
        self._bank_cap = None
        self._bank_ka = None
        self._bank_bit_cap = None
        if self.bank_analog or self.bank_mixed:
            k = 2 * self.chunk_samples // m
            dec = self.rx.decoder
            up, down = getattr(dec, "up", 8), getattr(dec, "down", 25)
            if (k * up) % down:
                raise ValueError(
                    f"chunk gives non-integral audio length: per-channel "
                    f"block {k} must be a multiple of {down}")
            self._bank_ka = k * up // down
            if self.bank_mixed:
                # sub-audible/AFSK bit budget per chunk: baud * chunk
                # seconds + margin (the timing-tracked slicers emit at
                # most ~1 bit per symbol period regardless of noise)
                baud = 1200.0 if decoder == "mpt1327" else 300.0
                secs = self.chunk_samples / self.sample_rate
                self._bank_bit_cap = int(
                    np.ceil((secs * baud * 1.25 + 16) / 32)) * 32
        elif bank_mode:
            k = (2 * self.chunk_samples // m
                 * getattr(self.rx.decoder, "upsample", 1))
            demod = self.rx.decoder.demod
            sps_min = demod.samples_per_symbol * (1.0 - demod.max_deviation)
            self._bank_cap = int(np.ceil((k / sps_min + 8) / 64)) * 64

        # dynamic step with float-pair state (parallel/boundary.py); the
        # per-slot outputs are packed ON DEVICE into one compact array
        # per chunk, so the device->host copy is one small transfer
        # instead of dibits+valid+power arrays for every slot
        self.step, self.state, self._reset_slot = self._build_live_step()

        # slot control arrays — the RUNTIME channel plan (bin pairs; a
        # single-bin slot repeats its index, see ChannelPlan); the device
        # copy is cached and invalidated by _tune (see _enqueue)
        self.bins = np.zeros((slots, 2), np.int32)
        self.steps = np.zeros(slots, np.float32)
        self._plan_dev = None
        self.slots = [ChannelSlot(i) for i in range(slots)]
        if self.banks is not None:
            for s in self.slots:
                key, local = self.rx.slot_key(s.index)
                s.bank_key, s.local = key, local
                s.kind = key.split("_", 1)[1]

        self.correction_ppm = 0.0
        self.event_logger = None
        if event_log_path is not None:
            from .eventlog import DecodeEventLogger
            self.event_logger = DecodeEventLogger(event_log_path)
        self.traffic = TrafficChannelManager(
            _PROTOCOL_LABELS.get(decoder, decoder.upper()),
            idle_teardown_seconds=idle_teardown_seconds,
            on_activate=self._activate, on_teardown=self._teardown)
        if self.event_logger is not None:
            self.traffic.event_sink = self.event_logger.receive
        if self.bank_mixed:
            from .bank_processor import MixedBankProcessor
            self.bank_proc = MixedBankProcessor(
                slots, control_slots=set(range(len(control_offsets_hz))),
                traffic=self.traffic, kind=decoder,
                channel_map=self.channel_map)
        elif self.bank_analog:
            from .bank_processor import AnalogBankProcessor
            self.bank_proc = AnalogBankProcessor(slots)
        elif self.bank_mode and host_process:
            # the bank host layer (framer + states + traffic manager)
            # runs in a WORKER PROCESS so its Python/numpy work is
            # truly parallel to the device management (the GIL
            # serialized them in-process; runtime/bank_worker.py)
            from .bank_worker import ProcessBankHost
            self.bank_host = ProcessBankHost(
                decoder, slots,
                control_slots=set(range(len(control_offsets_hz))),
                codec=self.codec,
                protocol_label=_PROTOCOL_LABELS.get(
                    decoder, decoder.upper()),
                idle_teardown=idle_teardown_seconds,
                bank_cap=self._bank_cap)
            self._worker_events: list = []
            self._worker_reply: dict = {}
        elif self.bank_mode:
            from .bank_processor import (DMRBankProcessor,
                                         P25P1BankProcessor,
                                         P25P2BankProcessor)
            cls = {"dmr": DMRBankProcessor,
                   "p25p2": P25P2BankProcessor}.get(decoder,
                                                    P25P1BankProcessor)
            self.bank_proc = cls(
                slots, control_slots=set(range(len(control_offsets_hz))),
                traffic=self.traffic, codec=self.codec)
        claimed: set[int] = set()
        for off, want_kind in control_entries:
            slot = next(
                s for s in self.slots if s.index not in claimed
                and (want_kind is None or self.banks is None
                     or s.kind == want_kind))
            claimed.add(slot.index)
            slot.is_control = True
            slot.active = True
            slot.frequency_hz = self.center_frequency_hz + float(off)
            if not self.bank_mode:
                kind = slot.kind or decoder
                slot.processor = make_channel_processor(
                    kind, traffic=self.traffic, codec=self.codec,
                    channel_map=self.channel_map)
                self._wire_logger(slot.processor)
            self._tune(slot.index, float(off))
        self.rotation = None
        if control_rotation:
            from .rotation import ChannelRotationMonitor
            self.rotation = ChannelRotationMonitor(
                control_rotation, self._rotate_control,
                rotation_delay=rotation_delay)

        self.now = 0.0
        self.samples_processed = 0
        # live recording taps (ComplexBufferWaveRecorder.java:42 /
        # BinaryRecorder.java:51 roles): wideband IQ + per-slot dibits
        # can start/stop mid-run
        self._iq_writer = None
        self._bits_recorders: dict[int, object] = {}
        self.audio_segments: list = []
        self.skipped_grants: list[float] = []
        self.error_state: str | None = None

        # tuner PPM auto-correction driven by the control channel's PLL
        # frequency error (CostasLoop broadcast -> FrequencyErrorMonitor)
        self.ppm_monitor = None
        if ppm_correction and self.slots[0].is_control \
                and self.slots[0].frequency_hz > 0:
            self.ppm_monitor = FrequencyErrorMonitor(
                self.slots[0].frequency_hz, threshold_ppm=ppm_threshold,
                observation_seconds=ppm_observation_seconds,
                on_correct=self._apply_ppm)

    # --- control plane -------------------------------------------------

    def _build_live_step(self):
        """Jitted live step = build_dynamic + on-device output packing:
        digital decoders emit one int8 per sample (valid<<2 | dibit);
        analog decoders emit float32 audio + int8 gate. power_db stays on
        device (it is never pulled by the live loop)."""
        import jax
        import jax.numpy as jnp

        from ..parallel.boundary import complex_safe, pack_tree
        base = self.rx.build_dynamic()
        bank_cap = self._bank_cap if self.bank_mode else None
        bank_analog = self.bank_analog
        bank_mixed = self.bank_mixed

        def ingest(x):
            # 8-bit IQ pairs are the live wire format (an RTL dongle's
            # native stream, 25.6 MB/s at 12.8 MHz); float pairs /
            # complex accepted too. uint8 is PACKED 4-bit IQ (high
            # nibble I, low nibble Q, two's complement): one byte/sample
            # for slow links
            if x.dtype == jnp.uint8:
                xi = x.astype(jnp.int32)
                i4 = (((xi >> 4) + 8) & 15) - 8
                q4 = (((xi & 15) + 8) & 15) - 8
                return jnp.stack([i4, q4], axis=-1).astype(jnp.float32) \
                    * (16.0 / 127.0)
            if x.dtype == jnp.int8:
                return x.astype(jnp.float32) * (1.0 / 127.0)
            return x

        def compact_and_correlate(dib, valid):
            """On-device symbol compaction + sync correlation + packing
            (see runtime/bank_processor.py for the host-side contract)."""
            c, k = dib.shape
            t_iota = jax.lax.broadcasted_iota(jnp.int32, (c, k), 1)
            # one fused sort key: sample index (invalid -> k) in the
            # high bits, the dibit riding in the low 2 bits
            combined = jnp.where(valid, t_iota, k) * 4 + dib.astype(jnp.int32)
            sdib = (jax.lax.sort(combined, dimension=-1) & 3)[:, :bank_cap]
            counts = jnp.sum(valid, axis=-1).astype(jnp.int32)
            # pack 4 dibits/byte (little 2-bit groups)
            d4 = sdib.reshape(c, bank_cap // 4, 4)
            dib4 = (d4 * jnp.array([1, 4, 16, 64], jnp.int32)
                    ).sum(-1).astype(jnp.uint8)
            # XOR-popcount sync correlation over the compact stream:
            # L shifted fused adds per bit plane per pattern.
            # Pattern set + threshold follow the protocol: P25P1's 4
            # rotation images at <=9 bit errors, DMR's 7 patterns at
            # <=4 (DMRSyncDetector threshold), P25P2's single 20-dibit
            # pattern at <=4 (P25P2SyncPattern)
            if self.decoder_name == "dmr":
                from ..protocol.dmr.bankframer import (
                    DMR_SYNC_DIBIT_PATTERNS as _PATS)
                from ..protocol.dmr.framer import MAX_SYNC_BIT_ERRORS \
                    as _THR
            elif self.decoder_name == "p25p2":
                from ..protocol.p25p2.bankframer import (
                    P25P2_SYNC_DIBITS)
                _PATS = P25P2_SYNC_DIBITS[None, :]
                _THR = 4
            else:
                from ..protocol.p25p1.bankframer import (
                    SYNC_DIBIT_PATTERNS as _PATS)
                _THR = 9
            plen = int(np.asarray(_PATS).shape[1])
            hi = (sdib >> 1).astype(jnp.int32)
            lo = (sdib & 1).astype(jnp.int32)
            lags = bank_cap - (plen - 1)
            best = jnp.full((c, lags), 96, jnp.int32)
            for pat in np.asarray(_PATS):
                err = jnp.zeros((c, lags), jnp.int32)
                for j in range(plen):
                    err = (err + (hi[:, j:j + lags] != int(pat[j] >> 1))
                           + (lo[:, j:j + lags] != int(pat[j] & 1)))
                best = jnp.minimum(best, err)
            hits = jnp.pad(best <= _THR, ((0, 0), (0, plen - 1)))
            h8 = hits.reshape(c, bank_cap // 8, 8).astype(jnp.int32)
            hbits = (h8 * jnp.array([128, 64, 32, 16, 8, 4, 2, 1],
                                    jnp.int32)).sum(-1).astype(jnp.uint8)
            return dib4, counts, hbits

        def pack_sym(symbols, valid):
            return (symbols.astype(jnp.int32)
                    | (valid.astype(jnp.int32) << 2)).astype(jnp.int8)

        multibank = self.banks is not None

        def fused(x, state, bins, steps):
            out, st = base(ingest(x), state, bins, steps)
            if multibank:
                # heterogeneous banks: per-bank packing under flat
                # "<bank>/<field>" keys
                out2 = {}
                for key, outs in out.items():
                    if "dibits" in outs:
                        out2[f"{key}/sym"] = pack_sym(outs["dibits"],
                                                      outs["valid"])
                        if "pll_freq" in outs:
                            out2[f"{key}/pll"] = outs["pll_freq"]
                    elif "bits" in outs:     # analog trunking: both
                        out2[f"{key}/sym"] = pack_sym(outs["bits"],
                                                      outs["valid"])
                        out2[f"{key}/audio"] = outs["audio"].astype(
                            jnp.float32)
                        out2[f"{key}/gate"] = outs["audio_gate"].astype(
                            jnp.int8)
                    else:
                        out2[f"{key}/audio"] = outs["audio"].astype(
                            jnp.float32)
                        out2[f"{key}/gate"] = outs["audio_gate"].astype(
                            jnp.int8)
                return out2, st
            if "dibits" in out and bank_cap is not None:
                dib4, counts, hbits = compact_and_correlate(
                    out["dibits"], out["valid"])
                # ONE flat uint8 transfer (one device->host copy per
                # chunk instead of four).
                # Layout: dib4 | hits | counts (le int32) | pll (le f32)
                counts8 = jax.lax.bitcast_convert_type(
                    counts, jnp.uint8).reshape(-1)
                pll8 = jax.lax.bitcast_convert_type(
                    out.get("pll_freq", jnp.zeros((1,), jnp.float32))[:1],
                    jnp.uint8).reshape(-1)
                out2 = {"packed": jnp.concatenate(
                    [dib4.reshape(-1), hbits.reshape(-1), counts8, pll8])}
            elif "dibits" in out:
                sym = (out["dibits"].astype(jnp.int32)
                       | (out["valid"].astype(jnp.int32) << 2)
                       ).astype(jnp.int8)
                out2 = {"sym": sym}
                if "pll_freq" in out:
                    out2["pll_freq"] = out["pll_freq"]
            elif bank_mixed and "bits" in out:
                # analog-trunking bank leg (LTR family / MPT1327):
                # companded voice + packed squelch gates + COMPACTED
                # sub-audible/AFSK bit decisions in one uint8 transfer
                # (DecoderFactory.java:398-425 module lists at bank
                # scale; bits ride at ~300-1200 baud so the compact
                # stream is tiny next to the audio)
                a = jnp.clip(out["audio"], -1.0, 1.0)
                c_, ka = a.shape
                comp = jnp.log1p(255.0 * jnp.abs(a)) \
                    * (1.0 / np.log(256.0))
                level = jnp.clip((comp * 127.0 + 0.5).astype(jnp.int32),
                                 0, 127)
                pcm8 = (jnp.where(a < 0, 128, 0) + level
                        ).astype(jnp.uint8)
                gate = out["audio_gate"] > 0
                pad = (-ka) % 8
                g = jnp.pad(gate, ((0, 0), (0, pad))).reshape(
                    c_, (ka + pad) // 8, 8).astype(jnp.int32)
                g8 = (g * jnp.array([128, 64, 32, 16, 8, 4, 2, 1],
                                    jnp.int32)).sum(-1).astype(jnp.uint8)
                bits = out["bits"].astype(jnp.int32)
                val = out["valid"]
                kb = bits.shape[1]
                cap = self._bank_bit_cap
                t_iota = jax.lax.broadcasted_iota(jnp.int32, (c_, kb), 1)
                combined = jnp.where(val, t_iota, kb) * 2 + bits
                sbits = (jax.lax.sort(combined, dimension=-1)
                         & 1)[:, :cap]
                counts = jnp.minimum(
                    jnp.sum(val, axis=-1), cap).astype(jnp.int32)
                b8g = sbits.reshape(c_, cap // 8, 8)
                b8 = (b8g * jnp.array([128, 64, 32, 16, 8, 4, 2, 1],
                                      jnp.int32)).sum(-1).astype(
                    jnp.uint8)
                counts8 = jax.lax.bitcast_convert_type(
                    counts, jnp.uint8).reshape(-1)
                out2 = {"packed_mixed": jnp.concatenate(
                    [pcm8.reshape(-1), g8.reshape(-1), b8.reshape(-1),
                     counts8])}
            elif bank_analog:
                # analog bank: companded 8-bit (default) or int16 PCM +
                # packed gate bits in one flat uint8 transfer (float
                # audio at 1023 slots would be 27 MB/chunk; mu-law keeps
                # ~35 dB SNR at half of int16's bytes, and
                # audio_format='int16' selects the full-fidelity path)
                a = jnp.clip(out["audio"], -1.0, 1.0)
                c_, ka = a.shape
                if self.audio_format == "int16":
                    pcm = jnp.clip((a * 32767.0), -32768,
                                   32767).astype(jnp.int16)
                    pcm_bytes = jax.lax.bitcast_convert_type(
                        pcm, jnp.uint8).reshape(-1)
                else:
                    comp = jnp.log1p(255.0 * jnp.abs(a)) \
                        * (1.0 / np.log(256.0))
                    level = jnp.clip(
                        (comp * 127.0 + 0.5).astype(jnp.int32), 0, 127)
                    pcm_bytes = (jnp.where(a < 0, 128, 0) + level
                                 ).astype(jnp.uint8).reshape(-1)
                gate = out["audio_gate"] > 0
                pad = (-ka) % 8
                g = jnp.pad(gate, ((0, 0), (0, pad))).reshape(
                    c_, (ka + pad) // 8, 8).astype(jnp.int32)
                g8 = (g * jnp.array([128, 64, 32, 16, 8, 4, 2, 1],
                                    jnp.int32)).sum(-1).astype(jnp.uint8)
                out2 = {"packed_audio": jnp.concatenate(
                    [pcm_bytes, g8.reshape(-1)])}
            else:
                out2 = {"audio": out["audio"].astype(jnp.float32),
                        "audio_gate": out["audio_gate"].astype(jnp.int8)}
            return out2, st

        wrapped, packed0 = complex_safe(fused, self.rx.init_state)

        if self.banks is not None:
            bank_dec0 = {
                key: jax.jit(lambda dec=dec: pack_tree(dec.init_state()))()
                for key, _, _, dec in self.rx.banks}

            def reset_slot(state, slot):
                key, local = self.rx.slot_key(slot)
                dec = jax.tree.map(
                    lambda full, init: full.at[local].set(init),
                    state[key], bank_dec0[key])
                return {**state, key: dec,
                        "mixer_phase":
                            state["mixer_phase"].at[slot].set(0.0)}

            return jax.jit(wrapped), packed0, reset_slot

        dec0_packed = jax.jit(
            lambda: pack_tree(self.rx.decoder.init_state()))()

        def reset_slot(state, slot):
            dec = jax.tree.map(lambda full, init: full.at[slot].set(init),
                               state["dec"], dec0_packed)
            return {"chan": state["chan"],
                    "mixer_phase": state["mixer_phase"].at[slot].set(0.0),
                    "rot": state["rot"], "dec": dec}

        return jax.jit(wrapped), packed0, reset_slot

    def _default_chunk(self, m: int) -> int:
        """Default wideband chunk: analog decoders resample per-channel
        streams to 8 kHz, so the per-channel block length (2*chunk/m)
        must be a multiple of the resampler's `down` factor for
        block-periodic streaming (dsp/fir.polyphase_resample)."""
        if self.banks is not None:
            # K = 250 channel samples satisfies every bank family: the
            # 8 kHz resampler (K % 25 == 0) and the AFSK correlator's
            # audio step (Ka % 10 == 0)
            return m * 125
        if self.decoder_name in ("nbfm", "am"):
            down = getattr(self.rx.decoder, "down", 25)
            # K = 2*chunk/m must be a multiple of `down`
            return m * down if down % 2 else m * down // 2
        if self.decoder_name in ("ltr", "ltrnet", "passport",
                                 "mpt1327"):
            # K = 250 satisfies the 8 kHz resampler (%25) and the AFSK
            # correlator's audio step (Ka % 10)
            return m * 125
        return 16 * m

    def _tune(self, slot: int, offset_hz: float) -> None:
        # oscillator-error model: a tuner reading `ppm` high shifts every
        # RF frequency f by f*ppm/1e6 in the capture; the correction is
        # frequency-proportional, applied at the slot mixer (the
        # analog of TunerController.setFrequencyCorrection)
        f_abs = self.center_frequency_hz + offset_hz
        offset_hz = offset_hz + self.correction_ppm * 1e-6 * f_abs
        ch = self.rx.channelizer
        kind = self.slots[slot].kind or self.decoder_name
        if kind == "p25p2":
            # P25 Phase 2 gets the reference's WIDE channel
            # (DecodeConfigP25Phase2 ChannelSpecification min 50 kHz):
            # a straddling two-bin pair joined by the PR synthesizer
            # serves the full flat 25 kHz joint passband, so an
            # operator can park a Phase 2 channel anywhere — including
            # between bin centers — exactly like the reference's
            # TwoChannelOutputProcessor. Mirrors plan_channels'
            # two-bin rule (dsp/extract.py:96-106); the chain then
            # upsamples x2 for Gardner timing resolution.
            spacing = ch.channel_spacing
            # floor picks the straddling pair (m, m+1) with residual in
            # [-spacing/2, spacing/2); round-half-even at exact bin
            # centers could select the wrapped Nyquist pair at the
            # band edges
            mbin = int(np.floor(offset_hz / spacing))
            served = ch.center_frequency(mbin) + spacing / 2.0
            residual = offset_hz - served
            if abs(residual) > spacing / 2 + 1e-6:
                raise ValueError(
                    f"offset {offset_hz} outside coverage")
            self.bins[slot] = (mbin % ch.channels,
                               (mbin + 1) % ch.channels)
        else:
            b = ch.channel_for_frequency(offset_hz)
            if not 0 <= b < ch.channels:
                raise ValueError(f"offset {offset_hz} outside coverage")
            residual = offset_hz - ch.center_frequency(b)
            self.bins[slot] = (b, b)
        self.steps[slot] = 2.0 * np.pi * residual / ch.channel_sample_rate
        self._plan_dev = None
        self.state = self._reset_slot(self.state, slot)

    def _wire_logger(self, processor) -> None:
        """Route a processor's decode-event history into the event-log
        sink (EventLogConfig.decode_events -> DecodeEventLogger)."""
        if self.event_logger is None:
            return
        hist = getattr(getattr(processor, "state", None), "history",
                       None) or getattr(processor, "history", None)
        if hist is not None and hasattr(hist, "add_listener"):
            hist.add_listener(self.event_logger.receive)

    def _bank_reset_slot(self, index: int, preload=None,
                         **extra) -> None:
        if self.bank_host is not None:
            self.bank_host.reset_slot(
                index, preload=preload, extra=extra or None,
                frequency=self.slots[index].frequency_hz)
            return
        self.bank_proc.reset_slot(index, preload=preload, **extra)
        state = self.bank_proc.states[index]
        if self.event_logger is not None and hasattr(state, "history"):
            state.history.add_listener(self.event_logger.receive)

    def _slot_flush_drain(self, slot) -> None:
        """Flush open calls on a slot and collect its audio segments."""
        if self.bank_host is not None:
            self.audio_segments.extend(
                self.bank_host.flush(slot.index, self.now))
        elif self.bank_mode:
            self.bank_proc.flush(slot.index, self.now)
            self.audio_segments.extend(self.bank_proc.drain_audio(slot.index))
        elif slot.processor is not None:
            slot.processor.flush(self.now)
            self.audio_segments.extend(slot.processor.drain_audio())

    def _rotate_control(self, frequency_hz: float) -> None:
        """Rotation monitor fired: move the control slot to the next
        candidate frequency (SourceEvent frequency-rotation request ->
        retune, ChannelRotationMonitor.java:95-120)."""
        slot = next(s for s in self.slots if s.is_control)
        offset = frequency_hz - self.center_frequency_hz
        ch = self.rx.channelizer
        if abs(offset) > ch.channels * ch.channel_spacing / 2:
            return                      # candidate outside coverage
        slot.frequency_hz = frequency_hz
        self._tune(slot.index, offset)

    def _apply_ppm(self, ppm: float) -> None:
        """Sustained PLL error -> global tuner correction + retune of all
        running slots (FrequencyErrorCorrectionManager.applyCorrection)."""
        self.correction_ppm += ppm
        for slot in self.slots:
            if slot.active:
                self._tune(slot.index,
                           slot.frequency_hz - self.center_frequency_hz)

    def on_source_event(self, event) -> None:
        """React to tuner notifications — the PolyphaseChannelManager
        lifecycle (PolyphaseChannelManager.java:328 process(SourceEvent)):
        a center-frequency or sample-rate change rebuilds the runtime
        channel plan; out-of-coverage channels are torn down."""
        from ..sources.tuner import SourceEventType
        if event.type == SourceEventType.FREQUENCY_CHANGE:
            self.retune(float(event.value))
        elif event.type == SourceEventType.SAMPLE_RATE_CHANGE:
            self.set_sample_rate(float(event.value))
        elif event.type == SourceEventType.ERROR_STATE:
            self.stop_all(reason=str(event.value))

    def stop_all(self, reason: str = "") -> None:
        """Tuner error state: stop every running channel, flushing open
        calls to AudioSegments (the reference's automatic channel stop on
        NOTIFICATION_ERROR_STATE,
        ChannelProcessingManager.java:359-389)."""
        self.error_state = reason or "error"
        for slot in self.slots:
            if not slot.active:
                continue
            if not self.bank_mode and slot.processor is None:
                continue
            self._slot_flush_drain(slot)
            slot.active = False
        self.traffic.active.clear()

    def retune(self, new_center_frequency_hz: float) -> None:
        """Tuner moved: remap every active slot's absolute frequency to
        an offset in the new capture; slots that fall outside coverage
        are torn down (the reference stops their channels with an error
        state)."""
        self.center_frequency_hz = float(new_center_frequency_hz)
        ch = self.rx.channelizer
        half_span = ch.channels * ch.channel_spacing / 2
        for slot in self.slots:
            if not slot.active:
                continue
            offset = slot.frequency_hz - self.center_frequency_hz
            if abs(offset) > half_span:
                if slot.is_control:
                    raise ValueError(
                        f"retune to {new_center_frequency_hz} drops the "
                        f"control channel at {slot.frequency_hz}")
                self._slot_flush_drain(slot)
                slot.active = False
                self.skipped_grants.append(slot.frequency_hz)
                continue
            self._tune(slot.index, offset)

    def set_sample_rate(self, new_sample_rate: float) -> None:
        """Tuner sample rate changed: rebuild the channelizer + jitted
        step for the new grid, then remap all active slots (the
        reference tears the whole polyphase down and recreates it)."""
        slots = len(self.slots)
        self.sample_rate = float(new_sample_rate)
        if self.banks is not None:
            self.rx = MultibankReceiver(
                self.sample_rate, self.banks,
                channel_bandwidth=self.channel_bandwidth)
        else:
            self.rx = WidebandReceiver(
                self.sample_rate, [0.0] * slots,
                channel_bandwidth=self.channel_bandwidth,
                decoder=self.decoder_name)
        m = self.rx.channelizer.channels
        self.chunk_samples = self._default_chunk(m)
        if self.bank_mode:
            k = (2 * self.chunk_samples // m
                 * getattr(self.rx.decoder, "upsample", 1))
            demod = self.rx.decoder.demod
            sps_min = demod.samples_per_symbol * (1.0 - demod.max_deviation)
            self._bank_cap = int(np.ceil((k / sps_min + 8) / 64)) * 64
        self.step, self.state, self._reset_slot = self._build_live_step()
        self.bins = np.zeros((slots, 2), np.int32)
        self.steps = np.zeros(slots, np.float32)
        self._plan_dev = None
        self.retune(self.center_frequency_hz)

    def _free_slot(self, kind: str | None = None) -> ChannelSlot | None:
        for slot in self.slots:
            if not slot.active and not slot.is_control \
                    and (kind is None or slot.kind == kind):
                return slot
        return None

    def _activate(self, frequency_hz: float,
                  identifiers: IdentifierCollection,
                  kind: str | None = None) -> None:
        """Traffic grant -> start decoding the granted frequency
        (P25TrafficChannelManager.processChannelGrant:229 ->
        REQUEST_ENABLE -> startProcessing equivalent). In a multibank
        receiver, `kind` picks the protocol bank (default: the control
        bank's kind — grants from a P25 control start P25 slots)."""
        offset = frequency_hz - self.center_frequency_hz
        ch = self.rx.channelizer
        if abs(offset) > ch.channels * ch.channel_spacing / 2:
            self.skipped_grants.append(frequency_hz)
            return
        for slot in self.slots:          # already tracking this frequency?
            if slot.active and slot.frequency_hz == frequency_hz:
                return
        if kind is None and self.banks is not None:
            kind = self.decoder_name
        slot = self._free_slot(kind)
        if slot is None:
            self.skipped_grants.append(frequency_hz)
            return
        self._tune(slot.index, offset)
        slot.frequency_hz = frequency_hz
        slot.active = True
        slot.activated_at = self.now
        if self.bank_mode:
            extra = {}
            # P25P2 traffic channels need the control channel's learned
            # scramble key (preload data, ChannelProcessingManager:403)
            if self.bank_host is not None:
                key = (self.bank_host.scramble_key()
                       if self.decoder_name == "p25p2" else None)
            else:
                key_fn = getattr(self.bank_proc, "scramble_key", None)
                key = key_fn() if key_fn is not None else None
            if key is not None:
                extra["scramble_key"] = key
            self._bank_reset_slot(slot.index, preload=identifiers,
                                  **extra)
            return
        # P25P2 traffic channels need the scramble key the control
        # channel learned (preload data, ChannelProcessingManager:403-468)
        extra = {}
        for s in self.slots:
            if s.is_control and isinstance(s.processor,
                                           P25P2ChannelProcessor) \
                    and s.processor.state.scramble_key is not None:
                extra["scramble_key"] = s.processor.state.scramble_key
                break
        slot.processor = make_channel_processor(
            slot.kind or self.decoder_name, traffic=None,
            codec=self.codec, preload=identifiers, **extra)
        self._wire_logger(slot.processor)

    def _teardown(self, frequency_hz: float) -> None:
        for slot in self.slots:
            if slot.active and not slot.is_control \
                    and slot.frequency_hz == frequency_hz:
                self._slot_flush_drain(slot)
                slot.active = False

    # --- live recording taps -------------------------------------------

    def start_iq_recording(self, path) -> None:
        """Record the wideband capture as an IQ wave while running
        (record/wave/ComplexBufferWaveRecorder.java:42). Tap sits at
        ingest, before any wire requantization."""
        from ..io.wave import ComplexWaveWriter
        self.stop_iq_recording()
        self._iq_writer = ComplexWaveWriter(path, int(self.sample_rate))

    def stop_iq_recording(self) -> None:
        if self._iq_writer is not None:
            self._iq_writer.close()
            self._iq_writer = None

    def start_bits_recording(self, slot_index: int, path) -> None:
        """Record a slot's demodulated dibit stream mid-run as a
        reference-format .bits file (record/binary/BinaryRecorder
        .java:51)."""
        from ..audio.recorder import BitsRecorder
        self.stop_bits_recording(slot_index)
        self._bits_recorders[slot_index] = BitsRecorder(path)

    def stop_bits_recording(self, slot_index: int) -> None:
        rec = self._bits_recorders.pop(slot_index, None)
        if rec is not None:
            rec.close()

    def _tap_bits_bank(self, dib4: np.ndarray,
                       counts: np.ndarray) -> None:
        from .bank_processor import unpack_dibits
        for idx, rec in self._bits_recorders.items():
            row = unpack_dibits(dib4[idx:idx + 1])[0]
            rec.write(row[: int(counts[idx])])

    # --- data plane ----------------------------------------------------

    def _prepare(self, iq: np.ndarray) -> np.ndarray:
        """Host-side wire format: float32 (n, 2) pairs, int8 (n, 2)
        passed through raw, or packed 4-bit uint8 (n,) when
        ingest_format='int4' (the device converts)."""
        iq = np.asarray(iq)
        if self._iq_writer is not None:
            self._iq_writer.write(
                iq.astype(np.float32) / 127.0 if iq.dtype == np.int8
                else iq)
        if np.iscomplexobj(iq):     # complex never crosses the boundary
            iq = np.stack([iq.real, iq.imag], -1).astype(np.float32)
        if self.ingest_format == "int4":
            if iq.dtype == np.int8:
                v = np.clip(np.round(iq.astype(np.float32) / 16.0),
                            -8, 7).astype(np.int32)
            else:
                v = np.clip(np.round(iq * 7.0), -8, 7).astype(np.int32)
            return (((v[:, 0] & 15) << 4)
                    | (v[:, 1] & 15)).astype(np.uint8)
        return iq

    def _upload(self, iq: np.ndarray):
        """Host->device copy of a prepared chunk. Runs on the
        pipeline's upload thread in run(), overlapping the host framing
        work."""
        import jax.numpy as jnp
        dtype = {np.dtype(np.int8): jnp.int8,
                 np.dtype(np.uint8): jnp.uint8}.get(iq.dtype,
                                                    jnp.float32)
        return jnp.asarray(iq, dtype)

    def _dispatch(self, dev_iq):
        """Queue the jitted step for an already-uploaded chunk."""
        import jax.numpy as jnp
        # the slot plan lives on device and is re-uploaded only when a
        # tune changed it (one host->device copy less per chunk)
        if self._plan_dev is None:
            self._plan_dev = (jnp.asarray(self.bins),
                              jnp.asarray(self.steps))
        out, self.state = self.step(dev_iq, self.state, *self._plan_dev)
        self.samples_processed += dev_iq.shape[0]
        return out, self.samples_processed / self.sample_rate

    def _enqueue(self, iq: np.ndarray):
        """Upload + dispatch one wideband chunk (synchronous upload);
        host-side consumption happens in _process so run_chunk callers
        can double-buffer."""
        return self._dispatch(self._upload(self._prepare(iq)))

    def run_chunk(self, iq: np.ndarray) -> dict:
        """Process one wideband chunk through the slot bank + host layer."""
        out, now = self._enqueue(iq)
        return self._process(out, now)

    def _split_packed(self, buf: np.ndarray):
        """Parse the bank-mode flat uint8 transfer (see _build_live_step
        layout: dib4 | hits | counts | pll)."""
        c = len(self.slots)
        cap = self._bank_cap
        q, h = cap // 4, cap // 8
        dib4 = buf[: c * q].reshape(c, q)
        hits = buf[c * q: c * (q + h)].reshape(c, h)
        counts = buf[c * (q + h): c * (q + h) + 4 * c].view(np.int32)
        pll_raw = float(buf[-4:].view(np.float32)[0])
        return dib4, hits, counts, pll_raw

    # mu-law expansion LUT for the analog bank transfer (inverse of the
    # device-side log companding; 256 entries)
    _MULAW_LUT = None

    @classmethod
    def _mulaw_lut(cls) -> np.ndarray:
        if cls._MULAW_LUT is None:
            level = np.arange(128, dtype=np.float32)
            mag = (np.power(256.0, level / 127.0) - 1.0) / 255.0
            cls._MULAW_LUT = np.concatenate([mag, -mag]).astype(np.float32)
        return cls._MULAW_LUT

    def _split_packed_audio(self, buf: np.ndarray):
        """Parse the analog bank transfer (PCM | packed gate)."""
        c = len(self.slots)
        ka = self._bank_ka
        if self.audio_format == "int16":
            n = c * ka * 2
            audio = (buf[:n].view("<i2").astype(np.float32)
                     / 32767.0).reshape(c, ka)
            rest = buf[n:]
        else:
            audio = self._mulaw_lut()[buf[: c * ka]].reshape(c, ka)
            rest = buf[c * ka:]
        nb = (ka + 7) // 8
        gate = np.unpackbits(rest.reshape(c, nb),
                             axis=1)[:, :ka].astype(bool)
        return audio, gate

    def _split_packed_mixed(self, buf: np.ndarray):
        """Parse the mixed analog-trunking transfer
        (mu-law PCM | gates | compacted bits | counts)."""
        c = len(self.slots)
        ka = self._bank_ka
        cap = self._bank_bit_cap
        audio = self._mulaw_lut()[buf[: c * ka]].reshape(c, ka)
        pos = c * ka
        nb = (ka + 7) // 8
        gate = np.unpackbits(buf[pos: pos + c * nb].reshape(c, nb),
                             axis=1)[:, :ka].astype(bool)
        pos += c * nb
        bits = np.unpackbits(
            buf[pos: pos + c * (cap // 8)].reshape(c, cap // 8), axis=1)
        pos += c * (cap // 8)
        counts = buf[pos: pos + 4 * c].view(np.int32)
        return audio, gate, bits, counts

    def _pull_bank(self, out: dict, now: float) -> dict:
        """Download-worker half of a bank chunk: transfer + unpack +
        bank-frame (stateful, called strictly in chunk order by the one
        download thread); the main thread only routes messages."""
        if self.bank_host is not None:
            active = np.array([s.active for s in self.slots])
            control_index = next(s.index for s in self.slots
                                 if s.is_control)
            reply = self.bank_host.process_chunk(
                np.asarray(out["packed"]), active, now, control_index)
            return {"worker_reply": reply}
        if self.bank_mixed:
            audio, gate, bits, counts = self._split_packed_mixed(
                np.asarray(out["packed_mixed"]))
            return {"bank_mixed": (audio, gate, bits, counts)}
        if self.bank_analog:
            audio, gate = self._split_packed_audio(
                np.asarray(out["packed_audio"]))
            return {"bank_audio": audio, "bank_gate": gate}
        dib4, hits, counts, pll_raw = self._split_packed(
            np.asarray(out["packed"]))
        if self._bits_recorders:
            self._tap_bits_bank(dib4, counts)
        msgs = self.bank_proc.frame_chunk(dib4, counts, hits)
        return {"bank_msgs": msgs, "counts": counts, "pll_raw": pll_raw}

    def _process(self, out: dict, now: float) -> dict:
        self.now = now
        digital = "sym" in out or "packed" in out or "bank_msgs" in out
        pll_raw = out.get("pll_raw")
        if "packed" in out or "packed_audio" in out \
                or "packed_mixed" in out:
            out = {**self._pull_bank(out, now)}  # un-pipelined bank path
            pll_raw = out.get("pll_raw")
        if self.banks is not None:
            host = {key: np.asarray(v) for key, v in out.items()}
            ctrl_pll = f"{self.slots[0].bank_key}/pll"
            if ctrl_pll in host:
                pll_raw = float(host[ctrl_pll]
                                [self.slots[0].local])
        elif "worker_reply" in out:
            reply = out["worker_reply"]
            pll_raw = reply.get("pll")
        elif "bank_msgs" in out:
            bank_msgs, counts = out["bank_msgs"], out["counts"]
        elif "bank_mixed" in out:
            mixed = out["bank_mixed"]
        elif "bank_audio" in out:
            audio, gate = out["bank_audio"], out["bank_gate"]
        elif digital:                      # packed: valid<<2 | dibit
            packed = np.asarray(out["sym"])
            dib = packed & 3
            val = (packed >> 2) > 0
        else:                                  # analog: gated 8 kHz audio
            audio = np.asarray(out["audio"])
            gate = np.asarray(out["audio_gate"]) > 0

        pll_err_hz = None
        if "pll_freq" in out:
            pll_raw = float(np.asarray(out["pll_freq"])[0])
        if self.ppm_monitor is not None and pll_raw is not None:
            # loop freq (rad/sample at channel rate) -> Hz
            # (CostasLoop.java:212); positive loop freq means the PLL
            # mixes UP to compensate a signal BELOW expected frequency
            rate = self.rx.channelizer.channel_sample_rate
            pll_err_hz = float(-pll_raw * rate / (2.0 * np.pi))
            self.ppm_monitor.update(pll_err_hz, self.now)

        frames = 0
        if self.banks is not None:
            for slot in self.slots:
                if not slot.active:
                    continue
                key, li = slot.bank_key, slot.local
                sym = host.get(f"{key}/sym")
                aud = host.get(f"{key}/audio")
                if sym is not None and aud is not None:
                    p = sym[li]
                    n = slot.processor.process_mixed(
                        (p & 1)[(p >> 2) > 0], aud[li],
                        host[f"{key}/gate"][li] > 0, self.now)
                elif sym is not None:
                    p = sym[li]
                    slot_dib = (p & 3)[(p >> 2) > 0]
                    rec = self._bits_recorders.get(slot.index)
                    if rec is not None:
                        rec.write(slot_dib)
                    n = slot.processor.process(slot_dib, self.now)
                else:
                    n = slot.processor.process_audio(
                        aud[li], host[f"{key}/gate"][li] > 0, self.now)
                frames += n
                if n and not slot.is_control:
                    self.traffic.process_activity(slot.frequency_hz,
                                                  self.now)
                self.audio_segments.extend(slot.processor.drain_audio())
        elif self.bank_host is not None:
            # worker-process bank: the worker already framed + routed;
            # apply its traffic ACTIONS to the device plan and collect
            # its outputs (one chunk of grant latency, like in-process
            # pipelined mode)
            frames = int(reply["per_slot"].sum())
            self._worker_events.extend(reply["events"])
            if self.event_logger is not None:
                for e in reply["events"]:
                    self.event_logger.receive(e)
            self.audio_segments.extend(reply["audio"])
            self._worker_reply = reply
            for action in reply["actions"]:
                if action[0] == "activate":
                    _, freq, ids, kind = action
                    self._activate(freq, ids, kind)
                else:
                    self._teardown(action[1])
        elif self.bank_mode:
            active = np.array([s.active for s in self.slots])
            if self.bank_mixed:
                per_slot = self.bank_proc.route_mixed(*mixed, active,
                                                      self.now)
            elif self.bank_analog:
                per_slot = self.bank_proc.route_audio(audio, gate,
                                                      active, self.now)
            else:
                per_slot = self.bank_proc.route(bank_msgs, counts,
                                                active, self.now)
            frames = int(per_slot.sum())
            for slot in self.slots:
                if not slot.active:
                    continue
                if per_slot[slot.index] and not slot.is_control:
                    self.traffic.process_activity(slot.frequency_hz,
                                                  self.now)
                self.audio_segments.extend(
                    self.bank_proc.drain_audio(slot.index))
        else:
            for slot in self.slots:
                if not slot.active:
                    continue
                if digital:
                    slot_dib = dib[slot.index][val[slot.index]]
                    rec = self._bits_recorders.get(slot.index)
                    if rec is not None:
                        rec.write(slot_dib)
                    n = slot.processor.process(slot_dib, self.now)
                else:
                    n = slot.processor.process_audio(
                        audio[slot.index], gate[slot.index], self.now)
                frames += n
                if n and not slot.is_control:
                    # frames on a traffic channel = teardown-aging activity
                    self.traffic.process_activity(slot.frequency_hz,
                                                  self.now)
                self.audio_segments.extend(slot.processor.drain_audio())
        if self.bank_host is None:
            self.traffic.check_teardown(self.now)

        if self.rotation is not None:
            ctrl = next(s for s in self.slots if s.is_control)
            if self.bank_host is not None:
                self.rotation.state(
                    self._worker_reply.get("control_state"), self.now)
            elif self.bank_mode:
                self.rotation.state(
                    self.bank_proc.channel_state(ctrl.index), self.now)
            elif hasattr(ctrl.processor, "channel_state"):
                self.rotation.state(ctrl.processor.channel_state(),
                                    self.now)
            self.rotation.check(self.now)

        metrics = {
            "t": round(self.now, 6),
            "samples": self.samples_processed,
            "active_channels": sum(s.active for s in self.slots),
            "frames": frames,
            "events": len(self.traffic.events),
            "audio_segments": len(self.audio_segments),
        }
        # bounded-degradation visibility: the bank framers shed work
        # under budget pressure — those counters belong in every line
        # so an operator can see frames being deferred/expired live
        framer = getattr(self.bank_proc, "framer", None)
        if framer is not None:
            for key in ("deferred_hard_bch", "expired_pending",
                        "dropped_hard_rs"):
                v = getattr(framer, key, 0)
                if v:
                    metrics[key] = int(v)
            if framer.pending:
                metrics["pending_frames"] = len(framer.pending)
        if self.bank_proc is not None:
            unk = sum(m.unknown_opcodes
                      for m in self.bank_proc.metrics)
            if unk:
                metrics["unknown_opcodes"] = int(unk)
        if self.bank_host is not None:
            metrics.update(self._worker_reply.get("degraded", {}))
            if self._worker_reply.get("unknown_opcodes"):
                metrics["unknown_opcodes"] = int(
                    self._worker_reply["unknown_opcodes"])
        if pll_err_hz is not None:
            metrics["pll_error_hz"] = round(pll_err_hz, 1)
            metrics["correction_ppm"] = round(self.correction_ppm, 3)
        if self.metrics_sink is not None:
            self.metrics_sink(json.dumps(metrics))
        return metrics

    def run(self, max_chunks: int | None = None,
            pipelined: bool = True) -> dict:
        """Drain the source to exhaustion (or max_chunks). Returns the
        final metrics line.

        pipelined: three-stage overlap — a dedicated thread copies chunk
        n+1 to the device while the device computes chunk n and the
        host drains/frames chunk n-1 (SURVEY §2.8 host<->device pipeline
        row; numpy releases the GIL for the framing work it overlaps). Control-plane
        writes from chunk n (grant activations, retunes) take effect from
        chunk n+2 — one chunk of grant latency, like the reference's
        queued channel-start requests."""
        metrics = {}
        chunks = 0
        pending = None
        if not pipelined:
            while max_chunks is None or chunks < max_chunks:
                if self.error_state is not None:
                    break
                iq = self.source(self.chunk_samples)
                if iq is None or len(iq) < self.chunk_samples:
                    break
                metrics = self.run_chunk(np.asarray(iq))
                chunks += 1
            return metrics

        from concurrent.futures import ThreadPoolExecutor

        def next_prepared():
            if self.error_state is not None:
                return None           # error stop: consume nothing more
            iq = self.source(self.chunk_samples)
            if iq is None or len(iq) < self.chunk_samples:
                return None
            return self._prepare(iq)

        def pull(out, now):
            if self.bank_mode:
                return self._pull_bank(out, now)
            return {key: np.asarray(v) for key, v in out.items()}

        def may_read(done: int) -> bool:
            # Bounded runs must consume exactly max_chunks from the
            # source: prefetching past the budget would silently drop a
            # chunk of IQ on every bounded run() call (stream gap).
            return max_chunks is None or done < max_chunks

        with ThreadPoolExecutor(1) as up_pool, \
                ThreadPoolExecutor(1) as down_pool:
            prep = next_prepared() if may_read(0) else None
            fut = up_pool.submit(self._upload, prep) if prep is not None \
                else None
            while fut is not None and \
                    (max_chunks is None or chunks < max_chunks):
                if self.error_state is not None:
                    break
                dev_iq = fut.result()
                # enqueue compute(n) and the small D2H(n) BEFORE the next
                # chunk's larger H2D so they never queue behind it; the
                # H2D copy then overlaps chunk n's host framing.
                out, now = self._dispatch(dev_iq)
                for v in out.values():
                    try:
                        v.copy_to_host_async()
                    except AttributeError:  # non-jax leaf
                        pass
                prep = next_prepared() if may_read(chunks + 1) else None
                fut = up_pool.submit(self._upload, prep) \
                    if prep is not None else None
                cur = (down_pool.submit(pull, out, now), now)
                if pending is not None:
                    metrics = self._process(pending[0].result(),
                                            pending[1])
                pending = cur
                chunks += 1
        if pending is not None:
            metrics = self._process(pending[0].result(), pending[1])
        return metrics

    # --- introspection ---------------------------------------------------

    @property
    def events(self) -> list[DecodeEvent]:
        if self.bank_host is not None:
            return self._worker_events
        return self.traffic.events

    def close(self) -> None:
        """Release the bank worker process (if any)."""
        if self.bank_host is not None:
            self.bank_host.close()
            self.bank_host = None

    def channel_status(self) -> list[dict]:
        if self.bank_host is not None:
            return [{
                "slot": s.index, "active": s.active,
                "control": s.is_control, "frequency_hz": s.frequency_hz,
                "frames": int(self.bank_host.frame_counts[s.index]),
                "metrics": None,
            } for s in self.slots]
        if self.bank_mode:
            return [{
                "slot": s.index, "active": s.active,
                "control": s.is_control, "frequency_hz": s.frequency_hz,
                "frames": int(self.bank_proc.frame_counts[s.index]),
                "metrics": self.bank_proc.metrics[s.index].as_dict(),
            } for s in self.slots]
        return [{
            "slot": s.index, "active": s.active, "control": s.is_control,
            "frequency_hz": s.frequency_hz,
            "frames": (s.processor.frame_count if s.processor else 0),
            "metrics": (s.processor.metrics.as_dict()
                        if s.processor is not None
                        and hasattr(s.processor, "metrics") else None),
        } for s in self.slots]
