"""Live monitor: playlist + source -> Orchestrator -> events/audio out.

Role of the reference's headless live application: SDRTrunk's
`--headless` boot wires the playlist, source and audio managers, then
auto-starts every enabled channel and runs trunking end-to-end
(gui/SDRTrunk.java:141,152,281-300 autoStartChannels ->
ChannelProcessingManager REQUEST_ENABLE). Here that surface is one
function: build an Orchestrator whose pinned (control) slots are the
playlist's enabled channels, run the live loop, and deliver decode
events (JSONL/CSV), per-chunk metrics lines, and completed call audio
as WAV files with metadata sidecars.

Device notes: all enabled channels plus every traffic slot run in
ONE jitted slot-bank graph (bank mode auto-engages at >=32 slots);
heterogeneous playlists map to a MultibankReceiver with the control
channels pinned into their protocol banks. A channel "starting" is a
host-side control write, never a recompile.
"""
from __future__ import annotations

import json
import signal as _signal
from pathlib import Path

import numpy as np

from .config import Playlist
from .runtime.orchestrator import Orchestrator

__all__ = ["MonitorSession", "plan_from_playlist"]

# playlist decoder names -> orchestrator/receiver decoder kinds
_KIND_MAP = {"p25p1": "c4fm", "p25p1-lsm": "lsm"}
# protocols whose control channels issue traffic grants (the rest are
# conventional: pinned channels only, no following)
_TRUNKED = {"c4fm", "lsm", "p25p1", "p25p1-lsm", "p25p2", "dmr",
            "ltr", "ltrnet", "passport", "mpt1327"}


def plan_from_playlist(playlist: Playlist, center_frequency_hz: float,
                       sample_rate: float,
                       traffic_slots: int = 4) -> dict:
    """Derive the Orchestrator construction plan from a playlist's
    enabled channels.

    Returns {kinds: ordered unique decoder kinds, controls:
    [(offset_hz, kind, name)], banks: [(kind, n)] | None, slots: int,
    decoder: str}. Single-kind playlists use the plain slot bank (bank
    mode auto-engages at scale); mixed playlists get one bank per kind
    with `traffic_slots` spare slots in every trunked bank.
    """
    enabled = [c for c in playlist.channels if c.enabled]
    if not enabled:
        raise ValueError("playlist has no enabled channels")
    half_span = sample_rate / 2.0
    controls: list[tuple[float, str, str]] = []
    kinds: list[str] = []
    for c in enabled:
        kind = _KIND_MAP.get(c.decode.decoder, c.decode.decoder)
        off = c.source.frequency_hz - center_frequency_hz
        if abs(off) > half_span:
            raise ValueError(
                f"channel '{c.name}' at {c.source.frequency_hz/1e6:.4f} "
                f"MHz is outside the capture (center "
                f"{center_frequency_hz/1e6:.4f} MHz, span "
                f"{sample_rate/1e6:.3f} MHz)")
        controls.append((off, kind, c.name))
        if kind not in kinds:
            kinds.append(kind)
    if len(kinds) == 1:
        kind = kinds[0]
        spare = traffic_slots if kind in _TRUNKED else 1
        return {"kinds": kinds, "controls": controls, "banks": None,
                "decoder": kind,
                "slots": len(controls) + max(1, spare)}
    banks = []
    for kind in kinds:
        n = sum(1 for _, k, _ in controls if k == kind)
        banks.append((kind, n + (traffic_slots if kind in _TRUNKED
                                 else 1)))
    return {"kinds": kinds, "controls": controls, "banks": banks,
            "decoder": kinds[0],
            "slots": sum(n for _, n in banks)}


class MonitorSession:
    """One live monitoring run (the headless app loop).

    source_read: callable(num_samples) -> complex64 array or None (a
    TunerController._read_chunk, the native ingest ring, or any
    generator). Writes:
      * metrics JSONL per chunk via `emit` (stdout by default),
      * decode events to event_log_path (orchestrator wiring),
      * completed AudioSegments as WAV+JSON under audio_dir as calls
        end (not at shutdown — a long run keeps delivering).
    Call stop() (or wire_sigint()) for a graceful end: the in-flight
    chunk finishes, open calls flush, remaining audio is written.
    """

    def __init__(self, playlist: Playlist, source_read,
                 sample_rate: float, center_frequency_hz: float,
                 emit=print, audio_dir=None, event_log_path=None,
                 traffic_slots: int = 4, bank_mode: bool | None = None,
                 codec=None, chunk_samples: int | None = None,
                 control_rotation=None, min_audio_seconds: float = 0.0,
                 host_process: bool = False):
        self.plan = plan_from_playlist(
            playlist, center_frequency_hz, sample_rate,
            traffic_slots=traffic_slots)
        self.emit = emit
        self.audio_dir = Path(audio_dir) if audio_dir else None
        if self.audio_dir is not None:
            self.audio_dir.mkdir(parents=True, exist_ok=True)
        self.min_audio_seconds = min_audio_seconds
        # per-playlist audio container: mp2 if ANY enabled channel
        # requests it (AudioSegmentRecorder format option)
        self.audio_container = "wav"
        for c in playlist.channels:
            if c.enabled and c.record.audio_format == "mp2":
                self.audio_container = "mp2"
        self.audio_written = 0
        self._stop = False
        self._alias_list = playlist.alias_list()

        def guarded(num):
            if self._stop:
                return None
            return source_read(num)

        if self.plan["banks"] is not None:
            control_arg = [(off, kind)
                           for off, kind, _ in self.plan["controls"]]
        else:
            control_arg = [off for off, _, _ in self.plan["controls"]]
        self.orch = Orchestrator(
            guarded, sample_rate, center_frequency_hz, control_arg,
            slots=self.plan["slots"], decoder=self.plan["decoder"],
            banks=self.plan["banks"], bank_mode=bank_mode, codec=codec,
            chunk_samples=chunk_samples,
            event_log_path=event_log_path,
            control_rotation=control_rotation,
            metrics_sink=self._on_metrics,
            host_process=host_process)
        control_slots = [s for s in self.orch.slots if s.is_control]
        for (off, kind, name), slot in zip(self.plan["controls"],
                                           control_slots):
            slot.name = name            # playlist channel name for status

        # per-channel RecordConfig -> live recorder taps
        # (record/wave/ComplexBufferWaveRecorder + BinaryRecorder roles)
        enabled = [c for c in playlist.channels if c.enabled]
        rec_dir = self.audio_dir or Path(".")
        for cfg, slot in zip(enabled, control_slots):
            if cfg.record.demodulated_bits:
                self.orch.start_bits_recording(
                    slot.index, rec_dir / f"{cfg.name}.bits")
            if cfg.record.baseband_iq and self.orch._iq_writer is None:
                self.orch.start_iq_recording(rec_dir / "wideband_iq.wav")
            # AuxDecodeConfig: fleetsync2/mdc1200/lj1200/tait1200 ride
            # the channel's demodulated audio
            if cfg.decode.aux and slot.processor is not None \
                    and hasattr(slot.processor, "add_aux"):
                for aux_name in cfg.decode.aux:
                    slot.processor.add_aux(aux_name)

    # -- per-chunk hook ---------------------------------------------------

    def _on_metrics(self, line: str) -> None:
        if self.emit is not None:
            self.emit(line)
        self._drain_audio()

    def _drain_audio(self) -> None:
        if not self.orch.audio_segments:
            return
        segments = self.orch.audio_segments
        self.orch.audio_segments = []
        for seg in segments:
            if seg.duration <= self.min_audio_seconds:
                continue
            self.audio_written += 1
            if self.audio_dir is None:
                continue
            from .audio.recorder import write_audio_mpeg, write_audio_wave
            stem = f"call_{self.audio_written:05d}_{seg.start_time:.2f}s"
            if self.audio_container == "mp2":
                write_audio_mpeg(self.audio_dir / f"{stem}.mp2", seg)
            else:
                write_audio_wave(self.audio_dir / f"{stem}.wav", seg)

    # -- control ----------------------------------------------------------

    def stop(self) -> None:
        """Request a graceful stop; the running chunk completes."""
        self._stop = True

    def wire_sigint(self) -> None:
        """First Ctrl-C stops gracefully; second raises as usual."""
        prev = _signal.getsignal(_signal.SIGINT)

        def handler(sig, frame):
            if self._stop:
                _signal.signal(_signal.SIGINT, prev)
                raise KeyboardInterrupt
            self.stop()
        _signal.signal(_signal.SIGINT, handler)

    def run(self, max_chunks: int | None = None,
            pipelined: bool = True) -> dict:
        """Run to source exhaustion / stop(); returns the summary dict."""
        self.orch.run(max_chunks=max_chunks, pipelined=pipelined)
        # end of stream: flush open calls into segments, deliver them,
        # finalize any recording taps
        for slot in self.orch.slots:
            if slot.active:
                self.orch._slot_flush_drain(slot)
        self._drain_audio()
        for idx in list(self.orch._bits_recorders):
            self.orch.stop_bits_recording(idx)
        self.orch.stop_iq_recording()
        summary = self.summary()
        self.orch.close()
        return summary

    def summary(self) -> dict:
        orch = self.orch
        events = orch.events
        return {
            "summary": True,
            "duration_s": round(orch.now, 3),
            "samples": orch.samples_processed,
            "channels": [
                {"name": getattr(s, "name", None), "slot": s.index,
                 "frequency_hz": s.frequency_hz, "control": s.is_control,
                 "active": s.active}
                for s in orch.slots if s.is_control or s.active],
            "events": len(events),
            "event_types": sorted({e.event_type.value for e in events}),
            "audio_segments": self.audio_written,
            "skipped_grants": len(orch.skipped_grants),
            "error_state": orch.error_state,
        }
