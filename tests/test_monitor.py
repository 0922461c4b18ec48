"""monitor CLI: the live Orchestrator as a product surface.

VERDICT r4 item 1: `sdrtrunk_jax monitor --playlist p.json --input
capture.wav` must decode a trunked capture end-to-end with traffic
following and write events + audio. The capture here is the same
synthetic P25 control+traffic scene as test_orchestrator (identical
graph shapes, so the jitted step compiles once per session).
"""
import json

import numpy as np
import pytest

from sdrtrunk_jax.config import (ChannelConfig, DecodeConfig, Playlist,
                                 RecordConfig, SourceConfig)
from sdrtrunk_jax.monitor import plan_from_playlist

from test_orchestrator import (BAUD, CENTER_HZ, CONTROL_OFF, FS,
                               TRAFFIC_OFF, _control_stream,
                               _traffic_stream)


def _write_capture(path) -> None:
    from sdrtrunk_jax.io.wave import write_complex_wave
    from sdrtrunk_jax.signal import generators
    duration_s = 2.6
    total_dibits = int(duration_s * BAUD)
    rng = np.random.default_rng(7)
    voice = [rng.integers(0, 2, (9, 144)).astype(np.uint8)
             for _ in range(2)]
    n = None
    wide = None
    for offset, dibits in ((CONTROL_OFF, _control_stream(total_dibits)),
                           (TRAFFIC_OFF,
                            _traffic_stream(total_dibits, voice))):
        iq = generators.c4fm_modulate(dibits, FS)
        if wide is None:
            n = len(iq) // 64 * 64
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / FS
        wide += (iq[:n] * np.exp(2j * np.pi * offset * t)
                 ).astype(np.complex64)
    write_complex_wave(path, wide, int(FS))


@pytest.fixture(scope="module")
def monitor_run(tmp_path_factory, capsys_module=None):
    from sdrtrunk_jax.cli import main
    tmp = tmp_path_factory.mktemp("monitor")
    capture = tmp / "capture.wav"
    _write_capture(capture)
    playlist = Playlist(channels=[ChannelConfig(
        name="Control", system="TestSys", site="Site1",
        source=SourceConfig(frequency_hz=CENTER_HZ + CONTROL_OFF),
        decode=DecodeConfig(decoder="p25p1"),
        record=RecordConfig(baseband_iq=True, demodulated_bits=True))])
    ppath = tmp / "playlist.json"
    playlist.save(ppath)
    audio_dir = tmp / "audio"
    events = tmp / "events.jsonl"
    rc = main(["--platform", "cpu", "monitor",
               "--playlist", str(ppath), "--input", str(capture),
               "--center-frequency", str(CENTER_HZ),
               "--audio-dir", str(audio_dir),
               "--event-log", str(events),
               "--traffic-slots", "3",
               "--chunk-samples", str(64 * 256),
               "--quiet"])
    return rc, tmp, audio_dir, events


def test_monitor_cli_runs_and_follows_traffic(monitor_run, capsys):
    rc, tmp, audio_dir, events = monitor_run
    assert rc == 0


def test_monitor_outputs(monitor_run):
    rc, tmp, audio_dir, events = monitor_run
    # decode events logged (grant + call events from traffic following)
    lines = events.read_text().strip().splitlines()
    assert lines
    freqs = set()
    for line in lines:
        try:
            freqs.add(json.loads(line).get("frequency_hz"))
        except json.JSONDecodeError:
            pass
    assert CENTER_HZ + TRAFFIC_OFF in freqs     # granted channel seen
    # the traffic call's voice became a WAV + metadata sidecar
    wavs = sorted(audio_dir.glob("call_*.wav"))
    assert wavs, list(audio_dir.iterdir())
    meta = json.loads(
        wavs[0].with_suffix(".wav.json").read_text())
    assert meta["duration"] == pytest.approx(18 * 0.020, rel=0.01)


def test_monitor_recording_taps(monitor_run):
    """RecordConfig flags wire the live recorder taps: the control
    channel's dibit stream lands as a reference-format .bits file and
    the wideband capture as an IQ wave (ComplexBufferWaveRecorder /
    BinaryRecorder roles, live)."""
    from sdrtrunk_jax.audio.recorder import BitsReader
    from sdrtrunk_jax.io.wave import read_complex_wave
    from sdrtrunk_jax.protocol.p25p1 import P25P1Framer

    rc, tmp, audio_dir, events = monitor_run
    bits_path = audio_dir / "Control.bits"
    assert bits_path.exists()
    dibits = BitsReader.read(bits_path)
    assert len(dibits) > 10000              # ~2.6 s at 4800 baud
    # the recorded stream re-frames: control TSBKs are in there
    msgs = P25P1Framer().process(dibits)
    assert sum(1 for m in msgs if m.duid.name == "TSBK") >= 4

    iq, rate = read_complex_wave(audio_dir / "wideband_iq.wav")
    assert rate == int(FS)
    assert len(iq) >= FS * 2.5              # nearly the whole capture


def test_plan_single_kind():
    pl = Playlist(channels=[
        ChannelConfig(name="A",
                      source=SourceConfig(frequency_hz=460_025_000.0),
                      decode=DecodeConfig(decoder="p25p1")),
        ChannelConfig(name="B",
                      source=SourceConfig(frequency_hz=460_150_000.0),
                      decode=DecodeConfig(decoder="p25p1"))])
    plan = plan_from_playlist(pl, 460e6, 800e3, traffic_slots=4)
    assert plan["banks"] is None and plan["decoder"] == "c4fm"
    assert plan["slots"] == 6
    assert [n for _, _, n in plan["controls"]] == ["A", "B"]


def test_plan_mixed_kinds_and_span_check():
    pl = Playlist(channels=[
        ChannelConfig(name="P25",
                      source=SourceConfig(frequency_hz=460_025_000.0),
                      decode=DecodeConfig(decoder="p25p1")),
        ChannelConfig(name="FM",
                      source=SourceConfig(frequency_hz=460_150_000.0),
                      decode=DecodeConfig(decoder="nbfm"))])
    plan = plan_from_playlist(pl, 460e6, 800e3, traffic_slots=2)
    assert plan["banks"] == [("c4fm", 3), ("nbfm", 2)]
    assert plan["slots"] == 5
    pl.channels[1].source.frequency_hz = 470e6      # outside capture
    with pytest.raises(ValueError, match="outside the capture"):
        plan_from_playlist(pl, 460e6, 800e3)
