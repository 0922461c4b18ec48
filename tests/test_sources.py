"""Tests: sample-format converters, tuner abstraction, synthetic and
file-replay sources."""
import numpy as np
import pytest

from sdrtrunk_jax.io import wave
from sdrtrunk_jax.sources import (
    rtl_bytes_to_iq, signed_bytes_to_iq, airspy_unpacked_to_floats,
    airspy_packed_to_floats, pcm16_to_iq,
    SourceEvent, SourceEventType, TunerSpec, TunerController, TunerManager,
    TunerUnavailable, TestTuner, RecordingTuner, ComplexWaveSource)


def test_rtl_converter_scale():
    raw = bytes([127, 127, 255, 0, 0, 255])
    iq = rtl_bytes_to_iq(raw)
    np.testing.assert_allclose(iq, [0.0 + 0.0j, 1.0 - 0.9921875j,
                                    -0.9921875 + 1.0j], atol=1e-6)


def test_signed_converter_scale():
    raw = np.array([0, 0, 127, -128], dtype=np.int8)
    iq = signed_bytes_to_iq(raw)
    np.testing.assert_allclose(iq, [0.0, 0.9921875 - 1.0j], atol=1e-6)


def test_airspy_unpacked():
    w = np.array([2048, 0, 4095], dtype=np.uint16)
    f = airspy_unpacked_to_floats(w)
    np.testing.assert_allclose(f, [0.0, -1.0, 2047 / 2048], atol=1e-6)


def test_airspy_packed_roundtrip():
    vals = np.array([0x800, 0x000, 0xFFF, 0x123], dtype=np.int64)
    # pack 2 samples per 3 bytes, MSB-first
    b = bytearray()
    for i in range(0, len(vals), 2):
        a, c = int(vals[i]), int(vals[i + 1])
        b += bytes([(a >> 4) & 0xFF, ((a & 0xF) << 4) | ((c >> 8) & 0xF),
                    c & 0xFF])
    f = airspy_packed_to_floats(bytes(b))
    np.testing.assert_allclose(f, (vals - 2048) / 2048.0, atol=1e-6)


def test_pcm16_converter():
    w = np.array([0, -32768, 16384, 32767], dtype=np.int16)
    iq = pcm16_to_iq(w)
    np.testing.assert_allclose(iq, [0.0 - 1.0j, 0.5 + 0.99996948j], atol=1e-6)


def _spec():
    return TunerSpec(name="x", minimum_frequency=100e6,
                     maximum_frequency=1e9, sample_rates=(2.4e6, 1.2e6),
                     usable_fraction=0.9, dc_spike_hz=5e3)


def test_tuner_controller_frequency_limits_and_events():
    class Dummy(TunerController):
        def _read_chunk(self, n):
            return None

    t = Dummy(_spec(), frequency=450e6, sample_rate=2.4e6)
    events = []
    t.add_listener(events.append)
    t.frequency = 460e6
    with pytest.raises(ValueError):
        t.frequency = 99e6
    with pytest.raises(ValueError):
        t.sample_rate = 999.0
    t.sample_rate = 1.2e6
    kinds = [e.type for e in events]
    assert kinds == [SourceEventType.FREQUENCY_CHANGE,
                     SourceEventType.SAMPLE_RATE_CHANGE]


def test_tuner_coverage_and_dc_spike():
    class Dummy(TunerController):
        def _read_chunk(self, n):
            return None

    t = Dummy(_spec(), frequency=450e6, sample_rate=2.4e6)
    assert t.covers(450.5e6, 12500.0)
    assert not t.covers(452e6, 12500.0)        # outside usable
    assert not t.covers(450.000e6, 12500.0)    # straddles DC spike


def test_tuner_manager_selection():
    class Dummy(TunerController):
        def _read_chunk(self, n):
            return None

    mgr = TunerManager()
    mgr.add("a", Dummy(_spec(), frequency=450e6, sample_rate=2.4e6))
    mgr.add("b", Dummy(_spec(), frequency=900e6, sample_rate=2.4e6))
    assert mgr.source_for(900.3e6, 12500.0) is mgr.tuners["b"]
    with pytest.raises(TunerUnavailable):
        mgr.source_for(700e6, 12500.0)


def test_test_tuner_tone_and_chunking():
    t = TestTuner(sample_rate=400_000.0, tone_offset_hz=50_000.0,
                  total_samples=8192)
    chunks = list(t.chunks(4096))
    assert [len(c) for c in chunks] == [4096, 4096]
    x = np.concatenate(chunks)
    ph = np.angle(x[1:] * np.conj(x[:-1]))
    f_est = ph.mean() * 400_000.0 / (2 * np.pi)
    assert f_est == pytest.approx(50_000.0, abs=10.0)
    # phase continuity across the chunk boundary: no jump
    assert abs(ph[4095] - ph.mean()) < 1e-3


def test_test_tuner_sweep_resets():
    t = TestTuner(sample_rate=400_000.0, tone_offset_hz=90_000.0,
                  sweep_rate_hz=30_000.0, total_samples=4096 * 4)
    list(t.chunks(4096))
    assert t.tone_offset_hz < 400_000.0 / 4


def test_recording_tuner_replays_wave(tmp_path):
    rng = np.random.default_rng(0)
    iq = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)
          ).astype(np.complex64) * 0.3
    p = tmp_path / "cap.wav"
    wave.write_complex_wave(p, iq, 48000)
    t = RecordingTuner(p, center_frequency=460e6)
    assert t.sample_rate == 48000.0
    out = np.concatenate(list(t.chunks(2048)))
    assert len(out) == 5000
    got, _ = wave.read_complex_wave(p)
    np.testing.assert_allclose(out, got, atol=1e-7)


def test_complex_wave_source_stepping(tmp_path):
    iq = np.arange(100, dtype=np.complex64) / 100.0
    p = tmp_path / "step.wav"
    wave.write_complex_wave(p, iq, 25000)
    src = ComplexWaveSource(p)
    a = src.next(30)
    b = src.next(30)
    assert len(a) == 30 and len(b) == 30 and src.position == 60
    src.rewind()
    np.testing.assert_array_equal(src.next(30), a)
