"""Demod / AGC / oscillator / generator tests."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.dsp import agc, demod, oscillator
from sdrtrunk_jax.signal import generators


def test_fm_demodulate_recovers_tone():
    fs, fa = 50000.0, 1000.0
    t = np.arange(5000) / fs
    audio = np.sin(2 * np.pi * fa * t).astype(np.float32)
    iq = generators.fm_modulate(audio, deviation_hz=3000.0, sample_rate=fs)
    gain = demod.fm_gain(fs, 3000.0)
    y, _ = demod.fm_demodulate(jnp.asarray(iq), gain=gain)
    y = np.asarray(y)[100:-100]
    # fm_modulate integrates trapezoidally -> the modulated message is the
    # half-sample-shifted midpoint sequence; compare against that
    mid = 0.5 * (audio[1:] + audio[:-1])
    ref = np.concatenate([[audio[0]], mid])[100:-100]
    corr = np.corrcoef(y, ref)[0, 1]
    assert corr > 0.999
    assert np.max(np.abs(y)) == pytest.approx(1.0, abs=0.05)


def test_fm_demod_streaming_continuity():
    iq = generators.tone(2000.0, 48000.0, 1000)
    full, _ = demod.fm_demodulate(jnp.asarray(iq))
    a, prev = demod.fm_demodulate(jnp.asarray(iq[:500]))
    b, _ = demod.fm_demodulate(jnp.asarray(iq[500:]), prev=prev)
    merged = np.concatenate([np.asarray(a), np.asarray(b)])
    assert np.allclose(merged, np.asarray(full), atol=1e-5)


def test_am_demodulate():
    fs = 25000.0
    t = np.arange(2500) / fs
    msg = 0.5 * (1.0 + 0.8 * np.sin(2 * np.pi * 400 * t))
    iq = (msg * np.exp(2j * np.pi * 100 * t)).astype(np.complex64)
    y = np.asarray(demod.am_demodulate(jnp.asarray(iq)))
    assert np.allclose(y, msg, atol=1e-3)


def test_power_squelch_gates_noise_vs_signal():
    rng = np.random.default_rng(0)
    quiet = (rng.standard_normal(5000) + 1j * rng.standard_normal(5000)).astype(np.complex64) * 1e-6
    loud = generators.tone(1000.0, 25000.0, 5000)
    x = np.concatenate([quiet, loud])
    gate, pdb, _ = demod.power_squelch(jnp.asarray(x), threshold_db=-78.0)
    gate = np.asarray(gate)
    assert not gate[:4000].any()
    assert gate[-1000:].all()


def test_feed_forward_agc_normalizes():
    x = generators.tone(500.0, 25000.0, 2000, amplitude=0.05)
    y, _ = agc.feed_forward_agc(jnp.asarray(x), window=32)
    env = np.abs(np.asarray(y))[64:]
    assert np.all(env < 1.05)
    assert np.median(env) > 0.9


def test_oscillator_phase_continuity():
    full, _ = oscillator.oscillate(1234.5, 48000.0, 1024)
    a, ph = oscillator.oscillate(1234.5, 48000.0, 512)
    b, _ = oscillator.oscillate(1234.5, 48000.0, 512, phase=ph)
    merged = np.concatenate([np.asarray(a), np.asarray(b)])
    assert np.allclose(merged, np.asarray(full), atol=1e-4)


def test_mix_down_centers_tone():
    fs = 50000.0
    x = generators.tone(7000.0, fs, 4096)
    y, _ = oscillator.mix_down(jnp.asarray(x), 7000.0, fs)
    y = np.asarray(y)
    # after mixing, spectrum peak should be at DC
    spec = np.abs(np.fft.fft(y))
    assert np.argmax(spec) == 0


def test_fs4_down_convert():
    fs = 48000.0
    x = generators.tone(12000.0, fs, 4096)  # tone at fs/4
    y = np.asarray(oscillator.fs4_down_convert(jnp.asarray(x)))
    spec = np.abs(np.fft.fft(y))
    assert np.argmax(spec) == 0


def test_c4fm_modulator_phase_steps():
    """Differential phase over each symbol period must be +/-45 / +/-135 deg.

    C4FM's modulation filter (RC Nyquist x inverse-sinc shaping,
    TIA-102.BAAA) makes the INTEGRATED frequency over a centered symbol
    window ISI-free — that is exactly what a differential-phase detector
    measures. Includes an alternating +/-3 run (sync-like worst case).
    """
    fs, baud = 48000.0, 4800.0
    sps = fs / baud
    dibits = np.concatenate([generators.random_dibits(100, seed=2),
                             np.array([1, 3] * 20, np.int32),
                             generators.random_dibits(60, seed=3)])
    iq = generators.c4fm_modulate(dibits, fs, baud)
    phase = np.unwrap(np.angle(iq))
    levels = generators.dibits_to_symbols(dibits)
    for i in range(10, len(dibits) - 10):
        t1 = int(round((i + 0.5) * sps))
        dp = (phase[t1] - phase[t1 - int(sps)]) * 180.0 / np.pi
        assert abs(dp - levels[i] * 45.0) < 6.0, (i, dp, levels[i])


def test_wave_roundtrip(tmp_path):
    from sdrtrunk_jax.io import wave
    iq = generators.tone(1000.0, 25000.0, 2048, amplitude=0.7)
    path = tmp_path / "test_iq.wav"
    wave.write_complex_wave(path, iq, 25000)
    iq2, rate = wave.read_complex_wave(path)
    assert rate == 25000
    assert np.allclose(iq2, iq, atol=2e-4)  # 16-bit quantization
