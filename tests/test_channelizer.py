"""Polyphase M/2 channelizer tests: oracle equivalence, tone routing,
streaming continuity, perfect reconstruction, and full NBFM-over-channelizer
decode (BASELINE.json config 2, miniaturized)."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.dsp import design
from sdrtrunk_jax.dsp.channelizer import (Channelizer, channel_count_for_rate,
                                          channelize)
from sdrtrunk_jax.dsp.extract import extract_channels, plan_channels
from sdrtrunk_jax.signal import generators


def oracle_channelize(x, h, M):
    """Direct evaluation of y[k,m] = sum_n h[n] x[kM/2-n] e^{-2pi i m(kM/2-n)/M}."""
    T = int(np.ceil(len(h) / M))
    hp = np.zeros(T * M)
    hp[: len(h)] = h
    N = len(x)
    K = 2 * N // M
    xp = np.concatenate([np.zeros(T * M, complex), np.asarray(x, complex)])
    H = T * M
    n = np.arange(T * M)
    y = np.zeros((K, M), complex)
    for k in range(K):
        xs = xp[H + k * M // 2 - n]
        for m in range(M):
            y[k, m] = np.sum(hp * xs * np.exp(-2j * np.pi * m * (k * M // 2 - n) / M))
    return y


def test_channel_count_for_rate():
    assert channel_count_for_rate(2_400_000, 12500) == 192
    assert channel_count_for_rate(2_400_000, 25000) == 96
    assert channel_count_for_rate(10_000_000, 12500) == 800


def test_channelizer_matches_oracle():
    rng = np.random.default_rng(0)
    M, T, N = 8, 3, 64
    x = (rng.standard_normal(N) + 1j * rng.standard_normal(N)).astype(np.complex64)
    h = rng.standard_normal(T * M - 1)
    ours = np.asarray(channelize(jnp.asarray(x), h, M))
    oracle = oracle_channelize(x, h, M)
    assert np.max(np.abs(ours - oracle)) < 1e-4


def test_tone_routes_to_correct_bin():
    M = 16
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    for m0, expect_bin in [(3, 3), (-2, M - 2), (M // 2, M // 2)]:
        x = generators.tone(m0 * 12500.0, fs, M * 64)
        y, _ = ch(jnp.asarray(x))
        y = np.asarray(y)[32:]
        energies = np.mean(np.abs(y) ** 2, axis=0)
        assert np.argmax(energies) == expect_bin % M
        # in-bin tone: ~unit amplitude, everything else < -40 dB
        assert np.abs(np.mean(np.abs(y[:, expect_bin % M]))) == pytest.approx(1.0, abs=0.05)
        others = np.delete(energies, expect_bin % M)
        assert np.max(others) < 1e-4


def test_streaming_equals_oneshot():
    M = 8
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    rng = np.random.default_rng(4)
    x = (rng.standard_normal(M * 48) + 1j * rng.standard_normal(M * 48)).astype(np.complex64)
    full, _ = ch(jnp.asarray(x))
    state = ch.init_state()
    parts = []
    step = M * 12
    for i in range(0, len(x), step):
        y, state = ch(jnp.asarray(x[i:i + step]), state)
        parts.append(np.asarray(y))
    merged = np.concatenate(parts, axis=0)
    assert np.allclose(merged, np.asarray(full), atol=1e-4)


def test_offset_tone_extraction():
    """A tone between bin centers must downconvert to its residual offset."""
    M = 16
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    f_signal = 3 * 12500.0 + 3000.0  # 3 kHz above bin 3 center
    x = generators.tone(f_signal, fs, M * 128)
    y, _ = ch(jnp.asarray(x))
    plan = plan_channels(ch, [f_signal])
    streams, _ = extract_channels(y, plan)
    s = np.asarray(streams[0])[64:]
    # after residual mix-down the stream should be ~DC
    dphi = np.angle(s[1:] * np.conj(s[:-1]))
    assert np.abs(np.mean(dphi)) < 1e-3
    assert np.std(np.abs(s)) < 0.05


def test_perfect_reconstruction_two_bins():
    """A tone at the shared band edge of two bins appears in both at -6 dB
    (amplitude 0.5 each) — the perfect-reconstruction design objective."""
    M = 16
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    edge = 3 * 12500.0 + 6250.0  # edge between bins 3 and 4
    x = generators.tone(edge, fs, M * 128)
    y, _ = ch(jnp.asarray(x))
    y = np.asarray(y)[64:]
    a3 = np.mean(np.abs(y[:, 3]))
    a4 = np.mean(np.abs(y[:, 4]))
    assert a3 == pytest.approx(0.5, abs=0.02)
    assert a4 == pytest.approx(0.5, abs=0.02)


def test_channelized_nbfm_decode():
    """Config-2 miniature: multi-channel NBFM through the channelizer."""
    from sdrtrunk_jax.decoders.nbfm import NBFMConfig, NBFMDecoder

    M = 16
    fs = M * 12500.0  # 200 kHz
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    # two NBFM signals on different bins with different audio tones
    fa1, fa2 = 700.0, 1100.0
    dur = 0.25
    n_aud = int(dur * 8000)
    t8 = np.arange(int(dur * fs)) / fs
    audio1 = np.sin(2 * np.pi * fa1 * t8).astype(np.float32)
    audio2 = np.sin(2 * np.pi * fa2 * t8).astype(np.float32)
    iq1 = generators.fm_modulate(audio1, 3000.0, fs)
    iq2 = generators.fm_modulate(audio2, 3000.0, fs)
    f1, f2 = 2 * 12500.0, 5 * 12500.0
    n = (len(iq1) // M) * M
    tt = np.arange(n) / fs
    wideband = (iq1[:n] * np.exp(2j * np.pi * f1 * tt)
                + iq2[:n] * np.exp(2j * np.pi * f2 * tt)).astype(np.complex64)

    y, _ = ch(jnp.asarray(wideband))
    plan = plan_channels(ch, [f1, f2])
    streams, _ = extract_channels(y, plan)

    dec = NBFMDecoder(NBFMConfig(sample_rate=ch.channel_sample_rate,
                                 bandwidth=12500.0))
    for idx, f_expect in [(0, fa1), (1, fa2)]:
        outputs, _ = dec(streams[idx], dec.init_state())
        audio = np.asarray(outputs["audio"])[400:]
        # squelch power IIR (alpha 4e-4 ~ 0.1 s time constant) must open
        # once warmed up
        assert np.asarray(outputs["audio_gate"])[1200:].all()
        spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
        freqs = np.fft.rfftfreq(len(audio), 1 / 8000.0)
        peak = freqs[np.argmax(spec)]
        assert abs(peak - f_expect) < 30.0, (idx, peak, f_expect)
