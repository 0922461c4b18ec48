"""Tests: misc filters (Goertzel, biquad, CMA, IQ correction, Hilbert),
prime-factor CIC DDC, and the two-channel M/2 synthesizer."""
import numpy as np
import jax.numpy as jnp
import pytest
from scipy import signal as sps

from sdrtrunk_jax.dsp import design
from sdrtrunk_jax.dsp.misc import (
    goertzel_magnitude, goertzel_power, biquad_design, biquad_apply,
    cma_equalize, iq_correction, real_to_complex)
from sdrtrunk_jax.dsp.cic import prime_factors, cic_decimate, CICChannel
from sdrtrunk_jax.dsp.synthesizer import TwoChannelSynthesizer, synthesize_two
from sdrtrunk_jax.dsp.channelizer import Channelizer


def test_goertzel_detects_tone():
    fs = 8000.0
    t = np.arange(1024) / fs
    x = jnp.asarray(0.8 * np.sin(2 * np.pi * 1000.0 * t), jnp.float32)
    assert float(goertzel_magnitude(x, 1000.0, fs)) == pytest.approx(0.8, abs=0.02)
    assert float(goertzel_power(x, 2500.0, fs)) < 1e-4


def test_biquad_matches_scipy_lfilter():
    b, a = biquad_design("lowpass", 1000.0, 8000.0)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(500).astype(np.float32)
    y, _ = biquad_apply(jnp.asarray(x), b, a)
    ref = sps.lfilter(b, a, x)
    np.testing.assert_allclose(np.asarray(y), ref, atol=1e-4)


def test_biquad_streaming_equals_oneshot():
    b, a = biquad_design("bandpass", 1200.0, 8000.0, q=5.0)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(400).astype(np.float32)
    full, _ = biquad_apply(jnp.asarray(x), b, a)
    st = None
    parts = []
    for chunk in np.split(x, 4):
        y, st = biquad_apply(jnp.asarray(chunk), b, a, st)
        parts.append(np.asarray(y))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(full),
                               atol=1e-5)


def test_cma_equalizer_restores_modulus():
    # QPSK through a mild static channel; CMA should drive |y| toward 1.
    rng = np.random.default_rng(5)
    syms = np.exp(1j * (np.pi / 4 + np.pi / 2 * rng.integers(0, 4, 4000)))
    chan = np.array([1.0, 0.25 - 0.1j])
    x = np.convolve(syms, chan)[: len(syms)].astype(np.complex64)
    y, taps = cma_equalize(jnp.asarray(x), mu=0.003)
    tail = np.abs(np.asarray(y)[-500:])
    head = np.abs(np.asarray(x)[:500])
    assert tail.std() < head.std() * 0.5
    assert tail.mean() == pytest.approx(1.0, abs=0.05)


def test_iq_correction_removes_dc():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal(20000) + 1j * rng.standard_normal(20000)
         + (0.3 - 0.2j)).astype(np.complex64)
    y, mean = iq_correction(jnp.asarray(x), ratio=0.005)
    assert abs(np.asarray(y)[-2000:].mean()) < 0.02
    # final state is the instantaneous tracker value (carries ~sigma*sqrt(a/2)
    # tracking noise per rail), so the tolerance is loose
    assert complex(mean) == pytest.approx(0.3 - 0.2j, abs=0.15)


def test_hilbert_produces_analytic_signal():
    fs = 100e3
    hb = design.half_band(22)  # 23 taps: (23+1)%4==0
    t = np.arange(8192) / fs
    f = 20e3
    x = jnp.asarray(np.cos(2 * np.pi * f * t), jnp.float32)
    y, _ = real_to_complex(x, hb)
    y = np.asarray(y)[200:-200]
    spec = np.fft.fftshift(np.fft.fft(y * np.hanning(len(y))))
    freqs = np.fft.fftshift(np.fft.fftfreq(len(y), 1 / fs))
    pos = np.abs(spec[np.argmin(np.abs(freqs - f))])
    neg = np.abs(spec[np.argmin(np.abs(freqs + f))])
    assert pos / max(neg, 1e-9) > 100.0  # negative image suppressed > 40 dB


def test_prime_factors():
    assert prime_factors(96) == [3, 2, 2, 2, 2, 2]
    assert prime_factors(1) == []
    # unbounded like commons-math Primes.primeFactors (no fixed table)
    assert prime_factors(53) == [53]
    assert prime_factors(2801 * 53 * 59) == [2801, 59, 53]
    with pytest.raises(ValueError):
        prime_factors(0)


def test_cic_decimate_preserves_dc():
    x = jnp.ones((960,), jnp.complex64)
    y = cic_decimate(x, 96)
    assert y.shape == (10,)
    np.testing.assert_allclose(np.asarray(y), 1.0, atol=1e-6)


def test_cic_channel_extracts_offset_tone():
    fs = 2_400_000.0
    ddc = CICChannel.design(fs, frequency_offset=300e3, channel_rate=25e3)
    assert ddc.decimation == 96
    n = 96 * 800
    t = np.arange(n) / fs
    # tone 2 kHz above the channel center
    x = jnp.asarray(np.exp(2j * np.pi * (300e3 + 2e3) * t), jnp.complex64)
    y, _ = ddc(x)
    y = np.asarray(y)[200:]
    ph = np.angle(y[1:] * np.conj(y[:-1]))
    f_est = ph.mean() * ddc.output_rate / (2 * np.pi)
    assert f_est == pytest.approx(2000.0, abs=20.0)
    assert np.abs(y).mean() == pytest.approx(1.0, abs=0.1)


def test_cic_channel_rejects_distant_tone():
    fs = 2_400_000.0
    ddc = CICChannel.design(fs, frequency_offset=300e3, channel_rate=25e3)
    n = 96 * 800
    t = np.arange(n) / fs
    x = jnp.asarray(np.exp(2j * np.pi * (300e3 + 60e3) * t), jnp.complex64)
    y, _ = ddc(x)
    assert np.abs(np.asarray(y)[200:]).mean() < 0.05


def _two_bin_setup(m=8, m0=2):
    bw = 12500.0
    fs = m * bw
    ch = Channelizer.design(fs, bw, 9, channels=m)
    return ch, bw, fs, m0


def test_two_channel_synthesizer_joint_band():
    ch, bw, fs, m0 = _two_bin_setup()
    syn = TwoChannelSynthesizer(channel_sample_rate=2 * bw)
    n = ch.channels * 600
    t = np.arange(n) / fs
    for nu, want_gain in [(-0.3, 1.0), (0.0, 1.0), (0.3, 1.0), (0.5, 1.0),
                          (0.7, 1.0), (1.0, 1.0), (1.3, 1.0)]:
        f = (m0 + nu) * bw
        x = jnp.asarray(np.exp(2j * np.pi * f * t), jnp.complex64)
        y, _ = ch(x)
        z, _ = syn(y[:, m0], y[:, m0 + 1])
        seg = np.asarray(z)[300:-300]
        ph = np.angle(seg[1:] * np.conj(seg[:-1]))
        f_est = ph.mean() * 2 * bw / (2 * np.pi)
        assert f_est == pytest.approx((nu - 0.5) * bw, abs=10.0)
        assert np.abs(seg).mean() == pytest.approx(want_gain, abs=0.025)
        assert np.abs(seg).std() < 0.01  # no aliasing beat
    # non-adjacent bin rejection
    x = jnp.asarray(np.exp(2j * np.pi * (m0 + 2.0) * bw * t), jnp.complex64)
    y, _ = ch(x)
    z, _ = syn(y[:, m0], y[:, m0 + 1])
    assert np.abs(np.asarray(z)[300:-300]).mean() < 1e-3


def test_two_channel_synthesizer_streaming_equals_oneshot():
    ch, bw, fs, m0 = _two_bin_setup()
    syn = TwoChannelSynthesizer(channel_sample_rate=2 * bw)
    n = ch.channels * 400
    t = np.arange(n) / fs
    x = jnp.asarray(np.exp(2j * np.pi * (m0 + 0.4) * bw * t), jnp.complex64)
    y, _ = ch(x)
    c1, c2 = y[:, m0], y[:, m0 + 1]
    full, _ = syn(c1, c2)
    st = None
    parts = []
    quarter = c1.shape[0] // 4
    for i in range(4):
        z, st = syn(c1[i * quarter:(i + 1) * quarter],
                    c2[i * quarter:(i + 1) * quarter], st)
        parts.append(np.asarray(z))
    np.testing.assert_allclose(np.concatenate(parts), np.asarray(full),
                               atol=1e-5)


def test_synthesize_two_wrap_bin():
    # upper bin wraps to bin 0 (m0 = M-1)
    ch, bw, fs, _ = _two_bin_setup()
    m0 = ch.channels - 1
    syn = TwoChannelSynthesizer(channel_sample_rate=2 * bw)
    n = ch.channels * 600
    t = np.arange(n) / fs
    f = (m0 + 0.5) * bw  # straddles the wrap boundary
    x = jnp.asarray(np.exp(2j * np.pi * f * t), jnp.complex64)
    y, _ = ch(x)
    z, _ = syn(y[:, m0], y[:, 0])
    seg = np.asarray(z)[300:-300]
    assert np.abs(seg).mean() == pytest.approx(1.0, abs=0.02)


class TestDFTProcessor:
    """Streaming frame-rate DFT (spectrum/DFTProcessor.java role)."""

    def test_frame_cadence_and_tone_bin(self):
        from sdrtrunk_jax.dsp.dft_processor import DFTProcessor
        fs = 100_000.0
        proc = DFTProcessor(fs, fft_size=1024, frame_rate=20.0)
        # 0.5 s of a +10 kHz tone -> exactly 10 frames
        n = int(0.5 * fs)
        t = np.arange(n) / fs
        x = np.exp(2j * np.pi * 10_000.0 * t).astype(np.complex64)
        rows = proc.receive(x)
        assert rows.shape == (10, 1024)
        # DC-centered: +10 kHz -> bin 512 + 1024*10k/100k
        peak = int(np.argmax(rows[-1]))
        assert peak == 512 + round(1024 * 10_000.0 / fs)

    def test_chunked_equals_oneshot(self):
        from sdrtrunk_jax.dsp.dft_processor import DFTProcessor
        fs = 50_000.0
        rng = np.random.default_rng(0)
        x = (rng.standard_normal(25_000)
             + 1j * rng.standard_normal(25_000)).astype(np.complex64)
        one = DFTProcessor(fs, fft_size=512, frame_rate=25.0).receive(x)
        proc = DFTProcessor(fs, fft_size=512, frame_rate=25.0)
        parts = [proc.receive(x[i:i + 777]) for i in range(0, len(x), 777)]
        chunked = np.concatenate([p for p in parts if p.size])
        assert chunked.shape == one.shape
        assert np.allclose(chunked, one, atol=1e-4)

    def test_frame_rate_bounds_and_source_events(self):
        from sdrtrunk_jax.dsp.dft_processor import DFTProcessor
        import pytest as _pytest
        with _pytest.raises(ValueError):
            DFTProcessor(48_000.0, frame_rate=0.5)
        proc = DFTProcessor(48_000.0, fft_size=256, frame_rate=10.0)
        proc.set_sample_rate(96_000.0)
        proc.set_frame_rate(40.0)
        rows = proc.receive(np.zeros(96_000, np.complex64))
        assert rows.shape[0] == 40
