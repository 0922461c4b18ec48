"""Filter design tests vs scipy oracles and the reference's design objectives."""
import numpy as np
import pytest
from scipy import signal as sps

from sdrtrunk_jax.dsp import design, windows


def test_kaiser_window_matches_scipy():
    length, atten = 129, 80.0
    beta = windows.kaiser_beta(atten)
    ours = windows.kaiser(length, atten)
    scipys = np.kaiser(length, beta)
    assert np.allclose(ours, scipys, atol=1e-9)


def test_kaiser_beta_regions():
    assert windows.kaiser_beta(80.0) == pytest.approx(0.1102 * (80.0 - 8.7))
    assert windows.kaiser_beta(30.0) == pytest.approx(
        0.5842 * 9.0 ** 0.4 + 0.07886 * 9.0)
    assert windows.kaiser_beta(10.0) == 0.0


def test_windowed_sinc_lowpass_response():
    taps = design.kaiser_sinc(201, 0.1, 80.0)
    w, h = sps.freqz(taps, worN=4096)
    f = w / np.pi / 2.0  # cycles/sample
    hdb = 20 * np.log10(np.abs(h) + 1e-12)
    # passband ~0 dB, stopband below -75 dB
    assert np.all(np.abs(hdb[f < 0.07]) < 0.1)
    assert np.all(hdb[f > 0.14] < -75.0)


def test_evaluate_db_matches_freqz():
    taps = design.kaiser_sinc(63, 0.05, 60.0)
    for freq in (0.02, 0.1, 0.3):
        w = np.pi * freq
        _, h = sps.freqz(taps, worN=[w])
        expected = 20 * np.log10(np.abs(h[0]))
        assert design.evaluate_db(taps, freq) == pytest.approx(expected, abs=1e-6)


def test_channelizer_prototype_band_edge():
    """The M/2 prototype must hit -6.02 dB at the channel band edge
    (FilterFactory.java:808 design objective)."""
    channels, tpc = 16, 9
    taps = design.sinc_m2_channelizer(12500.0, channels, tpc)
    assert len(taps) % channels == 0
    assert taps[0] == 0.0
    band_edge = 1.0 / channels
    response = design.evaluate_db(taps[1:], band_edge)
    assert response == pytest.approx(design.PERFECT_RECONSTRUCTION_GAIN_DB,
                                     abs=0.0005)


def test_channelizer_prototype_various_sizes():
    for channels in (8, 32, 128):
        taps = design.sinc_m2_channelizer(12500.0, channels, 9)
        band_edge = 1.0 / channels
        response = design.evaluate_db(taps[1:], band_edge)
        assert abs(response - design.PERFECT_RECONSTRUCTION_GAIN_DB) < 0.0005


def test_half_band_structure():
    taps = design.half_band(22)
    half = len(taps) // 2
    assert len(taps) % 2 == 1
    # Odd-offset taps exactly zero; center ~0.5 of DC gain
    for k in range(len(taps)):
        if k != half and (k - half) % 2 == 0:
            assert taps[k] == 0.0
    assert np.sum(taps) == pytest.approx(1.0)
    # Half-band symmetry point: -6 dB at quarter sample rate
    assert design.evaluate_db(taps, 0.5) == pytest.approx(-6.02, abs=0.1)


def test_remez_lowpass_p25_spec():
    """P25P1 baseband filter spec: pass 5100 / stop 6500 at 50 kHz
    (SURVEY.md section 2.7)."""
    taps = design.remez_lowpass(63, 5100.0, 6500.0, 50000.0, 0.01, 0.01)
    w, h = sps.freqz(taps, worN=8192, fs=50000.0)
    hdb = 20 * np.log10(np.abs(h) + 1e-12)
    assert np.all(np.abs(hdb[w < 4800]) < 0.5)
    assert np.all(hdb[w > 7000] < -35.0)
