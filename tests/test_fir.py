"""FIR / IIR / resampler tests vs scipy oracles and streaming equivalence."""
import numpy as np
import pytest
from scipy import signal as sps

import jax.numpy as jnp

from sdrtrunk_jax.dsp import design, fir, iir


def _rand_complex(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)


def test_fir_filter_matches_scipy_real():
    x = np.random.default_rng(1).standard_normal(500).astype(np.float32)
    taps = design.kaiser_sinc(31, 0.2, 60.0).astype(np.float32)
    ours = np.asarray(fir.fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    oracle = sps.lfilter(taps, [1.0], x)
    assert np.allclose(ours, oracle, atol=1e-4)


def test_fir_filter_matches_scipy_complex():
    x = _rand_complex(400)
    taps = design.kaiser_sinc(21, 0.15, 60.0).astype(np.float32)
    ours = np.asarray(fir.fir_filter(jnp.asarray(x), jnp.asarray(taps)))
    oracle = sps.lfilter(taps, [1.0], x)
    assert np.allclose(ours, oracle, atol=1e-4)


def test_fir_streaming_equals_oneshot():
    x = _rand_complex(600, seed=3)
    taps = jnp.asarray(design.kaiser_sinc(33, 0.1, 60.0), jnp.float32)
    full = np.asarray(fir.fir_filter(jnp.asarray(x), taps))
    state = fir.fir_init(33)
    chunks = []
    for i in range(0, 600, 100):
        y, state = fir.fir_apply(jnp.asarray(x[i:i + 100]), taps, state)
        chunks.append(np.asarray(y))
    assert np.allclose(np.concatenate(chunks), full, atol=1e-5)


def test_fir_decimate_matches_slice():
    x = _rand_complex(512, seed=5)
    taps = jnp.asarray(design.kaiser_sinc(31, 0.05, 60.0), jnp.float32)
    full = np.asarray(fir.fir_filter(jnp.asarray(x), taps))[::4]
    dec, _ = fir.fir_decimate(jnp.asarray(x), taps, 4)
    assert np.allclose(np.asarray(dec), full, atol=1e-5)


def test_halfband_cascade_decimates_tone():
    # 1 kHz tone at 64 kHz -> decimate x8 -> still a clean 1 kHz tone at 8 kHz
    fs, n = 64000.0, 8192
    t = np.arange(n) / fs
    x = np.exp(2j * np.pi * 1000.0 * t).astype(np.complex64)
    stage_taps = fir.decimation_cascade_taps(8)
    y, _ = fir.decimate_by_power2(jnp.asarray(x), stage_taps)
    y = np.asarray(y)[64:]  # drop transient
    spec = np.fft.fft(y * np.hanning(len(y)))
    freqs = np.fft.fftfreq(len(y), 1 / 8000.0)
    peak = freqs[np.argmax(np.abs(spec))]
    assert abs(peak - 1000.0) < 8000.0 / len(y) * 2


def test_polyphase_resample_matches_scipy():
    x = np.random.default_rng(7).standard_normal(1000).astype(np.float32)
    up, down = 8, 25  # 25 kHz -> 8 kHz audio path
    taps = fir.resample_taps(up, down)
    ours = np.asarray(fir.polyphase_resample(jnp.asarray(x), jnp.asarray(taps, jnp.float32), up, down))
    oracle = sps.upfirdn(taps, x, up=up, down=down)[: len(ours)]
    # allow group-delay alignment differences at edges; compare interior
    assert np.allclose(ours[10:-10], oracle[10:len(ours) - 10], atol=1e-3)


def test_single_pole_iir_matches_loop():
    x = np.random.default_rng(9).standard_normal(300).astype(np.float32)
    alpha = 0.0625
    y = np.asarray(iir.single_pole(jnp.asarray(x), alpha))
    expected = np.zeros_like(x)
    acc = 0.0
    for i, xi in enumerate(x):
        acc = acc + alpha * (xi - acc)
        expected[i] = acc
    assert np.allclose(y, expected, atol=1e-4)


def test_dc_removal_kills_offset():
    x = (np.random.default_rng(11).standard_normal(4000) * 0.1 + 2.5).astype(np.float32)
    y, _ = iir.dc_removal(jnp.asarray(x), 0.95)
    assert abs(np.mean(np.asarray(y)[1000:])) < 0.02


def test_streaming_single_pole_equals_oneshot():
    x = np.random.default_rng(13).standard_normal(256).astype(np.float32)
    full = np.asarray(iir.single_pole(jnp.asarray(x), 0.01))
    state = jnp.asarray(0.0)
    outs = []
    for i in range(0, 256, 64):
        y, state = iir.single_pole_apply(jnp.asarray(x[i:i + 64]), 0.01, state)
        outs.append(np.asarray(y))
    assert np.allclose(np.concatenate(outs), full, atol=1e-5)
