"""C4FM / DQPSK symbol recovery tests: closed-loop BER vs our modulator."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.decoders.c4fm import C4FMConfig, C4FMDecoder
from sdrtrunk_jax.dsp.interpolator import interpolator_bank
from sdrtrunk_jax.dsp.psk import DQPSKDemodulator, costas_gains
from sdrtrunk_jax.signal import generators


def _align_mismatch(tx: np.ndarray, rx: np.ndarray, max_lag: int = 60):
    """Align rx to tx over lags [0, max_lag); return (mismatch array, lag).

    The decoder's pipeline delay (baseband FIR group delay + interpolator +
    demod window) is ~7 symbols at 25 kHz, so rx[lag + k] ~ tx[k].
    """
    best = (1.0, 0, None)
    for lag in range(max_lag):
        n = min(len(tx), len(rx) - lag)
        if n < 100:
            continue
        mism = tx[:n] != rx[lag:lag + n]
        err = np.mean(mism)
        if err < best[0]:
            best = (err, lag, mism)
    assert best[2] is not None, "sequences too short to align"
    return best[2], best[1]


def test_interpolator_bank_properties():
    bank = interpolator_bank()
    assert bank.shape == (129, 8)
    # mu=0 row should be ~delta at tap 3
    assert np.argmax(np.abs(bank[0])) == 3
    assert bank[0][3] == pytest.approx(1.0, abs=0.02)
    # mu=1 row ~delta at tap 4
    assert np.argmax(np.abs(bank[128])) == 4
    # interpolating a pure sine must be accurate mid-band
    t = np.arange(16)
    x = np.sin(2 * np.pi * 0.08 * t)
    for i, mu in [(32, 0.25), (64, 0.5), (96, 0.75)]:
        est = np.dot(bank[i], x[2:10])
        true = np.sin(2 * np.pi * 0.08 * (5 + mu))
        assert est == pytest.approx(true, abs=0.01)


def test_costas_gains():
    alpha, beta = costas_gains(300.0)
    bw = 2 * np.pi / 300.0
    d = np.sqrt(2) / 2
    denom = 1 + 2 * d * bw + bw * bw
    assert alpha == pytest.approx(4 * d * bw / denom)
    assert beta == pytest.approx(4 * bw * bw / denom)


def test_c4fm_clean_ber_zero():
    """Clean C4FM at 25 kHz: after sync-up, dibit decisions must be perfect."""
    fs = 25000.0
    dibits = generators.random_dibits(600, seed=1)
    iq = generators.c4fm_modulate(dibits, fs)
    dec = C4FMDecoder(C4FMConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    assert len(rx) > 550  # roughly one symbol per 5.2 samples
    mism, lag = _align_mismatch(dibits, rx)
    ber = np.mean(mism[100:500])
    assert ber == 0.0, (ber, lag)


def test_c4fm_frequency_offset_tracking():
    """PLL must absorb a 200 Hz carrier offset (within +/- baud/2 capture)."""
    fs = 25000.0
    dibits = generators.random_dibits(1200, seed=3)
    iq = generators.c4fm_modulate(dibits, fs)
    n = len(iq)
    off = np.exp(2j * np.pi * 200.0 * np.arange(n) / fs)
    dec = C4FMDecoder(C4FMConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray((iq * off).astype(np.complex64)),
                 dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    # evaluate late window after PLL settles
    mism, lag = _align_mismatch(dibits, rx)
    ber = np.mean(mism[600:1100])
    assert ber < 0.02, (ber, lag)
    # PLL should have converged near the offset: 2*pi*200/fs
    freq = float(out["pll_freq"])
    assert freq == pytest.approx(-2 * np.pi * 200.0 / fs, rel=0.3)


def test_c4fm_noisy_ber():
    """12 dB SNR C4FM: low but nonzero error rate tolerated.

    Below ~11 dB full-band SNR the decision-directed symbol clock can slip
    (same algorithm/limitation as the reference's DQPSKDecisionDirected
    chain); protocol framers re-acquire on frame syncs.
    """
    fs = 25000.0
    dibits = generators.random_dibits(1000, seed=5)
    iq = generators.awgn(generators.c4fm_modulate(dibits, fs), 12.0)
    dec = C4FMDecoder(C4FMConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    mism, _ = _align_mismatch(dibits, rx)
    ber = np.mean(mism[200:900])
    assert ber < 0.1


def test_dqpsk_streaming_equals_oneshot():
    fs = 25000.0
    dibits = generators.random_dibits(400, seed=7)
    iq = generators.c4fm_modulate(dibits, fs)
    demod = DQPSKDemodulator(fs)
    d_full, v_full, _ = demod(jnp.asarray(iq))
    state = demod.init_state()
    ds, vs = [], []
    n = len(iq) - len(iq) % 500
    for i in range(0, n, 500):
        d, v, state = demod(jnp.asarray(iq[i:i + 500]), state)
        ds.append(np.asarray(d))
        vs.append(np.asarray(v))
    assert np.array_equal(np.concatenate(ds), np.asarray(d_full)[:n])
    assert np.array_equal(np.concatenate(vs), np.asarray(v_full)[:n])
