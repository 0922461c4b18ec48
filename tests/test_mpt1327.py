"""MPT1327 + AFSK1200 tests: codeword codec, framer, correlation demod,
and closed-loop through audio-band FSK."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.dsp.afsk import AFSK1200Demodulator
from sdrtrunk_jax.protocol import bits as B
from sdrtrunk_jax.protocol.mpt1327 import (MPT1327Framer, MPT1327MessageType,
                                           SYNC_CONTROL, mpt_checksum,
                                           mpt_decode_codeword,
                                           mpt_encode_codeword)


def _gtc_data(prefix=10, ident1=1000, channel=50, ident2=2000):
    d = np.zeros(48, np.uint8)
    d[0] = 1  # address word
    d[1:8] = B.from_int(prefix, 7)
    d[8:21] = B.from_int(ident1, 13)
    d[21:31] = B.from_int(channel, 10)   # < 256 type region -> GTC
    d[35:48] = B.from_int(ident2, 13)
    return d


def _alh_data(prefix=3, ident1=88):
    d = np.zeros(48, np.uint8)
    d[0] = 1
    d[1:8] = B.from_int(prefix, 7)
    d[8:21] = B.from_int(ident1, 13)
    d[21:30] = B.from_int(256, 9)        # ALH
    d[44:48] = B.from_int(5, 4)
    return d


def test_codeword_roundtrip():
    d = _gtc_data()
    w = mpt_encode_codeword(d)
    assert len(w) == 64 and int(w.sum()) % 2 == 0
    back = mpt_decode_codeword(w)
    assert np.array_equal(back, d)
    bad = w.copy()
    bad[5] ^= 1
    assert mpt_decode_codeword(bad) is None  # parity fails
    bad2 = w.copy()
    bad2[[5, 20]] ^= 1                       # parity ok, checksum fails
    assert mpt_decode_codeword(bad2) is None


def test_framer_and_types():
    stream = np.concatenate([
        np.random.default_rng(0).integers(0, 2, 17).astype(np.uint8),
        SYNC_CONTROL, mpt_encode_codeword(_gtc_data()),
        SYNC_CONTROL, mpt_encode_codeword(_alh_data()),
        np.zeros(9, np.uint8),
    ])
    msgs = MPT1327Framer("control").process(stream)
    assert len(msgs) == 2
    assert msgs[0].message_type == MPT1327MessageType.GTC
    assert msgs[0].fields["channel"] == 50
    assert msgs[0].fields["ident1"] == 1000
    assert msgs[1].message_type == MPT1327MessageType.ALH
    assert msgs[1].fields["ident1"] == 88


def _afsk_modulate(bits: np.ndarray, fs: float = 8000.0,
                   baud: float = 1200.0) -> np.ndarray:
    """Audio FSK: 1 -> 1200 Hz (mark), 0 -> 1800 Hz (space),
    phase-continuous."""
    sps = fs / baud
    n = int(np.ceil(len(bits) * sps))
    t = np.arange(n)
    sym = np.minimum((t / sps).astype(np.int64), len(bits) - 1)
    freq = np.where(bits[sym] == 1, 1200.0, 1800.0)
    phase = 2 * np.pi * np.cumsum(freq) / fs
    return (0.5 * np.sin(phase)).astype(np.float32)


def test_afsk_demod_recovers_bits():
    rng = np.random.default_rng(1)
    tx = rng.integers(0, 2, 300).astype(np.uint8)
    audio = _afsk_modulate(tx)
    audio = audio[: (len(audio) // 10) * 10]
    demod = AFSK1200Demodulator()
    bits, valid, _ = demod(jnp.asarray(audio))
    rx = np.asarray(bits)[np.asarray(valid)]
    best = (1.0, None)
    for lag in range(8):
        n = min(len(tx), len(rx) - lag)
        if n < 200:
            continue
        e = np.mean(tx[:n] != rx[lag:lag + n])
        if e < best[0]:
            best = (e, lag)
    assert best[0] < 0.02, best


def test_mpt1327_end_to_end():
    """GTC message -> AFSK audio -> demod -> framer -> parsed fields."""
    rng = np.random.default_rng(2)
    frame = np.concatenate([
        np.array([1, 0] * 8, np.uint8),          # bit-reversal preamble
        SYNC_CONTROL, mpt_encode_codeword(_gtc_data(channel=77)),
        SYNC_CONTROL, mpt_encode_codeword(_gtc_data(channel=77)),
        np.zeros(20, np.uint8),
    ])
    audio = _afsk_modulate(frame)
    audio = audio[: (len(audio) // 10) * 10]
    demod = AFSK1200Demodulator()
    bits, valid, _ = demod(jnp.asarray(audio))
    rx = np.asarray(bits)[np.asarray(valid)]
    msgs = MPT1327Framer("control").process(rx)
    assert len(msgs) >= 1, len(msgs)
    assert msgs[0].message_type == MPT1327MessageType.GTC
    assert msgs[0].fields["channel"] == 77
