"""LTR tests: word codec, framer, FSK scan demod, and closed-loop through
sub-audible FSK -> slicer -> framer."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.decoders.ltr import LTRConfig, LTRDecoder
from sdrtrunk_jax.protocol.ltr import (LTRFramer, LTRMessage, LTRMessageType,
                                       ltr_checksum, ltr_encode_word)
from sdrtrunk_jax.protocol.bits import dibits_to_bits


def test_word_roundtrip_and_types():
    w = ltr_encode_word(area=0, channel=5, home=5, group=128, free=5)
    assert len(w) == 40
    framer = LTRFramer("OSW")
    msgs = framer.process(np.concatenate([np.zeros(13, np.uint8), w,
                                          np.ones(9, np.uint8)]))
    assert len(msgs) == 1
    m = msgs[0]
    assert (m.channel, m.home, m.group, m.free) == (5, 5, 128, 5)
    assert m.message_type == LTRMessageType.CALL

    idle = ltr_encode_word(0, 7, 7, 255, 7)
    m2 = LTRFramer("OSW").process(np.concatenate([idle, np.zeros(5, np.uint8)]))
    assert m2[0].message_type == LTRMessageType.IDLE

    end = ltr_encode_word(0, 31, 9, 200, 9)
    m3 = LTRFramer("OSW").process(np.concatenate([end, np.zeros(5, np.uint8)]))
    assert m3[0].message_type == LTRMessageType.CALL_END


def test_isw_inverted():
    w = ltr_encode_word(1, 3, 4, 55, 6, direction="ISW")
    framer = LTRFramer("ISW")
    msgs = framer.process(np.concatenate([np.zeros(7, np.uint8), w]))
    assert len(msgs) == 1
    assert msgs[0].group == 55 and msgs[0].direction == "ISW"


def test_bad_checksum_rejected():
    w = ltr_encode_word(0, 5, 5, 100, 5)
    w[20] ^= 1
    msgs = LTRFramer("OSW").process(np.concatenate([w, np.zeros(5, np.uint8)]))
    assert msgs == []


def _fsk_modulate(bits: np.ndarray, fs: float = 8000.0,
                  baud: float = 300.0, amplitude: float = 0.3) -> np.ndarray:
    """Sub-audible square FSK: bit 1 -> +amp, bit 0 -> -amp (as sliced
    after the LTR low-pass, the sign carries the bit)."""
    sps = fs / baud
    n = int(np.ceil(len(bits) * sps))
    t = np.arange(n)
    sym = np.minimum((t / sps).astype(np.int64), len(bits) - 1)
    return (amplitude * (2.0 * bits[sym] - 1.0)).astype(np.float32)


def test_fsk_scan_recovers_bits():
    rng = np.random.default_rng(0)
    tx_bits = rng.integers(0, 2, 120).astype(np.uint8)
    audio = _fsk_modulate(tx_bits)
    dec = LTRDecoder(LTRConfig())
    out, _ = dec(jnp.asarray(audio), dec.init_state())
    rx = np.asarray(out["bits"])[np.asarray(out["valid"])]
    # align: find tx in rx
    best = (1.0, None)
    for lag in range(0, 12):
        n = min(len(tx_bits), len(rx) - lag)
        if n < 80:
            continue
        e = np.mean(tx_bits[:n] != rx[lag:lag + n])
        if e < best[0]:
            best = (e, lag)
    ber, lag = best
    assert ber is not None and ber < 0.02, best


def test_ltr_end_to_end():
    """LTR words -> square FSK at 8 kHz -> scan demod -> framer -> message."""
    rng = np.random.default_rng(1)
    words = [
        ltr_encode_word(0, 5, 5, 77, 5),
        ltr_encode_word(0, 5, 5, 77, 5),
        ltr_encode_word(0, 7, 7, 255, 7),
    ]
    tx_bits = np.concatenate([rng.integers(0, 2, 25).astype(np.uint8)]
                             + words + [rng.integers(0, 2, 30).astype(np.uint8)])
    audio = _fsk_modulate(tx_bits)
    dec = LTRDecoder()
    out, _ = dec(jnp.asarray(audio), dec.init_state())
    rx = np.asarray(out["bits"])[np.asarray(out["valid"])]
    msgs = LTRFramer("OSW").process(rx)
    assert len(msgs) >= 2, msgs
    calls = [m for m in msgs if m.message_type == LTRMessageType.CALL]
    idles = [m for m in msgs if m.message_type == LTRMessageType.IDLE]
    assert calls and calls[0].group == 77 and calls[0].channel == 5
    assert idles


def test_passport_word_roundtrip():
    from sdrtrunk_jax.protocol.passport import (PassportFramer,
                                                PassportMessageType,
                                                passport_encode_word)
    w = passport_encode_word(dcc=1, lcn=100, site=5, group=1234,
                             type_number=0, free=50)
    assert len(w) == 68
    msgs = PassportFramer().process(
        np.concatenate([np.zeros(11, np.uint8), w, np.ones(10, np.uint8)]))
    assert len(msgs) == 1
    m = msgs[0]
    assert (m.lcn, m.site, m.group) == (100, 5, 1234)
    assert m.message_type == PassportMessageType.CALL_START

    idle = passport_encode_word(0, 1792, 5, 0, 1, 0)
    m2 = PassportFramer().process(
        np.concatenate([idle, np.zeros(5, np.uint8)]))
    assert m2[0].message_type == PassportMessageType.IDLE
    bad = w.copy()
    bad[30] ^= 1
    assert PassportFramer().process(
        np.concatenate([bad, np.zeros(5, np.uint8)])) == []


def test_passport_end_to_end():
    from sdrtrunk_jax.protocol.passport import (PassportFramer,
                                                passport_encode_word)
    rng = np.random.default_rng(9)
    words = [passport_encode_word(0, 55, 3, 999, 0, 20)] * 2
    tx_bits = np.concatenate([rng.integers(0, 2, 21).astype(np.uint8)]
                             + words
                             + [rng.integers(0, 2, 30).astype(np.uint8)])
    audio = _fsk_modulate(tx_bits)
    dec = LTRDecoder()
    out, _ = dec(jnp.asarray(audio), dec.init_state())
    rx = np.asarray(out["bits"])[np.asarray(out["valid"])]
    msgs = PassportFramer().process(rx)
    assert len(msgs) >= 1
    assert msgs[0].group == 999 and msgs[0].lcn == 55
