"""Auxiliary decoder tests: generic framer, syndrome codes, Fleetsync II,
MDC-1200, LJ-1200, Tait 1200, and the closed audio loop via AFSK1200."""
import numpy as np

from sdrtrunk_jax.decoders.auxdec import AuxDecoder
from sdrtrunk_jax.protocol import bits as B
from sdrtrunk_jax.protocol.auxdec import fleetsync2 as fs2
from sdrtrunk_jax.protocol.auxdec import lj1200 as lj
from sdrtrunk_jax.protocol.auxdec import mdc1200 as mdc
from sdrtrunk_jax.protocol.auxdec import tait1200 as tait
from sdrtrunk_jax.protocol.edac.syndrome import SyndromeCode, xpow_mod
from sdrtrunk_jax.protocol.framer import MessageFramer
from sdrtrunk_jax.signal.generators import afsk1200_modulate


# ---------------------------------------------------------------- framer

def test_framer_finds_messages_and_streams_identically():
    rng = np.random.default_rng(7)
    sync = B.to_bits("10110001")
    msg_len = 40
    body = rng.integers(0, 2, msg_len - len(sync)).astype(np.uint8)
    m1 = np.concatenate([sync, body])
    m2 = np.concatenate([sync, 1 - body])
    stream = np.concatenate([
        rng.integers(0, 2, 13).astype(np.uint8), m1,
        rng.integers(0, 2, 5).astype(np.uint8), m2,
        rng.integers(0, 2, 3).astype(np.uint8),
    ])
    # guard: filler must not contain the sync by accident
    oneshot = MessageFramer(sync, msg_len).process(stream)
    assert any(np.array_equal(m, m1) for m in oneshot)
    assert any(np.array_equal(m, m2) for m in oneshot)
    # chunked streaming (awkward 7-bit chunks) must match one-shot
    framer = MessageFramer(sync, msg_len)
    chunked = []
    for i in range(0, len(stream), 7):
        chunked += framer.process(stream[i:i + 7])
    assert len(chunked) == len(oneshot)
    for a, b in zip(chunked, oneshot):
        assert np.array_equal(a, b)


def test_framer_bit_error_tolerance():
    sync = B.to_bits("1111000011110000")
    msg = np.concatenate([sync, np.ones(24, np.uint8)])
    corrupt = msg.copy()
    corrupt[3] ^= 1
    assert MessageFramer(sync, 40, max_bit_errors=0).process(corrupt) == []
    hits = MessageFramer(sync, 40, max_bit_errors=1).process(corrupt)
    assert len(hits) == 1


# ---------------------------------------------------------- syndrome code

def test_xpow_mod_doubling_identity():
    # s[p+1] = (s[p] << 1) mod g — the identity used to verify the
    # reference's hand-written tables (edac/CRCFleetsync.java:37)
    g, w = 0xE815, 15
    for p in range(1, 60):
        lo = xpow_mod(p - 1, g, w)
        hi = (lo << 1)
        if hi & (1 << w):
            hi ^= g
        assert xpow_mod(p, g, w) == hi


def test_syndrome_code_corrects_every_position():
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2, 48).astype(np.uint8)
    word = fs2.fleetsync_code.encode(data)
    assert fs2.fleetsync_code.check(word).passed
    for pos in range(len(word)):
        bad = word.copy()
        bad[pos] ^= 1
        res = fs2.fleetsync_code.check(bad)
        assert res.passed and res.corrected and res.error_position == pos
        assert np.array_equal(res.bits, word)


def test_syndrome_code_rejects_double_errors():
    data = np.ones(48, np.uint8)
    word = fs2.fleetsync_code.encode(data)
    bad = word.copy()
    bad[[2, 40]] ^= 1
    assert not fs2.fleetsync_code.check(bad).passed


# ------------------------------------------------------------- fleetsync

def _fleetsync_block1(fleet=100, ident1=1234, ident2=2345,
                      status_flag=True) -> np.ndarray:
    d = np.ones(48, np.uint8)          # flags are inverted: 1 = clear
    if status_flag:
        d[fs2._FLAG_STATUS - fs2.HEADER] = 0
    d[16:24] = B.from_int(fleet, 8)
    d[24:36] = B.from_int(ident1, 12)
    d[36:48] = B.from_int(ident2, 12)
    return d


def _fleetsync_message(block1_word: np.ndarray) -> np.ndarray:
    header = np.concatenate([B.to_bits("01010"), fs2.FLEETSYNC2_SYNC[5:]])
    assert np.array_equal(header, fs2.FLEETSYNC2_SYNC)
    tail = np.zeros(fs2.MESSAGE_LENGTH - fs2.HEADER - fs2.BLOCK, np.uint8)
    return np.concatenate([header, block1_word, tail])


def test_fleetsync_block_roundtrip_and_correction():
    data = _fleetsync_block1()
    word = fs2.encode_block(data)
    assert len(word) == 64 and int(word.sum()) % 2 == 0
    ok, fixed, n = fs2.check_block(word)
    assert ok and n == 0 and np.array_equal(fixed, word)
    # single data-bit error: odd parity + CRC correction
    bad = word.copy()
    bad[10] ^= 1
    ok, fixed, n = fs2.check_block(bad)
    assert ok and n == 1 and np.array_equal(fixed, word)
    # parity-bit error: CRC clean, flip parity back
    bad = word.copy()
    bad[63] ^= 1
    ok, fixed, n = fs2.check_block(bad)
    assert ok and n == 1 and np.array_equal(fixed, word)
    # double error rejected
    bad = word.copy()
    bad[[10, 20]] ^= 1
    ok, _, _ = fs2.check_block(bad)
    assert not ok


def test_fleetsync_parse_status():
    msg = _fleetsync_message(fs2.encode_block(_fleetsync_block1()))
    parsed = fs2.parse(msg)
    assert parsed.valid
    assert parsed.message_type is fs2.FleetsyncMessageType.STATUS
    assert parsed.fleet_from == 100
    assert parsed.ident_from == 1234
    assert parsed.ident_to == 2345
    assert parsed.from_id == ((100 + 99) << 12) + 1234 + 999


def test_fleetsync_framer_stream():
    msg = _fleetsync_message(fs2.encode_block(_fleetsync_block1(fleet=7)))
    stream = np.concatenate([np.zeros(31, np.uint8), msg,
                             np.zeros(11, np.uint8)])
    out = fs2.Fleetsync2Framer().process(stream)
    assert len(out) == 1 and out[0].fleet_from == 7 and out[0].valid


# --------------------------------------------------------------- mdc1200

def test_nrz_roundtrip():
    rng = np.random.default_rng(5)
    d = rng.integers(0, 2, 200).astype(np.uint8)
    for inv in (True, False):
        raw = mdc.nrz_encode(d, previous=0, inverted=inv)
        back, carry = mdc.nrz_decode(raw, previous=0, inverted=inv)
        assert np.array_equal(back, d)
        # chunked decode with carried state matches
        b1, c = mdc.nrz_decode(raw[:77], 0, inv)
        b2, _ = mdc.nrz_decode(raw[77:], c, inv)
        assert np.array_equal(np.concatenate([b1, b2]), d)


def _mdc_decoded_message(unit=0x1234) -> np.ndarray:
    m = np.zeros(mdc.MESSAGE_LENGTH, np.uint8)
    m[:40] = mdc.MDC1200_SYNC
    m[40] = 1                                    # opcode bit0 -> ANI
    # unit id: digit-swapped BCD — write the exact index groups the
    # parser reads (MDCMessage.java:27)
    digits = [(unit >> 12) & 0xF, (unit >> 8) & 0xF,
              (unit >> 4) & 0xF, unit & 0xF]
    for value, idx in zip(digits, ([63, 62, 61, 60], [59, 58, 57, 56],
                                   [71, 70, 69, 68], [67, 66, 65, 64])):
        for k, i in enumerate(idx):
            m[i] = (value >> (3 - k)) & 1
    return m


def test_mdc_framer_symbol_level():
    decoded = np.concatenate([np.zeros(23, np.uint8),
                              _mdc_decoded_message(0x2BAD),
                              np.zeros(9, np.uint8)])
    raw = mdc.nrz_encode(decoded, previous=0, inverted=True)
    out = mdc.MDCFramer().process(raw)
    assert len(out) == 1
    assert out[0].unit_id == 0x2BAD
    assert out[0].message_type is mdc.MDCMessageType.ANI


# ---------------------------------------------------------------- lj1200

def test_lj1200_roundtrip_and_correction():
    word = lj.encode_word(function=0xA, address=0x123ABCD)
    assert len(word) == 80
    out = lj.LJ1200Framer().process(
        np.concatenate([np.zeros(17, np.uint8), word]))
    assert len(out) == 1
    m = out[0]
    assert m.valid and not m.transponder
    assert m.function == 0xA and m.address == 0x123ABCD
    # transponder sync variant
    word_x = lj.encode_word(3, 42, transponder=True)
    out = lj.LJ1200Framer().process(word_x)
    assert len(out) == 1 and out[0].transponder and out[0].address == 42
    # single-bit error in the protected region corrected
    bad = word.copy()
    bad[40] ^= 1
    out = lj.LJ1200Framer().process(bad)
    assert len(out) == 1 and out[0].valid and out[0].corrected_bits == 1
    assert out[0].address == 0x123ABCD


# -------------------------------------------------------------- tait1200

def _tait_ani_message(from_s="TRUCK12 ", to_s="BASE01  ") -> np.ndarray:
    m = np.zeros(tait.MESSAGE_LENGTH, np.uint8)
    m[:20] = tait.TAIT_SELCAL_SYNC
    for i, ch in enumerate(from_s):
        m[36 + 8 * i:44 + 8 * i] = B.from_int(ord(ch), 8)
    for i, ch in enumerate(to_s):
        m[204 + 8 * i:212 + 8 * i] = B.from_int(ord(ch), 8)
    return m


def test_tait_ani_parse():
    stream = np.concatenate([np.ones(9, np.uint8), _tait_ani_message()])
    out = tait.Tait1200Framer().process(stream)
    assert len(out) == 1
    assert isinstance(out[0], tait.Tait1200ANIMessage)
    assert out[0].from_id == "TRUCK12"
    assert out[0].to_id == "BASE01"


def test_tait_gps_latitude():
    m = np.zeros(tait.MESSAGE_LENGTH, np.uint8)
    m[:20] = tait.TAIT_GPS_SYNC
    m[320:324] = B.from_int(3, 4)     # degrees tens
    m[324:328] = B.from_int(7, 4)     # degrees units
    m[329:332] = B.from_int(2, 3)     # minutes tens
    m[332:336] = B.from_int(5, 4)     # minutes units
    m[336:340] = B.from_int(1, 4)     # seconds tens
    out = tait.Tait1200Framer().process(m)
    assert len(out) == 1
    assert isinstance(out[0], tait.Tait1200GPSMessage)
    assert abs(out[0].latitude - (37 + 25 / 60.0 + 10 / 3600.0)) < 1e-6


# -------------------------------------------------------- audio closed loop

def _pad10(audio: np.ndarray) -> np.ndarray:
    extra = (-len(audio)) % 10
    return np.concatenate([audio, np.zeros(extra, np.float32)])


def test_auxdecoder_lj1200_over_audio():
    word = lj.encode_word(function=0x5, address=0x0ABCDEF)
    bits = np.concatenate([
        np.tile(np.array([1, 0], np.uint8), 20),      # preamble
        word, np.zeros(24, np.uint8)])
    audio = _pad10(afsk1200_modulate(bits))
    dec = AuxDecoder("lj1200")
    msgs = dec.process(audio)
    assert any(m.valid and m.address == 0x0ABCDEF for m in msgs)


def test_auxdecoder_fleetsync_over_audio():
    msg = _fleetsync_message(
        fs2.encode_block(_fleetsync_block1(fleet=55, ident1=321)))
    bits = np.concatenate([
        np.tile(np.array([1, 0], np.uint8), 16),
        msg, np.zeros(30, np.uint8)])
    audio = _pad10(afsk1200_modulate(bits))
    # split across blocks to exercise carried demod/framer state
    dec = AuxDecoder("fleetsync2")
    cut = (len(audio) // 20) * 10
    msgs = dec.process(audio[:cut]) + dec.process(audio[cut:])
    assert any(m.valid and m.fleet_from == 55 and m.ident_from == 321
               for m in msgs)


def test_auxdecoder_mdc1200_over_audio():
    decoded = np.concatenate([
        np.zeros(16, np.uint8), _mdc_decoded_message(0x0042),
        np.zeros(8, np.uint8)])
    raw = mdc.nrz_encode(decoded, previous=0, inverted=True)
    # the inverted demod outputs 1 - (tone==mark); lead-in of raw-0
    # symbols (mark tone) keeps the NRZ running parity at zero
    lead = np.zeros(24, np.uint8)
    symbols = np.concatenate([lead, raw])
    audio = _pad10(afsk1200_modulate(1 - symbols))
    msgs = AuxDecoder("mdc1200").process(audio)
    assert any(m.unit_id == 0x0042 for m in msgs)


def test_aux_wired_into_nbfm_channel_processor():
    """AuxDecodeConfig wiring (DecoderFactory.java:398-425 aux module
    list): an NBFM channel with aux=['fleetsync2'] decodes Fleetsync
    bursts riding its demodulated audio into PAGE decode events."""
    from sdrtrunk_jax.runtime.processors import NBFMChannelProcessor

    msg = _fleetsync_message(
        fs2.encode_block(_fleetsync_block1(fleet=12, ident1=456)))
    bits = np.concatenate([
        np.tile(np.array([1, 0], np.uint8), 16),
        msg, np.zeros(30, np.uint8)])
    audio = _pad10(afsk1200_modulate(bits))
    proc = NBFMChannelProcessor(aux=["fleetsync2"])
    gate = np.ones(len(audio), bool)
    n = proc.process_audio(audio, gate, now=1.0)
    assert n >= 1
    protos = {p for p, _ in proc.aux_messages}
    assert "fleetsync2" in protos
    events = proc.history.events
    assert events and events[-1].protocol == "FLEETSYNC2"
    roles = {i.role.value for e in events
             for i in e.identifiers.all()}
    assert "FROM" in roles and "TO" in roles
    # the combined fleet+ident display id carries the encoded ident
    assert any("456" in str(i.value) for e in events
               for i in e.identifiers.all())
