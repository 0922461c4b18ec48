"""P25 Phase 1 protocol tests: codecs, framer, and full closed-loop decode
through the C4FM modem (modulate dibits -> demodulate -> frame -> messages).
"""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.protocol import bits as B
from sdrtrunk_jax.protocol.p25p1 import DUID, NID, P25P1Framer, \
    P25P1FrameAssembler
from sdrtrunk_jax.protocol.p25p1.framer import payload_dibit_positions
from sdrtrunk_jax.protocol.p25p1.hdu import (hdu_decode, hdu_encode,
                                             tdulc_decode, tdulc_encode)
from sdrtrunk_jax.protocol.p25p1.lc import lc_build_group_voice, lc_parse
from sdrtrunk_jax.protocol.p25p1.ldu import (ldu1_decode, ldu1_encode,
                                             ldu2_decode, ldu2_encode)
from sdrtrunk_jax.protocol.p25p1.messages import decode_frame
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_decode, tsbk_encode


def test_nid_roundtrip():
    bits = NID.encode(0x293, DUID.TSBK)
    assert len(bits) == 64
    nid = NID.decode(bits)
    assert nid.nac == 0x293 and nid.duid == DUID.TSBK
    bad = bits.copy().astype(np.int64)
    bad[[0, 5, 20, 40, 60]] ^= 1
    nid = NID.decode(bad)
    assert nid is not None and nid.nac == 0x293 and nid.corrected == 5


def test_tsbk_roundtrip():
    args = B.from_int(0x00FF00FF00FF00FF, 64)
    wire = tsbk_encode(0x00, args, last_block=True)
    assert len(wire) == 196
    t = tsbk_decode(wire)
    assert t is not None
    assert t.opcode == 0x00 and t.last_block
    assert t.fields["group_address"] == 0xFF00
    assert t.fields["source_address"] == 0xFF00FF
    # bit errors within viterbi reach
    bad = wire.copy()
    bad[[7, 90, 150]] ^= 1
    t2 = tsbk_decode(bad)
    assert t2 is not None and np.array_equal(t2.args, t.args)
    # garbage rejected by CRC
    rng = np.random.default_rng(0)
    assert tsbk_decode(rng.integers(0, 2, 196).astype(np.uint8)) is None


def test_ldu1_roundtrip():
    rng = np.random.default_rng(1)
    lc = lc_build_group_voice(group=0x1234, source=0xABCDE)
    voice = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    payload = ldu1_encode(lc, voice)
    assert len(payload) == 1568
    dec = ldu1_decode(payload)
    assert dec.link_control is not None
    assert dec.link_control.fields["group_address"] == 0x1234
    assert dec.link_control.fields["source_address"] == 0xABCDE
    assert np.array_equal(dec.voice_frames, voice)
    # corrupt some LC bits: hamming + RS recover
    bad = payload.copy()
    bad[[290, 475, 660, 845]] ^= 1
    dec2 = ldu1_decode(bad)
    assert dec2.link_control is not None
    assert dec2.link_control.fields["group_address"] == 0x1234


def test_ldu2_roundtrip():
    rng = np.random.default_rng(2)
    mi = rng.integers(0, 2, 72).astype(np.uint8)
    voice = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    payload = ldu2_encode(mi, 0xAA, 0x1234, voice)
    dec = ldu2_decode(payload)
    assert dec.algorithm_id == 0xAA and dec.key_id == 0x1234
    assert np.array_equal(dec.message_indicator, mi)
    assert dec.encrypted


def test_hdu_roundtrip():
    rng = np.random.default_rng(3)
    mi = rng.integers(0, 2, 72).astype(np.uint8)
    payload = hdu_encode(mi, mfid=0, algorithm_id=0x80, key_id=0,
                         talkgroup=0x4567)
    assert len(payload) == 658
    h = hdu_decode(payload)
    assert h is not None and h.talkgroup == 0x4567 and not h.encrypted
    bad = payload.copy()
    bad[rng.choice(648, 8, replace=False)] ^= 1
    h2 = hdu_decode(bad)
    assert h2 is not None and h2.talkgroup == 0x4567


def test_tdulc_roundtrip():
    lc = lc_build_group_voice(group=7, source=99)
    payload = tdulc_encode(lc)
    assert len(payload) == 308
    parsed = tdulc_decode(payload)
    assert parsed is not None and parsed.fields["group_address"] == 7


def test_status_positions():
    pos = payload_dibit_positions(98)  # TSBK payload dibits
    # first status after frame start dibit 35 already consumed in header;
    # next at transmitted dibit 71 -> payload skips it
    assert 71 not in pos and 107 not in pos
    assert pos[0] == 57
    diffs = np.diff(pos)
    assert set(diffs.tolist()) <= {1, 2}


def test_framer_dibit_roundtrip():
    """Assemble frames -> dibit stream -> framer recovers all messages."""
    asm = P25P1FrameAssembler(nac=0x293)
    rng = np.random.default_rng(4)
    tsbk_wire = tsbk_encode(0x3B, rng.integers(0, 2, 64).astype(np.uint8))
    lc = lc_build_group_voice(0x111, 0x22222)
    voice = rng.integers(0, 2, (9, 144)).astype(np.uint8)
    ldu_payload = ldu1_encode(lc, voice)
    stream = np.concatenate([
        rng.integers(0, 4, 40).astype(np.uint8),      # leading noise
        asm.assemble(DUID.TSBK, tsbk_wire),
        rng.integers(0, 4, 23).astype(np.uint8),
        asm.assemble(DUID.LDU1, ldu_payload),
        rng.integers(0, 4, 60).astype(np.uint8),
    ])
    framer = P25P1Framer()
    frames = framer.process(stream)
    assert len(frames) == 2, [f.duid for f in frames]
    assert frames[0].duid == DUID.TSBK and frames[0].nac == 0x293
    assert frames[1].duid == DUID.LDU1
    msgs = [decode_frame(f) for f in frames]
    assert msgs[0].valid and msgs[0].content.opcode == 0x3B
    assert msgs[1].valid
    assert msgs[1].content.link_control.fields["group_address"] == 0x111


def test_framer_streaming_chunks():
    """Chunked feeding must produce the same frames as one-shot."""
    asm = P25P1FrameAssembler(nac=0x1AB)
    rng = np.random.default_rng(5)
    parts = [rng.integers(0, 4, 31).astype(np.uint8)]
    for i in range(4):
        parts.append(asm.assemble(
            DUID.TSBK, tsbk_encode(0x3D, rng.integers(0, 2, 64))))
        parts.append(rng.integers(0, 4, 17).astype(np.uint8))
    stream = np.concatenate(parts)
    one = P25P1Framer().process(stream)
    chunked = P25P1Framer()
    frames = []
    for i in range(0, len(stream), 97):
        frames.extend(chunked.process(stream[i:i + 97]))
    assert len(one) == 4 and len(frames) == 4
    for a, b in zip(one, frames):
        assert a.start == b.start and a.nac == b.nac
        assert np.array_equal(a.payload, b.payload)


def test_framer_rotation_recovery():
    """A 180-degree PLL slip must still decode via the rotated sync image."""
    asm = P25P1FrameAssembler(nac=0x293)
    rng = np.random.default_rng(6)
    wire = tsbk_encode(0x00, rng.integers(0, 2, 64))
    dibits = asm.assemble(DUID.TSBK, wire)
    flipped = np.array([3, 2, 1, 0], np.uint8)[dibits]
    stream = np.concatenate([rng.integers(0, 4, 25).astype(np.uint8),
                             flipped])
    frames = P25P1Framer().process(stream)
    assert len(frames) == 1
    assert frames[0].rotation == "error_180"
    assert frames[0].nac == 0x293
    assert decode_frame(frames[0]).valid


def test_p25_c4fm_end_to_end():
    """Full stack: TSBK -> frame -> C4FM modulate -> demod -> frame -> parse."""
    import jax
    from sdrtrunk_jax.decoders.c4fm import C4FMConfig, C4FMDecoder
    from sdrtrunk_jax.signal import generators

    asm = P25P1FrameAssembler(nac=0x293)
    rng = np.random.default_rng(7)
    messages = []
    parts = [rng.integers(0, 4, 50).astype(np.uint8)]
    for opcode in (0x3B, 0x3A, 0x00):
        args = rng.integers(0, 2, 64).astype(np.uint8)
        messages.append((opcode, args))
        parts.append(asm.assemble(DUID.TSBK, tsbk_encode(opcode, args)))
        parts.append(rng.integers(0, 4, 30).astype(np.uint8))
    parts.append(np.zeros(60, np.uint8))
    tx_dibits = np.concatenate(parts)

    fs = 25000.0
    iq = generators.c4fm_modulate(tx_dibits, fs)
    dec = C4FMDecoder(C4FMConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx_dibits = np.asarray(out["dibits"])[np.asarray(out["valid"])]

    framer = P25P1Framer()
    frames = framer.process(rx_dibits)
    assert len(frames) == 3, [f.duid for f in frames]
    for (opcode, args), frame in zip(messages, frames):
        msg = decode_frame(frame)
        assert msg.valid and msg.nac == 0x293
        assert msg.content.opcode == opcode
        assert np.array_equal(msg.content.args, args)


def test_motorola_lc_patch_group_words():
    """Motorola vendor LC words (lc/motorola/*.java): MFID 0x90 selects
    the vendor layouts, including the patch-group voice channel user
    whose patch group doubles as the call's group address."""
    import numpy as np

    from sdrtrunk_jax.protocol.bits import from_int
    from sdrtrunk_jax.protocol.p25p1.lc import MFID_MOTOROLA, lc_parse

    b = np.zeros(72, np.uint8)
    b[2:8] = from_int(0x00, 6)            # opcode 0: patch group user
    b[8:16] = from_int(MFID_MOTOROLA, 8)
    b[16:24] = from_int(0x20, 8)          # service options
    b[32:48] = from_int(0x1234, 16)       # patch group
    b[48:72] = from_int(0xABCDE, 24)      # source
    lc = lc_parse(b)
    assert lc.mfid == MFID_MOTOROLA
    assert lc.opcode_name == "MOTOROLA_PATCH_GROUP_VOICE_CHANNEL_USER"
    assert lc.fields["group_address"] == 0x1234
    assert lc.fields["patch_group"] == 0x1234
    assert lc.fields["source_address"] == 0xABCDE

    b2 = np.zeros(72, np.uint8)
    b2[2:8] = from_int(0x03, 6)           # patch group add
    b2[8:16] = from_int(MFID_MOTOROLA, 8)
    b2[16:32] = from_int(0x0A0B, 16)
    b2[32:48] = from_int(0x0C0D, 16)
    lc2 = lc_parse(b2)
    assert lc2.opcode_name == "MOTOROLA_PATCH_GROUP_ADD"
    assert lc2.fields["patch_group"] == 0x0A0B
    assert lc2.fields["patched_group_1"] == 0x0C0D

    b3 = np.zeros(72, np.uint8)
    b3[2:8] = from_int(0x0F, 6)           # talk complete
    b3[8:16] = from_int(MFID_MOTOROLA, 8)
    b3[48:72] = from_int(0x555, 24)
    lc3 = lc_parse(b3)
    assert lc3.opcode_name == "MOTOROLA_TALK_COMPLETE"
    assert lc3.fields["address"] == 0x555
