"""DMR protocol tests: burst substructures, LC/CSBK codecs, framer, and
closed-loop decode through the 4FSK modem."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.protocol.dmr.burst import CACH, EMB, SlotType
from sdrtrunk_jax.protocol.dmr.csbk import csbk_decode, csbk_encode
from sdrtrunk_jax.protocol.dmr.framer import (VOICE_FRAME_ORDER, DataType,
                                              DMRBurstAssembler, DMRFramer)
from sdrtrunk_jax.protocol.dmr.lc import (MASK_TERMINATOR, MASK_VOICE_HEADER,
                                          embedded_lc_decode,
                                          embedded_lc_encode,
                                          full_lc_decode, full_lc_encode,
                                          lc_build_group_voice)
from sdrtrunk_jax.protocol.dmr.sync import DMRSyncPattern
from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_encode


def test_cach_roundtrip():
    raw = CACH.encode(busy=True, timeslot=2, lcss=3)
    c = CACH.decode(raw)
    assert c.valid and c.busy and c.timeslot == 2 and c.lcss == 3


def test_slot_type_roundtrip():
    st_bits = SlotType.encode(color_code=7, data_type=DataType.CSBK)
    assert len(st_bits) == 20
    st = SlotType.decode(st_bits)
    assert st.valid and st.color_code == 7 and st.data_type == DataType.CSBK
    bad = st_bits.copy()
    bad[[3, 15]] ^= 1
    st2 = SlotType.decode(bad)
    assert st2.valid and st2.color_code == 7


def test_emb_roundtrip():
    emb_bits = EMB.encode(color_code=5, pi=False, lcss=1)
    assert len(emb_bits) == 16
    e = EMB.decode(emb_bits)
    assert e.valid and e.color_code == 5 and e.lcss == 1


def test_full_lc_roundtrip():
    lc = lc_build_group_voice(group=0x1234, source=0x56789)
    for mask in (MASK_VOICE_HEADER, MASK_TERMINATOR):
        w = full_lc_encode(lc, mask)
        assert len(w) == 96
        dec = full_lc_decode(w, mask)
        assert dec is not None
        assert dec.fields["group_address"] == 0x1234
        assert dec.fields["source_address"] == 0x56789
        # single-octet error corrected (t=1)
        bad = w.copy()
        bad[10:14] ^= 1
        dec2 = full_lc_decode(bad, mask)
        assert dec2 is not None and dec2.fields["group_address"] == 0x1234
        # wrong mask -> rejected
        assert full_lc_decode(w, mask ^ 0xFF) is None


def test_embedded_lc_roundtrip():
    lc = lc_build_group_voice(group=42, source=10203)
    frags = embedded_lc_encode(lc)
    assert frags.shape == (4, 32)
    dec = embedded_lc_decode(frags)
    assert dec is not None and dec.fields["group_address"] == 42
    bad = frags.copy().reshape(-1)
    bad[17] ^= 1
    dec2 = embedded_lc_decode(bad.reshape(4, 32))
    assert dec2 is not None and dec2.fields["group_address"] == 42


def test_csbk_roundtrip():
    rng = np.random.default_rng(0)
    data = rng.integers(0, 2, 64).astype(np.uint8)
    wire = csbk_encode(0x3D, data)
    assert len(wire) == 196
    c = csbk_decode(wire)
    assert c is not None and c.opcode == 0x3D
    assert np.array_equal(c.data, data)
    bad = wire.copy()
    bad[rng.choice(196, 3, replace=False)] ^= 1
    c2 = csbk_decode(bad)
    assert c2 is not None and np.array_equal(c2.data, data)
    assert csbk_decode(rng.integers(0, 2, 196).astype(np.uint8)) is None


def test_framer_data_bursts():
    asm = DMRBurstAssembler(color_code=3)
    rng = np.random.default_rng(1)
    csbk_wire = csbk_encode(0x19, rng.integers(0, 2, 64))
    lc = lc_build_group_voice(group=9, source=77)
    from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_encode
    vh_wire = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
    bursts = [
        asm.data_burst(DMRSyncPattern.BASE_STATION_DATA, DataType.CSBK,
                       csbk_wire, timeslot=1),
        asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                       DataType.VOICE_HEADER, vh_wire, timeslot=2),
    ]
    dibits = np.concatenate([
        rng.integers(0, 4, 37).astype(np.uint8),
        DMRBurstAssembler.to_dibits(bursts),
        rng.integers(0, 4, 25).astype(np.uint8),
    ])
    frames = DMRFramer().process(dibits)
    assert len(frames) == 2
    assert frames[0].content_kind == "csbk"
    assert frames[0].content.opcode == 0x19
    assert frames[0].slot_type.color_code == 3
    assert frames[0].timeslot == 1
    assert frames[1].content_kind == "voice_header"
    assert frames[1].content.fields["group_address"] == 9
    assert frames[1].timeslot == 2


def test_framer_voice_superframe():
    asm = DMRBurstAssembler(color_code=1)
    rng = np.random.default_rng(2)
    ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
    lc = lc_build_group_voice(group=0x222, source=0x333)
    frags = embedded_lc_encode(lc)
    from sdrtrunk_jax.protocol.dmr.framer import VOICE_FRAME_ORDER
    bursts = [asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE, ambe)]
    lcss = [1, 3, 3, 2]  # first, cont, cont, last
    for i, vf in enumerate(VOICE_FRAME_ORDER[:4]):
        bursts.append(asm.voice_burst(vf, ambe, emb_lcss=lcss[i],
                                      lc_fragment=frags[i]))
    bursts.append(asm.voice_burst(VOICE_FRAME_ORDER[4], ambe, emb_lcss=0))
    dibits = np.concatenate([
        rng.integers(0, 4, 41).astype(np.uint8),
        DMRBurstAssembler.to_dibits(bursts),
        rng.integers(0, 4, 10).astype(np.uint8),
    ])
    frames = DMRFramer().process(dibits)
    assert len(frames) == 6, [f.pattern for f in frames]
    assert frames[0].pattern == DMRSyncPattern.BASE_STATION_VOICE
    assert all(f.content_kind == "voice" for f in frames)
    assert np.array_equal(frames[0].content["ambe_frames"], ambe)
    # reassemble embedded LC from frames B..E
    collected = np.stack([f.embedded_lc_fragment() for f in frames[1:5]])
    dec = embedded_lc_decode(collected)
    assert dec is not None and dec.fields["group_address"] == 0x222


def test_dmr_4fsk_end_to_end():
    """CSBK -> burst -> 4FSK modulate -> DMR demod -> framer -> parse."""
    import jax
    from sdrtrunk_jax.decoders.dmr import DMRConfig, DMRDecoder
    from sdrtrunk_jax.signal import generators

    asm = DMRBurstAssembler(color_code=2)
    rng = np.random.default_rng(3)
    payloads = []
    bursts = []
    for opcode in (0x19, 0x3D):
        data = rng.integers(0, 2, 64).astype(np.uint8)
        payloads.append((opcode, data))
        bursts.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                     DataType.CSBK, csbk_encode(opcode, data)))
    tx_dibits = np.concatenate([
        rng.integers(0, 4, 60).astype(np.uint8),
        DMRBurstAssembler.to_dibits(bursts),
        np.zeros(60, np.uint8),
    ])
    fs = 25000.0
    iq = generators.c4fm_modulate(tx_dibits, fs)  # DMR 4FSK == same mapping
    dec = DMRDecoder(DMRConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    frames = DMRFramer().process(rx)
    assert len(frames) == 2, [f.pattern for f in frames]
    for (opcode, data), frame in zip(payloads, frames):
        assert frame.content_kind == "csbk"
        assert frame.content.opcode == opcode
        assert np.array_equal(frame.content.data, data)
        assert frame.slot_type.color_code == 2


def test_framer_chunked_equals_oneshot():
    """Voice frames B..F carry EMB instead of sync and are only reachable
    by the stride walk from frame A — the framer must keep frame A in its
    carry until the superframe completes, so feeding the stream in small
    chunks (the orchestrator delivers ~100 dibits per step) must produce
    exactly the one-shot frame sequence (round-3 regression: chunked
    processing dropped every continuation burst)."""
    rng = np.random.default_rng(9)
    asm = DMRBurstAssembler(color_code=1)
    ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
    lc = lc_build_group_voice(group=0x31, source=0x77)
    vh = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
    bursts = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                             DataType.VOICE_HEADER, vh),
              asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE, ambe)]
    for vf in VOICE_FRAME_ORDER:
        bursts.append(asm.voice_burst(vf, ambe))
    dibits = np.concatenate([
        rng.integers(0, 4, 33).astype(np.uint8),
        DMRBurstAssembler.to_dibits(bursts),
        rng.integers(0, 4, 40).astype(np.uint8)])

    oneshot = DMRFramer().process(dibits)
    chunked_framer = DMRFramer()
    chunked = []
    for i in range(0, len(dibits), 97):
        chunked.append(chunked_framer.process(dibits[i:i + 97]))
    chunked = [f for fs in chunked for f in fs]
    assert [(f.start, f.content_kind) for f in chunked] == \
           [(f.start, f.content_kind) for f in oneshot]
    assert sum(1 for f in oneshot if f.content_kind == "voice") == 6
