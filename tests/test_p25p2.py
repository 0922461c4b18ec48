"""P25 Phase 2 tests: scrambler, ISCH, timeslot codecs, framer, and
closed-loop decode through the 6000-baud modem."""
import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.protocol import bits as B
from sdrtrunk_jax.protocol.p25p2 import (P25P2FragmentAssembler, P25P2Framer,
                                         ScramblingSequence, isch_decode,
                                         isch_encode, lfsr_sequence)
from sdrtrunk_jax.protocol.p25p2.timeslot import (DataUnitID, MacPduType,
                                                  facch_encode, sacch_encode,
                                                  timeslot_decode,
                                                  voice4_encode)


def test_lfsr_properties():
    seq = lfsr_sequence(0xA4BC3, 0x123, 0x29A)
    assert len(seq) == 4320
    assert 0.4 < seq.mean() < 0.6          # balanced
    seq2 = lfsr_sequence(0xA4BC3, 0x123, 0x29A)
    assert np.array_equal(seq, seq2)       # deterministic
    assert not np.array_equal(seq, lfsr_sequence(0xA4BC3, 0x123, 0x29B))
    # all-zero key falls back to the all-ones register
    z = lfsr_sequence(0, 0, 0)
    assert z[:10].any()
    sc = ScramblingSequence(1, 2, 3)
    assert sc.segments.shape == (12, 320)


def test_isch_roundtrip():
    for chan in (0, 1):
        for seqn in (0, 1, 2):
            w = isch_encode(chan, seqn, True, 2)
            assert len(w) == 40
            d = isch_decode(w)
            assert d is not None and d.bit_errors == 0
            assert d.channel == chan and d.isch_sequence == seqn
            assert d.inbound_free and d.superframe_sequence == 2
    # error tolerance
    w = isch_encode(1, 2, False, 0)
    bad = w.copy()
    bad[[3, 17, 30]] ^= 1
    d = isch_decode(bad)
    assert d is not None and d.channel == 1 and d.isch_sequence == 2


def test_facch_sacch_roundtrip():
    rng = np.random.default_rng(0)
    info = rng.integers(0, 2, 156).astype(np.uint8)
    ts = facch_encode(info)
    dec = timeslot_decode(ts, 0, 0)
    assert dec is not None and dec.duid == DataUnitID.FACCH_UNSCRAMBLED
    assert np.array_equal(dec.mac_octets, info)
    # correctable symbol errors (punctured RS: t_eff ~ 5 hexbits)
    bad = ts.copy()
    bad[[10, 11, 50, 51]] ^= 1
    dec2 = timeslot_decode(bad, 0, 0)
    assert dec2 is not None and np.array_equal(dec2.mac_octets, info)

    info_s = rng.integers(0, 2, 180).astype(np.uint8)
    ts_s = sacch_encode(info_s)
    dec3 = timeslot_decode(ts_s, 0, 0)
    assert dec3 is not None and dec3.duid == DataUnitID.SACCH_UNSCRAMBLED
    assert np.array_equal(dec3.mac_octets, info_s)


def test_voice4_and_scrambling():
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    ts = voice4_encode(frames)
    sc = ScramblingSequence(0xBEE, 0x42, 0x123)
    seg = sc.segment(5)
    from sdrtrunk_jax.protocol.p25p2.timeslot import DUID_POSITIONS
    scrambled = ts ^ seg
    scrambled[DUID_POSITIONS] = ts[DUID_POSITIONS]
    dec = timeslot_decode(scrambled, 5, 1, seg)
    assert dec is not None and dec.duid == DataUnitID.VOICE_4
    assert np.array_equal(dec.voice_frames, frames)


def test_fragment_framer():
    wacn, system, nac = 0xA4BC3, 0x123, 0x29A
    rng = np.random.default_rng(2)
    asm = P25P2FragmentAssembler(wacn, system, nac)
    info = rng.integers(0, 2, 156).astype(np.uint8)
    mac = np.zeros(156, np.uint8)
    mac[:3] = B.from_int(3, 3)  # MAC_3_IDLE
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    timeslots = [facch_encode(info), voice4_encode(frames),
                 facch_encode(mac), voice4_encode(frames)]
    frag_bits = asm.assemble(1, timeslots)
    dibits = np.concatenate([
        rng.integers(0, 4, 55).astype(np.uint8),
        P25P2FragmentAssembler.to_dibits([frag_bits]),
        rng.integers(0, 4, 20).astype(np.uint8),
    ])
    framer = P25P2Framer(wacn, system, nac)
    frags = framer.process(dibits)
    assert len(frags) == 1
    frag = frags[0]
    assert frag.fragment_number == 1
    assert len(frag.timeslots) == 4
    assert frag.timeslots[0].duid == DataUnitID.FACCH_UNSCRAMBLED
    assert np.array_equal(frag.timeslots[0].mac_octets, info)
    assert frag.timeslots[2].mac_pdu_type == MacPduType.IDLE
    assert np.array_equal(frag.timeslots[1].voice_frames, frames)
    # timeslot numbering from ISCH fragment sequence 1 -> offset 4
    assert [t.index for t in frag.timeslots] == [4, 5, 6, 7]


def test_p25p2_modem_end_to_end():
    """Fragment -> 6000-baud constant-envelope differential modem ->
    demod -> framer -> parsed timeslots.

    A C4FM-style constant-envelope transmission carries no amplitude
    transitions for the Gardner TED, so this test pins the
    decision-directed timing core (the production default is Gardner for
    the linear H-DQPSK downlink — see tests/test_gardner.py)."""
    import jax
    from sdrtrunk_jax.decoders.p25p2 import P25P2Config, P25P2Decoder
    from sdrtrunk_jax.signal import generators

    wacn, system, nac = 0xA4BC3, 0x123, 0x29A
    rng = np.random.default_rng(3)
    asm = P25P2FragmentAssembler(wacn, system, nac)
    info = rng.integers(0, 2, 156).astype(np.uint8)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    timeslots = [facch_encode(info), voice4_encode(frames),
                 facch_encode(info), voice4_encode(frames)]
    frag_bits = asm.assemble(0, timeslots)
    tx_dibits = np.concatenate([
        rng.integers(0, 4, 60).astype(np.uint8),
        P25P2FragmentAssembler.to_dibits([frag_bits]),
        np.zeros(40, np.uint8),
    ])
    fs = 50000.0
    iq = generators.c4fm_modulate(tx_dibits, fs, symbol_rate=6000.0)
    dec = P25P2Decoder(P25P2Config(sample_rate=fs, timing="decision",
                                   sample_counter_gain=0.3))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    frags = P25P2Framer(wacn, system, nac).process(rx)
    assert len(frags) == 1
    assert np.array_equal(frags[0].timeslots[0].mac_octets, info)
    assert np.array_equal(frags[0].timeslots[1].voice_frames, frames)
