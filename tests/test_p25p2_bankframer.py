"""P25P2 bank framer equivalence: the vectorized bank tier must emit
the same fragments (ISCH, timeslots, voice frames, MAC octets) as the
per-slot P25P2Framer on mixed multi-slot streams, including chunk
boundaries and per-slot scramble parameters."""
import numpy as np
import pytest

from sdrtrunk_jax.protocol.bits import bits_to_dibits
from sdrtrunk_jax.protocol.p25p2 import P25P2Framer, P25P2FragmentAssembler
from sdrtrunk_jax.protocol.p25p2.bankframer import (P25P2BankFramer,
                                                    P25P2_SYNC_DIBITS)
from sdrtrunk_jax.protocol.p25p2.timeslot import (facch_encode,
                                                  sacch_encode,
                                                  voice4_encode)

WACN, SYSTEM, NAC = 0xA4BC3, 0x123, 0x29A


def _mac_info(n_info: int, rng) -> np.ndarray:
    bits = rng.integers(0, 2, n_info * 6).astype(np.uint8)
    bits[0:3] = [0, 0, 1]          # PTT MAC PDU type
    return bits


def _stream(rng, n_frags: int, pad0: int) -> np.ndarray:
    asm = P25P2FragmentAssembler(WACN, SYSTEM, NAC)
    frags = []
    for j in range(n_frags):
        frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
        timeslots = [facch_encode(_mac_info(26, rng)),
                     voice4_encode(frames),
                     sacch_encode(_mac_info(30, rng), scrambled=True),
                     voice4_encode(frames)]
        frags.append(asm.assemble(j % 3, timeslots))
    dib = P25P2FragmentAssembler.to_dibits(frags)
    return np.concatenate([rng.integers(0, 4, pad0).astype(np.uint8),
                           dib,
                           rng.integers(0, 4, 60).astype(np.uint8)])


def _device_hits(chunk: np.ndarray, counts: np.ndarray,
                 thr: int = 4) -> np.ndarray:
    diff = np.array([[bin(a ^ b).count("1") for b in range(4)]
                     for a in range(4)], np.uint8)
    hits = np.zeros(chunk.shape, bool)
    L = chunk.shape[1] - 19
    err = np.zeros((chunk.shape[0], L), np.uint16)
    for k in range(20):
        err += diff[chunk[:, k:k + L], P25P2_SYNC_DIBITS[k]]
    hits[:, :L] = err <= thr
    for i, n in enumerate(counts):
        hits[i, max(0, n - 19):] = False
    return hits


def _frag_key(f):
    return (f.start, f.sync_errors,
            None if f.isch0 is None else
            (f.isch0.channel, f.isch0.isch_sequence, f.isch0.bit_errors),
            len(f.timeslots))


@pytest.mark.parametrize("use_device_hits", [True, False])
def test_bank_matches_per_slot(use_device_hits):
    rng = np.random.default_rng(5)
    c = 4
    streams = [_stream(rng, 5, 37 + 211 * i) for i in range(3)]
    streams.append(rng.integers(0, 4, len(streams[0])).astype(np.uint8))
    length = min(len(s) for s in streams)
    streams = [s[:length] for s in streams]
    cap = 1024

    per = [P25P2Framer(WACN, SYSTEM, NAC) for _ in range(c)]
    bank = P25P2BankFramer(c)
    for s in range(c):
        bank.set_scramble_parameters(s, WACN, SYSTEM, NAC)
    ref = {i: [] for i in range(c)}
    got = {i: [] for i in range(c)}

    offs = np.zeros(c, np.int64)
    while np.any(offs < length):
        counts = np.minimum(rng.integers(cap - 50, cap + 1, c),
                            length - offs)
        chunk = np.zeros((c, cap), np.uint8)
        for i in range(c):
            chunk[i, :counts[i]] = streams[i][offs[i]:offs[i] + counts[i]]
            ref[i].extend(per[i].process(
                streams[i][offs[i]:offs[i] + counts[i]]))
        hits = _device_hits(chunk, counts) if use_device_hits else None
        for slot, frag in bank.process(chunk, counts, device_hits=hits):
            got[slot].append(frag)
        offs += counts

    total = 0
    for i in range(c):
        assert len(got[i]) == len(ref[i]), \
            (i, [_frag_key(f) for f in got[i]],
             [_frag_key(f) for f in ref[i]])
        for a, b in zip(got[i], ref[i]):
            total += 1
            assert _frag_key(a) == _frag_key(b)
            for ta, tb in zip(a.timeslots, b.timeslots):
                assert ta.duid == tb.duid
                assert ta.index == tb.index
                assert ta.rs_errors == tb.rs_errors
                np.testing.assert_array_equal(ta.bits, tb.bits)
                if ta.voice_frames is not None:
                    np.testing.assert_array_equal(ta.voice_frames,
                                                  tb.voice_frames)
                if ta.mac_octets is not None:
                    np.testing.assert_array_equal(ta.mac_octets,
                                                  tb.mac_octets)
                    assert ta.mac_pdu_type == tb.mac_pdu_type
    assert total >= 3 * 4               # 3 live slots, >=4 fragments each
    assert len(got[3]) == 0             # noise slot silent


def test_scramble_param_isolation():
    """Each slot's scrambling is independent: a slot with the wrong key
    mis-descrambles scrambled timeslots (different bits), while the
    right-key slot matches the per-slot framer."""
    rng = np.random.default_rng(9)
    stream = _stream(rng, 4, 50)
    bank = P25P2BankFramer(2)
    bank.set_scramble_parameters(0, WACN, SYSTEM, NAC)    # correct
    # slot 1 keeps default (0,0,0) -> wrong sequence
    chunk = np.stack([stream, stream])
    counts = np.array([len(stream), len(stream)])
    frags = bank.process(chunk, counts)
    by_slot = {0: [], 1: []}
    for s, f in frags:
        by_slot[s].append(f)
    assert by_slot[0] and by_slot[1]
    f0, f1 = by_slot[0][0], by_slot[1][0]
    scr0 = [t for t in f0.timeslots if t.duid.name == "SACCH_SCRAMBLED"]
    scr1 = [t for t in f1.timeslots if t.duid.name == "SACCH_SCRAMBLED"]
    assert scr0 and scr0[0].mac_octets is not None
    # wrong key: either RS fails (dropped/None) or bits differ
    if scr1 and scr1[0].mac_octets is not None:
        assert not np.array_equal(scr0[0].bits, scr1[0].bits)
