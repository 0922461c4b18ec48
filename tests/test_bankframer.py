"""P25P1BankFramer vs the per-slot P25P1Framer: identical frames on
mixed multi-slot streams, chunked with ragged per-slot counts."""
import numpy as np
import pytest

from sdrtrunk_jax.protocol.p25p1.bankframer import P25P1BankFramer
from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.protocol.p25p1.framer import (P25P1FrameAssembler,
                                                P25P1Framer)
from sdrtrunk_jax.protocol.p25p1.ldu import ldu1_encode, ldu2_encode
from sdrtrunk_jax.protocol.p25p1.lc import lc_build_group_voice
from sdrtrunk_jax.protocol.p25p1.messages import decode_frame
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode


def _voice_stream(seed: int, n_super: int = 4) -> np.ndarray:
    """LDU1/LDU2 voice superframes ending in a TDU."""
    rng = np.random.default_rng(seed)
    asm = P25P1FrameAssembler()
    lc = lc_build_group_voice(0x123 + seed, 0x45678 + seed)
    parts = []
    for _ in range(n_super):
        p1 = ldu1_encode(lc, rng.integers(0, 2, (9, 144)).astype(np.uint8),
                         rng.integers(0, 2, 32).astype(np.uint8))
        p2 = ldu2_encode(rng.integers(0, 2, 72).astype(np.uint8), 0x80, 1,
                         rng.integers(0, 2, (9, 144)).astype(np.uint8))
        parts += [asm.assemble(DUID.LDU1, p1), asm.assemble(DUID.LDU2, p2)]
    parts.append(asm.assemble(DUID.TDU, np.zeros(28, np.uint8)))
    return np.concatenate(parts)


def _control_stream(seed: int, n: int = 30) -> np.ndarray:
    asm = P25P1FrameAssembler()
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(n):
        args = rng.integers(0, 2, 64).astype(np.uint8)
        parts.append(asm.assemble(DUID.TSBK,
                                  tsbk_encode(0x00, args, last_block=True)))
        # inter-frame idle dibits exercise non-aligned syncs
        parts.append(rng.integers(0, 4, rng.integers(0, 40)
                                  ).astype(np.uint8))
    return np.concatenate(parts)


def _msg_key(m):
    return (m.nac, int(m.duid), m.start, m.valid, m.bit_errors)


def _run_equivalence(streams, cap, seed=0):
    c = len(streams)
    rng = np.random.default_rng(seed)
    length = min(len(s) for s in streams)
    streams = [s[:length] for s in streams]

    # reference: per-slot framers
    ref = {i: [] for i in range(c)}
    framers = [P25P1Framer() for _ in range(c)]

    bank = P25P1BankFramer(c, retain=2048)
    got = {i: [] for i in range(c)}

    offs = np.zeros(c, np.int64)
    while np.any(offs < length):
        counts = np.minimum(rng.integers(cap - 60, cap + 1, c),
                            length - offs)
        chunk = np.zeros((c, cap), np.uint8)
        for i in range(c):
            chunk[i, :counts[i]] = streams[i][offs[i]:offs[i] + counts[i]]
            frames = framers[i].process(
                streams[i][offs[i]:offs[i] + counts[i]])
            ref[i].extend(decode_frame(f) for f in frames)
        for slot, msg in bank.process(chunk, counts):
            got[slot].append(msg)
        offs += counts

    for i in range(c):
        assert len(got[i]) == len(ref[i]), \
            f"slot {i}: {len(got[i])} vs {len(ref[i])} frames"
        for a, b in zip(got[i], ref[i]):
            assert _msg_key(a) == _msg_key(b), f"slot {i}: {a} vs {b}"
            if a.duid in (DUID.LDU1, DUID.LDU2):
                np.testing.assert_array_equal(a.content.voice_frames,
                                              b.content.voice_frames)
                np.testing.assert_array_equal(a.content.lsd, b.content.lsd)
            if a.duid == DUID.LDU1 and a.content.link_control is not None:
                assert (a.content.link_control.opcode ==
                        b.content.link_control.opcode)
    return got


def test_bank_matches_per_slot_voice_and_control():
    streams = [_control_stream(1), _voice_stream(2), _voice_stream(3),
               np.random.default_rng(9).integers(0, 4, 20000
                                                 ).astype(np.uint8)]
    got = _run_equivalence(streams, cap=1024)
    assert sum(len(v) for v in got.values()) > 40
    assert len(got[0]) >= 25            # TSBKs decoded
    assert len(got[3]) == 0             # noise slot stays silent


def test_bank_matches_per_slot_small_chunks():
    """Frames span many chunks (cap 256 << LDU span 890)."""
    streams = [_voice_stream(5, n_super=2), _voice_stream(6, n_super=2)]
    got = _run_equivalence(streams, cap=256, seed=1)
    assert len(got[0]) == 5 and len(got[1]) == 5


def test_bank_device_hits_path():
    """Feeding an explicit (superset) hit mask gives the same frames as
    host-side correlation."""
    stream = _voice_stream(7, n_super=3)
    cap = 1024
    c = 2
    bank_host = P25P1BankFramer(c, retain=2048)
    bank_dev = P25P1BankFramer(c, retain=2048)
    from sdrtrunk_jax.protocol.p25p1.bankframer import (DIBIT_DIFF,
                                                        SYNC_DIBIT_PATTERNS)
    host_msgs, dev_msgs = [], []
    for off in range(0, len(stream) - cap, cap):
        counts = np.array([cap, cap - 7])
        chunk = np.zeros((c, cap), np.uint8)
        chunk[0] = stream[off:off + cap]
        chunk[1, :cap - 7] = stream[off:off + cap - 7][::-1]  # junk slot
        host_msgs += bank_host.process(chunk, counts)
        # device-style mask: correlate each slot chunk-locally
        hits = np.zeros((c, cap), bool)
        for s in range(c):
            n = counts[s]
            for p in range(4):
                pat = SYNC_DIBIT_PATTERNS[p]
                err = np.zeros(max(0, n - 23), np.int32)
                for k in range(24):
                    err += DIBIT_DIFF[chunk[s, k:k + len(err)], pat[k]]
                hits[s, :len(err)] |= err <= 9
        dev_msgs += bank_dev.process(chunk, counts, device_hits=hits)
    assert len(host_msgs) == len(dev_msgs) > 0
    for a, b in zip(host_msgs, dev_msgs):
        assert a[0] == b[0] and _msg_key(a[1]) == _msg_key(b[1])
