"""DMRBankFramer vs the per-slot DMRFramer: identical bursts on mixed
multi-slot streams, chunked with ragged per-slot counts (the DMR
sibling of tests/test_bankframer.py)."""
import numpy as np
import pytest

from sdrtrunk_jax.protocol.dmr.bankframer import (DMR_SYNC_DIBIT_PATTERNS,
                                                  DMRBankFramer, _DIFF)
from sdrtrunk_jax.protocol.dmr.framer import DMRFramer


def _voice_stream(seed: int, n_calls: int = 3) -> np.ndarray:
    from sdrtrunk_jax.protocol.dmr.framer import (DataType,
                                                  DMRBurstAssembler,
                                                  VOICE_FRAME_ORDER)
    from sdrtrunk_jax.protocol.dmr.lc import (MASK_TERMINATOR,
                                              MASK_VOICE_HEADER,
                                              embedded_lc_encode,
                                              full_lc_encode,
                                              lc_build_group_voice)
    from sdrtrunk_jax.protocol.dmr.sync import DMRSyncPattern
    from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_encode

    rng = np.random.default_rng(seed)
    asm = DMRBurstAssembler(color_code=1)
    parts = [rng.integers(0, 4, 173).astype(np.uint8)]
    for call in range(n_calls):
        ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
        lc = lc_build_group_voice(group=0x40 + call, source=0x1000 + call)
        vh = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
        tlc = bptc_196_96_encode(full_lc_encode(lc, MASK_TERMINATOR))
        frags = embedded_lc_encode(lc)
        bursts = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                 DataType.VOICE_HEADER, vh),
                  asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE,
                                  ambe)]
        for i, vf in enumerate(VOICE_FRAME_ORDER[:4]):
            bursts.append(asm.voice_burst(
                vf, ambe, emb_lcss=[1, 3, 3, 2][i],
                lc_fragment=frags[i]))
        bursts.append(asm.voice_burst(VOICE_FRAME_ORDER[4], ambe))
        bursts.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                     DataType.TLC, tlc))
        parts.append(DMRBurstAssembler.to_dibits(bursts))
        parts.append(rng.integers(0, 4, rng.integers(40, 200)
                                  ).astype(np.uint8))
    return np.concatenate(parts)


def _burst_key(f):
    return (f.pattern, f.start, f.sync_errors, f.content_kind,
            f.timeslot)


def _device_hits(chunk: np.ndarray, counts: np.ndarray,
                 thr: int = 4) -> np.ndarray:
    hits = np.zeros(chunk.shape, bool)
    L = chunk.shape[1] - 23
    best = np.full((chunk.shape[0], L), 255, np.uint16)
    for p in range(len(DMR_SYNC_DIBIT_PATTERNS)):
        e = np.zeros((chunk.shape[0], L), np.uint16)
        pat = DMR_SYNC_DIBIT_PATTERNS[p]
        for k in range(24):
            e += _DIFF[chunk[:, k:k + L], pat[k]]
        np.minimum(best, e, out=best)
    hits[:, :L] = best <= thr
    return hits


@pytest.mark.parametrize("cap,use_device_hits", [(512, False),
                                                 (512, True),
                                                 (192, False)])
def test_dmr_bank_matches_per_slot(cap, use_device_hits):
    streams = [_voice_stream(1), _voice_stream(2),
               np.random.default_rng(9).integers(0, 4, 9000
                                                 ).astype(np.uint8)]
    c = len(streams)
    length = min(len(s) for s in streams)
    streams = [s[:length] for s in streams]
    rng = np.random.default_rng(7)

    framers = [DMRFramer() for _ in range(c)]
    ref = {i: [] for i in range(c)}
    bank = DMRBankFramer(c)
    got = {i: [] for i in range(c)}

    offs = np.zeros(c, np.int64)
    while np.any(offs < length):
        counts = np.minimum(rng.integers(cap - 40, cap + 1, c),
                            length - offs)
        chunk = np.zeros((c, cap), np.uint8)
        for i in range(c):
            chunk[i, :counts[i]] = streams[i][offs[i]:offs[i] + counts[i]]
            ref[i].extend(framers[i].process(
                streams[i][offs[i]:offs[i] + counts[i]]))
        hits = _device_hits(chunk, counts) if use_device_hits else None
        for slot, frame in bank.process(chunk, counts,
                                        device_hits=hits):
            got[slot].append(frame)
        offs += counts

    for i in range(c):
        assert len(got[i]) == len(ref[i]), \
            (i, [_burst_key(f) for f in got[i]],
             [_burst_key(f) for f in ref[i]])
        for a, b in zip(got[i], ref[i]):
            assert _burst_key(a) == _burst_key(b)
            np.testing.assert_array_equal(a.bits, b.bits)
            if a.content_kind == "voice":
                np.testing.assert_array_equal(
                    a.content["ambe_frames"], b.content["ambe_frames"])
    assert sum(len(v) for v in got.values()) >= 2 * 21  # 3 calls x 7
    assert len(got[2]) == 0                 # noise slot silent
