"""EDAC bit-exactness and roundtrip tests.

Reference test vectors come from the reference's own embedded scratch
harnesses (e.g. BCH_63_16_11.java main()) and from the published standard
tables; everything else is encode->corrupt->decode self-consistency.
"""
import numpy as np
import pytest

from sdrtrunk_jax.protocol import bits as B
from sdrtrunk_jax.protocol.edac.bch import BCH_63_16_11
from sdrtrunk_jax.protocol.edac.bptc import (bptc_196_96_decode,
                                             bptc_196_96_encode)
from sdrtrunk_jax.protocol.edac.crc import (check_crc16_ccitt, crc9_p25,
                                            crc16_ccitt, crc_bits)
from sdrtrunk_jax.protocol.edac.galois import GF64_P25
from sdrtrunk_jax.protocol.edac.golay import (golay18_decode, golay18_encode,
                                              golay23_decode, golay23_encode,
                                              golay24_decode, golay24_encode)
from sdrtrunk_jax.protocol.edac.hamming import (HAMMING_10_6_3,
                                                HAMMING_13_9_3,
                                                HAMMING_15_11_3,
                                                HAMMING_16_11_4,
                                                HAMMING_17_12_5)
from sdrtrunk_jax.protocol.edac.rs import ReedSolomon
from sdrtrunk_jax.protocol.edac.trellis import (TRELLIS_1_2_P25,
                                                TRELLIS_3_4_DMR,
                                                P25_DEINTERLEAVE,
                                                deinterleave_p25,
                                                interleave_p25)


def test_bits_roundtrip():
    v = B.from_int(0xA5C3, 16)
    assert B.to_int(v) == 0xA5C3
    assert B.bits_to_hex(v) == "A5C3"
    d = B.bits_to_dibits(v)
    assert np.array_equal(B.dibits_to_bits(d), v)
    assert B.unpack_bits(B.pack_bits(v), 16).tolist() == v.tolist()


def test_xor_popcount_correlate():
    pattern = B.from_int(0b10110, 5)
    stream = np.concatenate([np.zeros(7, np.uint8), pattern,
                             np.ones(4, np.uint8)])
    errs = B.xor_popcount_correlate(stream, pattern)
    assert errs[7] == 0
    assert np.all(errs[:7] > 0)


def test_bch_reference_vector():
    """The reference's own BCH test vector (BCH_63_16_11.java main())."""
    bch = BCH_63_16_11()
    orig = B.to_bits("00100110000000110100101000000001100001111100111010"
                     "10001010110000")
    err = B.to_bits("00010101000000110100101000000001100001111000110010"
                    "10001010110000")
    data, nerr = bch.decode(err)
    assert nerr == 6
    assert np.array_equal(data, orig[:16])
    # our encoder regenerates the reference codeword's 63 BCH bits
    assert np.array_equal(bch.encode(orig[:16])[:63], orig[:63])


def test_bch_roundtrip_capacity():
    bch = BCH_63_16_11()
    rng = np.random.default_rng(1)
    for _ in range(5):
        d = rng.integers(0, 2, 16).astype(np.uint8)
        cw = bch.encode(d)[:63].astype(np.int64)
        pos = rng.choice(63, 11, replace=False)
        bad = cw.copy()
        bad[pos] ^= 1
        dec, nerr = bch.decode(bad)
        assert nerr == 11 and np.array_equal(dec, d)


def test_rs_shortened_p25():
    rng = np.random.default_rng(2)
    for n, k in [(24, 12), (24, 16), (36, 20)]:
        rs = ReedSolomon(n, k, GF64_P25)
        t = (n - k) // 2
        d = rng.integers(0, 64, k)
        cw = rs.encode(d)
        bad = cw.copy()
        pos = rng.choice(n, t, replace=False)
        for p in pos:
            bad[p] ^= rng.integers(1, 64)
        dec, nerr = rs.decode(bad)
        assert nerr == t and np.array_equal(dec, cw)
        # beyond capacity -> detected (None) virtually always
        bad2 = cw.copy()
        pos2 = rng.choice(n, t + 2, replace=False)
        for p in pos2:
            bad2[p] ^= rng.integers(1, 64)
        _, nerr2 = rs.decode(bad2)
        assert nerr2 is None or nerr2 > 0


def test_golay_roundtrips():
    rng = np.random.default_rng(3)
    for _ in range(10):
        d = rng.integers(0, 2, 12).astype(np.uint8)
        cw = golay23_encode(d)
        bad = cw.copy()
        bad[rng.choice(23, 3, replace=False)] ^= 1
        dec, nerr = golay23_decode(bad)
        assert nerr == 3 and np.array_equal(dec, cw)

        cw24 = golay24_encode(d)
        assert cw24.sum() % 2 == 0  # even overall parity
        bad = cw24.copy()
        bad[rng.choice(24, 3, replace=False)] ^= 1
        dec, nerr = golay24_decode(bad)
        assert nerr == 3 and np.array_equal(dec, cw24)

        d6 = rng.integers(0, 2, 6).astype(np.uint8)
        cw18 = golay18_encode(d6)
        bad = cw18.copy()
        bad[rng.choice(18, 3, replace=False)] ^= 1
        dec, nerr = golay18_decode(bad)
        assert nerr == 3 and np.array_equal(dec, cw18)


def test_golay24_parity_table_convention():
    """Parity rows must match the P25 convention (Golay24.java checksums)."""
    expected_first_rows = [0x63A, 0x31D, 0x7B4, 0x3DA]
    for i, exp in enumerate(expected_first_rows):
        d = np.zeros(12, np.uint8)
        d[i] = 1
        cw = golay23_encode(d)
        parity = B.to_int(cw[12:])
        assert parity == exp, (i, hex(parity), hex(exp))


def test_hamming_codes():
    rng = np.random.default_rng(4)
    for code in [HAMMING_10_6_3, HAMMING_13_9_3, HAMMING_15_11_3,
                 HAMMING_16_11_4, HAMMING_17_12_5]:
        for _ in range(5):
            d = rng.integers(0, 2, code.k).astype(np.uint8)
            cw = code.encode(d)
            assert code.syndrome(cw) == 0
            bad = cw.copy()
            p = rng.integers(0, code.n)
            bad[p] ^= 1
            dec, nerr = code.decode(bad)
            assert nerr == 1 and np.array_equal(dec, cw), code.name


def test_trellis_roundtrip():
    rng = np.random.default_rng(5)
    # P25 1/2: 96 data bits + flush -> 196 transmitted bits
    d = rng.integers(0, 2, 96).astype(np.uint8)
    enc = TRELLIS_1_2_P25.encode(d)
    assert len(enc) == 196
    dec, errs = TRELLIS_1_2_P25.decode(enc)
    assert errs == 0 and np.array_equal(dec, d)
    # flip bits: viterbi should correct scattered errors
    bad = enc.copy()
    bad[[10, 50, 120, 180]] ^= 1
    dec, errs = TRELLIS_1_2_P25.decode(bad)
    assert np.array_equal(dec, d) and errs >= 4

    # DMR 3/4: 144 data bits -> (48+1)*4 = 196 bits
    d3 = rng.integers(0, 2, 144).astype(np.uint8)
    enc3 = TRELLIS_3_4_DMR.encode(d3)
    assert len(enc3) == 196
    dec3, errs3 = TRELLIS_3_4_DMR.decode(enc3)
    assert errs3 == 0 and np.array_equal(dec3, d3)
    bad3 = enc3.copy()
    bad3[[30, 100]] ^= 1
    dec3, _ = TRELLIS_3_4_DMR.decode(bad3)
    assert np.array_equal(dec3, d3)


def test_p25_interleave_matches_reference_table():
    """Spot-check against P25P1Interleave.DATA_DEINTERLEAVE values."""
    expected = {0: 0, 4: 16, 8: 32, 52: 4, 56: 20, 100: 8, 148: 12,
                192: 188, 195: 191}
    for wire, enc in expected.items():
        assert P25_DEINTERLEAVE[wire] == enc, (wire,)
    rng = np.random.default_rng(6)
    b = rng.integers(0, 2, 196).astype(np.uint8)
    assert np.array_equal(deinterleave_p25(interleave_p25(b)), b)


def test_crc16_ccitt():
    # classic check value: "123456789" ascii, poly 0x1021 init 0 -> 0x31C3
    msg = np.concatenate([B.from_int(c, 8) for c in b"123456789"])
    assert crc_bits(msg, 0x1021, 16) == 0x31C3
    # complemented convention self-check
    data = B.from_int(0xDEADBEEF, 32)
    crc = crc16_ccitt(data)
    word = np.concatenate([data, B.from_int(crc, 16)])
    assert check_crc16_ccitt(word, 32)
    word[3] ^= 1
    assert not check_crc16_ccitt(word, 32)


def test_bptc_196_96():
    rng = np.random.default_rng(7)
    d = rng.integers(0, 2, 96).astype(np.uint8)
    tx = bptc_196_96_encode(d)
    assert len(tx) == 196
    dec, nerr = bptc_196_96_decode(tx)
    assert nerr == 0 and np.array_equal(dec, d)
    # scattered errors correctable by iterative row/col decoding
    bad = tx.copy()
    bad[rng.choice(196, 4, replace=False)] ^= 1
    dec, nerr = bptc_196_96_decode(bad)
    assert nerr is not None and np.array_equal(dec, d)
