"""Gardner timing recovery (VERDICT round-1 item 5).

Closed-loop checks for the GardnerDQPSKDemodulator scan core against the
conditions the reference chose it for (P25 LSM simulcast and Phase 2,
dsp/psk/DQPSKGardnerDemodulator.java): carrier frequency offset, symbol
clock skew, and inter-site simulcast echo where the decision-directed
detector demonstrably loses frames.
"""
import numpy as np
import jax.numpy as jnp

from sdrtrunk_jax.decoders.c4fm import C4FMConfig, C4FMDecoder
from sdrtrunk_jax.decoders.lsm import LSMConfig, LSMDecoder
from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.protocol.p25p1.framer import (P25P1FrameAssembler,
                                                P25P1Framer)
from sdrtrunk_jax.protocol.p25p1.messages import decode_frame
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
from sdrtrunk_jax.signal import generators

FS = 25000.0


def _tsbk_stream(n_frames: int = 4, seed: int = 0):
    rng = np.random.default_rng(seed)
    asm = P25P1FrameAssembler(nac=0x293)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)]
    for _ in range(n_frames):
        parts += [asm.assemble(DUID.TSBK, tsbk_encode(0x3B, args)),
                  rng.integers(0, 4, 20).astype(np.uint8)]
    parts.append(np.zeros(40, np.uint8))
    return np.concatenate(parts), args


def _decode_count(dec, iq) -> tuple[int, int]:
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    frames = P25P1Framer().process(rx)
    return len(frames), sum(1 for f in frames if decode_frame(f).valid)


def test_gardner_locks_with_offset_and_clock_skew():
    """+300 Hz carrier error and +1.5% symbol clock skew (inside the
    +/-2% InterpolatingSampleBuffer tracking range): every frame must
    decode bit-exact through the Gardner loop."""
    dibits, args = _tsbk_stream()
    iq = generators.lsm_modulate(dibits, FS, symbol_rate=4800.0 * 1.015)
    t = np.arange(len(iq)) / FS
    iq = (iq * np.exp(2j * np.pi * 300.0 * t)).astype(np.complex64)
    dec = LSMDecoder(LSMConfig(sample_rate=FS))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    frames = P25P1Framer().process(rx)
    assert len(frames) == 4
    for f in frames:
        msg = decode_frame(f)
        assert msg.valid and np.array_equal(msg.content.args, args)


def test_gardner_beats_decision_directed_on_simulcast_echo():
    """Two-site simulcast: a 0.5-symbol-delayed echo at 0.7 amplitude.
    The amplitude-sensitive Gardner TED keeps lock where the
    decision-directed detector drops frames — the reason the reference
    uses Gardner for LSM (P25P1DecoderLSM.java:88-90)."""
    dibits, _ = _tsbk_stream()
    base = generators.lsm_modulate(dibits, FS)
    d = int(round(0.5 * FS / 4800.0))
    echo = np.concatenate([np.zeros(d, np.complex64), base[:-d]])
    iq = (base + 0.7 * np.exp(1.2j) * echo).astype(np.complex64)

    _, gardner_valid = _decode_count(LSMDecoder(LSMConfig(sample_rate=FS)),
                                     iq)
    _, dd_valid = _decode_count(C4FMDecoder(C4FMConfig(sample_rate=FS)), iq)
    assert gardner_valid == 4
    assert dd_valid < gardner_valid


def test_p25p2_gardner_end_to_end_with_offset_and_skew():
    """P25P2 fragment through the (now Gardner-timed) HDQPSK decoder with
    carrier offset + symbol clock skew: superframe still parses.

    H-DQPSK downlink is a LINEAR modulation (receivable by both C4FM and
    CQPSK radios), so it is synthesized with the pi/4-DQPSK RRC modulator
    — the Gardner TED needs envelope transitions and by design does not
    lock on constant-envelope FSK (that is what the decision-directed
    core is for). Skew stays within what P25P2's 0.1 timing gain
    (P25P2DecoderHDQPSK.java:62) can converge inside one superframe."""
    from sdrtrunk_jax.decoders.p25p2 import P25P2Config, P25P2Decoder
    from sdrtrunk_jax.protocol.p25p2 import (P25P2FragmentAssembler,
                                             P25P2Framer)
    from sdrtrunk_jax.protocol.p25p2.timeslot import (facch_encode,
                                                      voice4_encode)

    wacn, system, nac = 0xA4BC3, 0x123, 0x29A
    rng = np.random.default_rng(3)
    asm = P25P2FragmentAssembler(wacn, system, nac)
    info = rng.integers(0, 2, 156).astype(np.uint8)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    timeslots = [facch_encode(info), voice4_encode(frames),
                 facch_encode(info), voice4_encode(frames)]
    frag_bits = asm.assemble(0, timeslots)
    tx_dibits = np.concatenate([
        rng.integers(0, 4, 300).astype(np.uint8),
        P25P2FragmentAssembler.to_dibits([frag_bits]),
        np.zeros(40, np.uint8),
    ])
    fs = 50000.0
    iq = generators.lsm_modulate(tx_dibits, fs, symbol_rate=6000.0 * 1.005)
    t = np.arange(len(iq)) / fs
    iq = (iq * np.exp(2j * np.pi * 250.0 * t)).astype(np.complex64)
    dec = P25P2Decoder(P25P2Config(sample_rate=fs))
    assert dec.config.timing == "gardner"
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    rx = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    frags = P25P2Framer(wacn, system, nac).process(rx)
    assert len(frags) == 1
    assert np.array_equal(frags[0].timeslots[0].mac_octets, info)
    assert np.array_equal(frags[0].timeslots[1].voice_frames, frames)
