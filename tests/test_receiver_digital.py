"""Wideband digital (C4FM) receiver: channelize -> vmapped DQPSK -> frames.

The flagship digital path (VERDICT round-1 item 1): multiple P25P1 control
messages modulated onto different channels of one wideband capture must
decode through the batched channelizer + vmapped symbol-recovery scan with
zero dibit errors, recovered per channel by the host framer.
"""
import numpy as np
import jax.numpy as jnp

from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.protocol.p25p1.framer import P25P1FrameAssembler, P25P1Framer
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
from sdrtrunk_jax.protocol.p25p1.messages import decode_frame
from sdrtrunk_jax.receiver import WidebandReceiver
from sdrtrunk_jax.signal import generators


def _tx_dibits(opcode: int, seed: int, asm: P25P1FrameAssembler):
    rng = np.random.default_rng(seed)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    # 120-dibit preamble: acquisition transient through the channelizer
    # (filter settle + AGC window + BW_300 PLL lock) is ~80 dibits
    parts = [rng.integers(0, 4, 120).astype(np.uint8),
             asm.assemble(DUID.TSBK, tsbk_encode(opcode, args)),
             rng.integers(0, 4, 20).astype(np.uint8),
             asm.assemble(DUID.TSBK, tsbk_encode(opcode, args)),
             np.zeros(40, np.uint8)]
    return np.concatenate(parts), args


def test_wideband_c4fm_multichannel():
    m = 64
    fs = m * 12500.0
    # three active channels at different offsets, rest idle
    actives = {5: 0x3B, 17: 0x3A, 29: 0x00}
    offsets = [(i - 16) * 12500.0 for i in range(32)]

    asm = P25P1FrameAssembler(nac=0x293)
    txs = {}
    n = None
    wide = None
    for ch_idx, opcode in actives.items():
        dibits, args = _tx_dibits(opcode, seed=ch_idx, asm=asm)
        iq = generators.c4fm_modulate(dibits, fs)
        if wide is None:
            n = len(iq) // m * m
            wide = np.zeros(n, np.complex64)
        iq = iq[:n]
        t = np.arange(n) / fs
        wide += (iq * np.exp(2j * np.pi * offsets[ch_idx] * t)
                 ).astype(np.complex64)
        txs[ch_idx] = (dibits, opcode, args)

    rx = WidebandReceiver(fs, offsets, decoder="c4fm")
    step = rx.build()
    out, _ = step(jnp.asarray(wide), rx.init_state())
    dib = np.asarray(out["dibits"])
    val = np.asarray(out["valid"])

    for ch_idx, (tx, opcode, args) in txs.items():
        rx_dibits = dib[ch_idx][val[ch_idx]]
        frames = P25P1Framer().process(rx_dibits)
        assert len(frames) == 2, f"ch {ch_idx}: {[f.duid for f in frames]}"
        for frame in frames:
            msg = decode_frame(frame)
            assert msg.valid and msg.nac == 0x293
            assert msg.content.opcode == opcode
            assert np.array_equal(msg.content.args, args)
    # idle channels must not produce valid frames
    idle = [i for i in range(len(offsets)) if i not in txs][:4]
    for ch_idx in idle:
        frames = P25P1Framer().process(dib[ch_idx][val[ch_idx]])
        assert len(frames) == 0
