"""Checked-in golden capture decode (VERDICT round-2 item 8): the
fixture .bits files in tests/golden/ are the float64 host oracle's
decode of fixed-seed synthesized transmissions, stored in the
reference's BinaryRecorder byte format. Every run must

  * reproduce each golden .bits BYTE-EXACTLY from the oracle (the
    oracle is plain float64 NumPy, deterministic across platforms),
  * decode each golden .bits through the framers to the checked-in
    expected event lists,
  * and agree with the device (jitted float32) decode path at the dibit
    and event level.

Regenerate with: python -m sdrtrunk_jax.parity --write-golden tests/golden
"""
import json
import os

import numpy as np
import pytest

import jax.numpy as jnp

from sdrtrunk_jax.audio.recorder import BitsReader
from sdrtrunk_jax.parity import (_dmr_events, _dmr_tx, host_c4fm_demod,
                                 host_gardner_demod)
from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.protocol.p25p1.framer import (P25P1FrameAssembler,
                                                P25P1Framer)
from sdrtrunk_jax.protocol.p25p1.messages import decode_frame
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
from sdrtrunk_jax.signal import generators

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(GOLDEN, "manifest.json")) as f:
        return json.load(f)


def _p25_tx(seed):
    rng = np.random.default_rng(seed)
    asm = P25P1FrameAssembler(nac=0x293)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)]
    for _ in range(4):
        parts += [asm.assemble(DUID.TSBK, tsbk_encode(0x3B, args)),
                  rng.integers(0, 4, 20).astype(np.uint8)]
    parts.append(np.zeros(40, np.uint8))
    return np.concatenate(parts)


def _p25_events(dibits, with_opcode=True):
    events = []
    for f in P25P1Framer().process(dibits):
        m = decode_frame(f)
        if m.valid:
            row = [m.duid.name, int(m.nac)]
            if with_opcode:
                row.append(int(m.content.opcode)
                           if hasattr(m.content, "opcode") else -1)
            events.append(row)
    return events


def test_c4fm_golden_byte_exact(manifest):
    from sdrtrunk_jax.decoders.c4fm import C4FMConfig, C4FMDecoder
    meta = manifest["c4fm"]
    fs = meta["sample_rate"]
    iq = generators.c4fm_modulate(_p25_tx(meta["seed"]),
                                  fs).astype(np.complex64)
    dec = C4FMDecoder(C4FMConfig(sample_rate=fs))
    dibits = host_c4fm_demod(iq, fs,
                             baseband_taps=np.asarray(dec.baseband_taps))
    golden = BitsReader.read(os.path.join(GOLDEN, "c4fm.bits"))
    assert np.array_equal(golden[:len(dibits)], dibits)
    assert _p25_events(dibits) == meta["events"]
    # device path agrees with the golden capture
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    dev = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    n = min(len(dev), len(dibits))
    assert float(np.mean(dev[100:n] == dibits[100:n])) > 0.999
    assert _p25_events(dev) == meta["events"]


def test_dmr_golden_byte_exact(manifest):
    from sdrtrunk_jax.decoders.dmr import DMRConfig, DMRDecoder
    meta = manifest["dmr"]
    fs = meta["sample_rate"]
    iq = generators.c4fm_modulate(_dmr_tx(meta["seed"]),
                                  fs).astype(np.complex64)
    dec = DMRDecoder(DMRConfig(sample_rate=fs))
    dibits = host_c4fm_demod(iq, fs, sample_counter_gain=0.4,
                             baseband_taps=np.asarray(dec.baseband_taps))
    golden = BitsReader.read(os.path.join(GOLDEN, "dmr.bits"))
    assert np.array_equal(golden[:len(dibits)], dibits)
    assert [[k, ts] for k, ts in _dmr_events(dibits)] == meta["events"]
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    dev = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    assert [[k, ts] for k, ts in _dmr_events(dev)] == meta["events"]


def test_lsm_golden_byte_exact(manifest):
    from sdrtrunk_jax.decoders.lsm import LSMConfig, LSMDecoder
    meta = manifest["lsm"]
    fs = meta["sample_rate"]
    iq = generators.lsm_modulate(_p25_tx(meta["seed"]),
                                 fs).astype(np.complex64)
    dec = LSMDecoder(LSMConfig(sample_rate=fs))
    dibits = host_gardner_demod(
        iq, fs, baseband_taps=np.asarray(dec.baseband_taps))
    golden = BitsReader.read(os.path.join(GOLDEN, "lsm.bits"))
    assert np.array_equal(golden[:len(dibits)], dibits)
    assert _p25_events(dibits, with_opcode=False) == meta["events"]
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    dev = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    assert _p25_events(dev, with_opcode=False) == meta["events"]
