"""Channel rotation monitor + decode-event logger sinks (VERDICT
round-2 item 10; reference source/tuner/channel/rotation/ and
module/log/DecodeEventLogger.java)."""
import json

import numpy as np
import pytest

from sdrtrunk_jax.runtime.events import (DecodeEvent, DecodeEventType)
from sdrtrunk_jax.runtime.eventlog import CSV_HEADER, DecodeEventLogger
from sdrtrunk_jax.runtime.identifiers import (Identifier,
                                              IdentifierCollection,
                                              IdentifierRole)
from sdrtrunk_jax.runtime.rotation import ChannelRotationMonitor
from sdrtrunk_jax.runtime.state import ChannelState


def _event(now=1.5):
    ids = IdentifierCollection()
    ids.update(Identifier.talkgroup(0x123))
    ids.update(Identifier.radio(0x456, IdentifierRole.FROM))
    e = DecodeEvent(event_type=DecodeEventType.CALL_GROUP, time_start=now,
                    protocol="APCO25", frequency_hz=460.15e6,
                    identifiers=ids, details='grant, "quoted"')
    e.end(now + 2.0)
    return e


def test_csv_logger(tmp_path):
    path = tmp_path / "events.csv"
    log = DecodeEventLogger(path)
    log.receive(_event())
    log.close()
    lines = path.read_text().splitlines()
    assert lines[0] == CSV_HEADER
    row = lines[1]
    assert row.startswith("1.500000,2000,APCO25,GROUP CALL,1110,291,")
    assert "460150000" in row
    assert '"grant, ""quoted"""' in row


def test_jsonl_logger(tmp_path):
    path = tmp_path / "events.jsonl"
    log = DecodeEventLogger(path)
    log.receive(_event())
    log.receive(_event(3.0))
    log.close()
    rows = [json.loads(l) for l in path.read_text().splitlines()]
    assert len(rows) == 2
    assert rows[0]["event"] == "GROUP CALL"
    assert rows[0]["to"] == "291"
    assert rows[0]["from"] == "1110"
    assert rows[0]["duration_ms"] == 2000.0


def test_rotation_cycles_until_active():
    rotated = []
    mon = ChannelRotationMonitor([851e6, 852e6, 853e6], rotated.append,
                                 rotation_delay=0.5)
    # no activity: rotates at each expired check, wrapping the list
    assert not mon.check(0.3)
    assert mon.check(0.6) and rotated == [852e6]
    assert not mon.check(0.9)
    assert mon.check(1.2) and rotated == [852e6, 853e6]
    assert mon.check(1.8) and rotated[-1] == 851e6      # wrapped
    # control state found: rotation stops
    mon.state(ChannelState.CONTROL, 2.0)
    assert not mon.check(2.4)
    mon.state(ChannelState.CONTROL, 2.5)
    assert not mon.check(2.9)
    # signal lost again: rotation resumes after the delay
    assert mon.check(3.1) and len(rotated) == 4


def test_rotation_delay_clamped():
    mon = ChannelRotationMonitor([1e6, 2e6], lambda f: None,
                                 rotation_delay=99.0)
    assert mon.rotation_delay == 2.0
    mon2 = ChannelRotationMonitor([1e6, 2e6], lambda f: None,
                                  rotation_delay=0.01)
    assert mon2.rotation_delay == 0.2


def test_orchestrator_rotates_to_working_control(tmp_path):
    """End-to-end: the configured first control frequency carries only
    noise; the rotation monitor cycles until it lands on the frequency
    actually transmitting P25 control, which then decodes and pins the
    rotation — and the decode events land in the CSV log."""
    from sdrtrunk_jax.protocol.bits import from_int
    from sdrtrunk_jax.protocol.p25p1.duid import DUID
    from sdrtrunk_jax.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
    from sdrtrunk_jax.runtime.orchestrator import Orchestrator
    from sdrtrunk_jax.signal import generators

    fs = 64 * 12500.0
    center = 460e6
    good_off = 50_000.0          # the live control channel
    bad_off = -50_000.0          # configured first, carries nothing
    baud = 4800.0

    rng = np.random.default_rng(3)
    asm = P25P1FrameAssembler(nac=0x293)
    rfss = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    parts = [rng.integers(0, 4, 120).astype(np.uint8)]
    while sum(len(p) for p in parts) < int(2.2 * baud):
        parts += [rfss, rng.integers(0, 4, 60).astype(np.uint8)]
    dibits = np.concatenate(parts)
    iq = generators.c4fm_modulate(dibits, fs)
    n = len(iq) // 64 * 64
    t = np.arange(n) / fs
    wide = (iq[:n] * np.exp(2j * np.pi * good_off * t)).astype(np.complex64)
    wide += (1e-4 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
             ).astype(np.complex64)
    pos = 0

    def source(num):
        nonlocal pos
        chunk = wide[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    log_path = tmp_path / "rotation_events.csv"
    orch = Orchestrator(
        source, fs, center, [bad_off], slots=2, chunk_samples=64 * 256,
        control_rotation=[center + bad_off, center + good_off],
        rotation_delay=0.5, event_log_path=str(log_path),
        ppm_correction=False)
    orch.run()

    assert orch.rotation.rotations >= 1
    ctrl = next(s for s in orch.slots if s.is_control)
    assert ctrl.frequency_hz == pytest.approx(center + good_off)
    assert ctrl.processor.frame_count > 0
    # once locked to CONTROL the monitor stops rotating away
    assert orch.rotation.current_frequency == pytest.approx(
        center + good_off)
