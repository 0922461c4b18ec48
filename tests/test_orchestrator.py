"""Live orchestrator integration: traffic-following end-to-end.

VERDICT round-1 item 3: a synthetic P25 control channel in a wideband
capture broadcasts IDEN_UP + a group voice grant; the Orchestrator must
dynamically activate a slot on the granted frequency WHILE RUNNING,
decode the voice call there (HDU/LDU1 with IMBE frames -> AudioSegment
via the fake codec), and tear the channel down when the call goes idle —
the ChannelProcessingManager.java:290-483 +
P25TrafficChannelManager.java:229 behavior as one deterministic loop.
"""
import numpy as np
import pytest

from sdrtrunk_jax.protocol.bits import from_int
from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.protocol.p25p1.framer import P25P1FrameAssembler
from sdrtrunk_jax.protocol.p25p1.hdu import hdu_encode, tdulc_encode
from sdrtrunk_jax.protocol.p25p1.lc import lc_build_group_voice
from sdrtrunk_jax.protocol.p25p1.ldu import ldu1_encode
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
from sdrtrunk_jax.runtime.identifiers import IdentifierRole
from sdrtrunk_jax.runtime.orchestrator import Orchestrator
from sdrtrunk_jax.signal import generators

CENTER_HZ = 460_000_000.0
CONTROL_OFF = 25_000.0          # control channel at +25 kHz (bin +2)
BASE_HZ = 460_100_000.0         # IDEN_UP base frequency
CHAN_NUM = 4                    # grant: base + 4 * 12.5 kHz = 460.15 MHz
TRAFFIC_OFF = BASE_HZ + CHAN_NUM * 12500.0 - CENTER_HZ   # +150 kHz
GROUP = 0x0457
SOURCE = 0xABCDE
FS = 64 * 12500.0
BAUD = 4800.0


def _iden_up_args() -> np.ndarray:
    """IDEN_UP (0x3D) 64-bit args: id=1, bw 12.5 kHz, offset 0,
    spacing 12.5 kHz, base 460.1 MHz (5 Hz units) — field layout per
    tsbk.py:348-355 / reference IdentifierUpdate."""
    bits = np.zeros(64, np.uint8)
    bits[0:4] = from_int(1, 4)
    bits[4:13] = from_int(100, 9)          # 12.5 kHz / 0.125
    bits[22:32] = from_int(100, 10)        # spacing 12.5 kHz / 0.125
    bits[32:64] = from_int(int(BASE_HZ / 5), 32)
    return bits


def _grant_args() -> np.ndarray:
    bits = np.zeros(64, np.uint8)
    bits[8:12] = from_int(1, 4)            # frequency band id
    bits[12:24] = from_int(CHAN_NUM, 12)
    bits[24:40] = from_int(GROUP, 16)
    bits[40:64] = from_int(SOURCE, 24)
    return bits


def _pad_to(dibits: np.ndarray, total: int, rng) -> np.ndarray:
    if len(dibits) > total:
        raise AssertionError(f"stream too long: {len(dibits)} > {total}")
    return np.concatenate(
        [dibits, rng.integers(0, 4, total - len(dibits)).astype(np.uint8)])


def _control_stream(total_dibits: int) -> np.ndarray:
    """Continuous control channel: preamble, IDEN_UP x2, GRANT x6 spread
    out (grant updates keep the traffic channel's activity fresh during
    the call), then idle filler."""
    rng = np.random.default_rng(11)
    asm = P25P1FrameAssembler(nac=0x293)
    iden = asm.assemble(DUID.TSBK, tsbk_encode(0x3D, _iden_up_args()))
    grant = asm.assemble(DUID.TSBK, tsbk_encode(0x00, _grant_args()))
    rfss = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    parts = [rng.integers(0, 4, 120).astype(np.uint8), iden, iden,
             grant, grant]
    # keep granting during the call window, then go quiet (rfss filler)
    for _ in range(4):
        parts += [rfss, grant]
    stream = np.concatenate(parts)
    return _pad_to(stream, total_dibits, rng)


def _traffic_stream(total_dibits: int, voice: list[np.ndarray]
                    ) -> np.ndarray:
    """Traffic channel: C4FM filler until ~0.7 s (covers grant latency +
    slot reacquisition), then HDU + LDUs + terminator, then filler."""
    rng = np.random.default_rng(23)
    asm = P25P1FrameAssembler(nac=0x293)
    lc = lc_build_group_voice(group=GROUP, source=SOURCE)
    mi = np.zeros(72, np.uint8)
    call = [asm.assemble(DUID.HDU, hdu_encode(mi, 0, 0x80, 0,
                                              talkgroup=GROUP))]
    call += [asm.assemble(DUID.LDU1, ldu1_encode(lc, v)) for v in voice]
    call.append(asm.assemble(DUID.TDULC, tdulc_encode(lc)))
    start = int(0.7 * BAUD)
    stream = np.concatenate(
        [rng.integers(0, 4, start).astype(np.uint8)] + call)
    return _pad_to(stream, total_dibits, rng)


@pytest.fixture(scope="module")
def run_result():
    duration_s = 2.6
    total_dibits = int(duration_s * BAUD)
    rng = np.random.default_rng(7)
    voice = [rng.integers(0, 2, (9, 144)).astype(np.uint8)
             for _ in range(2)]

    n = None
    wide = None
    for offset, dibits in ((CONTROL_OFF, _control_stream(total_dibits)),
                           (TRAFFIC_OFF, _traffic_stream(total_dibits,
                                                         voice))):
        iq = generators.c4fm_modulate(dibits, FS)
        if wide is None:
            n = len(iq) // 64 * 64
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / FS
        wide += (iq[:n] * np.exp(2j * np.pi * offset * t)
                 ).astype(np.complex64)

    pos = 0

    def source(num):
        nonlocal pos
        chunk = wide[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    metrics_lines = []
    orch = Orchestrator(
        source, FS, CENTER_HZ, [CONTROL_OFF], slots=4,
        chunk_samples=64 * 256, idle_teardown_seconds=0.6,
        metrics_sink=metrics_lines.append)
    orch.run()
    return orch, voice, metrics_lines


def test_grant_activates_traffic_channel(run_result):
    orch, _, _ = run_result
    freq = CENTER_HZ + TRAFFIC_OFF
    # the grant fired and was followed
    assert not orch.skipped_grants
    grant_events = [e for e in orch.events
                    if e.frequency_hz == pytest.approx(freq)]
    assert grant_events, [e.event_type for e in orch.events]
    # the traffic slot decoded real frames after mid-run activation
    status = orch.channel_status()
    traffic = [s for s in status
               if not s["control"] and s["frequency_hz"] == freq]
    assert traffic and traffic[0]["frames"] >= 4   # HDU + 2 LDU1 + TDULC


def test_traffic_call_messages_decoded(run_result):
    orch, _, _ = run_result
    freq = CENTER_HZ + TRAFFIC_OFF
    slot = next(s for s in orch.slots
                if not s.is_control and s.frequency_hz == freq)
    duids = [m.duid for m in slot.processor.messages if m.valid]
    assert DUID.HDU in duids and DUID.TDULC in duids
    assert duids.count(DUID.LDU1) == 2
    ldu = next(m for m in slot.processor.messages
               if m.valid and m.duid == DUID.LDU1)
    assert ldu.content.link_control.fields["group_address"] == GROUP
    assert ldu.content.link_control.fields["source_address"] == SOURCE


def test_voice_becomes_audio_segment(run_result):
    orch, voice, _ = run_result
    segs = [s for s in orch.audio_segments if s.duration > 0]
    assert len(segs) == 1
    seg = segs[0]
    # 2 LDUs x 9 IMBE frames x 20 ms through the fake codec
    assert seg.duration == pytest.approx(18 * 0.020)
    tgs = [i.value for i in seg.identifiers.all()
           if i.role == IdentifierRole.TO]
    assert GROUP in tgs


def test_idle_teardown_frees_slot(run_result):
    orch, _, _ = run_result
    freq = CENTER_HZ + TRAFFIC_OFF
    assert freq not in orch.traffic.active
    slot = next(s for s in orch.slots
                if not s.is_control and s.frequency_hz == freq)
    assert not slot.active


def test_metrics_stream(run_result):
    import json
    _, _, lines = run_result
    assert len(lines) > 50
    peak = max(json.loads(l)["active_channels"] for l in lines)
    assert peak == 2          # control + traffic during the call
    final = json.loads(lines[-1])
    assert final["active_channels"] == 1   # traffic torn down
