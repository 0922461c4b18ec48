"""Bank-mode orchestrator: the 1000-channel scaling tier must deliver
the SAME product behavior as the per-slot path — traffic following,
message decode, audio segments, teardown — on the identical capture
test_orchestrator.py drives through the per-slot path."""
import json

import numpy as np
import pytest

from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.runtime.identifiers import IdentifierRole
from sdrtrunk_jax.runtime.orchestrator import Orchestrator
from sdrtrunk_jax.signal import generators

import test_orchestrator as to


@pytest.fixture(scope="module")
def bank_run():
    duration_s = 2.6
    total_dibits = int(duration_s * to.BAUD)
    rng = np.random.default_rng(7)
    voice = [rng.integers(0, 2, (9, 144)).astype(np.uint8)
             for _ in range(2)]

    n = None
    wide = None
    for offset, dibits in (
            (to.CONTROL_OFF, to._control_stream(total_dibits)),
            (to.TRAFFIC_OFF, to._traffic_stream(total_dibits, voice))):
        iq = generators.c4fm_modulate(dibits, to.FS)
        if wide is None:
            n = len(iq) // 64 * 64
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / to.FS
        wide += (iq[:n] * np.exp(2j * np.pi * offset * t)
                 ).astype(np.complex64)

    # feed as int8 IQ pairs — the live wire format of bank mode
    scale = float(np.max(np.abs(np.stack([wide.real, wide.imag]))))
    iq8 = np.clip(np.stack([wide.real, wide.imag], -1) / scale * 120.0,
                  -127, 127).astype(np.int8)

    pos = 0

    def source(num):
        nonlocal pos
        chunk = iq8[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    metrics_lines = []
    orch = Orchestrator(
        source, to.FS, to.CENTER_HZ, [to.CONTROL_OFF], slots=4,
        chunk_samples=64 * 256, idle_teardown_seconds=0.6,
        metrics_sink=metrics_lines.append, bank_mode=True)
    orch.run()
    return orch, voice, metrics_lines


def test_bank_grant_activates_traffic_channel(bank_run):
    orch, _, _ = bank_run
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert orch.bank_mode and orch.bank_proc is not None
    assert not orch.skipped_grants
    assert [e for e in orch.events
            if e.frequency_hz == pytest.approx(freq)]
    status = orch.channel_status()
    traffic = [s for s in status
               if not s["control"] and s["frequency_hz"] == freq]
    assert traffic and traffic[0]["frames"] >= 4


def test_bank_voice_becomes_audio_segment(bank_run):
    orch, _, _ = bank_run
    segs = [s for s in orch.audio_segments if s.duration > 0]
    assert len(segs) == 1
    assert segs[0].duration == pytest.approx(18 * 0.020)
    tgs = [i.value for i in segs[0].identifiers.all()
           if i.role == IdentifierRole.TO]
    assert to.GROUP in tgs


def test_bank_idle_teardown_frees_slot(bank_run):
    orch, _, _ = bank_run
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert freq not in orch.traffic.active
    slot = next(s for s in orch.slots
                if not s.is_control and s.frequency_hz == freq)
    assert not slot.active


def test_bank_metrics_stream(bank_run):
    _, _, lines = bank_run
    assert len(lines) > 50
    peak = max(json.loads(l)["active_channels"] for l in lines)
    assert peak == 2
    assert json.loads(lines[-1])["active_channels"] == 1


@pytest.mark.parametrize("audio_format", ["mulaw8", "int16"])
def test_analog_bank_audio_segments(audio_format):
    """NBFM bank mode: device ships companded-8-bit (default) or int16
    (PCIe) PCM + packed gate; host assembles per-slot AudioSegments
    (the analog leg of the 1000-channel target at CPU test scale)."""
    fs = 32 * 12500.0
    m = 32
    rng = np.random.default_rng(3)
    dur = 1.2
    n = int(fs * dur) // (m * 25) * (m * 25)
    t = np.arange(n) / fs
    wide = np.zeros(n, np.complex64)
    from sdrtrunk_jax.signal.generators import nbfm_modulate
    offs = [2 * 12500.0, -5 * 12500.0]
    for k, off in enumerate(offs):
        audio_in = 0.8 * np.sin(2 * np.pi * (500.0 + 300 * k)
                                * np.arange(int(8000 * dur)) / 8000.0)
        iq = nbfm_modulate(audio_in, 8000.0, fs)[:n]
        wide[:len(iq)] += (iq * np.exp(2j * np.pi * off * t[:len(iq)])
                           ).astype(np.complex64)
    scale = float(np.max(np.abs(np.stack([wide.real, wide.imag])))) or 1.0
    iq8 = np.clip(np.stack([wide.real, wide.imag], -1) / scale * 120.0,
                  -127, 127).astype(np.int8)

    pos = 0

    def source(num):
        nonlocal pos
        c = iq8[pos:pos + num]
        pos += num
        return c if len(c) == num else None

    orch = Orchestrator(source, fs, 460e6, [offs[0]], slots=4,
                        decoder="nbfm", chunk_samples=m * 25 * 32,
                        ppm_correction=False, bank_mode=True,
                        audio_format=audio_format)
    orch._activate(460e6 + offs[1], __import__(
        "sdrtrunk_jax.runtime.identifiers",
        fromlist=["IdentifierCollection"]).IdentifierCollection())
    orch.run()
    for slot in orch.slots:
        if slot.active:
            orch._slot_flush_drain(slot)
    segs = [s for s in orch.audio_segments if s.duration > 0.2]
    assert len(segs) >= 2
    # audio content survives the PCM + gate packing round trip
    pcm = segs[0].samples
    spec = np.abs(np.fft.rfft(pcm[800:]))
    peak = np.fft.rfftfreq(len(pcm) - 800, 1 / 8000.0)[int(np.argmax(spec))]
    assert 350.0 < peak < 950.0


def test_dmr_bank_grant_voice_teardown():
    """DMR bank mode end to end: TSCC CSBK grants on the control slot
    activate a traffic slot whose AMBE voice superframe becomes an
    AudioSegment — the DMR leg of the 1000-channel tier at CPU test
    scale (bank framer + DMRBankProcessor instead of per-slot
    framers)."""
    from sdrtrunk_jax.protocol.bits import from_int
    from sdrtrunk_jax.protocol.dmr.csbk import csbk_encode
    from sdrtrunk_jax.protocol.dmr.framer import (DataType,
                                                  DMRBurstAssembler)
    from sdrtrunk_jax.protocol.dmr.sync import DMRSyncPattern
    from sdrtrunk_jax.runtime.traffic import FrequencyBand
    from test_multibank import _dmr_voice_stream, DMR_GROUP

    fs = to.FS
    total_dibits = int(2.6 * to.BAUD)
    rng = np.random.default_rng(31)
    asm = DMRBurstAssembler(color_code=1)
    grant_bits = np.zeros(64, np.uint8)
    grant_bits[0:12] = from_int(to.CHAN_NUM, 12)     # Tier III channel
    grant_bits[16:40] = from_int(DMR_GROUP, 24)
    grant_bits[40:64] = from_int(0x12345, 24)
    grant = asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                           DataType.CSBK, csbk_encode(0x31, grant_bits))
    aloha = asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                           DataType.CSBK,
                           csbk_encode(0x19, np.zeros(64, np.uint8)))
    parts = [rng.integers(0, 4, 140).astype(np.uint8),
             DMRBurstAssembler.to_dibits([aloha])]
    for _ in range(8):
        parts += [DMRBurstAssembler.to_dibits([grant]),
                  rng.integers(0, 4, 500).astype(np.uint8)]
    control = to._pad_to(np.concatenate(parts), total_dibits, rng)

    traffic_stream = _dmr_voice_stream(total_dibits)
    n = None
    wide = None
    for off, dibits in ((to.CONTROL_OFF, control),
                        (to.TRAFFIC_OFF, traffic_stream)):
        iq = generators.c4fm_modulate(dibits, fs)
        if wide is None:
            n = len(iq) // (64 * 256) * (64 * 256)
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / fs
        wide += (iq[:n] * np.exp(2j * np.pi * off * t)
                 ).astype(np.complex64)

    pos = 0

    def source(num):
        nonlocal pos
        chunk = wide[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    orch = Orchestrator(source, fs, to.CENTER_HZ, [to.CONTROL_OFF],
                        slots=4, decoder="dmr",
                        chunk_samples=64 * 256,
                        idle_teardown_seconds=0.8, bank_mode=True)
    orch.traffic.update_band(FrequencyBand(
        identifier=0, base_frequency_hz=to.BASE_HZ,
        channel_spacing_hz=12500.0))
    orch.run()
    for slot in orch.slots:
        if slot.active:
            orch._slot_flush_drain(slot)

    freq = to.BASE_HZ + to.CHAN_NUM * 12500.0
    assert [e for e in orch.traffic.events
            if e.frequency_hz == pytest.approx(freq)]
    status = orch.channel_status()
    traffic = [s for s in status
               if not s["control"] and s["frequency_hz"] == freq]
    assert traffic and traffic[0]["frames"] >= 6
    segs = [s for s in orch.audio_segments if s.duration > 0]
    assert segs, "DMR AMBE voice must become an AudioSegment"


@pytest.fixture(scope="module")
def bank_run_int4(bank_run):
    """The SAME capture through ingest_format='int4' (packed 4-bit IQ,
    one byte/sample): the constant-envelope C4FM scene must decode
    identically — grant followed, same call audio — despite the ~25 dB
    quantization floor (VERDICT r4 item 6 slow-link wire format)."""
    duration_s = 2.6
    total_dibits = int(duration_s * to.BAUD)
    rng = np.random.default_rng(7)
    voice = [rng.integers(0, 2, (9, 144)).astype(np.uint8)
             for _ in range(2)]
    n = None
    wide = None
    for offset, dibits in (
            (to.CONTROL_OFF, to._control_stream(total_dibits)),
            (to.TRAFFIC_OFF, to._traffic_stream(total_dibits, voice))):
        iq = generators.c4fm_modulate(dibits, to.FS)
        if wide is None:
            n = len(iq) // 64 * 64
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / to.FS
        wide += (iq[:n] * np.exp(2j * np.pi * offset * t)
                 ).astype(np.complex64)
    scale = float(np.max(np.abs(np.stack([wide.real, wide.imag]))))
    iq8 = np.clip(np.stack([wide.real, wide.imag], -1) / scale * 120.0,
                  -127, 127).astype(np.int8)
    pos = 0

    def source(num):
        nonlocal pos
        chunk = iq8[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    orch = Orchestrator(
        source, to.FS, to.CENTER_HZ, [to.CONTROL_OFF], slots=4,
        chunk_samples=64 * 256, idle_teardown_seconds=0.6,
        bank_mode=True, ingest_format="int4")
    orch.run()
    return orch


def test_int4_ingest_decodes_like_int8(bank_run, bank_run_int4):
    ref, _, _ = bank_run
    orch = bank_run_int4
    freq = to.CENTER_HZ + to.TRAFFIC_OFF
    assert not orch.skipped_grants
    assert [e for e in orch.events
            if e.frequency_hz == pytest.approx(freq)]
    segs = [s for s in orch.audio_segments if s.duration > 0]
    ref_segs = [s for s in ref.audio_segments if s.duration > 0]
    assert len(segs) == len(ref_segs) == 1
    assert segs[0].duration == pytest.approx(ref_segs[0].duration)
    # frame counts within a frame of the int8 run (acquisition edges)
    f4 = sum(s["frames"] for s in orch.channel_status())
    f8 = sum(s["frames"] for s in ref.channel_status())
    assert f4 >= f8 - 2, (f4, f8)


def test_lsm_bank_mode_decodes():
    """LSM (CQPSK) rides the P25P1 bank tier: Gardner demod on device,
    the same 4-pattern sync correlation + P25P1BankFramer on host
    (round-5 _BANK_KINDS addition)."""
    from sdrtrunk_jax.protocol.p25p1.duid import DUID
    from sdrtrunk_jax.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode

    fs = 32 * 12500.0
    m = 32
    rng = np.random.default_rng(5)
    asm = P25P1FrameAssembler(nac=0x293)
    tsbk = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    total = int(2.0 * 4800)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)] + [tsbk] * 6
    stream = np.concatenate(parts)
    stream = np.concatenate(
        [stream, rng.integers(0, 4, total - len(stream)).astype(np.uint8)])
    iq = generators.lsm_modulate(stream, fs)
    off = 3 * 12500.0
    n = len(iq) // m * m
    t = np.arange(n) / fs
    wide = (iq[:n] * np.exp(2j * np.pi * off * t)).astype(np.complex64)
    iq8 = np.clip(np.stack([wide.real, wide.imag], -1) * 100.0,
                  -127, 127).astype(np.int8)
    pos = 0

    def source(num):
        nonlocal pos
        c = iq8[pos:pos + num]
        pos += num
        return c if len(c) == num else None

    orch = Orchestrator(source, fs, 460e6, [off], slots=4,
                        decoder="lsm", chunk_samples=m * 256,
                        ppm_correction=False, bank_mode=True)
    orch.run()
    assert orch.bank_mode
    status = orch.channel_status()
    ctrl = next(s for s in status if s["control"])
    assert ctrl["frames"] >= 4


def test_ltr_mixed_bank_mode():
    """LTR rides the MIXED bank leg (round-5 analog-trunking tier):
    companded voice + gates + compacted 300-baud FSK bits in one
    transfer; per-slot LTR framers decode OSWs and voice assembles."""
    from sdrtrunk_jax.protocol.ltr.messages import ltr_encode_word
    from test_ltr import _fsk_modulate
    from sdrtrunk_jax.signal import generators as gen

    fs = 32 * 12500.0
    m = 32
    rng = np.random.default_rng(11)
    words = [ltr_encode_word(0, 5, 5, 77, 5)] * 30
    bits = np.concatenate([rng.integers(0, 2, 25).astype(np.uint8)]
                          + words)
    data = _fsk_modulate(bits, amplitude=0.35)
    dur = 2.0
    need = int(8000 * dur)
    data = np.tile(data, need // len(data) + 1)[:need]
    voice = 0.5 * np.sin(2 * np.pi * 800.0 * np.arange(need) / 8000.0)
    iq = gen.nbfm_modulate(data + voice, 8000.0, fs)
    off = 2 * 12500.0
    chunk = m * 125
    n = len(iq) // chunk * chunk
    t = np.arange(n) / fs
    wide = (iq[:n] * np.exp(2j * np.pi * off * t)).astype(np.complex64)
    iq8 = np.clip(np.stack([wide.real, wide.imag], -1) * 110.0,
                  -127, 127).astype(np.int8)
    pos = 0

    def source(num):
        nonlocal pos
        c = iq8[pos:pos + num]
        pos += num
        return c if len(c) == num else None

    orch = Orchestrator(source, fs, 460e6, [off], slots=4,
                        decoder="ltr", ppm_correction=False,
                        bank_mode=True)
    assert orch.bank_mixed
    orch.run()
    for slot in orch.slots:
        if slot.active:
            orch._slot_flush_drain(slot)
    ctrl = next(s for s in orch.channel_status() if s["control"])
    assert ctrl["frames"] >= 5, ctrl     # OSW CALL words decoded
    proc = orch.bank_proc.procs[0]
    assert any(m.message_type.value == "CALL" for m in proc.messages)
    segs = [s for s in orch.audio_segments if s.duration > 0.2]
    assert segs                          # voice assembled


def test_mpt1327_mixed_bank_mode():
    """MPT1327 control channel through the mixed bank leg: 1200-baud
    AFSK codewords decode via the per-slot framer at bank scale."""
    from sdrtrunk_jax.protocol.mpt1327 import (SYNC_CONTROL,
                                               mpt_encode_codeword)
    from test_mpt1327 import _afsk_modulate, _alh_data
    from sdrtrunk_jax.signal import generators as gen

    fs = 32 * 12500.0
    m = 32
    rng = np.random.default_rng(13)
    frame = np.concatenate([
        rng.integers(0, 2, 24).astype(np.uint8),
        SYNC_CONTROL, mpt_encode_codeword(_alh_data()),
    ])
    bits = np.tile(frame, 30)
    audio = _afsk_modulate(bits)
    dur = 2.0
    need = int(8000 * dur)
    audio = np.tile(audio, need // len(audio) + 1)[:need]
    iq = gen.nbfm_modulate(0.7 * audio, 8000.0, fs)
    off = -3 * 12500.0
    chunk = m * 125
    n = len(iq) // chunk * chunk
    t = np.arange(n) / fs
    wide = (iq[:n] * np.exp(2j * np.pi * off * t)).astype(np.complex64)
    iq8 = np.clip(np.stack([wide.real, wide.imag], -1) * 110.0,
                  -127, 127).astype(np.int8)
    pos = 0

    def source(num):
        nonlocal pos
        c = iq8[pos:pos + num]
        pos += num
        return c if len(c) == num else None

    orch = Orchestrator(source, fs, 460e6, [off], slots=4,
                        decoder="mpt1327", ppm_correction=False,
                        bank_mode=True)
    assert orch.bank_mixed
    orch.run()
    ctrl = next(s for s in orch.channel_status() if s["control"])
    assert ctrl["frames"] >= 3, ctrl
    proc = orch.bank_proc.procs[0]
    assert any(m.message_type.value == "ALH" for m in proc.messages)


def test_bank_worker_process_matches_in_process(bank_run):
    """host_process=True moves the whole bank host layer (framer +
    decoder states + traffic manager) into a worker process; the same
    capture must produce the same product outcome as the in-process
    bank run — grant followed, same call audio, teardown —
    (runtime/bank_worker.py; the GIL-parallel live tier)."""
    ref, _, _ = bank_run
    duration_s = 2.6
    total_dibits = int(duration_s * to.BAUD)
    rng = np.random.default_rng(7)
    voice = [rng.integers(0, 2, (9, 144)).astype(np.uint8)
             for _ in range(2)]
    n = None
    wide = None
    for offset, dibits in (
            (to.CONTROL_OFF, to._control_stream(total_dibits)),
            (to.TRAFFIC_OFF, to._traffic_stream(total_dibits, voice))):
        iq = generators.c4fm_modulate(dibits, to.FS)
        if wide is None:
            n = len(iq) // 64 * 64
            wide = np.zeros(n, np.complex64)
        t = np.arange(n) / to.FS
        wide += (iq[:n] * np.exp(2j * np.pi * offset * t)
                 ).astype(np.complex64)
    scale = float(np.max(np.abs(np.stack([wide.real, wide.imag]))))
    iq8 = np.clip(np.stack([wide.real, wide.imag], -1) / scale * 120.0,
                  -127, 127).astype(np.int8)
    pos = 0

    def source(num):
        nonlocal pos
        chunk = iq8[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    metrics_lines = []
    orch = Orchestrator(
        source, to.FS, to.CENTER_HZ, [to.CONTROL_OFF], slots=4,
        chunk_samples=64 * 256, idle_teardown_seconds=0.6,
        metrics_sink=metrics_lines.append, bank_mode=True,
        host_process=True)
    try:
        orch.run()
        freq = to.CENTER_HZ + to.TRAFFIC_OFF
        assert not orch.skipped_grants
        assert [e for e in orch.events
                if e.frequency_hz == pytest.approx(freq)]
        segs = [s for s in orch.audio_segments if s.duration > 0]
        ref_segs = [s for s in ref.audio_segments if s.duration > 0]
        assert len(segs) == len(ref_segs) == 1
        assert segs[0].duration == pytest.approx(ref_segs[0].duration)
        tgs = [i.value for i in segs[0].identifiers.all()
               if i.role == IdentifierRole.TO]
        assert to.GROUP in tgs
        # traffic slot torn down after the call, like in-process
        slot = next(s for s in orch.slots
                    if not s.is_control and s.frequency_hz == freq)
        assert not slot.active
        status = orch.channel_status()
        f_worker = sum(s["frames"] for s in status)
        f_ref = sum(s["frames"] for s in ref.channel_status())
        assert f_worker == f_ref, (f_worker, f_ref)
    finally:
        orch.close()
