"""Audio subsystem tests: segments, duplicate detection, recording
(WAV + .bits), streaming client."""
import numpy as np
import pytest

from sdrtrunk_jax.audio import (AudioSegment, BitsReader, BitsRecorder,
                                DuplicateCallDetector, read_audio_wave,
                                write_audio_wave)
from sdrtrunk_jax.audio.streaming import (AudioStreamingManager,
                                          IcecastSourceClient, StreamConfig)
from sdrtrunk_jax.runtime.identifiers import Identifier


def _segment(start=0.0, tg=100):
    seg = AudioSegment(start_time=start)
    seg.add_identifiers([Identifier.talkgroup(tg, protocol="APCO25")])
    seg.add_audio(np.sin(2 * np.pi * 800 * np.arange(1600) / 8000
                         ).astype(np.float32))
    seg.complete_segment()
    return seg


def test_segment_accumulation():
    seg = AudioSegment()
    seg.add_audio(np.ones(100, np.float32))
    seg.add_audio(np.zeros(60, np.float32))
    assert len(seg.samples) == 160
    assert seg.duration == pytest.approx(0.02)
    seg.complete_segment()
    with pytest.raises(ValueError):
        seg.add_audio(np.ones(5))


def test_duplicate_detection():
    det = DuplicateCallDetector(window_seconds=2.0)
    a = _segment(start=0.0, tg=100)
    b = _segment(start=1.0, tg=100)   # same call relayed on another channel
    c = _segment(start=1.0, tg=200)   # different talkgroup
    d = _segment(start=10.0, tg=100)  # later call, same talkgroup
    assert not det.is_duplicate(a)
    assert det.is_duplicate(b) and b.duplicate
    assert not det.is_duplicate(c)
    assert not det.is_duplicate(d)


def test_audio_wave_roundtrip(tmp_path):
    seg = _segment()
    path = tmp_path / "call.wav"
    write_audio_wave(path, seg)
    samples, rate, meta = read_audio_wave(path)
    assert rate == 8000
    assert np.allclose(samples, seg.samples, atol=1e-3)
    assert meta["identifiers"][0]["value"] == 100


def test_bits_recorder_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    dibits = rng.integers(0, 4, 1001).astype(np.uint8)
    path = tmp_path / "capture.bits"
    rec = BitsRecorder(path)
    rec.write(dibits[:500])
    rec.write(dibits[500:])
    rec.close()
    back = BitsReader.read(path)
    assert np.array_equal(back[:1001], dibits)


class _FakeSocket:
    def __init__(self):
        self.sent = b""
        self.closed = False

    def sendall(self, data):
        self.sent += data

    def recv(self, n):
        return b"HTTP/1.1 100 Continue\r\n\r\n"

    def close(self):
        self.closed = True


def test_icecast_client_and_streaming_manager():
    sock = _FakeSocket()
    client = IcecastSourceClient(
        StreamConfig(name="scanner", mountpoint="/feed", password="pw"),
        socket_factory=lambda host, port: sock)
    assert client.connect()
    assert b"PUT /feed HTTP/1.1" in sock.sent
    assert b"Authorization: Basic" in sock.sent

    mgr = AudioStreamingManager(client, delay_seconds=1.0)
    seg = _segment(start=0.0)
    mgr.receive(seg)
    dup = _segment(start=0.0)
    dup.duplicate = True
    mgr.receive(dup)                       # suppressed
    assert mgr.process(now=0.5) == 0       # still inside delay
    header_len = len(sock.sent)
    assert mgr.process(now=2.0) == 1
    assert len(sock.sent) - header_len == 2 * 1600  # PCM16 payload
    assert mgr.sent_segments == 1


def test_wave_list_info_metadata():
    """Call WAVs carry an in-container LIST-INFO chunk (the reference's
    AudioMetadataUtils tags) that survives a standard wave reader."""
    import numpy as np
    from sdrtrunk_jax.audio.recorder import (read_audio_wave,
                                             read_wave_list_info,
                                             write_audio_wave)
    from sdrtrunk_jax.audio.segments import AudioSegment
    from sdrtrunk_jax.runtime.identifiers import (Identifier,
                                                  IdentifierRole)
    import tempfile, os
    seg = AudioSegment(start_time=12.5, sample_rate=8000.0, timeslot=1)
    seg.add_audio(0.2 * np.sin(2 * np.pi * 600 *
                               np.arange(4000) / 8000.0
                               ).astype(np.float32))
    seg.identifiers.update(Identifier.talkgroup(0x457))
    seg.identifiers.update(Identifier.radio(0xABCDE,
                                            IdentifierRole.FROM))
    seg.complete_segment()
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "call.wav")
        write_audio_wave(p, seg)
        # the PCM still reads back through the normal wave reader
        samples, rate, meta = read_audio_wave(p)
        assert rate == 8000 and len(samples) == 4000
        info = read_wave_list_info(p)
        assert info["INAM"] == str(0x457)        # TO talkgroup
        assert info["IART"] == str(0xABCDE)      # FROM radio
        assert "timeslot=1" in info["ICMT"]


def test_mp2_call_recording():
    """RecordConfig audio_format='mp2': calls record as conformant
    Layer II files the independent ISO decoder accepts."""
    import numpy as np
    from sdrtrunk_jax.audio.mpeg import L2_FRAME_BYTES
    from sdrtrunk_jax.audio.recorder import write_audio_mpeg
    from sdrtrunk_jax.audio.segments import AudioSegment
    import tempfile, os, json
    seg = AudioSegment(start_time=1.0, sample_rate=8000.0)
    seg.add_audio(0.3 * np.sin(2 * np.pi * 800 *
                               np.arange(8000) / 8000.0
                               ).astype(np.float32))
    seg.complete_segment()
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "call.mp2")
        write_audio_mpeg(p, seg)
        data = open(p, "rb").read()
        assert len(data) % L2_FRAME_BYTES == 0 and len(data) > 0
        assert data[0] == 0xFF and (data[1] >> 1) & 3 == 0b10
        meta = json.loads(open(p + ".json").read())
        assert meta["duration"] > 0.9
