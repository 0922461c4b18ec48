"""Native ingest runtime tests: ring buffer semantics, converters,
threaded producer/consumer."""
import threading

import numpy as np
import pytest

from sdrtrunk_jax.io.native import (IqRingBuffer, convert_packed12_iq,
                                    convert_s16_iq, convert_u8_iq,
                                    native_available)


def test_native_library_builds():
    assert native_available(), "native libiqruntime.so should build (cc)"


def test_ring_write_read_roundtrip():
    ring = IqRingBuffer(capacity=1024)
    iq = (np.arange(100) + 1j * np.arange(100)).astype(np.complex64)
    assert ring.write(iq) == 100
    assert ring.available == 100
    out = ring.read(60)
    assert out.shape == (60, 2)
    assert np.allclose(out[:, 0], np.arange(60))
    out2 = ring.read(100)
    assert out2.shape == (40, 2)
    assert np.allclose(out2[:, 1], np.arange(60, 100))
    assert ring.available == 0


def test_ring_overflow_drops():
    ring = IqRingBuffer(capacity=128, reset_threshold=64)
    big = np.ones((200, 2), np.float32)
    written = ring.write(big)
    assert written == 128
    assert ring.dropped == 72
    assert ring.overflowed
    ring.read(100)   # drain below the reset threshold
    assert not ring.overflowed


def test_ring_wraparound():
    ring = IqRingBuffer(capacity=64)
    for i in range(10):
        block = np.full((40, 2), float(i), np.float32)
        ring.write(block)
        out = ring.read(40)
        assert np.all(out == float(i))


def test_threaded_producer_consumer():
    ring = IqRingBuffer(capacity=4096)
    total = 50_000
    received = []

    def producer():
        sent = 0
        while sent < total:
            n = min(500, total - sent)
            block = np.full((n, 2), 1.0, np.float32)
            sent += ring.write(block)   # spin until space

    t = threading.Thread(target=producer)
    t.start()
    got = 0
    while got < total:
        out = ring.read(1000)
        got += out.shape[0]
    t.join()
    assert got == total and ring.available == 0


def test_converters():
    u8 = np.array([0, 127, 128, 255], np.uint8)
    f = convert_u8_iq(u8)
    assert f[0] == pytest.approx(-1.0)
    assert abs(f[1]) < 0.01 and abs(f[2]) < 0.01
    assert f[3] == pytest.approx(1.0)

    s16 = np.array([-32768, 0, 16384], np.int16)
    g = convert_s16_iq(s16)
    assert g[0] == pytest.approx(-1.0) and g[2] == pytest.approx(0.5)

    # packed 12-bit: values 0x800 (zero), 0xFFF (max)
    packed = np.array([0x80, 0x0F, 0xFF], np.uint8)  # 0x800, 0xFFF
    h = convert_packed12_iq(packed)
    assert h[0] == pytest.approx(0.0)
    assert h[1] == pytest.approx((0xFFF - 2048) / 2048.0)
