"""libusb binding: real context init + enumeration (the library is in
the image; no tuner hardware is, so discovery returns an empty tuner
list), classification table, and bulk streaming stall recovery against
a fake transport."""
import threading
import time

import pytest

from sdrtrunk_jax.sources.libusb import (BulkStreamer, DeviceInfo,
                                         LibUsbContext, available,
                                         classify, discover_tuners)
from sdrtrunk_jax.sources.usb import TransferState, UsbError


@pytest.mark.skipif(not available(), reason="libusb-1.0 not installed")
def test_real_context_and_enumeration():
    with LibUsbContext() as ctx:
        devices = ctx.devices()
        # containers expose zero or more hub/root devices; the call must
        # succeed and every entry must carry a parseable identity
        for dev in devices:
            assert 0 <= dev.vendor_id <= 0xFFFF
            assert 0 <= dev.product_id <= 0xFFFF
        tuners = discover_tuners(ctx)
        for t in tuners:
            assert t["kind"] in ("rtl2832", "airspy", "hackrf", "fcd")


def test_classification_table():
    assert classify(0x0BDA, 0x2832) == ("rtl2832", "RTL2832 SDR")
    assert classify(0x1D50, 0x6089)[0] == "hackrf"
    assert classify(0x1D50, 0x60A1)[0] == "airspy"
    assert classify(0x04D8, 0xFB31)[0] == "fcd"
    assert classify(0x1234, 0x5678) is None
    assert str(DeviceInfo(0x0BDA, 0x2832, 1, 4)) == \
        "0BDA:2832 bus 1 addr 4"


class _FakeBulkTransport:
    """Scripted bulk endpoint: yields data, then stalls twice, then
    resumes — the USBTransferProcessor.java:235 clearHalt scenario."""

    def __init__(self, stall_after: int = 3, stalls: int = 2):
        self.reads = 0
        self.cleared = 0
        self.stall_after = stall_after
        self.stalls = stalls

    def bulk_read(self, endpoint, length):
        self.reads += 1
        if self.stall_after < self.reads <= self.stall_after + self.stalls:
            err = UsbError("stall")
            err.stalled = True
            raise err
        return bytes(length)

    def clear_halt(self, endpoint):
        self.cleared += 1


def test_bulk_streamer_recovers_from_stall():
    transport = _FakeBulkTransport()
    got = []
    done = threading.Event()

    def sink(data):
        got.append(len(data))
        if len(got) >= 8:
            done.set()

    streamer = BulkStreamer(transport, endpoint=1, sink=sink,
                            transfer_bytes=4096)
    streamer.start()
    assert done.wait(timeout=5.0)
    streamer.stop()
    assert transport.cleared == 2                   # one per stall
    assert streamer.processor.errors == 2
    assert streamer.processor.completed >= 8
    assert streamer.processor.state in (TransferState.STOPPED,)


def test_bulk_streamer_error_state_after_repeated_failures():
    class _DeadTransport:
        def bulk_read(self, endpoint, length):
            err = UsbError("gone")
            err.stalled = False
            raise err

        def clear_halt(self, endpoint):
            pass

    streamer = BulkStreamer(_DeadTransport(), endpoint=1,
                            sink=lambda d: None)
    streamer.start()
    deadline = time.time() + 5.0
    while time.time() < deadline and \
            streamer.processor.state != TransferState.ERROR:
        time.sleep(0.01)
    assert streamer.processor.state == TransferState.ERROR
    streamer.stop()
