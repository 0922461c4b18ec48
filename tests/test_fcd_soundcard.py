"""FCD HID control plane + sound-card capture sources."""
import struct

import numpy as np
import pytest

from sdrtrunk_jax.sources.fcd import (FCDCommand, FCDProPlusController,
                                      RecordingHid)
from sdrtrunk_jax.sources.soundcard import (MixerChannelMode, MixerManager,
                                            MixerSpec, SoundCardSource)
from sdrtrunk_jax.sources.usb import UsbError


class TestFCD:
    def test_set_frequency_report(self):
        hid = RecordingHid()
        fcd = FCDProPlusController(hid)
        fcd.set_frequency(145_000_000)
        assert hid.reports[-1] == bytes([FCDCommand.APP_SET_FREQUENCY_HZ]) \
            + struct.pack("<I", 145_000_000)
        assert fcd.frequency == 145_000_000

    def test_get_frequency_and_pll(self):
        hid = RecordingHid(responses={
            FCDCommand.APP_GET_FREQUENCY_HZ:
                bytes([FCDCommand.APP_GET_FREQUENCY_HZ, 1])
                + struct.pack("<I", 433_500_000),
            FCDCommand.APP_GET_PLL_LOCKED:
                bytes([FCDCommand.APP_GET_PLL_LOCKED, 1, 1])})
        fcd = FCDProPlusController(hid)
        assert fcd.get_frequency() == 433_500_000
        assert fcd.is_pll_locked()

    def test_failure_and_range(self):
        hid = RecordingHid(responses={
            FCDCommand.APP_SET_FREQUENCY_HZ:
                bytes([FCDCommand.APP_SET_FREQUENCY_HZ, 0])})
        fcd = FCDProPlusController(hid)
        with pytest.raises(UsbError):
            fcd.set_frequency(145_000_000)
        with pytest.raises(UsbError):
            fcd.set_frequency(10)        # below range, no HID traffic

    def test_corrections(self):
        hid = RecordingHid()
        fcd = FCDProPlusController(hid)
        fcd.set_dc_correction(-12, 34)
        assert hid.reports[-1][1:] == struct.pack("<hh", -12, 34)
        fcd.set_if_gain(20)
        with pytest.raises(UsbError):
            fcd.set_if_gain(60)


def _pcm16(values):
    return np.asarray(values, "<i2").tobytes()


class TestSoundCard:
    def test_mono_decode(self):
        data = _pcm16([0, 16384, -16384, 32767])
        src = SoundCardSource(lambda n: data, 48000)
        out = src.get_samples(4)
        np.testing.assert_allclose(
            out, [0.0, 0.5, -0.5, 32767 / 32768], atol=1e-6)

    def test_stereo_iq_decode_and_swap(self):
        data = _pcm16([16384, -16384, 0, 32767])
        src = SoundCardSource(lambda n: data, 192000,
                              MixerChannelMode.STEREO_IQ)
        out = src.get_samples(2)
        assert out.dtype == np.complex64
        np.testing.assert_allclose(out[0], 0.5 - 0.5j, atol=1e-6)
        swapped = SoundCardSource(lambda n: data, 192000,
                                  MixerChannelMode.STEREO_IQ,
                                  swap_iq=True)
        np.testing.assert_allclose(swapped.get_samples(2)[0],
                                   -0.5 + 0.5j, atol=1e-6)

    def test_remainder_carry_across_reads(self):
        # feed byte stream split at a non-frame boundary
        stream = _pcm16([100, 200, 300, 400])
        chunks = [stream[:3], stream[3:]]
        def read(n):
            return chunks.pop(0) if chunks else b""
        src = SoundCardSource(read, 8000)
        first = src.get_samples(2)
        second = src.get_samples(3)
        got = np.concatenate([first, second]) * 32768.0
        np.testing.assert_allclose(got, [100, 200, 300, 400], atol=0.5)

    def test_mixer_manager_selection(self):
        mgr = MixerManager()
        mgr.register(MixerSpec("fcd", 192000, 2),
                     lambda: (lambda n: b""))
        mgr.register(MixerSpec("mic", 48000, 1),
                     lambda: (lambda n: b""))
        iq = mgr.open("fcd")
        assert iq.mode == MixerChannelMode.STEREO_IQ
        mono = mgr.open("mic")
        assert mono.mode == MixerChannelMode.MONO
        with pytest.raises(ValueError):
            mgr.open("mic", MixerChannelMode.STEREO_IQ)
        with pytest.raises(KeyError):
            mgr.open("nope")
