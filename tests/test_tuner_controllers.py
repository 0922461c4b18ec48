"""Hardware tuner control planes driven against a recording USB
transport: every register sequence and encoding is asserted without
hardware.
"""
import struct

import pytest

from sdrtrunk_jax.sources.airspy import (AirspyController, Command,
                                         LINEARITY_GAINS)
from sdrtrunk_jax.sources.hackrf import (HackRFController, Request,
                                         select_baseband_filter)
from sdrtrunk_jax.sources.rtl2832 import (R820TController,
                                          RTL2832Controller,
                                          SHADOW_INIT, pll_registers)
from sdrtrunk_jax.sources.usb import (RecordingTransport, TransferProcessor,
                                      TransferState, UsbError)


class TestRTL2832:
    def test_sample_rate_ratio_and_reset(self):
        t = RecordingTransport()
        rtl = RTL2832Controller(t)
        actual = rtl.set_sample_rate(2_400_000)
        assert actual == 2_400_000
        writes = t.writes()
        # ratio high bits to page-1 demod register 0x9F
        assert writes[0].value == (0x9F << 8) | 0x20
        assert writes[0].index == 0x10 | 0x1
        assert writes[0].data == (0x0300).to_bytes(2, "big")
        # low ratio register zeroed, then correction, then demod reset
        assert writes[1].value == (0xA1 << 8) | 0x20
        assert writes[-2].data == b"\x14" and writes[-1].data == b"\x10"

    def test_closest_rate_selection(self):
        t = RecordingTransport()
        assert RTL2832Controller(t).set_sample_rate(2_500_000) == 2_560_000

    def test_ppm_correction_offset(self):
        t = RecordingTransport()
        rtl = RTL2832Controller(t)
        rtl.set_sample_rate_correction(10)
        offset = int(-10 * (1 << 22) / 1_000_000)
        low, high = t.writes()[-2:]
        assert low.data[0] == offset & 0xFF
        assert high.data[0] == (offset >> 8) & 0xFF


class TestR820TPLL:
    def test_pll_math_100mhz(self):
        # 100 MHz tune -> oscillator 103.57 MHz -> divider 4 (0x80),
        # integral 27 of 1.8 MHz units above 54 MHz, fractional SDM
        regs = pll_registers(103_570_000)
        assert regs["divider"] == 0x80
        delta = 103_570_000 - 54_000_000
        integral = delta // 1_800_000
        assert integral == 27
        n = integral + 1
        assert regs["pll"] == ((n & 3) << 6) | ((n >> 2) + 4)
        frac = (delta - integral * 1_800_000) / 1_800_000
        assert regs["sdm"] == int(frac * 0x10000) & 0xFFFF

    def test_vco_fine_tune_shifts_divider(self):
        base = pll_registers(103_570_000, vco_fine_tune=2)
        lower = pll_registers(103_570_000, vco_fine_tune=1)
        higher = pll_registers(103_570_000, vco_fine_tune=3)
        assert lower["divider"] == base["divider"] - 0x20
        assert higher["divider"] == base["divider"] + 0x20

    def test_exact_integral_no_sdm(self):
        # exactly 54 MHz + 10 * 1.8 MHz -> zero fractional part
        regs = pll_registers(54_000_000 + 10 * 1_800_000)
        assert regs["sdm"] == 0


class TestR820TController:
    def _tuner(self):
        t = RecordingTransport()
        return t, R820TController(RTL2832Controller(t))

    def test_masked_write_preserves_shadow(self):
        t, r = self._tuner()
        r.set_mixer_gain(5)
        # reg 0x07 shadow 0x75, mask 0x1F -> 0x60 | 5
        assert r.shadow[0x07] == (SHADOW_INIT[0x07] & ~0x1F) | 5
        assert t.writes()[-1].data == bytes([0x07, r.shadow[0x07]])

    def test_set_frequency_register_sequence(self):
        t, r = self._tuner()
        r.set_frequency(100_000_000)
        regs = [w.data[0] for w in t.writes()]
        # ref div, autotune, vco current, divider, pll, sdm power+msb+lsb,
        # autotune variant — in R820TTunerController.setPLL order
        assert regs[:4] == [0x10, 0x1A, 0x12, 0x10]
        assert 0x14 in regs and 0x15 in regs and 0x16 in regs
        assert regs[-1] == 0x1A
        assert r.frequency == 100_000_000

    def test_frequency_out_of_range(self):
        _, r = self._tuner()
        with pytest.raises(UsbError):
            r.set_frequency(5_000_000)

    def test_init_registers_writes_5_to_31(self):
        t, r = self._tuner()
        r.init_registers()
        assert [w.data[0] for w in t.writes()] == list(range(5, 32))
        assert [w.data[1] for w in t.writes()] == SHADOW_INIT[5:]


class TestHackRF:
    def test_frequency_mhz_hz_split(self):
        t = RecordingTransport()
        h = HackRFController(t)
        h.set_frequency(145_500_000)
        w = t.writes()[-1]
        assert w.request == Request.SET_FREQUENCY
        assert w.data == struct.pack("<II", 145, 500_000)

    def test_sample_rate_sets_matching_filter(self):
        t = RecordingTransport()
        h = HackRFController(t)
        h.set_sample_rate(10_000_000)
        rate_w, filt_w = t.writes()[-2:]
        assert rate_w.data == struct.pack("<II", 10_000_000, 1)
        bw = select_baseband_filter(10_000_000)
        assert bw == 7_000_000
        assert filt_w.value == bw & 0xFFFF
        assert filt_w.index == bw >> 16

    def test_gain_validation(self):
        h = HackRFController(RecordingTransport())
        with pytest.raises(UsbError):
            h.set_lna_gain(12)         # not an 8 dB step
        with pytest.raises(UsbError):
            h.set_vga_gain(63)
        h.set_lna_gain(24)
        h.set_vga_gain(20)


class TestAirspy:
    def test_read_sample_rates(self):
        t = RecordingTransport(responses={
            (Command.GET_SAMPLE_RATES, 0, 0): struct.pack("<I", 2),
            (Command.GET_SAMPLE_RATES, 0, 2):
                struct.pack("<2I", 10_000_000, 2_500_000)})
        a = AirspyController(t)
        assert a.read_sample_rates() == [10_000_000, 2_500_000]
        a.set_sample_rate(2_500_000)           # programs the rate INDEX
        assert t.transfers[-1].index == 1
        with pytest.raises(UsbError):
            a.set_sample_rate(3_000_000)

    def test_coupled_gain_program(self):
        t = RecordingTransport(default=b"\x00")
        a = AirspyController(t)
        a.set_gain(14, "linearity")
        cmds = [(tr.request, tr.index) for tr in t.transfers]
        vga, mixer, lna = LINEARITY_GAINS[14]
        assert cmds == [
            (Command.SET_MIXER_AGC, 0), (Command.SET_LNA_AGC, 0),
            (Command.SET_VGA_GAIN, vga), (Command.SET_MIXER_GAIN, mixer),
            (Command.SET_LNA_GAIN, lna)]

    def test_frequency_encoding(self):
        t = RecordingTransport()
        a = AirspyController(t)
        a.set_frequency(433_920_000)
        assert t.writes()[-1].data == struct.pack("<I", 433_920_000)


class TestTransferProcessor:
    def test_steady_state_keeps_pipeline_full(self):
        tp = TransferProcessor(lambda: True, n_transfers=4)
        tp.start()
        assert tp.in_flight == 4
        for _ in range(10):
            tp.on_complete(True)
        assert tp.in_flight == 4 and tp.completed == 10
        assert tp.state == TransferState.RUNNING

    def test_error_storm_restarts_then_fails(self):
        tp = TransferProcessor(lambda: True, n_transfers=2,
                               max_consecutive_errors=3, max_restarts=2)
        tp.start()
        # 3 consecutive errors -> restart; repeat past max_restarts
        for _ in range(3 * 3):
            tp.on_complete(False)
        assert tp.state == TransferState.ERROR

    def test_success_resets_error_counter(self):
        tp = TransferProcessor(lambda: True, n_transfers=2,
                               max_consecutive_errors=3, max_restarts=1)
        tp.start()
        for _ in range(20):
            tp.on_complete(False)
            tp.on_complete(True)
        assert tp.state == TransferState.RUNNING


class TestE4K:
    """E4K control plane vs the reference's register semantics
    (E4KTunerController.java; completes the RTL tuner matrix)."""

    def _controller(self):
        from sdrtrunk_jax.sources.e4k import E4K_I2C_ADDRESS, E4KController
        # PLL lock bit set on every I2C read-back
        t = RecordingTransport(
            responses={(0, E4K_I2C_ADDRESS, 0x600): b"\x01"})
        return E4KController(RTL2832Controller(t)), t

    def test_pll_solution_100mhz(self):
        from sdrtrunk_jax.sources.e4k import e4k_pll_solution
        sol = e4k_pll_solution(100_000_000)
        # 100 MHz < 108.3 -> index 0x0D, scaled osc 900 kHz
        assert sol["index"] == 0x0D
        assert sol["scaled_oscillator"] == 900_000
        assert sol["z"] == 100_000_000 // 900_000
        # z*scaled + x/65536*scaled reproduces the frequency within one
        # fractional step
        assert abs(sol["actual"] - 100_000_000) <= 900_000 / 65536 + 1
        assert sol["three_phase"]

    def test_pll_52mhz_rounding_hack(self):
        from sdrtrunk_jax.sources.e4k import (E4K_MIN_FREQUENCY,
                                              e4k_pll_solution)
        sol = e4k_pll_solution(52_000_000)
        # setTunedFrequency:379-386: x bumps so actual >= 52 MHz
        assert sol["actual"] >= E4K_MIN_FREQUENCY

    def test_band_and_filter_selection(self):
        from sdrtrunk_jax.sources.e4k import e4k_band, e4k_rf_filter
        assert e4k_band(100e6) == 0          # VHF2
        assert e4k_band(200e6) == 2          # VHF3
        assert e4k_band(450e6) == 4          # UHF
        assert e4k_band(1.3e9) == 6          # L
        assert e4k_rf_filter(100_000_000) == 0       # bypass below 350M
        assert e4k_rf_filter(455_000_000) == 4       # M450 437.5-462.5M
        assert e4k_rf_filter(1_400_000_000) == 3     # M1410

    def test_set_frequency_register_sequence(self):
        from sdrtrunk_jax.sources.e4k import (BIAS, SYNTH1, SYNTH3,
                                              SYNTH4, SYNTH5, SYNTH7,
                                              e4k_pll_solution)
        e4k, t = self._controller()
        actual = e4k.set_frequency(460_000_000)
        sol = e4k_pll_solution(460_000_000)
        assert actual == sol["actual"]
        # i2c writes carry [register, value] payloads at the E4K address
        seq = [(tr.data[0], tr.data[1]) for tr in t.writes()
               if tr.value == 0xC8 and len(tr.data) == 2]
        assert (SYNTH7, sol["index"]) in seq
        assert (SYNTH3, sol["z"]) in seq
        assert (SYNTH4, sol["x"] & 0xFF) in seq
        assert (SYNTH5, (sol["x"] >> 8) & 0xFF) in seq
        # UHF band: bias 0x3, SYNTH1 band bits reset then set to 4
        assert (BIAS, 0x3) in seq
        s1 = [v for r, v in seq if r == SYNTH1]
        assert s1[-2:] == [0x00, 0x04]

    def test_pll_lock_failure_raises(self):
        from sdrtrunk_jax.sources.e4k import E4K_I2C_ADDRESS, E4KController
        t = RecordingTransport(
            responses={(0, E4K_I2C_ADDRESS, 0x600): b"\x00"})
        e4k = E4KController(RTL2832Controller(t))
        with pytest.raises(RuntimeError, match="lock"):
            e4k.set_frequency(460_000_000)

    def test_frequency_range_guard(self):
        e4k, _ = self._controller()
        with pytest.raises(ValueError):
            e4k.set_frequency(10_000_000)
        with pytest.raises(ValueError):
            e4k.set_frequency(3_000_000_000)

    def test_init_sequence(self):
        from sdrtrunk_jax.sources.e4k import (AGC4, AGC5, AGC6, CLKOUT_PWDN,
                                              MASTER1)
        e4k, t = self._controller()
        e4k.init_tuner()
        seq = [(tr.data[0], tr.data[1]) for tr in t.writes()
               if tr.value == 0xC8 and len(tr.data) == 2]
        assert seq[0] == (MASTER1, 0x07)     # reset | stby | por
        assert (CLKOUT_PWDN, 0x96) in seq
        assert (AGC4, 0x10) in seq and (AGC5, 0x04) in seq \
            and (AGC6, 0x1A) in seq

    def test_bandwidth_filter(self):
        from sdrtrunk_jax.sources.e4k import FILT2, FILT3
        e4k, t = self._controller()
        e4k.set_bandwidth(2_400_000)
        seq = [(tr.data[0], tr.data[1]) for tr in t.writes()
               if tr.value == 0xC8 and len(tr.data) == 2]
        # 2.4 MHz falls in the 2.5 MHz mixer filter class (0xE0)
        assert (FILT2, 0xE0) in seq
        assert (FILT3, 0x00) in seq          # channel filter enabled


class TestRtlLiveTuner:
    """The streaming RTL source: control-plane bring-up + bulk ingest
    through the overflow ring into _read_chunk, on a fake transport."""

    class _FakeTransport(RecordingTransport):
        def __init__(self, responses=None):
            super().__init__(responses=responses)
            rng = __import__("numpy").random.default_rng(0)
            self._chunks = 0
            self._rng = rng

        def bulk_read(self, endpoint, length):
            import numpy as np
            self._chunks += 1
            if self._chunks > 50:          # bounded stream for the test
                import time
                time.sleep(0.005)
                return b""
            return self._rng.integers(0, 256, length,
                                      dtype=np.uint8).tobytes()

        def clear_halt(self, endpoint):
            pass

    def test_r820t_live_read(self):
        import numpy as np
        from sdrtrunk_jax.sources.rtl_live import RtlLiveTuner
        t = self._FakeTransport()
        tuner = RtlLiveTuner(t, sample_rate=2_400_000,
                             frequency=450e6, ring_seconds=0.5)
        chunk = tuner._read_chunk(8192)
        tuner.stop()
        assert chunk is not None and len(chunk) == 8192
        assert chunk.dtype == np.complex64
        # u8 conversion centers around zero
        assert abs(float(np.mean(chunk.real))) < 0.05
        assert float(np.std(chunk.real)) > 0.1

    def test_e4k_live_bringup(self):
        from sdrtrunk_jax.sources.e4k import E4K_I2C_ADDRESS, SYNTH7
        from sdrtrunk_jax.sources.rtl_live import RtlLiveTuner
        t = self._FakeTransport(
            responses={(0, E4K_I2C_ADDRESS, 0x600): b"\x01"})
        tuner = RtlLiveTuner(t, sample_rate=2_400_000,
                             frequency=460e6, ring_seconds=0.5,
                             tuner_chip="e4k")
        tuner.stop()
        assert tuner.spec.name == "RTL-2832/E4000"
        seq = [(tr.data[0], tr.data[1]) for tr in t.writes()
               if tr.value == E4K_I2C_ADDRESS and len(tr.data) == 2]
        assert any(r == SYNTH7 for r, _ in seq)   # PLL got programmed
