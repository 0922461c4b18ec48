"""Decode metrics + PPM auto-correction (SURVEY.md §5 observability;
reference FrequencyErrorCorrectionManager.java:32-143 semantics)."""
import numpy as np
import pytest

from sdrtrunk_jax.runtime.metrics import ChannelMetrics, FrequencyErrorMonitor


class _Frame:
    def __init__(self, bit_errors):
        self.bit_errors = bit_errors


def test_channel_metrics_counters():
    m = ChannelMetrics()
    m.update(1000, [_Frame(2), _Frame(0)])
    m.message(True)
    m.message(False)
    d = m.as_dict()
    assert d["dibits"] == 1000 and d["frames"] == 2
    assert d["valid_frames"] == 1 and d["corrected_bits"] == 2
    assert d["sync_rate"] == pytest.approx(2.0)
    assert d["corrected_ber"] == pytest.approx(2 / 2000)


def test_ppm_monitor_sustained_error_corrects():
    fired = []
    mon = FrequencyErrorMonitor(460e6, threshold_ppm=0.4,
                                observation_seconds=30.0,
                                on_correct=fired.append)
    err_hz = 0.6e-6 * 460e6           # +0.6 ppm, above threshold
    for t in range(0, 31, 5):
        mon.update(err_hz, float(t))
    assert len(fired) == 1
    assert fired[0] == pytest.approx(0.6, abs=0.01)
    assert mon.applied_ppm == pytest.approx(-0.6, abs=0.01)
    assert mon.correction_hz == pytest.approx(-err_hz, rel=0.02)
    # monitor resets after applying
    assert mon._window_start is None


def test_ppm_monitor_below_threshold_never_fires():
    fired = []
    mon = FrequencyErrorMonitor(460e6, on_correct=fired.append)
    for t in range(0, 100, 5):
        mon.update(0.3e-6 * 460e6, float(t))
    assert not fired


def test_ppm_monitor_polarity_flip_restarts_window():
    """Opposite-polarity readings restart the observation timer
    (FrequencyErrorCorrectionManager.updatePPM polarity branches)."""
    fired = []
    mon = FrequencyErrorMonitor(460e6, observation_seconds=30.0,
                                on_correct=fired.append)
    err = 0.6e-6 * 460e6
    for t in range(0, 25, 5):
        mon.update(err, float(t))
    mon.update(-err, 27.0)            # flip restarts at t=27
    for t in range(30, 55, 5):
        mon.update(err, float(t))     # flip again at t=30
    assert not fired                  # no 30 s same-polarity window yet
    mon.update(err, 61.0)
    assert len(fired) == 1


def test_orchestrator_ppm_correction_end_to_end():
    """A capture with a frequency-proportional oscillator error: the
    control channel's PLL measures it, the monitor corrects, and the
    mixer retune brings the residual PLL error near zero."""
    import jax.numpy as jnp

    from sdrtrunk_jax.protocol.p25p1.duid import DUID
    from sdrtrunk_jax.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
    from sdrtrunk_jax.runtime.orchestrator import Orchestrator
    from sdrtrunk_jax.signal import generators

    fs = 64 * 12500.0
    center = 460e6
    control_off = 25000.0
    ppm_true = 0.9                     # tuner reads 0.9 ppm low
    err_hz = ppm_true * 1e-6 * (center + control_off)   # ~414 Hz

    rng = np.random.default_rng(2)
    asm = P25P1FrameAssembler(nac=0x293)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)]
    for _ in range(40):
        parts += [asm.assemble(DUID.TSBK, tsbk_encode(0x3A, args)),
                  rng.integers(0, 4, 30).astype(np.uint8)]
    dibits = np.concatenate(parts)

    iq = generators.c4fm_modulate(dibits, fs)
    n = len(iq) // 64 * 64
    t = np.arange(n) / fs
    wide = (iq[:n] * np.exp(2j * np.pi * (control_off + err_hz) * t)
            ).astype(np.complex64)

    pos = 0

    def source(num):
        nonlocal pos
        chunk = wide[pos:pos + num]
        pos += num
        return chunk if len(chunk) else None

    metrics = []
    orch = Orchestrator(source, fs, center, [control_off], slots=2,
                        chunk_samples=64 * 256,
                        ppm_observation_seconds=0.4,
                        metrics_sink=metrics.append)
    orch.run()

    assert orch.ppm_monitor is not None
    assert len(orch.ppm_monitor.corrections) >= 1
    # first-pass correction from a still-settling PLL recovers most of
    # the error (the reference converges over repeated 30 s windows too)
    assert orch.correction_ppm == pytest.approx(ppm_true, abs=0.3)
    # control channel still decoding after the retune
    status = orch.channel_status()[0]
    assert status["metrics"]["valid_frames"] >= 30
    # residual PLL error after correction is small
    import json
    tail = json.loads(metrics[-1])
    assert abs(tail["pll_error_hz"]) < 120.0
    assert tail["correction_ppm"] != 0.0
