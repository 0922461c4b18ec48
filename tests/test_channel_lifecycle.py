"""Channel-plan lifecycle on tuner changes — the
PolyphaseChannelManager.java:328 process(SourceEvent) behavior: retunes
and sample-rate changes rebuild the runtime plan, keep in-coverage
channels, and tear down channels that fall outside the new capture.
"""
import numpy as np
import pytest

from sdrtrunk_jax.runtime.identifiers import IdentifierCollection
from sdrtrunk_jax.runtime.orchestrator import Orchestrator
from sdrtrunk_jax.sources.tuner import SourceEvent, SourceEventType

FS = 64 * 12500.0
CENTER = 460_000_000.0


def _orchestrator(**kw):
    return Orchestrator(source=lambda n: None, sample_rate=FS,
                        center_frequency_hz=CENTER,
                        control_offsets_hz=[25_000.0], slots=4,
                        ppm_correction=False, **kw)


class TestRetune:
    def test_retune_remaps_active_slots(self):
        orch = _orchestrator()
        orch._activate(CENTER + 150_000.0, IdentifierCollection())
        traffic = next(s for s in orch.slots
                       if s.active and not s.is_control)
        bins_before = orch.bins[traffic.index].copy()
        # shift the tuner down 100 kHz: all offsets grow by +100 kHz
        orch.retune(CENTER - 100_000.0)
        assert orch.center_frequency_hz == CENTER - 100_000.0
        assert traffic.active
        ch = orch.rx.channelizer
        expect = ch.channel_for_frequency(
            traffic.frequency_hz - orch.center_frequency_hz)
        assert orch.bins[traffic.index][0] == expect
        assert orch.bins[traffic.index][0] != bins_before[0]

    def test_retune_drops_out_of_coverage_traffic(self):
        orch = _orchestrator()
        orch._activate(CENTER + 150_000.0, IdentifierCollection())
        traffic = next(s for s in orch.slots
                       if s.active and not s.is_control)
        # move so the traffic channel lands outside the 800 kHz span
        orch.retune(CENTER - 300_000.0)
        assert not traffic.active
        assert traffic.frequency_hz in orch.skipped_grants

    def test_retune_that_drops_control_raises(self):
        orch = _orchestrator()
        with pytest.raises(ValueError):
            orch.retune(CENTER + 5_000_000.0)

    def test_source_event_dispatch(self):
        orch = _orchestrator()
        orch.on_source_event(SourceEvent(
            SourceEventType.FREQUENCY_CHANGE, value=CENTER + 50_000.0))
        assert orch.center_frequency_hz == CENTER + 50_000.0


class TestSampleRateChange:
    def test_rebuild_keeps_plan(self):
        orch = _orchestrator()
        orch._activate(CENTER + 150_000.0, IdentifierCollection())
        m_before = orch.rx.channelizer.channels
        orch.set_sample_rate(128 * 12500.0)
        assert orch.rx.channelizer.channels == 2 * m_before
        assert orch.chunk_samples == 16 * orch.rx.channelizer.channels
        # both control and traffic still active, mapped on the new grid
        ctrl = orch.slots[0]
        traffic = next(s for s in orch.slots
                       if s.active and not s.is_control)
        ch = orch.rx.channelizer
        for slot in (ctrl, traffic):
            expect = ch.channel_for_frequency(
                slot.frequency_hz - orch.center_frequency_hz)
            assert orch.bins[slot.index][0] == expect

    def test_event_driven_rate_change_runs_decode(self):
        """After a sample-rate rebuild the jitted step still runs."""
        orch = _orchestrator()
        orch.on_source_event(SourceEvent(
            SourceEventType.SAMPLE_RATE_CHANGE, value=32 * 12500.0))
        iq = (np.random.default_rng(0).normal(
            0, 0.01, (orch.chunk_samples, 2)) @ np.array([1, 1j])
        ).astype(np.complex64)
        out = orch.run_chunk(iq)
        assert isinstance(out, dict)


def test_error_state_stops_all_channels():
    """Tuner ERROR_STATE -> every channel stops with open calls flushed
    to AudioSegments and the run loop exits (the reference's automatic
    channel stop, ChannelProcessingManager.java:359-389)."""
    import numpy as np
    from sdrtrunk_jax.runtime.identifiers import IdentifierCollection
    from sdrtrunk_jax.runtime.orchestrator import Orchestrator
    from sdrtrunk_jax.sources.tuner import SourceEvent, SourceEventType

    fs = 32 * 12500.0
    rng = np.random.default_rng(0)
    noise = (0.01 * (rng.standard_normal(32 * 64)
                     + 1j * rng.standard_normal(32 * 64))
             ).astype(np.complex64)
    calls = [0]

    def source(num):
        calls[0] += 1
        return noise[:num]

    orch = Orchestrator(source, fs, 460e6, [25000.0], slots=3,
                        chunk_samples=32 * 64, ppm_correction=False)
    orch._activate(460e6 - 25000.0, IdentifierCollection())
    assert sum(s.active for s in orch.slots) == 2

    orch.run(max_chunks=2)
    orch.on_source_event(SourceEvent(SourceEventType.ERROR_STATE,
                                     "usb stall"))
    assert orch.error_state == "usb stall"
    assert not any(s.active for s in orch.slots)
    assert not orch.traffic.active
    before = calls[0]
    orch.run(max_chunks=5)          # must not consume further chunks
    assert calls[0] == before
