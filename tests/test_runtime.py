"""Control-plane tests: state machine, identifiers, aliases, events,
traffic manager, and the P25 decoder-state message flow."""
import numpy as np

from sdrtrunk_jax.protocol import bits as B
from sdrtrunk_jax.protocol.p25p1 import DUID
from sdrtrunk_jax.protocol.p25p1.framer import P25P1Frame
from sdrtrunk_jax.protocol.p25p1.messages import decode_frame
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
from sdrtrunk_jax.runtime import (Alias, AliasList, ChannelState,
                                  DecodeEventType, FrequencyBand, Identifier,
                                  IdentifierCollection, StateMachine,
                                  TrafficChannelManager)
from sdrtrunk_jax.runtime.aliases import TalkgroupMatcher
from sdrtrunk_jax.runtime.identifiers import IdentifierForm, IdentifierRole
from sdrtrunk_jax.runtime.p25_state import P25P1DecoderState


def test_state_machine_transitions_and_timeouts():
    sm = StateMachine(fade_timeout=1.0, end_timeout=2.0)
    assert sm.state == ChannelState.IDLE
    assert sm.set_state(ChannelState.CALL, now=0.0)
    # illegal: CONTROL cannot go to CALL directly
    sm2 = StateMachine()
    sm2.set_state(ChannelState.CONTROL, now=0.0)
    assert not sm2.set_state(ChannelState.CALL, now=0.1)
    # timeout: CALL -> FADE -> TEARDOWN
    sm.check(now=0.5)
    assert sm.state == ChannelState.CALL
    sm.check(now=1.5)
    assert sm.state == ChannelState.FADE
    sm.check(now=4.0)
    assert sm.state == ChannelState.TEARDOWN
    # refresh keeps active
    sm3 = StateMachine(fade_timeout=1.0)
    sm3.set_state(ChannelState.CALL, now=0.0)
    sm3.set_state(ChannelState.CALL, now=0.9)
    sm3.check(now=1.5)
    assert sm3.state == ChannelState.CALL


def test_identifier_collection_latest_wins():
    ic = IdentifierCollection()
    ic.update(Identifier.talkgroup(100))
    ic.update(Identifier.talkgroup(200))
    assert ic.get(IdentifierForm.TALKGROUP).value == 200
    ic.update(Identifier.radio(7))
    assert len(ic.all()) == 2
    ic.remove(form=IdentifierForm.RADIO)
    assert len(ic.all()) == 1


def test_alias_lookup():
    alias = Alias(name="Fire Dispatch", priority=10, record=True,
                  matchers=[TalkgroupMatcher("APCO25", range_min=100,
                                             range_max=199)])
    other = Alias(name="PD", matchers=[TalkgroupMatcher("APCO25", value=500)])
    al = AliasList("test", [alias, other])
    tg = Identifier.talkgroup(150, protocol="APCO25")
    assert al.lookup(tg).name == "Fire Dispatch"
    assert al.is_recordable([tg])
    assert al.priority([tg]) == 10
    assert al.lookup(Identifier.talkgroup(500, protocol="APCO25")).name == "PD"
    assert al.lookup(Identifier.talkgroup(999, protocol="APCO25")) is None


def test_traffic_manager_grant_lifecycle():
    activated, torn = [], []
    tm = TrafficChannelManager(
        on_activate=lambda f, i: activated.append(f),
        on_teardown=lambda f: torn.append(f),
        idle_teardown_seconds=2.0)
    tm.update_band(FrequencyBand(identifier=1,
                                 base_frequency_hz=851_000_000.0,
                                 channel_spacing_hz=12500.0))
    ch = tm.process_grant(band_id=1, channel_number=40, now=0.0,
                          group=123, source=456)
    assert ch is not None
    assert ch.frequency_hz == 851_000_000.0 + 40 * 12500.0
    assert activated == [ch.frequency_hz]
    assert tm.events[0].event_type == DecodeEventType.CALL_GROUP
    # repeated grant refreshes, does not duplicate
    tm.process_grant(band_id=1, channel_number=40, now=1.0, group=123)
    assert len(tm.active) == 1
    # idle teardown
    tm.check_teardown(now=3.5)
    assert torn == [ch.frequency_hz] and not tm.active
    # unknown band -> no activation
    assert tm.process_grant(band_id=9, channel_number=1, now=0.0) is None


def _tsbk_frame(opcode: int, args: np.ndarray) -> P25P1Frame:
    from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_decode
    return P25P1Frame(nac=0x293, duid=DUID.TSBK,
                      payload=tsbk_encode(opcode, args), start=0)


def test_p25_decoder_state_flow():
    """IDEN_UP then a grant: decoder state drives the traffic manager."""
    state = P25P1DecoderState()
    # IDEN_UP: id 2, bw 12.5 kHz, spacing 12.5 kHz, base 851 MHz
    iden_args = np.concatenate([
        B.from_int(2, 4), B.from_int(100, 9), B.from_int(0, 9),
        B.from_int(100, 10), B.from_int(int(851e6 / 5), 32)])
    msg = decode_frame(_tsbk_frame(0x3D, iden_args))
    state.receive(msg, now=0.0)
    assert 2 in state.traffic.bands
    assert state.state_machine.state == ChannelState.CONTROL
    # group voice grant on band 2 channel 10
    grant_args = np.concatenate([
        B.from_int(0, 8), B.from_int(2, 4), B.from_int(10, 12),
        B.from_int(777, 16), B.from_int(888, 24)])
    msg2 = decode_frame(_tsbk_frame(0x00, grant_args))
    state.receive(msg2, now=0.1)
    assert len(state.traffic.active) == 1
    freq = list(state.traffic.active)[0]
    assert abs(freq - (851e6 + 10 * 12500.0)) < 1.0
    tc = state.traffic.active[freq]
    assert tc.identifiers.get(IdentifierForm.TALKGROUP).value == 777
    assert tc.identifiers.get(IdentifierForm.RADIO).value == 888


class TestAliasActions:
    """Beep/clip/script alias actions + interval semantics
    (alias/action/RecurringAction.java:35-145)."""

    def _setup(self):
        from sdrtrunk_jax.runtime.aliases import Alias, AliasList, \
            TalkgroupMatcher
        from sdrtrunk_jax.runtime.alias_actions import AliasActionManager
        alias = Alias(name="SWAT", matchers=[
            TalkgroupMatcher(protocol="APCO25", value=0x123)])
        mgr = AliasActionManager(AliasList("test", [alias]))
        return mgr

    def _ids(self, tg=0x123):
        from sdrtrunk_jax.runtime.identifiers import Identifier
        return [Identifier.talkgroup(tg, protocol="APCO25")]

    def test_once_fires_single_time(self):
        from sdrtrunk_jax.runtime.alias_actions import (ActionInterval,
                                                        BeepAction)
        beeps = []
        mgr = self._setup()
        mgr.add_action("SWAT", BeepAction(interval=ActionInterval.ONCE,
                                          sink=beeps.append))
        assert mgr.receive(self._ids(), "call", now=1.0) == 1
        assert mgr.receive(self._ids(), "call", now=2.0) == 0
        assert len(beeps) == 1 and "SWAT" in beeps[0]
        # non-matching talkgroup never fires
        assert mgr.receive(self._ids(0x999), "call", now=3.0) == 0

    def test_delayed_reset_rearms_after_period(self):
        from sdrtrunk_jax.runtime.alias_actions import (ActionInterval,
                                                        ClipAction)
        plays = []
        mgr = self._setup()
        mgr.add_action("SWAT", ClipAction(
            interval=ActionInterval.DELAYED_RESET, period_seconds=5.0,
            path="/clips/alert.wav", player=plays.append))
        assert mgr.receive(self._ids(), "call", now=0.0) == 1
        assert mgr.receive(self._ids(), "call", now=3.0) == 0
        assert mgr.receive(self._ids(), "call", now=5.5) == 1
        assert plays == ["/clips/alert.wav"] * 2

    def test_until_dismissed(self):
        from sdrtrunk_jax.runtime.alias_actions import (ActionInterval,
                                                        ScriptAction)
        runs = []
        mgr = self._setup()
        action = ScriptAction(interval=ActionInterval.UNTIL_DISMISSED,
                              period_seconds=2.0, script="/bin/alert.sh",
                              runner=runs.append)
        mgr.add_action("SWAT", action)
        assert mgr.receive(self._ids(), "c1", now=0.0) == 1
        assert mgr.receive(self._ids(), "c2", now=2.5) == 1
        action.dismiss()
        assert mgr.receive(self._ids(), "c3", now=5.0) == 0
        assert runs[0] == ["/bin/alert.sh", "SWAT", "c1"]


class TestHeartbeatMonitor:
    """Source stall watchdog (HeartbeatManager.java role)."""

    def test_stall_fires_once_and_recovers(self):
        from sdrtrunk_jax.runtime.heartbeat import HeartbeatMonitor
        t = [0.0]
        stalls, recovers = [], []
        mon = HeartbeatMonitor(timeout_seconds=1.0,
                               on_stall=stalls.append,
                               on_recover=lambda: recovers.append(1),
                               clock=lambda: t[0])
        mon.beat(1024)
        t[0] = 0.5
        assert mon.check() and not stalls
        t[0] = 1.6                      # 1.6 s silent -> stall
        assert not mon.check()
        assert not mon.check()          # fires once, stays stalled
        assert len(stalls) == 1 and stalls[0] > 1.0
        mon.beat(1024)                  # flow resumes
        assert not mon.stalled and recovers == [1]
        assert mon.samples == 2048 and mon.stalls == 1

    def test_stall_into_orchestrator_error_state(self):
        """Watchdog -> ERROR_STATE -> all channels stop (the full
        failure-detection loop of SURVEY §5)."""
        import numpy as np
        from sdrtrunk_jax.runtime.heartbeat import HeartbeatMonitor
        from sdrtrunk_jax.runtime.orchestrator import Orchestrator
        from sdrtrunk_jax.sources.tuner import (SourceEvent,
                                                SourceEventType)
        fs = 32 * 12500.0
        noise = np.zeros(32 * 64, np.complex64)
        orch = Orchestrator(lambda n: noise[:n], fs, 460e6, [25000.0],
                            slots=2, chunk_samples=32 * 64,
                            ppm_correction=False)
        t = [0.0]
        mon = HeartbeatMonitor(
            timeout_seconds=2.0, clock=lambda: t[0],
            on_stall=lambda silent: orch.on_source_event(SourceEvent(
                SourceEventType.ERROR_STATE,
                f"source stalled {silent:.1f}s")))
        mon.beat()
        t[0] = 5.0
        mon.check()
        assert orch.error_state is not None
        assert not any(s.active for s in orch.slots)
