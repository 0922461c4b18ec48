"""Traffic channel management (role of
module/decode/p25/P25TrafficChannelManager.java:88 and the DMR/MPT1327
equivalents).

The reference spawns a new ProcessingChain per granted traffic channel; in
this design every polyphase bin is already computed, so "activating a
traffic channel" is just adding its bin to the active channel set and
tagging it with preload identifiers — this manager tracks grants, resolves
channel numbers to frequencies via IDEN_UP frequency bands, emits
channel-activation requests, and tears idle grants down.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from .events import DecodeEvent, DecodeEventType
from .identifiers import Identifier, IdentifierCollection, IdentifierRole

__all__ = ["FrequencyBand", "TrafficChannelManager", "TrafficChannel"]


@dataclass(frozen=True)
class FrequencyBand:
    """P25 IDEN_UP record (tsbk.py opcodes 0x3D/0x34)."""
    identifier: int
    base_frequency_hz: float
    channel_spacing_hz: float
    bandwidth_hz: float = 12500.0
    transmit_offset_hz: float = 0.0
    tdma_timeslots: int = 1

    def downlink_hz(self, channel_number: int) -> float:
        # TDMA protocols number logical channels timeslot-interleaved
        chan = channel_number // max(self.tdma_timeslots, 1)
        return self.base_frequency_hz + chan * self.channel_spacing_hz


@dataclass
class TrafficChannel:
    frequency_hz: float
    channel_number: int
    timeslot: int
    start_time: float
    identifiers: IdentifierCollection
    last_activity: float


class TrafficChannelManager:
    """Grant -> activation tracking for one control channel.

    on_activate(frequency_hz, identifiers) / on_teardown(frequency_hz) are
    wired by the owner (e.g. a receiver updating its channel plan).
    """

    def __init__(self, protocol: str = "APCO25",
                 max_channels: int = 64,
                 idle_teardown_seconds: float = 4.0,
                 on_activate: Callable | None = None,
                 on_teardown: Callable | None = None):
        self.protocol = protocol
        self.max_channels = max_channels
        self.idle_teardown_seconds = idle_teardown_seconds
        self.on_activate = on_activate
        self.on_teardown = on_teardown
        self.bands: dict[int, FrequencyBand] = {}
        self.active: dict[float, TrafficChannel] = {}
        self.events: list[DecodeEvent] = []
        self.event_sink: Callable | None = None   # e.g. DecodeEventLogger

    # --- frequency band (IDEN_UP) bookkeeping ---

    def update_band(self, band: FrequencyBand) -> None:
        self.bands[band.identifier] = band

    def resolve_frequency(self, band_id: int,
                          channel_number: int) -> float | None:
        band = self.bands.get(band_id)
        if band is None:
            return None
        return band.downlink_hz(channel_number)

    # --- grant processing ---

    def process_grant(self, band_id: int, channel_number: int,
                      now: float, group: int | None = None,
                      source: int | None = None, timeslot: int = 0,
                      encrypted: bool = False) -> TrafficChannel | None:
        """Handle a voice channel grant (P25TrafficChannelManager
        .processChannelGrant:229 equivalent)."""
        freq = self.resolve_frequency(band_id, channel_number)
        if freq is None:
            return None
        idents = IdentifierCollection(timeslot=timeslot)
        if group is not None:
            idents.update(Identifier.talkgroup(group, IdentifierRole.TO,
                                               self.protocol))
        if source is not None:
            idents.update(Identifier.radio(source, IdentifierRole.FROM,
                                           self.protocol))
        idents.update(Identifier.frequency(freq))

        existing = self.active.get(freq)
        if existing is not None:
            existing.last_activity = now
            existing.identifiers.update_all(idents.all())
            return existing
        if len(self.active) >= self.max_channels:
            return None
        channel = TrafficChannel(
            frequency_hz=freq, channel_number=channel_number,
            timeslot=timeslot, start_time=now, identifiers=idents,
            last_activity=now)
        self.active[freq] = channel
        event_type = (DecodeEventType.CALL_GROUP_ENCRYPTED if encrypted
                      else DecodeEventType.CALL_GROUP if group is not None
                      else DecodeEventType.CALL_UNIT_TO_UNIT)
        event = DecodeEvent(
            event_type=event_type, time_start=now, protocol=self.protocol,
            frequency_hz=freq, identifiers=idents.copy(),
            timeslot=timeslot,
            details=f"GRANT channel {channel_number}")
        self.events.append(event)
        if self.event_sink is not None:
            self.event_sink(event)
        if self.on_activate is not None:
            self.on_activate(freq, idents)
        return channel

    def process_activity(self, frequency_hz: float, now: float) -> None:
        ch = self.active.get(frequency_hz)
        if ch is not None:
            ch.last_activity = now

    def check_teardown(self, now: float) -> list[float]:
        """Tear down grants idle past the timeout
        (TrafficChannelTeardownMonitor:755 equivalent). Returns the
        frequencies torn down."""
        torn = []
        for freq, ch in list(self.active.items()):
            if now - ch.last_activity >= self.idle_teardown_seconds:
                del self.active[freq]
                torn.append(freq)
                if self.on_teardown is not None:
                    self.on_teardown(freq)
        return torn
