"""Map service (plottable tracks -> GeoJSON) and the RadioReference
client against canned SOAP responses."""
import json

import numpy as np
import pytest

from sdrtrunk_jax.map_service import MapService
from sdrtrunk_jax.runtime.events import DecodeEvent, DecodeEventType
from sdrtrunk_jax.runtime.identifiers import (Identifier,
                                              IdentifierCollection,
                                              IdentifierRole)
from sdrtrunk_jax.service.radioreference import (LoginStatus,
                                                 RadioReferenceClient,
                                                 RadioReferenceError)


def _gps(lat, lon, radio=0x111, t=1.0):
    ids = IdentifierCollection()
    ids.update(Identifier.radio(radio, IdentifierRole.FROM))
    return DecodeEvent(event_type=DecodeEventType.GPS, time_start=t,
                       protocol="DMR", identifiers=ids,
                       location=(lat, lon))


class TestMapService:
    def test_tracks_and_geojson(self):
        svc = MapService(track_length=10)
        updates = []
        svc.add_listener(updates.append)
        svc.receive(_gps(38.0, -77.5, t=1.0))
        svc.receive(_gps(38.001, -77.501, t=2.0))
        svc.receive(_gps(40.0, -75.0, radio=0x222, t=3.0))
        # non-plottable events are ignored
        svc.receive(DecodeEvent(event_type=DecodeEventType.CALL_GROUP,
                                time_start=4.0))
        assert len(svc.tracks) == 2
        assert len(updates) == 3
        track = svc.tracks["RADIO:273"]
        assert track.location == (38.001, -77.501)
        gj = svc.to_geojson()
        assert gj["type"] == "FeatureCollection"
        points = [f for f in gj["features"]
                  if f["geometry"]["type"] == "Point"]
        lines = [f for f in gj["features"]
                 if f["geometry"]["type"] == "LineString"]
        assert len(points) == 2 and len(lines) == 1
        # GeoJSON is [lon, lat]
        assert lines[0]["geometry"]["coordinates"][0] == [-77.5, 38.0]
        json.dumps(gj)                      # serializable

    def test_track_length_bounded(self):
        svc = MapService(track_length=5)
        for i in range(20):
            svc.receive(_gps(38.0 + i * 0.001, -77.0, t=float(i)))
        track = next(iter(svc.tracks.values()))
        assert len(track.points) == 5
        assert track.location[0] == pytest.approx(38.019)

    def test_plottable_fields(self):
        """DecodeEvent carries the PlottableDecodeEvent fields; the DMR
        LRRP path sets location (asserted in test_dmr_state's GPS
        scenario) so the map service can consume those events."""
        e = _gps(38.0, -77.5)
        assert e.plottable and e.location == (38.0, -77.5)
        assert not DecodeEvent(event_type=DecodeEventType.CALL_GROUP,
                               time_start=0.0).plottable


def _soap(body: str) -> bytes:
    return (f'<?xml version="1.0"?><SOAP-ENV:Envelope xmlns:SOAP-ENV='
            f'"http://schemas.xmlsoap.org/soap/envelope/">'
            f"<SOAP-ENV:Body>{body}</SOAP-ENV:Body>"
            f"</SOAP-ENV:Envelope>").encode()


class TestRadioReference:
    def _client(self, responses):
        calls = []

        def transport(url, body, headers):
            calls.append((headers.get("SOAPAction"), body))
            return responses[headers["SOAPAction"]]

        c = RadioReferenceClient("user", "pw", transport=transport)
        return c, calls

    def test_connection_and_auth_block(self):
        c, calls = self._client({
            "getUserData": _soap("<getUserDataResponse>"
                                 "<subLevel>2</subLevel>"
                                 "<subExpireDate>2027-01-01"
                                 "</subExpireDate>"
                                 "</getUserDataResponse>")})
        assert c.test_connection() == LoginStatus.VALID_PREMIUM
        action, body = calls[0]
        assert action == "getUserData"
        assert b"<appKey>88969092</appKey>" in body
        assert b"<username>user</username>" in body

    def test_expired_account(self):
        c, _ = self._client({
            "getUserData": _soap("<r><subLevel>0</subLevel></r>")})
        assert c.test_connection() == LoginStatus.VALID_EXPIRED

    def test_fault_raises(self):
        c, _ = self._client({
            "getTrsDetails": _soap("<SOAP-ENV:Fault><faultstring>"
                                   "AUTH</faultstring></SOAP-ENV:Fault>")})
        with pytest.raises(RadioReferenceError, match="fault"):
            c.get_system(1234)

    def test_system_sites_talkgroups(self):
        c, _ = self._client({
            "getTrsDetails": _soap(
                "<r><sName>Metro P25</sName><sType>P25</sType>"
                "<sFlavor>Phase II</sFlavor><sVoice>APCO-25</sVoice></r>"),
            "getTrsSites": _soap(
                "<r><item><siteId>1</siteId><siteDescr>North"
                "</siteDescr><siteFreq><item><freq>851.0125</freq>"
                "</item><item><freq>852.5</freq></item></siteFreq>"
                "</item></r>"),
            "getTrsTalkgroups": _soap(
                "<r><item><tgDec>1001</tgDec><tgDescr>Dispatch"
                "</tgDescr><tgMode>D</tgMode></item>"
                "<item><tgDec>1002</tgDec><tgDescr>Tactical"
                "</tgDescr></item></r>"),
        })
        system = c.get_system(42)
        assert system.name == "Metro P25" and system.flavor == "Phase II"
        sites = c.get_sites(42)
        assert len(sites) == 1
        assert sites[0].frequencies == (851_012_500.0, 852_500_000.0)
        tgs = c.get_talkgroups(42)
        assert [t.decimal for t in tgs] == [1001, 1002]
        assert tgs[0].description == "Dispatch"
