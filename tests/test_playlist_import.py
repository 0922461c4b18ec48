"""Reference PlaylistV2 XML import: a synthesized playlist in the exact
Jackson-XML shape PlaylistManager.java:450 writes must load into
config.py dataclasses with every field carried over."""
import numpy as np
import pytest

from sdrtrunk_jax.playlist_import import import_playlist_xml

_XML = """<?xml version="1.0" encoding="UTF-8" standalone="yes"?>
<playlist version="2">
  <alias name="County Fire" list="Main" group="Fire" color="-65536"
         iconName="Fire">
    <id xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="talkgroup" protocol="APCO25" value="4571"/>
    <id xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="priority" priority="3"/>
    <id xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="record"/>
    <id xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="broadcastChannel" channel="MyFeed"/>
  </alias>
  <alias name="PD Range" list="Main" group="Police">
    <id xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="talkgroupRange" protocol="APCO25" min="5000"
        max="5099"/>
  </alias>
  <channel system="County" site="North" name="Control" enabled="true"
           order="1">
    <alias_list_name>Main</alias_list_name>
    <decode_configuration
        xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="decodeConfigP25Phase1" modulation="C4FM"
        ignore_data_calls="false" traffic_channel_pool_size="20"/>
    <source_configuration
        xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="sourceConfigTuner" frequency="460125000"
        source_type="TUNER"/>
    <record_configuration>
      <recorder>DEMODULATED_BIT_STREAM</recorder>
      <recorder>BASEBAND</recorder>
    </record_configuration>
    <event_log_configuration>
      <logger>DECODE_EVENT</logger>
    </event_log_configuration>
  </channel>
  <channel system="County" site="North" name="FD Dispatch"
           enabled="false">
    <alias_list_name>Main</alias_list_name>
    <decode_configuration
        xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="decodeConfigNBFM" bandwidth="BW_12_5" squelch="-70"
        talkgroup="1"/>
    <source_configuration
        xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="sourceConfigTuner" frequency="154280000"/>
  </channel>
  <channel system="Sim" site="S" name="LSM Voice" enabled="true">
    <decode_configuration
        xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="decodeConfigP25Phase1" modulation="CQPSK"/>
    <source_configuration
        xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
        xsi:type="sourceConfigRecording" path="/tmp/capture.wav"/>
  </channel>
  <stream xmlns:xsi="http://www.w3.org/2001/XMLSchema-instance"
          xsi:type="icecastHTTPConfiguration" name="MyFeed"
          host="audio.example.org" port="8010" mount_point="/fire"
          password="hackme" delay="2000" enabled="true"/>
</playlist>
"""


@pytest.fixture()
def playlist(tmp_path):
    p = tmp_path / "playlist.xml"
    p.write_text(_XML)
    return import_playlist_xml(p)


def test_channels_imported(playlist):
    assert len(playlist.channels) == 3
    ctrl = playlist.channels[0]
    assert ctrl.name == "Control" and ctrl.system == "County"
    assert ctrl.enabled and ctrl.alias_list == "Main"
    assert ctrl.decode.decoder == "p25p1"
    assert ctrl.source.frequency_hz == 460_125_000.0
    assert ctrl.record.demodulated_bits and ctrl.record.baseband_iq
    assert not ctrl.record.audio
    assert ctrl.event_log.decode_events

    fd = playlist.channels[1]
    assert fd.decode.decoder == "nbfm" and not fd.enabled
    assert fd.decode.bandwidth_hz == 12_500.0
    assert fd.decode.squelch_threshold_db == -70.0

    lsm = playlist.channels[2]
    assert lsm.decode.decoder == "p25p1-lsm"        # CQPSK modulation
    assert lsm.source.source == "wave"
    assert lsm.source.path == "/tmp/capture.wav"


def test_aliases_imported(playlist):
    fire = [a for a in playlist.aliases if a.name == "County Fire"]
    assert len(fire) == 1
    a = fire[0]
    assert a.talkgroup == 4571 and a.protocol == "APCO25"
    assert a.priority == 3 and a.record and a.stream
    assert a.list_name == "Main" and a.group == "Fire"

    rng = next(a for a in playlist.aliases if a.name == "PD Range")
    assert rng.talkgroup_min == 5000 and rng.talkgroup_max == 5099


def test_streams_imported(playlist):
    assert len(playlist.streams) == 1
    s = playlist.streams[0]
    assert s.name == "MyFeed" and s.host == "audio.example.org"
    assert s.port == 8010 and s.mountpoint == "/fire"
    assert s.password == "hackme" and s.delay_seconds == 2.0


def test_imported_playlist_saves_native(playlist, tmp_path):
    """Round-trip into the native JSON format."""
    out = tmp_path / "native.json"
    playlist.save(out)
    from sdrtrunk_jax.config import Playlist
    loaded = Playlist.load(out)
    assert len(loaded.channels) == 3
    assert loaded.channels[0].decode.decoder == "p25p1"
    assert loaded.aliases and loaded.streams


def test_rejects_non_playlist(tmp_path):
    p = tmp_path / "bad.xml"
    p.write_text("<foo/>")
    with pytest.raises(ValueError):
        import_playlist_xml(p)
