"""Vendor message families (VERDICT round-2 item 7): Motorola/Harris
TSBKs, Motorola Connect+/Capacity+ and Hytera CSBKs, and XCMP — each
round-tripped through the real wire codec (trellis/BPTC + CRC) and the
grant-bearing ones driven closed-loop into the decoder states' traffic
managers."""
import numpy as np

from sdrtrunk_jax.protocol.bits import from_int
from sdrtrunk_jax.protocol.dmr.csbk import csbk_decode, csbk_encode
from sdrtrunk_jax.protocol.dmr.csbk_vendor import (FID_CAPACITY_PLUS,
                                                   FID_CONNECT_PLUS,
                                                   FID_HYTERA_68)
from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_decode, tsbk_encode
from sdrtrunk_jax.protocol.p25p1.tsbk_vendor import (MFID_HARRIS,
                                                     MFID_MOTOROLA)


# ------------------------------------------------------------- P25 TSBK

def test_motorola_patch_group_grant_roundtrip():
    args = np.zeros(64, np.uint8)
    args[0:8] = from_int(0x00, 8)            # service options
    args[8:12] = from_int(2, 4)              # frequency band
    args[12:24] = from_int(0x123, 12)        # channel
    args[24:40] = from_int(0xBEEF, 16)       # patch group
    args[40:64] = from_int(0x98765, 24)      # source
    t = tsbk_decode(tsbk_encode(0x02, args, mfid=MFID_MOTOROLA))
    assert t is not None
    assert t.opcode_name == "MOTOROLA_PATCH_GROUP_CHANNEL_GRANT"
    assert t.fields["patch_group"] == 0xBEEF
    assert t.fields["channel_number"] == 0x123
    assert t.fields["source_address"] == 0x98765


def test_motorola_patch_group_add_and_cwid():
    args = np.zeros(64, np.uint8)
    args[0:16] = from_int(0x1111, 16)
    args[16:32] = from_int(0x2222, 16)
    args[32:48] = from_int(0x3333, 16)
    t = tsbk_decode(tsbk_encode(0x00, args, mfid=MFID_MOTOROLA))
    assert t.opcode_name == "MOTOROLA_PATCH_GROUP_ADD"
    assert t.fields["patch_group"] == 0x1111
    assert t.fields["group_address_1"] == 0x2222
    assert t.fields["group_address_2"] == 0x3333

    # base station CWID: "KC0ABC" in 6-bit chr(v+43) characters
    cwid = "KC0ABC"
    args = np.zeros(64, np.uint8)
    for i, c in enumerate(cwid):
        args[6 * i:6 * i + 6] = from_int(ord(c) - 43, 6)
    args[48:52] = from_int(1, 4)
    args[52:64] = from_int(0x2AA, 12)
    t = tsbk_decode(tsbk_encode(0x0B, args, mfid=MFID_MOTOROLA))
    assert t.opcode_name == "MOTOROLA_BASE_STATION_ID"
    assert t.fields["cwid"] == cwid
    assert t.fields["channel_number"] == 0x2AA


def test_harris_tsbk_named():
    t = tsbk_decode(tsbk_encode(0x30, np.zeros(64, np.uint8),
                                mfid=MFID_HARRIS))
    assert t is not None
    assert t.opcode_name == "HARRIS_TDMA_SYNC"


def test_motorola_patch_grant_drives_traffic_manager():
    from sdrtrunk_jax.runtime.p25_state import P25P1DecoderState
    from sdrtrunk_jax.runtime.traffic import (FrequencyBand,
                                              TrafficChannelManager)

    traffic = TrafficChannelManager("APCO25")
    traffic.update_band(FrequencyBand(identifier=2,
                                      base_frequency_hz=851e6,
                                      channel_spacing_hz=12500.0))
    state = P25P1DecoderState(traffic=traffic)

    args = np.zeros(64, np.uint8)
    args[8:12] = from_int(2, 4)
    args[12:24] = from_int(10, 12)
    args[24:40] = from_int(0xBEEF, 16)
    args[40:64] = from_int(0x11111, 24)
    t = tsbk_decode(tsbk_encode(0x02, args, mfid=MFID_MOTOROLA))

    class _Msg:
        valid = True
        nac = 0x293
        from sdrtrunk_jax.protocol.p25p1.duid import DUID
        duid = DUID.TSBK
        content = t

    state.receive(_Msg(), now=1.0)
    assert len(traffic.active) == 1
    assert next(iter(traffic.active)) == 851e6 + 10 * 12500.0


# ------------------------------------------------------------- DMR CSBK

def test_connect_plus_voice_channel_user_roundtrip():
    d = np.zeros(64, np.uint8)
    d[0:24] = from_int(0x12345, 24)          # source
    d[24:48] = from_int(0x00067, 24)         # group
    d[48:52] = from_int(5, 4)                # repeater
    d[52] = 1                                # timeslot bit -> ts 2
    c = csbk_decode(csbk_encode(3, d, fid=FID_CONNECT_PLUS))
    assert c is not None
    assert c.opcode_name == "CONPLUS_VOICE_CHANNEL_USER"
    assert c.fields["source_address"] == 0x12345
    assert c.fields["group_address"] == 0x67
    assert c.fields["repeater"] == 5
    assert c.fields["timeslot"] == 2


def test_capacity_plus_system_status_roundtrip():
    d = np.zeros(64, np.uint8)
    d[3:7] = from_int(7, 4)                  # rest repeater
    d[7] = 1                                 # rest timeslot -> 2
    c = csbk_decode(csbk_encode(62, d, fid=FID_CAPACITY_PLUS))
    assert c.opcode_name == "CAPPLUS_SYSTEM_STATUS"
    assert c.fields["rest_repeater"] == 7
    assert c.fields["rest_timeslot"] == 2


def test_hytera_xpt_site_state_roundtrip():
    d = np.zeros(64, np.uint8)
    d[0:4] = from_int(3, 4)                  # free repeater
    d[16:24] = from_int(0x42, 8)             # repeater A ts0 address
    c = csbk_decode(csbk_encode(10, d, fid=FID_HYTERA_68))
    assert c.opcode_name == "HYTERA_XPT_SITE_STATE"
    assert c.fields["free_repeater"] == 3
    assert c.fields["repeater_a_ts0"] == 0x42


def test_connect_plus_grant_drives_traffic_manager():
    """A Con+ VOICE_CHANNEL_USER through the burst assembler + framer +
    DMRDecoderState activates the repeater's frequency (VERDICT item 7
    done-criterion: a vendor grant drives the orchestrator's traffic
    path)."""
    from sdrtrunk_jax.protocol.dmr.framer import (DataType,
                                                  DMRBurstAssembler,
                                                  DMRFramer)
    from sdrtrunk_jax.protocol.dmr.sync import DMRSyncPattern
    from sdrtrunk_jax.runtime.dmr_state import DMRDecoderState
    from sdrtrunk_jax.runtime.traffic import (FrequencyBand,
                                              TrafficChannelManager)

    traffic = TrafficChannelManager("DMR")
    traffic.update_band(FrequencyBand(identifier=0,
                                      base_frequency_hz=460e6,
                                      channel_spacing_hz=12500.0))
    state = DMRDecoderState(traffic=traffic)

    d = np.zeros(64, np.uint8)
    d[0:24] = from_int(0x12345, 24)
    d[24:48] = from_int(0x00067, 24)
    d[48:52] = from_int(4, 4)
    asm = DMRBurstAssembler(color_code=1)
    burst = asm.data_burst(DMRSyncPattern.BASE_STATION_DATA, DataType.CSBK,
                           csbk_encode(3, d, fid=FID_CONNECT_PLUS))
    rng = np.random.default_rng(1)
    dibits = np.concatenate([rng.integers(0, 4, 21).astype(np.uint8),
                             DMRBurstAssembler.to_dibits([burst])])
    for frame in DMRFramer().process(dibits):
        state.receive(frame, now=1.0)
    assert len(traffic.active) == 1
    assert next(iter(traffic.active)) == 460e6 + 4 * 12500.0
    ch = next(iter(traffic.active.values()))
    assert ch.timeslot == 1


# ------------------------------------------------------------- XCMP

def test_xcmp_over_udp():
    from sdrtrunk_jax.protocol.ip import ipv4_checksum
    from sdrtrunk_jax.protocol.ip.packets import parse_ipv4

    xcmp = bytes([0x02, 0xAA, 0xBB, 0xCC])   # NETWORK_FREQUENCY_FILE
    udp = bytes([0x0F, 0xA4, 0x0F, 0xA4, 0, 8 + len(xcmp), 0, 0]) + xcmp
    total = 20 + len(udp)
    hdr = bytearray([0x45, 0, total >> 8, total & 0xFF, 0, 0, 0, 0, 64,
                     17, 0, 0, 10, 0, 0, 1, 10, 0, 0, 2])
    cs = ipv4_checksum(bytes(hdr))
    hdr[10], hdr[11] = cs >> 8, cs & 0xFF
    pkt = parse_ipv4(bytes(hdr) + udp)
    assert pkt is not None and pkt.application is not None
    assert pkt.application.message_type_name == "NETWORK_FREQUENCY_FILE"
    assert pkt.application.payload == bytes([0xAA, 0xBB, 0xCC])
    assert "XCMP" in pkt.describe()


def test_capacity_max_aloha_fields():
    d = np.zeros(64, np.uint8)
    d[3:6] = from_int(5, 3)                  # version
    d[8:13] = from_int(0x15, 5)              # mask
    d[20:24] = from_int(9, 4)                # backoff
    d[40:64] = from_int(0xABCDE, 24)         # radio
    c = csbk_decode(csbk_encode(25, d, fid=FID_CAPACITY_PLUS))
    assert c.opcode_name == "CAPMAX_ALOHA"
    assert c.fields["version"] == 5
    assert c.fields["mask"] == 0x15
    assert c.fields["backoff"] == 9
    assert c.fields["radio"] == 0xABCDE


def test_capacity_plus_neighbors_fields():
    d = np.zeros(64, np.uint8)
    d[3:7] = from_int(4, 4)                  # rest repeater
    d[9:12] = from_int(3, 3)                 # site
    d[13:16] = from_int(2, 3)                # neighbor count
    d[16:20] = from_int(7, 4)                # neighbor 1 site
    d[20:24] = from_int(6, 4)                # neighbor 1 rest
    d[24:28] = from_int(5, 4)                # neighbor 2 site
    c = csbk_decode(csbk_encode(59, d, fid=FID_CAPACITY_PLUS))
    assert c.opcode_name == "CAPPLUS_NEIGHBOR_REPORT"
    assert c.fields["site"] == 3
    assert c.fields["neighbor_count"] == 2
    assert c.fields["neighbor_1_site"] == 7
    assert c.fields["neighbor_1_rest"] == 6
    assert c.fields["neighbor_2_site"] == 5


def test_connect_plus_data_revert_windows():
    d = np.zeros(64, np.uint8)
    d[0:7] = from_int(33, 7)                 # window
    d[8:12] = from_int(4, 4)                 # superframe
    d[12:16] = from_int(2, 4)                # repeater
    d[16:40] = from_int(0x54321, 24)         # target radio
    c = csbk_decode(csbk_encode(28, d, fid=FID_CONNECT_PLUS))
    assert c.opcode_name == "CONPLUS_DATA_WINDOW_ANNOUNCEMENT"
    assert c.fields["window"] == 33
    assert c.fields["superframe"] == 4
    assert c.fields["target_radio"] == 0x54321

    g = np.zeros(64, np.uint8)
    g[0:24] = from_int(0x54321, 24)
    g[32:36] = from_int(6, 4)
    g[54:59] = from_int(17, 5)
    c = csbk_decode(csbk_encode(29, g, fid=FID_CONNECT_PLUS))
    assert c.opcode_name == "CONPLUS_DATA_WINDOW_GRANT"
    assert c.fields["target_address"] == 0x54321
    assert c.fields["superframe"] == 6
    assert c.fields["window"] == 17


def test_hytera_xpt_preamble_fields():
    d = np.zeros(64, np.uint8)
    d[16:20] = from_int(2, 4)                # free repeater
    d[24:40] = from_int(0x1234, 16)          # target
    d[48:64] = from_int(0x4567, 16)          # source
    c = csbk_decode(csbk_encode(61, d, fid=FID_HYTERA_68))
    assert c.opcode_name == "HYTERA_XPT_PREAMBLE"
    assert c.fields["free_repeater"] == 2
    assert c.fields["target_address"] == 0x1234
    assert c.fields["source_address"] == 0x4567


# ------------------------------------------------------------- IP stack

def test_icmp_type_codes():
    from sdrtrunk_jax.protocol.ip.packets import ICMPHeader, ipv4_checksum
    from sdrtrunk_jax.protocol.ip.packets import parse_ipv4
    h = ICMPHeader.parse(bytes([8, 0, 0x12, 0x34]))
    assert h.type_code == "ECHO REQUEST"
    assert h.describe() == "ICMP ECHO REQUEST"
    assert ICMPHeader.parse(bytes([3, 3, 0, 0])).type_code == \
        "DESTINATION PORT UNREACHABLE"
    assert "UNKNOWN TYPE CODE" in \
        ICMPHeader.parse(bytes([200, 9, 0, 0])).describe()
    # through the IPV4 layer (protocol 1)
    icmp = bytes([0, 0, 0, 0, 1, 2, 3, 4])
    total = 20 + len(icmp)
    hdr = bytearray([0x45, 0, total >> 8, total & 0xFF, 0, 0, 0, 0, 64,
                     1, 0, 0, 10, 0, 0, 1, 10, 0, 0, 2])
    cs = ipv4_checksum(bytes(hdr))
    hdr[10], hdr[11] = cs >> 8, cs & 0xFF
    pkt = parse_ipv4(bytes(hdr) + icmp)
    assert pkt.transport.type_code == "ECHO REPLY"


def test_cellocator_location_status():
    import math
    import struct
    from sdrtrunk_jax.protocol.ip.cellocator import (MCGPMessageType,
                                                     parse_cellocator)
    p = bytearray(65)
    struct.pack_into("<I", p, 0, 0xDEAD01)           # unit id
    p[6] = 42                                        # numerator
    p[38] = 9                                        # satellites
    struct.pack_into("<i", p, 39, int(math.radians(-122.41) * 1e8))
    struct.pack_into("<i", p, 43, int(math.radians(37.77) * 1e8))
    struct.pack_into("<i", p, 47, 12345)             # alt cm
    struct.pack_into("<i", p, 51, 2500)              # 2500 cm/s = 90 kph
    struct.pack_into("<H", p, 55, 1571)              # ~pi/2 -> 90 deg
    p[57], p[58], p[59], p[60], p[61] = 30, 15, 12, 21, 8
    struct.pack_into(">H", p, 62, 2026)   # wire bit order (BE), like
    # the reference's UTC_TIME_YEAR read (LocationStatusMessage.java:210)
    msg = b"MCGP" + bytes([0]) + bytes(p)
    assert len(msg) == 70
    pkt = parse_cellocator(msg)
    assert pkt.message_type == MCGPMessageType.OUTBOUND_LOCATION_STATUS
    loc = pkt.content
    assert loc.unit_id == 0xDEAD01
    assert loc.message_numerator == 42
    assert loc.satellites == 9
    assert abs(loc.longitude - -122.41) < 1e-5
    assert abs(loc.latitude - 37.77) < 1e-5
    assert abs(loc.altitude_m - 123.45) < 1e-6
    assert abs(loc.speed_kph - 90.0) < 0.1
    assert abs(loc.heading_deg - 90.0) < 0.1
    assert loc.utc == (2026, 8, 21, 12, 15, 30)
    assert "CELLOCATOR RADIO:" in pkt.describe()


def test_cellocator_type_disambiguation_and_udp():
    from sdrtrunk_jax.protocol.ip import ipv4_checksum
    from sdrtrunk_jax.protocol.ip.cellocator import (MCGPMessageType,
                                                     parse_cellocator)
    from sdrtrunk_jax.protocol.ip.packets import parse_ipv4
    # type 0 at 25 bytes = inbound command; at 70 = location status
    cmd = b"MCGP" + bytes([0]) + bytes(20)
    assert parse_cellocator(cmd).message_type == \
        MCGPMessageType.INBOUND_GENERIC_COMMAND
    ack = b"MCGP" + bytes([4]) + bytes(8) + bytes(15)
    assert parse_cellocator(ack).message_type == \
        MCGPMessageType.INBOUND_GENERAL_ACKNOWLEDGE
    # over UDP port 231
    udp = bytes([0, 231, 0, 231, 0, 8 + len(cmd), 0, 0]) + cmd
    total = 20 + len(udp)
    hdr = bytearray([0x45, 0, total >> 8, total & 0xFF, 0, 0, 0, 0, 64,
                     17, 0, 0, 10, 0, 0, 1, 10, 0, 0, 2])
    cs = ipv4_checksum(bytes(hdr))
    hdr[10], hdr[11] = cs >> 8, cs & 0xFF
    pkt = parse_ipv4(bytes(hdr) + udp)
    assert pkt.application is not None
    assert "CELLOCATOR COMMAND" in pkt.application.describe()
