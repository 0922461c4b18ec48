"""P25P1 PDU packet data + expanded TSBK/LC opcode tables."""
import numpy as np
import pytest

from sdrtrunk_jax.protocol.bits import from_int
from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.protocol.p25p1.framer import (P25P1FrameAssembler,
                                                P25P1Framer)
from sdrtrunk_jax.protocol.p25p1.lc import lc_parse
from sdrtrunk_jax.protocol.p25p1.messages import decode_frame
from sdrtrunk_jax.protocol.p25p1.pdu import (assemble_packet,
                                             build_packet_blocks,
                                             pdu_decode_block,
                                             pdu_decode_header,
                                             pdu_encode_block,
                                             pdu_encode_header)
from sdrtrunk_jax.protocol.p25p1.tsbk import (decode_service_options,
                                              tsbk_decode, tsbk_encode)


def test_pdu_header_roundtrip():
    on_air = pdu_encode_header(format=22, sap=4, llid=0xABCDE,
                               blocks_to_follow=3, confirmation=True,
                               pad_octets=2)
    h = pdu_decode_header(on_air)
    assert h is not None
    assert h.format == 22 and h.format_name == "PACKET_DATA"
    assert h.sap == 4 and h.sap_name == "PACKET_DATA"
    assert h.llid == 0xABCDE
    assert h.blocks_to_follow == 3
    assert h.confirmation_required and h.outbound
    assert h.pad_octets == 2


def test_pdu_header_bit_error_correction():
    on_air = pdu_encode_header(format=22, sap=4, llid=1234,
                               blocks_to_follow=1)
    corrupted = on_air.copy()
    corrupted[[10, 50, 100]] ^= 1     # trellis corrects a few bit errors
    h = pdu_decode_header(corrupted)
    assert h is not None and h.llid == 1234


@pytest.mark.parametrize("confirmed", [False, True])
def test_pdu_data_block_roundtrip(confirmed):
    rng = np.random.default_rng(3)
    payload = rng.integers(0, 2, 128 if confirmed else 96).astype(np.uint8)
    on_air = pdu_encode_block(payload, confirmed, sequence=5)
    blk = pdu_decode_block(on_air, confirmed)
    assert blk.valid
    assert np.array_equal(blk.payload, payload)
    if confirmed:
        assert blk.sequence == 5


@pytest.mark.parametrize("confirmed", [False, True])
def test_pdu_packet_end_to_end(confirmed):
    """Full path: packet octets -> blocks -> on-air frame -> framer ->
    decode_frame -> PDUSequence -> re-assembled octets + CRC-32 pass."""
    octets = bytes(range(1, 41))
    blocks, n_blocks, pad = build_packet_blocks(octets, confirmed)
    header = pdu_encode_header(format=22, sap=4, llid=0x123456,
                               blocks_to_follow=n_blocks,
                               confirmation=confirmed, pad_octets=pad)
    payload = np.concatenate([header] + blocks)

    asm = P25P1FrameAssembler(nac=0x293)
    tx = np.concatenate([
        np.random.default_rng(0).integers(0, 4, 30).astype(np.uint8),
        asm.assemble(DUID.PDU, payload),
        np.zeros(30, np.uint8)])
    frames = P25P1Framer().process(tx)
    assert len(frames) == 1 and frames[0].duid == DUID.PDU
    msg = decode_frame(frames[0])
    assert msg.valid
    seq = msg.content
    assert seq.header.llid == 0x123456
    assert seq.complete
    result = assemble_packet(seq)
    assert result is not None
    out, crc_ok = result
    assert crc_ok
    assert out == octets


def test_tsbk_multiblock_frame():
    rng = np.random.default_rng(9)
    args1 = rng.integers(0, 2, 64).astype(np.uint8)
    args2 = rng.integers(0, 2, 64).astype(np.uint8)
    payload = np.concatenate([
        tsbk_encode(0x00, args1, last_block=False),
        tsbk_encode(0x3B, args2, last_block=True)])
    asm = P25P1FrameAssembler(nac=0x1FE)
    tx = np.concatenate([
        rng.integers(0, 4, 25).astype(np.uint8),
        asm.assemble(DUID.TSBK, payload),
        np.zeros(25, np.uint8)])
    frames = P25P1Framer().process(tx)
    assert len(frames) == 1
    msg = decode_frame(frames[0])
    assert msg.valid and msg.content.opcode == 0x00
    assert msg.siblings and msg.siblings[0].opcode == 0x3B
    assert np.array_equal(msg.siblings[0].args, args2)


def test_tsbk_opcode_fields_rfss():
    """RFSS status broadcast layout (RFSSStatusBroadcast.java:
    system at arg bits 12-24, not 8-20)."""
    args = np.zeros(64, np.uint8)
    args[0:8] = from_int(0x5A, 8)      # LRA
    args[12:24] = from_int(0x123, 12)  # system
    args[24:32] = from_int(0x42, 8)    # rfss
    args[32:40] = from_int(0x07, 8)    # site
    args[40:44] = from_int(0x2, 4)     # band
    args[44:56] = from_int(0x456, 12)  # channel
    args[56:64] = from_int(0x70, 8)    # ssc
    t = tsbk_decode(tsbk_encode(0x3A, args))
    f = t.fields
    assert f["location_registration_area"] == 0x5A
    assert f["system_id"] == 0x123
    assert f["rfss_id"] == 0x42 and f["site_id"] == 0x07
    assert f["frequency_band"] == 0x2 and f["channel_number"] == 0x456
    assert f["system_service_class"] == 0x70


def test_tsbk_opcode_names_and_breadth():
    """Every standard OSP opcode decodes with a name; grants/updates/
    status/sccb/iden all produce fields."""
    from sdrtrunk_jax.protocol.p25p1.tsbk import OSP_OPCODES, _OSP_FIELDS
    rng = np.random.default_rng(1)
    covered = 0
    for opcode in OSP_OPCODES:
        args = rng.integers(0, 2, 64).astype(np.uint8)
        t = tsbk_decode(tsbk_encode(opcode, args))
        assert t is not None and t.opcode == opcode
        assert not t.opcode_name.startswith("OPCODE_")
        if opcode in _OSP_FIELDS or opcode in (0x33, 0x34, 0x3D):
            assert t.fields, f"opcode {opcode:#x} parsed no fields"
            covered += 1
    assert covered >= 35


def test_tsbk_isp_direction():
    args = np.zeros(64, np.uint8)
    args[24:40] = from_int(0x2345, 16)   # group
    args[40:64] = from_int(0xABCDE, 24)  # source
    t = tsbk_decode(tsbk_encode(0x00, args), direction="inbound")
    assert t.opcode_name == "GRP_V_REQ"
    assert t.fields["group_address"] == 0x2345
    assert t.fields["source_address"] == 0xABCDE


def test_service_options():
    so = decode_service_options(0xC5)
    assert so["emergency"] and so["encrypted"] and not so["duplex"]
    assert so["priority"] == 5


def test_lc_opcode_table():
    """LC broadcast opcodes (0x20-0x29 block per LinkControlOpcode.java)."""
    b = np.zeros(72, np.uint8)
    b[2:8] = from_int(0x23, 6)          # RFSS_STATUS_BROADCAST
    b[8:16] = from_int(0x11, 8)         # LRA
    b[20:32] = from_int(0x123, 12)      # system
    b[32:40] = from_int(0x09, 8)        # rfss
    b[40:48] = from_int(0x05, 8)        # site
    b[48:52] = from_int(0x1, 4)
    b[52:64] = from_int(0x0AB, 12)
    lc = lc_parse(b)
    assert lc.opcode_name == "RFSS_STATUS_BROADCAST"
    assert lc.fields["system_id"] == 0x123
    assert lc.fields["rfss_id"] == 0x09 and lc.fields["site_id"] == 0x05
    assert lc.fields["channel_number"] == 0x0AB

    # IDEN_UP (CHANNEL_IDENTIFIER_UPDATE, 0x18) scaled fields
    b2 = np.zeros(72, np.uint8)
    b2[2:8] = from_int(0x18, 6)
    b2[8:12] = from_int(0x3, 4)
    b2[12:21] = from_int(100, 9)        # bandwidth 12.5 kHz
    b2[30:40] = from_int(100, 10)       # spacing 12.5 kHz
    b2[40:72] = from_int(170_000_000, 32)  # base 850 MHz
    lc2 = lc_parse(b2)
    assert lc2.fields["identifier"] == 3
    assert lc2.fields["bandwidth_khz"] == pytest.approx(12.5)
    assert lc2.fields["channel_spacing_khz"] == pytest.approx(12.5)
    assert lc2.fields["base_frequency_mhz"] == pytest.approx(850.0)


def test_pdu_ip_dispatch_lrrp():
    """P25 packet data routes into the IP stack: assembled SAP-4 payload
    carrying IPV4/UDP/LRRP parses end-to-end (PacketMessageFactory
    routing parity)."""
    from sdrtrunk_jax.protocol.ip import ipv4_checksum
    from sdrtrunk_jax.protocol.p25p1.pdu import PDUSequence, pdu_dispatch

    lrrp = bytes([0x0D, 3, 0x6C, 0x01, 0x2C])      # TRIGGERED + SPEED
    udp = bytes([0x0F, 0xA1, 0x0F, 0xA1,           # 4001 -> 4001
                 0, 8 + len(lrrp), 0, 0]) + lrrp
    total = 20 + len(udp)
    hdr = bytearray([0x45, 0, total >> 8, total & 0xFF, 0, 0, 0, 0,
                     64, 17, 0, 0, 10, 0, 0, 9, 10, 0, 0, 8])
    csum = ipv4_checksum(bytes(hdr))
    hdr[10], hdr[11] = csum >> 8, csum & 0xFF
    datagram = bytes(hdr) + udp

    blocks, n_blocks, pad = build_packet_blocks(datagram, confirmed=True)
    header_bits = pdu_encode_header(format=22, sap=4, llid=7,
                                    blocks_to_follow=n_blocks,
                                    confirmation=True, pad_octets=pad)
    h = pdu_decode_header(header_bits)
    seq = PDUSequence(header=h)
    for b in blocks:
        seq.blocks.append(pdu_decode_block(b, confirmed=True))
    payload, crc_ok = assemble_packet(seq)
    assert crc_ok and payload == datagram
    pkt = pdu_dispatch(h, payload)
    assert pkt is not None and pkt.header.protocol.name == "UDP"
    assert pkt.application is not None
    assert pkt.application.token("SPEED").fields["speed_mps"] == 3.0


def test_pdu_sndcp_dispatch():
    """SAP-6 PDUs route to the SNDCP control parser: an inbound
    Activate TDS Context Request and the outbound Accept both decode
    their typed fields (pdu/packet/sndcp/ActivateTdsContextRequest
    .java:38-49 / ActivateTdsContextAccept.java:41-55 layouts)."""
    from sdrtrunk_jax.protocol.p25p1.pdu import PDUSequence, pdu_dispatch
    from sdrtrunk_jax.protocol.p25p1.sndcp import parse_sndcp

    # inbound request: byte0 0x01 -> pdu_type 0, version 1; byte1 0x51
    # -> nsapi 5, NAT dynamic(1); ip 10.0.0.9
    # bytes: [type|ver, nsapi|nat, ip x4, dsut|udpcomp, ipcomp,
    #         tcpss|udpss, mdpco]
    req = bytes([0x01, 0x51, 10, 0, 0, 9, 0x20, 0x00, 0x12, 0x00])
    msg = parse_sndcp(req, outbound=False)
    assert msg.type_name == "ACTIVATE_TDS_CONTEXT_REQUEST"
    assert msg.fields["version"] == 1 and msg.fields["nsapi"] == 5
    assert msg.fields["nat"] == "IPV4_DYNAMIC"
    assert msg.fields["ip_address"] == "10.0.0.9"
    assert msg.fields["dsut"] == 2
    assert msg.fields["tcpss"] == 1 and msg.fields["udpss"] == 2

    # outbound accept with full layout through the PDU pipeline
    accept = bytearray(13)
    accept[0] = 0x05                  # pdu_type 0, nsapi 5
    accept[1] = 0x34                  # priority 3, ready timer 4
    accept[2] = 0x21                  # standby 2, NAT 1 (dynamic)
    accept[3:7] = bytes([192, 168, 1, 7])
    accept[9] = 0x40                  # mtu nibble = 4
    datagram = bytes(accept)
    blocks, n_blocks, pad = build_packet_blocks(datagram, confirmed=True)
    header_bits = pdu_encode_header(format=22, sap=6, llid=99,
                                    blocks_to_follow=n_blocks,
                                    confirmation=True, pad_octets=pad)
    h = pdu_decode_header(header_bits)
    assert h.sap_name == "SNDCP_PACKET_DATA_CONTROL"
    seq = PDUSequence(header=h)
    for b in blocks:
        seq.blocks.append(pdu_decode_block(b, confirmed=True))
    payload, crc_ok = assemble_packet(seq)
    assert crc_ok
    msg = pdu_dispatch(h, payload)
    assert msg is not None
    assert msg.type_name == "ACTIVATE_TDS_CONTEXT_ACCEPT"
    assert msg.fields["nsapi"] == 5
    assert msg.fields["ip_address"] == "192.168.1.7"
    assert msg.fields["nat"] == "IPV4_DYNAMIC"
    assert msg.fields["mtu"] == 4
    assert "ACTIVATE_TDS_CONTEXT_ACCEPT" in msg.describe()

    # reject + deactivate variants
    rej = parse_sndcp(bytes([0x35, 0x02]), outbound=True)
    assert rej.type_name == "ACTIVATE_TDS_CONTEXT_REJECT"
    assert rej.fields["nsapi"] == 5 and rej.fields["reject_reason"] == 2
    deact = parse_sndcp(bytes([0x27, 0x01]), outbound=True)
    assert deact.type_name == "DEACTIVATE_TDS_CONTEXT_REQUEST"
    assert deact.fields["reason"] == "NETWORK_INITIATED"


def test_lrrp_extended_token_set():
    """The zero-length report tokens the reference names (REQUEST_3A,
    ALTITUDE_ACCURACY, TIME, ALTITUDE, HORIZONTAL_DIRECTION, REQUEST_62
    /64) parse in sequence without desync (TokenType.java parity)."""
    from sdrtrunk_jax.protocol.ip.lrrp import parse_lrrp

    body = bytes([
        0x36, 0x01,           # VERSION 1
        0x3A,                 # REQUEST_3A (0 len)
        0x50,                 # ALTITUDE_ACCURACY
        0x52,                 # TIME
        0x54,                 # ALTITUDE
        0x57,                 # HORIZONTAL_DIRECTION
        0x62,                 # REQUEST_62
        0x64,                 # REQUEST_64
        0x66, 0x20, 0, 0, 0, 0x10, 0, 0, 0,   # POINT_2D
        0x56, 0x2D,           # HEADING
    ])
    pkt = parse_lrrp(bytes([0x0D, len(body)]) + body)
    names = [t.name for t in pkt.tokens]
    for want in ("VERSION", "REQUEST_3A", "ALTITUDE_ACCURACY", "TIME",
                 "ALTITUDE", "HORIZONTAL_DIRECTION", "REQUEST_62",
                 "REQUEST_64", "POINT_2D", "HEADING"):
        assert want in names, names
    assert pkt.token("POINT_2D") is not None


def test_unknown_opcode_counter():
    """Coverage gauge: contents whose opcode lacks a named structure
    count into ChannelMetrics.unknown_opcodes; known ones do not."""
    from sdrtrunk_jax.protocol.dmr.csbk import CSBK
    from sdrtrunk_jax.protocol.p25p1.tsbk import TSBK
    from sdrtrunk_jax.runtime.metrics import ChannelMetrics

    m = ChannelMetrics()
    m.content(TSBK(opcode=0x00, mfid=0, last_block=True,
                   protected=False, args=np.zeros(64, np.uint8)))
    assert m.unknown_opcodes == 0            # GROUP VOICE GRANT: known
    m.content(TSBK(opcode=0x01, mfid=0, last_block=True,
                   protected=False, args=np.zeros(64, np.uint8)))
    assert m.unknown_opcodes == 1            # OSP 0x01 is reserved
    m.content({"ambe_frames": None})         # voice dicts never count
    assert m.unknown_opcodes == 1
