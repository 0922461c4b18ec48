"""DMR packet-data layer: headers, blocks, sequence assembly, IP stack.

Closed-loop against the repo's own encoders (the reference is
receive-only): build headers/blocks bit-exact per ETSI layouts, push
them through the framer + assembler, and check the reassembled IPV4 /
UDP / LRRP / ARS content.
"""
import numpy as np
import pytest

from sdrtrunk_jax.protocol.bits import from_int, pack_bits
from sdrtrunk_jax.protocol.dmr.data import (DataPacketFormat,
                                            ServiceAccessPoint,
                                            parse_data_header)
from sdrtrunk_jax.protocol.dmr.framer import (DataType, DMRBurstAssembler,
                                              DMRFramer)
from sdrtrunk_jax.protocol.dmr.packet import (
    DataBlock, PacketSequenceAssembler, decode_block, decode_rate34_block,
    encode_confirmed_block_1_2, encode_data_header, encode_rate34_block,
    encode_unconfirmed_block_1_2)
from sdrtrunk_jax.protocol.dmr.sync import DMRSyncPattern
from sdrtrunk_jax.protocol.ip import (parse_ars, parse_ipv4, parse_lrrp,
                                      ipv4_checksum)


def _header80(dpf: int, sap: int, dst: int, src: int, *, group=False,
              pad=0, blocks=0, full=True, fsn=0, confirmed=False,
              resync=False, seq=0) -> np.ndarray:
    """Build the 80 pre-CRC header bits per OctetDataHeader.java layout."""
    b = np.zeros(80, np.uint8)
    b[0] = 1 if group else 0
    b[3] = (pad >> 4) & 1
    b[4:8] = from_int(dpf, 4)
    b[8:12] = from_int(sap, 4)
    b[12:16] = from_int(pad & 0xF, 4)
    b[16:40] = from_int(dst, 24)
    b[40:64] = from_int(src, 24)
    b[64] = 1 if full else 0
    b[65:72] = from_int(blocks, 7)
    if confirmed:
        b[72] = 1 if resync else 0
        b[73:76] = from_int(seq, 3)
    b[76:80] = from_int(fsn, 4)
    return b


def _udp_ipv4(payload: bytes, src_port: int, dst_port: int) -> bytes:
    udp = bytes([src_port >> 8, src_port & 0xFF, dst_port >> 8,
                 dst_port & 0xFF, (8 + len(payload)) >> 8,
                 (8 + len(payload)) & 0xFF, 0, 0]) + payload
    total = 20 + len(udp)
    hdr = bytearray([0x45, 0, total >> 8, total & 0xFF, 0, 0, 0, 0,
                     64, 17, 0, 0, 10, 0, 0, 1, 10, 0, 0, 2])
    csum = ipv4_checksum(bytes(hdr))
    hdr[10], hdr[11] = csum >> 8, csum & 0xFF
    return bytes(hdr) + udp


def _lrrp_response() -> bytes:
    # IMMEDIATE_LOCATION_RESPONSE with POINT_2D + SPEED tokens
    lat = int(38.9 / 180.0 * 4294967295) & 0x7FFFFFFF
    lon_val = int((360.0 - 77.0) / 360.0 * 4294967295)  # -77 degrees
    body = bytes([0x66]) + lat.to_bytes(4, "big") + \
        lon_val.to_bytes(4, "big") + bytes([0x6C, 0x01, 0x2C])
    return bytes([0x07, len(body)]) + body


class TestRate34:
    def test_roundtrip(self):
        rng = np.random.default_rng(7)
        data = rng.integers(0, 2, 144).astype(np.uint8)
        tx = encode_rate34_block(data)
        assert tx.shape == (196,)
        rx, errors = decode_rate34_block(tx)
        assert errors == 0
        np.testing.assert_array_equal(rx, data)

    def test_corrects_bit_errors(self):
        rng = np.random.default_rng(8)
        data = rng.integers(0, 2, 144).astype(np.uint8)
        tx = encode_rate34_block(data)
        tx[30] ^= 1
        rx, errors = decode_rate34_block(tx)
        np.testing.assert_array_equal(rx, data)
        assert errors >= 1


class TestDataHeader:
    def test_unconfirmed_header_fields(self):
        b80 = _header80(DataPacketFormat.UNCONFIRMED_DATA_PACKET,
                        ServiceAccessPoint.IP_PACKET_DATA, 0x123456,
                        0x654321, pad=17, blocks=3, fsn=5)
        from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_decode
        info, nerr = bptc_196_96_decode(encode_data_header(b80))
        assert nerr == 0
        hdr = parse_data_header(info)
        assert hdr.crc_ok
        assert hdr.dpf == DataPacketFormat.UNCONFIRMED_DATA_PACKET
        assert hdr.sap == ServiceAccessPoint.IP_PACKET_DATA
        assert hdr.dst == 0x123456 and hdr.src == 0x654321
        assert hdr.pad_octets == 17          # exercises the split bit 3
        assert hdr.blocks_to_follow == 3
        assert hdr.fragment_seq == 5
        assert not hdr.confirmed

    def test_confirmed_header_fields(self):
        b80 = _header80(DataPacketFormat.CONFIRMED_DATA_PACKET,
                        ServiceAccessPoint.IP_PACKET_DATA, 1, 2,
                        blocks=2, confirmed=True, resync=True, seq=4)
        hdr = parse_data_header(np.concatenate(
            [b80, from_int(0, 16)]))        # bad CRC on purpose
        assert not hdr.crc_ok
        assert hdr.confirmed and hdr.resync and hdr.send_seq == 4

    def test_corrupted_header_crc_fails(self):
        b80 = _header80(DataPacketFormat.UNCONFIRMED_DATA_PACKET, 4, 1, 2)
        from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_decode
        info, _ = bptc_196_96_decode(encode_data_header(b80))
        info = info.copy()
        info[20] ^= 1
        assert not parse_data_header(info).crc_ok


class TestSequenceAssembly:
    def _ip_sequence_bits(self, payload: bytes, confirmed: bool):
        """Split an IP payload across rate-1/2 blocks + header bursts."""
        per_block = 10 if confirmed else 12      # octets per block
        n_blocks = -(-len(payload) // per_block)
        pad = n_blocks * per_block - len(payload)
        padded = payload + bytes(pad)
        dpf = (DataPacketFormat.CONFIRMED_DATA_PACKET if confirmed
               else DataPacketFormat.UNCONFIRMED_DATA_PACKET)
        header = encode_data_header(_header80(
            dpf, ServiceAccessPoint.IP_PACKET_DATA, 0xBEEF, 0xCAFE,
            pad=pad, blocks=n_blocks, confirmed=confirmed))
        blocks = []
        for i in range(n_blocks):
            chunk = padded[i * per_block:(i + 1) * per_block]
            bits = np.unpackbits(np.frombuffer(chunk, np.uint8))
            if confirmed:
                blocks.append(encode_confirmed_block_1_2(bits, i))
            else:
                blocks.append(encode_unconfirmed_block_1_2(bits))
        return header, blocks

    @pytest.mark.parametrize("confirmed", [False, True])
    def test_ip_lrrp_end_to_end(self, confirmed):
        datagram = _udp_ipv4(_lrrp_response(), 4001, 4001)
        header196, block196s = self._ip_sequence_bits(datagram, confirmed)
        asm = PacketSequenceAssembler()
        from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_decode
        info, _ = bptc_196_96_decode(header196)
        asm.on_header(1, parse_data_header(info))
        for b in block196s:
            asm.on_block(1, decode_block(DataType.RATE_1_2_DATA, b))
        assert len(asm.messages) == 1
        msg = asm.messages[0]
        assert msg.kind == "ip"
        assert msg.block_crc_failures == 0
        assert msg.header.src == 0xCAFE
        pkt = msg.packet
        assert pkt is not None and pkt.header.checksum_ok
        assert pkt.header.src == "10.0.0.1" and pkt.header.dst == "10.0.0.2"
        assert pkt.transport.dst_port == 4001
        lrrp = pkt.application
        assert lrrp is not None
        assert lrrp.packet_type.name == "IMMEDIATE_LOCATION_RESPONSE"
        point = lrrp.token("POINT_2D")
        assert point is not None
        assert abs(point.fields["latitude"] - 38.9) < 1e-3
        assert abs(point.fields["longitude"] - (-77.0)) < 1e-3
        assert lrrp.token("SPEED").fields["speed_mps"] == pytest.approx(3.0)

    def test_through_framer(self):
        """Bursts through the DMRFramer land in the assembler as a
        complete IP message."""
        datagram = _udp_ipv4(b"hello-dmr", 4004, 4004)
        header196, block196s = self._ip_sequence_bits(datagram, False)
        builder = DMRBurstAssembler(color_code=1)
        bursts = [builder.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                     DataType.DATA_HEADER, header196)]
        bursts += [builder.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                      DataType.RATE_1_2_DATA, b)
                   for b in block196s]
        dibits = DMRBurstAssembler.to_dibits(bursts)
        frames = DMRFramer().process(dibits)
        asm = PacketSequenceAssembler()
        for fr in frames:
            if fr.content_kind == "data_header" and fr.content is not None:
                asm.on_header(fr.timeslot, fr.content)
            elif fr.content_kind == "data_block" and fr.content is not None:
                asm.on_block(fr.timeslot, fr.content)
        assert len(asm.messages) == 1
        msg = asm.messages[0]
        assert msg.kind == "ip"
        assert msg.packet.payload[:9] == b"hello-dmr"

    def test_confirmed_crc9_detects_corruption(self):
        bits = np.unpackbits(np.frombuffer(b"0123456789", np.uint8))
        blk196 = encode_confirmed_block_1_2(bits, 3)
        from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_decode
        info, _ = bptc_196_96_decode(blk196)
        block = DataBlock(info, "1/2")
        assert block.serial == 3 and block.crc_ok
        bad = info.copy()
        bad[40] ^= 1
        assert not DataBlock(bad, "1/2").crc_ok


class TestARS:
    def test_device_registration(self):
        body = bytes([4]) + b"RAD1"
        flags = 0x00          # device registration, no extension
        length = 1 + len(body)
        data = bytes([length >> 8, length & 0xFF, flags]) + body
        pkt = parse_ars(data)
        assert pkt.pdu_type.name == "DEVICE_REGISTRATION"
        assert pkt.strings == ["RAD1"]

    def test_ars_over_udp_port(self):
        body = bytes([2]) + b"AB"
        data = bytes([0, 1 + len(body), 0x05]) + body
        pkt = parse_ipv4(_udp_ipv4(data, 4005, 4005))
        assert pkt.application is not None
        assert pkt.application.pdu_type.name == "USER_REGISTRATION"


class TestLRRPTokens:
    def test_timestamp_token(self):
        # 2024-06-15 12:30:45 packed per Timestamp.java
        packed = (2024 << 26) | (6 << 22) | (15 << 17) | (12 << 12) \
            | (30 << 6) | 45
        data = bytes([0x0D, 6, 0x34]) + packed.to_bytes(5, "big")
        lrrp = parse_lrrp(data)
        ts = lrrp.token("TIMESTAMP")
        assert ts.fields == {"year": 2024, "month": 6, "day": 15,
                             "hour": 12, "minute": 30, "second": 45}

    def test_variable_identity_token(self):
        data = bytes([0x05, 5, 0x22, 3, 0x01, 0x02, 0x03])
        lrrp = parse_lrrp(data)
        assert lrrp.packet_type.name == "IMMEDIATE_LOCATION_REQUEST"
        assert lrrp.token("IDENTITY").fields["identity"] == 0x010203
