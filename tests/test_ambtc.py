"""AMBTC (format-23 PDU trunking control) parsing + decoder-state
routing: an AMBTC group voice channel grant must drive the traffic
manager exactly like its TSBK twin
(pdu/ambtc/osp/AMBTCGroupVoiceChannelGrant.java,
PDUMessageFactory.createAMBTC:208)."""
import numpy as np

from sdrtrunk_jax.protocol.bits import from_int
from sdrtrunk_jax.protocol.p25p1.ambtc import parse_ambtc
from sdrtrunk_jax.protocol.p25p1.duid import DUID
from sdrtrunk_jax.protocol.p25p1.messages import P25P1Message
from sdrtrunk_jax.protocol.p25p1.pdu import (PDUSequence,
                                             pdu_decode_block,
                                             pdu_decode_header,
                                             pdu_encode_block,
                                             pdu_encode_header)
from sdrtrunk_jax.runtime.p25_state import P25P1DecoderState
from sdrtrunk_jax.runtime.traffic import (FrequencyBand,
                                          TrafficChannelManager)


def _seq(opcode: int, address: int, block_bits: np.ndarray,
         outbound: bool = True) -> PDUSequence:
    hdr_air = pdu_encode_header(format=23, sap=61, llid=address,
                                blocks_to_follow=1, outbound=outbound,
                                ambtc_opcode=opcode)
    header = pdu_decode_header(hdr_air)
    assert header is not None and header.ambtc_opcode == opcode
    blk_air = pdu_encode_block(block_bits, confirmed=False)
    seq = PDUSequence(header=header)
    seq.blocks.append(pdu_decode_block(blk_air, confirmed=False))
    return seq


def _grant_block(band: int, channel: int, group: int) -> np.ndarray:
    b = np.zeros(96, np.uint8)
    b[16:20] = from_int(band, 4)
    b[20:32] = from_int(channel, 12)
    b[48:64] = from_int(group, 16)
    return b


def test_parse_group_voice_grant():
    seq = _seq(0, address=0x1234, block_bits=_grant_block(2, 0x123,
                                                          0x4567))
    m = parse_ambtc(seq)
    assert m is not None and m.outbound and m.name == "GRP_VCH_GRANT"
    assert m.fields["frequency_band"] == 2
    assert m.fields["channel_number"] == 0x123
    assert m.fields["group_address"] == 0x4567
    assert m.fields["source_address"] == 0x1234


def test_parse_rfss_status():
    b = np.zeros(96, np.uint8)
    b[0:8] = from_int(3, 8)          # rfss
    b[8:16] = from_int(7, 8)         # site
    seq = _seq(58, address=0, block_bits=b)
    m = parse_ambtc(seq)
    assert m.name == "RFSS_STATUS_BCST"
    assert m.fields["rfss_id"] == 3 and m.fields["site_id"] == 7


def test_ambtc_grant_reaches_traffic_manager():
    traffic = TrafficChannelManager("APCO25")
    traffic.update_band(FrequencyBand(identifier=2,
                                      base_frequency_hz=851_000_000.0,
                                      channel_spacing_hz=12_500.0))
    state = P25P1DecoderState(traffic=traffic)
    seq = _seq(0, address=0x99, block_bits=_grant_block(2, 40, 0x222))
    msg = P25P1Message(nac=0x293, duid=DUID.PDU, start=0, content=seq,
                       valid=True)
    state.receive(msg, now=1.0)
    grants = [e for e in traffic.events if "GRANT" in str(e.event_type)
              or e.frequency_hz is not None]
    assert grants, "AMBTC grant must produce a traffic grant event"
    assert grants[0].frequency_hz == 851_000_000.0 + 40 * 12_500.0


def test_isp_ambtc_is_header_only():
    seq = _seq(31, address=0xABC, block_bits=np.zeros(96, np.uint8),
               outbound=False)
    m = parse_ambtc(seq)
    assert m.name == "CALL_ALRT_REQ" and m.address == 0xABC
    assert m.fields == {}


def test_parse_umbtc_dial_request():
    """UMBTC (format 21) telephone interconnect explicit dial request:
    opcode in block 0 bits [2:8), digits as 4-bit nibbles
    (PDUMessageFactory.createUMBTC:294-311)."""
    from sdrtrunk_jax.protocol.p25p1.ambtc import parse_umbtc

    hdr_air = pdu_encode_header(format=21, sap=61, llid=0x42,
                                blocks_to_follow=1, outbound=False)
    header = pdu_decode_header(hdr_air)
    b = np.zeros(96, np.uint8)
    b[2:8] = from_int(8, 6)          # ISP TELE_INT_DIAL_REQ
    b[8:16] = from_int(3, 8)         # 3 digits
    b[24:28] = from_int(9, 4)
    b[28:32] = from_int(1, 4)
    b[32:36] = from_int(1, 4)
    seq = PDUSequence(header=header)
    seq.blocks.append(pdu_decode_block(pdu_encode_block(b, False),
                                       confirmed=False))
    m = parse_umbtc(seq)
    assert m is not None and m.name == "TELE_INT_DIAL_REQ"
    assert m.fields["digits"] == [9, 1, 1]
