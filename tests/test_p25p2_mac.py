"""P25P2 MAC messages: structure parsing, decoder state, and end-to-end
scrambler key learning from network status broadcasts."""
import numpy as np
import pytest

from sdrtrunk_jax.protocol.bits import from_int
from sdrtrunk_jax.protocol.p25p2 import P25P2FragmentAssembler, P25P2Framer
from sdrtrunk_jax.protocol.p25p2.mac import (MAC_OPCODE_NAMES,
                                             build_mac_pdu,
                                             mac_structure_encode,
                                             parse_mac_pdu)
from sdrtrunk_jax.protocol.p25p2.timeslot import (MacPduType, facch_encode,
                                                  sacch_encode)
from sdrtrunk_jax.runtime.p25p2_state import P25P2DecoderState
from sdrtrunk_jax.runtime.state import ChannelState
from sdrtrunk_jax.runtime.traffic import TrafficChannelManager


def _ptt_bits(group: int, source: int, algorithm: int = 0x80,
              total: int = 180) -> np.ndarray:
    """SACCH PTT MAC PDU (structure/PushToTalk.java offsets)."""
    b = np.zeros(total, np.uint8)
    b[0:3] = from_int(MacPduType.PTT.value, 3)
    b[80:88] = from_int(algorithm, 8)
    b[88:104] = from_int(0x1234, 16)      # key id
    b[104:128] = from_int(source, 24)
    b[128:144] = from_int(group, 16)
    return b


def test_mac_structure_roundtrip_grant():
    bits = mac_structure_encode(64, {
        "service_options": 0x00, "frequency_band": 2,
        "channel_number": 0x123, "group_address": 0x4567,
        "source_address": 0x89ABC})
    pdu = parse_mac_pdu(build_mac_pdu(MacPduType.ACTIVE, [bits], 156))
    assert pdu.pdu_type == MacPduType.ACTIVE
    assert len(pdu.structures) == 1
    s = pdu.structures[0]
    assert s.opcode_name == "GROUP_VOICE_CHANNEL_GRANT_ABBREVIATED"
    assert s.fields["channel_number"] == 0x123
    assert s.fields["group_address"] == 0x4567
    assert s.fields["source_address"] == 0x89ABC


def test_mac_chained_structures():
    """ACTIVE PDUs chain up to three structures located by table length."""
    s1 = mac_structure_encode(1, {"service_options": 0x40,
                                  "group_address": 0x1111,
                                  "source_address": 0x22222})     # 7 octets
    s2 = mac_structure_encode(122, {"system_id": 0x3AB, "rfss_id": 1,
                                    "site_id": 7, "frequency_band": 2,
                                    "channel_number": 0x222})     # 9 octets
    pdu = parse_mac_pdu(build_mac_pdu(MacPduType.HANGTIME, [s1, s2], 180))
    assert [s.opcode for s in pdu.structures] == [1, 122]
    assert pdu.structures[0].fields["group_address"] == 0x1111
    assert pdu.structures[1].fields["site_id"] == 7


def test_mac_ptt_and_end():
    pdu = parse_mac_pdu(_ptt_bits(0xBEEF, 0x12345, algorithm=0xAA))
    assert pdu.pdu_type == MacPduType.PTT
    f = pdu.structures[0].fields
    assert f["group_address"] == 0xBEEF
    assert f["source_address"] == 0x12345
    assert f["algorithm_id"] == 0xAA


def test_mac_iden_up_scaling():
    bits = np.zeros(9 * 8, np.uint8)
    bits[0:8] = from_int(125, 8)
    bits[8:12] = from_int(1, 4)
    bits[12:21] = from_int(100, 9)          # 12.5 kHz
    bits[30:40] = from_int(100, 10)         # 12.5 kHz
    bits[40:72] = from_int(170_200_000, 32)  # 851 MHz
    pdu = parse_mac_pdu(build_mac_pdu(MacPduType.ACTIVE, [bits], 156))
    f = pdu.structures[0].fields
    assert f["bandwidth_khz"] == pytest.approx(12.5)
    assert f["base_frequency_mhz"] == pytest.approx(851.0)


def test_p25p2_state_grant_and_call():
    traffic = TrafficChannelManager("APCO25-P2")
    state = P25P2DecoderState(traffic=traffic)

    iden = np.zeros(72, np.uint8)
    iden[0:8] = from_int(125, 8)
    iden[8:12] = from_int(2, 4)
    iden[12:21] = from_int(100, 9)
    iden[30:40] = from_int(100, 10)
    iden[40:72] = from_int(170_200_000, 32)
    grant = mac_structure_encode(64, {
        "frequency_band": 2, "channel_number": 10,
        "group_address": 0x4567, "source_address": 0x89ABC})

    class _Frag:
        timeslots = []

    class _TS:
        def __init__(self, mac, channel=0):
            self.mac = mac
            self.channel = channel

    frag = _Frag()
    frag.timeslots = [
        _TS(parse_mac_pdu(build_mac_pdu(MacPduType.ACTIVE, [iden], 156))),
        _TS(parse_mac_pdu(build_mac_pdu(MacPduType.ACTIVE, [grant], 156))),
    ]
    state.receive_fragment(frag, now=1.0)
    assert len(traffic.active) == 1
    freq = next(iter(traffic.active))
    assert freq == pytest.approx(851e6 + 10 * 12500.0)

    # PTT starts a call on timeslot 1
    frag2 = _Frag()
    frag2.timeslots = [_TS(parse_mac_pdu(_ptt_bits(0xBEEF, 0x12345)),
                           channel=1)]
    state.receive_fragment(frag2, now=2.0)
    assert state.state[1].state == ChannelState.CALL
    assert state.current_call[1] is not None

    # END_PTT tears it down
    endptt = np.zeros(180, np.uint8)
    endptt[0:3] = from_int(MacPduType.END_PTT.value, 3)
    endptt[104:128] = from_int(0x12345, 24)
    endptt[128:144] = from_int(0xBEEF, 16)
    frag3 = _Frag()
    frag3.timeslots = [_TS(parse_mac_pdu(endptt), channel=1)]
    state.receive_fragment(frag3, now=3.0)
    assert state.current_call[1] is None
    assert state.state[1].state == ChannelState.FADE


def test_scrambler_learning_end_to_end():
    """The flagship P25P2 closed loop: the framer starts with NO scramble
    key; an UNscrambled FACCH network status broadcast teaches the state
    the WACN/SYS/NAC, the state updates the framer, and a subsequent
    SCRAMBLED SACCH PTT then decodes and starts a call."""
    wacn, system, nac = 0xA4BC3, 0x123, 0x29A
    asm = P25P2FragmentAssembler(wacn=wacn, system=system, nac=nac)

    net = mac_structure_encode(123, {
        "wacn": wacn, "system_id": system, "color_code": nac,
        "frequency_band": 1, "channel_number": 5})
    facch_net = facch_encode(
        build_mac_pdu(MacPduType.ACTIVE, [net], 156), scrambled=False)
    sacch_ptt = sacch_encode(_ptt_bits(0x4567, 0x89ABC), scrambled=True)
    idle = facch_encode(
        build_mac_pdu(MacPduType.IDLE, [], 156), scrambled=False)

    frag_a = asm.assemble(0, [facch_net, idle, idle, idle])
    frag_b = asm.assemble(1, [sacch_ptt, idle, idle, idle])
    dibits = P25P2FragmentAssembler.to_dibits(
        [np.zeros(200, np.uint8), frag_a, frag_b, np.zeros(200, np.uint8)])

    framer = P25P2Framer()  # no key
    state = P25P2DecoderState(
        on_scramble_update=framer.set_scramble_parameters)

    # process fragment A first (bits [200,1640) = dibits [100,820)):
    # learns the key from the unscrambled network status broadcast
    frags = framer.process(dibits[:900])
    assert len(frags) == 1
    for i, frag in enumerate(frags):
        state.receive_fragment(frag, now=float(i))
    assert state.scramble_key == (wacn, system, nac)

    # remaining stream: the scrambled PTT must now decode
    frags2 = framer.process(dibits[900:])
    for frag in frags2:
        state.receive_fragment(frag, now=10.0)
    assert state.current_call[0] is not None
    idents = {(i.form.name, i.value)
              for i in state.current_call[0].identifiers.all()}
    assert ("TALKGROUP", 0x4567) in idents
    assert ("RADIO", 0x89ABC) in idents
