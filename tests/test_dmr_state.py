"""DMR decoder state machine: voice calls, embedded LC identifier
learning, CSBK control, and packet-data events — closed loop through
the burst assembler + framer (DMRDecoderState.java role).
"""
import numpy as np

from sdrtrunk_jax.audio.mbe import FakeMBECodec
from sdrtrunk_jax.protocol.dmr.framer import (DataType, DMRBurstAssembler,
                                              DMRFramer, VOICE_FRAME_ORDER)
from sdrtrunk_jax.protocol.dmr.lc import (MASK_TERMINATOR,
                                          MASK_VOICE_HEADER,
                                          embedded_lc_encode,
                                          full_lc_encode,
                                          lc_build_group_voice)
from sdrtrunk_jax.protocol.dmr.sync import DMRSyncPattern
from sdrtrunk_jax.protocol.edac.bptc import bptc_196_96_encode
from sdrtrunk_jax.runtime.dmr_state import DMRDecoderState
from sdrtrunk_jax.runtime.events import DecodeEventType
from sdrtrunk_jax.runtime.identifiers import IdentifierForm


def _run(bursts, state=None):
    state = state or DMRDecoderState(codec=FakeMBECodec())
    rng = np.random.default_rng(5)
    dibits = np.concatenate([
        rng.integers(0, 4, 21).astype(np.uint8),
        DMRBurstAssembler.to_dibits(bursts),
        rng.integers(0, 4, 10).astype(np.uint8)])
    now = 0.0
    for frame in DMRFramer().process(dibits):
        now += 0.03
        state.receive(frame, now)
    return state


def test_voice_call_lifecycle_with_audio():
    asm = DMRBurstAssembler(color_code=1)
    rng = np.random.default_rng(2)
    ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
    lc = lc_build_group_voice(group=0x222, source=0x333)
    vh = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
    tlc = bptc_196_96_encode(full_lc_encode(lc, MASK_TERMINATOR))
    bursts = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                             DataType.VOICE_HEADER, vh)]
    bursts.append(asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE, ambe))
    frags = embedded_lc_encode(lc)
    for i, vf in enumerate(VOICE_FRAME_ORDER[:4]):
        bursts.append(asm.voice_burst(vf, ambe, emb_lcss=[1, 3, 3, 2][i],
                                      lc_fragment=frags[i]))
    bursts.append(asm.voice_burst(VOICE_FRAME_ORDER[4], ambe))
    bursts.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                 DataType.TLC, tlc))
    state = _run(bursts)
    events = state.history.events
    calls = [e for e in events
             if e.event_type == DecodeEventType.CALL_GROUP]
    assert len(calls) == 1
    call = calls[0]
    assert call.duration > 0
    tg = call.identifiers.get(IdentifierForm.TALKGROUP)
    assert tg is not None and tg.value == 0x222
    segments = state.drain_audio()
    assert len(segments) == 1
    assert len(segments[0].samples) == 6 * 3 * 160   # 20 ms per frame


def test_embedded_lc_learns_identifiers_midcall():
    """No voice header — identifiers come only from the embedded LC in
    frames B..E."""
    asm = DMRBurstAssembler(color_code=1)
    rng = np.random.default_rng(3)
    ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
    lc = lc_build_group_voice(group=0x77, source=0x4242)
    frags = embedded_lc_encode(lc)
    bursts = [asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE, ambe)]
    for i, vf in enumerate(VOICE_FRAME_ORDER[:4]):
        bursts.append(asm.voice_burst(vf, ambe, emb_lcss=[1, 3, 3, 2][i],
                                      lc_fragment=frags[i]))
    state = _run(bursts)
    slot = state.slots[1]
    tg = slot.identifiers.get(IdentifierForm.TALKGROUP)
    assert tg is not None and tg.value == 0x77


def test_data_packet_event_gps():
    """Data header + rate-1/2 blocks carrying IPV4/UDP/LRRP with a
    position -> GPS decode event."""
    from sdrtrunk_jax.protocol.dmr.data import (DataPacketFormat,
                                                ServiceAccessPoint)
    from sdrtrunk_jax.protocol.dmr.packet import (
        encode_data_header, encode_unconfirmed_block_1_2)
    from sdrtrunk_jax.protocol.ip import ipv4_checksum
    from sdrtrunk_jax.protocol.bits import from_int

    lat = int(38.0 / 180.0 * 4294967295) & 0x7FFFFFFF
    lon = int(282.5 / 360.0 * 4294967295)      # -77.5
    lrrp = bytes([0x0D, 9, 0x66]) + lat.to_bytes(4, "big") \
        + lon.to_bytes(4, "big")
    udp = bytes([0x0F, 0xA1, 0x0F, 0xA1, 0, 8 + len(lrrp), 0, 0]) + lrrp
    total = 20 + len(udp)
    hdr = bytearray([0x45, 0, total >> 8, total & 0xFF, 0, 0, 0, 0, 64,
                     17, 0, 0, 10, 0, 0, 1, 10, 0, 0, 2])
    cs = ipv4_checksum(bytes(hdr))
    hdr[10], hdr[11] = cs >> 8, cs & 0xFF
    datagram = bytes(hdr) + udp
    n_blocks = -(-len(datagram) // 12)
    pad = n_blocks * 12 - len(datagram)
    padded = datagram + bytes(pad)

    b80 = np.zeros(80, np.uint8)
    b80[4:8] = from_int(int(DataPacketFormat.UNCONFIRMED_DATA_PACKET), 4)
    b80[8:12] = from_int(int(ServiceAccessPoint.IP_PACKET_DATA), 4)
    b80[3] = (pad >> 4) & 1
    b80[12:16] = from_int(pad & 0xF, 4)
    b80[16:40] = from_int(0x111, 24)
    b80[40:64] = from_int(0x222, 24)
    b80[65:72] = from_int(n_blocks, 7)

    asm = DMRBurstAssembler(color_code=1)
    bursts = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                             DataType.DATA_HEADER,
                             encode_data_header(b80))]
    for i in range(n_blocks):
        bits = np.unpackbits(np.frombuffer(
            padded[i * 12:(i + 1) * 12], np.uint8))
        bursts.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                     DataType.RATE_1_2_DATA,
                                     encode_unconfirmed_block_1_2(bits)))
    state = _run(bursts)
    gps = [e for e in state.history.events
           if e.event_type == DecodeEventType.GPS]
    assert len(gps) == 1
    assert "lat=38.0" in gps[0].details
    assert "-77.5" in gps[0].details


def test_csbk_control_state():
    from sdrtrunk_jax.protocol.dmr.csbk import csbk_encode
    from sdrtrunk_jax.runtime.state import ChannelState

    asm = DMRBurstAssembler(color_code=1)
    aloha = csbk_encode(0x19, np.zeros(64, np.uint8))
    bursts = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                             DataType.CSBK, aloha)]
    state = _run(bursts)
    assert state.slots[1].machine.state == ChannelState.CONTROL
