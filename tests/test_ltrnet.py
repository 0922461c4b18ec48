"""LTR-Net message typing, field extraction, and site tracking —
closed-loop against ltrnet_encode_word (the reference is receive-only).
"""
import numpy as np

from sdrtrunk_jax.protocol.bits import from_int
from sdrtrunk_jax.protocol.ltr.ltrnet import (LtrNetFramer, LtrNetMessageType,
                                              LtrNetTracker,
                                              ltrnet_encode_word,
                                              parse_ltrnet)
from sdrtrunk_jax.protocol.ltr.messages import ltr_checksum, SYNC_OSW

T = LtrNetMessageType


def _word_from_payload(area, channel, home, group, free, direction="OSW"):
    return ltrnet_encode_word(area, channel, home, group, free, direction)


class TestTyping:
    def test_osw_call_start_and_idle(self):
        m = parse_ltrnet(_word_from_payload(0, 5, 3, 42, 7))
        assert m.message_type == T.OSW_CALL_START
        assert m.fields["lcn"] == 5
        assert m.fields["talkgroup"] == (3 << 8) | 42
        idle = parse_ltrnet(_word_from_payload(0, 5, 3, 255, 7))
        assert idle.message_type == T.OSW_SYSTEM_IDLE

    def test_osw_escape_channels(self):
        assert parse_ltrnet(_word_from_payload(0, 17, 21, 0, 0)) \
            .message_type == T.OSW_REGISTRATION_ACCEPT
        assert parse_ltrnet(_word_from_payload(0, 18, 21, 0, 0)) \
            .message_type == T.OSW_SITE_ID
        assert parse_ltrnet(_word_from_payload(0, 31, 1, 2, 3)) \
            .message_type == T.OSW_CALL_END
        # channel 24 with bit20 set (group MSB) is TX-frequency HIGH
        assert parse_ltrnet(_word_from_payload(0, 24, 0, 0x80, 0)) \
            .message_type == T.OSW_TRANSMIT_FREQUENCY_HIGH
        assert parse_ltrnet(_word_from_payload(0, 24, 0, 0, 0)) \
            .message_type == T.OSW_TRANSMIT_FREQUENCY_LOW
        assert parse_ltrnet(_word_from_payload(0, 25, 0, 0x80, 0)) \
            .message_type == T.OSW_RECEIVE_FREQUENCY_HIGH
        assert parse_ltrnet(_word_from_payload(0, 26, 2, 0x40, 0)) \
            .message_type == T.OSW_NEIGHBOR_ID

    def test_isw_typing(self):
        assert parse_ltrnet(_word_from_payload(0, 31, 1, 2, 3, "ISW"),
                            "ISW").message_type == T.ISW_CALL_END
        assert parse_ltrnet(_word_from_payload(0, 24, 0, 0, 0, "ISW"),
                            "ISW").message_type == T.ISW_UNIQUE_ID
        assert parse_ltrnet(_word_from_payload(0, 5, 3, 10, 21, "ISW"),
                            "ISW").message_type == T.ISW_CALL_START
        assert parse_ltrnet(_word_from_payload(0, 5, 3, 10, 31, "ISW"),
                            "ISW").message_type == T.ISW_REQUEST_ACCESS

    def test_checksum_rejects(self):
        w = _word_from_payload(0, 5, 3, 42, 7)
        w[35] ^= 1
        assert parse_ltrnet(w) is None

    def test_isw_checksum_127_escape(self):
        # deliberately wrong checksum transmitted as 127 with free=31
        payload = np.concatenate([
            from_int(0, 1), from_int(5, 5), from_int(3, 5),
            from_int(10, 8), from_int(31, 5)])
        assert ltr_checksum(payload) != 127
        word = np.concatenate([SYNC_OSW, payload, from_int(127, 7)])
        m = parse_ltrnet((word ^ 1).astype(np.uint8), "ISW")
        assert m is not None and m.message_type == T.ISW_REQUEST_ACCESS


class TestTracker:
    def test_frequency_learning_and_call_flow(self):
        tracker = LtrNetTracker()
        # rx frequency for channel 5: 178.875 MHz (the 4-bit high-units
        # field caps the 150 MHz + units*1250 formula below ~232 MHz)
        freq = 178_875_000
        units = (freq - 150_000_000) // 1250
        high, low = units >> 12, units & 0xFFF
        # high nibble rides bits 29-32 (free[1:5]); the type bit is
        # group's MSB (bit 20)
        w_high = _word_from_payload(0, 25, 5, 0x80, high)
        # low 12 bits ride bits 21-32: group[1:8] + free[0:5]
        w_low = _word_from_payload(0, 25, 5, (low >> 5) & 0x7F,
                                   low & 0x1F)
        m_high = parse_ltrnet(w_high)
        m_low = parse_ltrnet(w_low)
        assert m_high.message_type == T.OSW_RECEIVE_FREQUENCY_HIGH
        assert m_low.message_type == T.OSW_RECEIVE_FREQUENCY_LOW
        tracker.process(m_high)
        tracker.process(m_low)
        assert tracker.rx_freq[5] == 178_875_000

        start = parse_ltrnet(_word_from_payload(0, 5, 3, 42, 7))
        tracker.process(start)
        assert tracker.active_calls[5] == (3 << 8) | 42
        assert tracker.events[-1]["type"] == "CALL_START"
        assert tracker.events[-1]["frequency"] == 178_875_000

        end = parse_ltrnet(_word_from_payload(0, 31, 5, 42, 7))
        tracker.process(end)
        assert 5 not in tracker.active_calls
        assert tracker.events[-1]["type"] == "CALL_END"

    def test_site_and_esn(self):
        tracker = LtrNetTracker()
        site_word = _word_from_payload(0, 18, 21, 0x2A, 0x15)
        m = parse_ltrnet(site_word)
        tracker.process(m)
        # site = bits 23-32 = group[3:8]+free[0:5]
        assert tracker.site_id == ((0x2A & 0x1F) << 5) | 0x15
        hi = parse_ltrnet(_word_from_payload(0, 29, 0x12 >> 4 & 0x7,
                                             0, 0, "ISW"), "ISW")
        assert hi.message_type == T.ISW_REGISTRATION_REQUEST_ESN_HIGH


def test_ltrnet_end_to_end_fsk():
    """LTR-Net words -> square FSK audio -> LTRDecoder scan ->
    LtrNetFramer -> tracker events (the full signal chain)."""
    import jax.numpy as jnp
    from sdrtrunk_jax.decoders.ltr import LTRDecoder

    rng = np.random.default_rng(3)
    words = [
        ltrnet_encode_word(0, 18, 21, 0x2A, 0x15),   # site id
        ltrnet_encode_word(0, 5, 3, 42, 7),          # call start
        ltrnet_encode_word(0, 31, 5, 42, 7),         # call end
    ]
    tx_bits = np.concatenate(
        [rng.integers(0, 2, 25).astype(np.uint8)] + words
        + [rng.integers(0, 2, 30).astype(np.uint8)])
    sps = 8000.0 / 300.0
    n = int(np.ceil(len(tx_bits) * sps))
    sym = np.minimum((np.arange(n) / sps).astype(np.int64),
                     len(tx_bits) - 1)
    audio = (0.3 * (2.0 * tx_bits[sym] - 1.0)).astype(np.float32)
    dec = LTRDecoder()
    out, _ = dec(jnp.asarray(audio), dec.init_state())
    rx = np.asarray(out["bits"])[np.asarray(out["valid"])]
    tracker = LtrNetTracker()
    msgs = LtrNetFramer("OSW").process(rx)
    for m in msgs:
        tracker.process(m)
    assert tracker.site_id == ((0x2A & 0x1F) << 5) | 0x15
    types = [e["type"] for e in tracker.events]
    assert types == ["CALL_START", "CALL_END"]


class TestFramer:
    def test_stream_framing_across_chunks(self):
        words = [
            _word_from_payload(0, 18, 21, 0x2A, 0x15),
            _word_from_payload(0, 5, 3, 42, 7),
            _word_from_payload(0, 31, 5, 42, 7),
        ]
        stream = np.concatenate(
            [np.zeros(13, np.uint8)] +
            [np.concatenate([w, np.ones(5, np.uint8) * (i % 2)])
             for i, w in enumerate(words)])
        framer = LtrNetFramer("OSW")
        got = []
        for chunk in np.array_split(stream, 7):
            got.extend(framer.process(chunk))
        types = [m.message_type for m in got]
        assert T.OSW_SITE_ID in types
        assert T.OSW_CALL_START in types
        assert T.OSW_CALL_END in types
