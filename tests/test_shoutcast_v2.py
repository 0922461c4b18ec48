"""Shoutcast v2 / Ultravox 2.1 client against a scripted server socket:
framing round-trip, XTEA credential encryption, full handshake, and
MP3_DATA streaming (ultravox/UltravoxMessage.java wire format)."""
import struct

import pytest

from sdrtrunk_jax.audio.shoutcast_v2 import (ShoutcastV2Client,
                                             ShoutcastV2Config,
                                             UltravoxMessageType,
                                             pack_message, unpack_message,
                                             xtea_encrypt_hex)


def test_frame_roundtrip():
    raw = pack_message(UltravoxMessageType.MP3_DATA, b"\x01\x02\x03")
    msg_type, payload, rest = unpack_message(raw + b"tail")
    assert msg_type == UltravoxMessageType.MP3_DATA
    assert payload == b"\x01\x02\x03" and rest == b"tail"
    assert raw[0] == 0x5A
    # string payloads carry the trailing 0x00 in the length
    raw = pack_message(UltravoxMessageType.STANDBY, "hi")
    _, payload, _ = unpack_message(raw)
    assert payload == b"hi\x00"
    with pytest.raises(ValueError):
        unpack_message(b"\xFF" + raw[1:])


def _xtea_textbook(key: bytes, block: bytes) -> bytes:
    """Independent textbook XTEA encrypt (sum-based loop, the classic
    Needham/Wheeler form util/XTEA.java unrolls) to cross-check the
    client's precomputed-subkey implementation."""
    M = 0xFFFFFFFF
    k = struct.unpack(">4I", key[:16].ljust(16, b"\x00"))
    v0, v1 = struct.unpack(">2I", block)
    total = 0
    for _ in range(32):
        v0 = (v0 + (((((v1 << 4) & M) ^ (v1 >> 5)) + v1) & M
                    ^ (total + k[total & 3]) & M)) & M
        total = (total + 0x9E3779B9) & M
        v1 = (v1 + (((((v0 << 4) & M) ^ (v0 >> 5)) + v0) & M
                    ^ (total + k[(total >> 11) & 3]) & M)) & M
    return struct.pack(">2I", v0, v1)


def test_xtea_matches_textbook_form():
    from sdrtrunk_jax.audio.shoutcast_v2 import (_xtea_block,
                                                 _xtea_subkeys)
    for key, pt in ((bytes(range(16)), bytes.fromhex("0011223344556677")),
                    (b"cipherseed", b"password"),
                    (b"k", bytes(8))):
        s1, s2 = _xtea_subkeys(key)
        assert _xtea_block(pt, s1, s2) == _xtea_textbook(key, pt)
    # credential helper: 8-byte blocks, hex output, zero padding
    out = xtea_encrypt_hex("secretkey", "password1")   # 9 bytes -> 2 blocks
    assert len(out) == 32 and all(c in "0123456789abcdef" for c in out)
    # empty (non-None) credential pads to ONE zero block, like the
    # reference client (AuthenticateBroadcast.encrypt); None = absent
    s1, s2 = _xtea_subkeys(b"secretkey")
    assert xtea_encrypt_hex("secretkey", "") == \
        _xtea_block(bytes(8), s1, s2).hex()
    assert xtea_encrypt_hex("secretkey", None) == ""


class ScriptedServer:
    """Socket double that parses client messages and answers each with
    the scripted response payload."""

    def __init__(self, responses: dict):
        self.responses = dict(responses)
        self.received: list = []
        self._out = b""
        self._in = b""

    def sendall(self, data):
        self._in += data
        while True:
            try:
                msg_type, payload, rest = unpack_message(self._in)
            except ValueError:
                return
            self._in = rest
            self.received.append((msg_type, payload))
            resp = self.responses.get(msg_type, b"ACK\x00")
            if resp is not None:
                self._out += pack_message(msg_type, resp)

    def recv(self, n):
        out, self._out = self._out[:n], self._out[n:]
        return out

    def close(self):
        pass


def _config():
    return ShoutcastV2Config(name="jax feed", host="x", port=8000,
                             stream_id=5, user_id="u", password="pw",
                             bitrate=192000)


def test_handshake_and_streaming():
    server = ScriptedServer({
        UltravoxMessageType.REQUEST_CIPHER: b"ACK:cipherseed\x00",
    })
    client = ShoutcastV2Client(_config(), lambda h, p: server)
    assert client.connect()

    types = [t for t, _ in server.received]
    assert types[:5] == [
        UltravoxMessageType.REQUEST_CIPHER,
        UltravoxMessageType.AUTHENTICATE_BROADCAST,
        UltravoxMessageType.STREAM_MIME_TYPE,
        UltravoxMessageType.SETUP_BROADCAST,
        UltravoxMessageType.CONFIGURE_ICY_NAME,
    ]
    auth = dict(server.received)[
        UltravoxMessageType.AUTHENTICATE_BROADCAST].rstrip(b"\x00").decode()
    version, stream_id, enc_user, enc_pw = auth.split(":")
    assert version == "2.1" and stream_id == "5"
    assert enc_user == xtea_encrypt_hex("cipherseed", "u")
    assert enc_pw == xtea_encrypt_hex("cipherseed", "pw")

    client.send(b"\xFF\xFB" * 2000, chunk=1024)     # 4000 bytes -> 4 msgs
    data_msgs = [p for t, p in server.received
                 if t == UltravoxMessageType.MP3_DATA]
    assert len(data_msgs) == 4
    assert b"".join(data_msgs) == b"\xFF\xFB" * 2000


def test_auth_rejection():
    server = ScriptedServer({
        UltravoxMessageType.REQUEST_CIPHER: b"ACK:seed\x00",
        UltravoxMessageType.AUTHENTICATE_BROADCAST:
            b"NAK:invalid credentials\x00",
    })
    client = ShoutcastV2Client(_config(), lambda h, p: server)
    assert not client.connect()
    assert not client.connected
    with pytest.raises(ConnectionError):
        client.send(b"x")
