"""CLI + config tests: playlist roundtrip/migration, decode/info/
channelize commands end-to-end on synthesized captures."""
import json

import numpy as np
import pytest

from sdrtrunk_jax import cli
from sdrtrunk_jax.config import (AliasEntry, ChannelConfig, DecodeConfig,
                                 Playlist, SourceConfig)
from sdrtrunk_jax.io.wave import write_complex_wave
from sdrtrunk_jax.signal import generators


def test_playlist_roundtrip(tmp_path):
    pl = Playlist(channels=[
        ChannelConfig(name="Dispatch",
                      source=SourceConfig(frequency_hz=851_000_000.0),
                      decode=DecodeConfig(decoder="p25p1", nac=0x293)),
    ], aliases=[AliasEntry(name="Fire", protocol="APCO25",
                           talkgroup_min=100, talkgroup_max=199,
                           record=True)])
    path = tmp_path / "playlist.json"
    pl.save(path)
    pl.save(path)  # second save creates a .backup
    assert path.with_suffix(".json.backup").exists()
    back = Playlist.load(path)
    assert back.channels[0].name == "Dispatch"
    assert back.channels[0].decode.nac == 0x293
    al = back.alias_list()
    from sdrtrunk_jax.runtime.identifiers import Identifier
    assert al.lookup(Identifier.talkgroup(150, protocol="APCO25")
                     ).name == "Fire"
    # corrupted file falls back to backup
    path.write_text("{corrupt")
    recovered = Playlist.load(path)
    assert recovered.channels[0].name == "Dispatch"


def test_decode_config_validation():
    with pytest.raises(ValueError):
        DecodeConfig(decoder="bogus")


def _write_p25_capture(tmp_path, fs=25000.0):
    from sdrtrunk_jax.protocol.p25p1 import DUID, P25P1FrameAssembler
    from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode
    rng = np.random.default_rng(0)
    asm = P25P1FrameAssembler(nac=0x2F7)
    parts = [rng.integers(0, 4, 50).astype(np.uint8)]
    for opcode in (0x3B, 0x00):
        parts.append(asm.assemble(
            DUID.TSBK, tsbk_encode(opcode, rng.integers(0, 2, 64))))
        parts.append(rng.integers(0, 4, 20).astype(np.uint8))
    dibits = np.concatenate(parts)
    iq = generators.c4fm_modulate(dibits, fs)
    path = tmp_path / "p25.wav"
    write_complex_wave(path, iq, int(fs))
    return path


def test_cli_decode_p25(tmp_path, capsys):
    path = _write_p25_capture(tmp_path)
    rc = cli.main(["decode", str(path), "--protocol", "p25p1"])
    assert rc == 0
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()]
    msgs = [l for l in lines
            if l.get("protocol") == "p25p1" and not l.get("summary")]
    assert len(msgs) == 2
    assert msgs[0]["opcode"] == "NET_STS_BCST"
    assert msgs[0]["nac"] == 0x2F7
    summary = [l for l in lines if l.get("summary")][0]
    assert summary["messages"] == 2


def test_cli_info_and_channelize(tmp_path, capsys):
    fs = 200_000.0
    tone = generators.tone(37500.0, fs, 16384, amplitude=0.5)
    path = tmp_path / "band.wav"
    write_complex_wave(path, tone, int(fs))
    rc = cli.main(["info", str(path)])
    assert rc == 0
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()]
    rows = [l for l in lines if "offset_hz" in l]
    hot = max(rows, key=lambda r: r["power_db"])
    assert abs(hot["offset_hz"] - 37500.0) < 12500.0

    rc = cli.main(["channelize", str(path), "--channels", "37500",
                   "--output", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    assert "channel_37500.wav" in out
    from sdrtrunk_jax.io.wave import read_complex_wave
    chan, rate = read_complex_wave(tmp_path / "channel_37500.wav")
    # extracted channel should hold a strong near-DC tone
    spec = np.abs(np.fft.fft(np.asarray(chan)[256:2304]))
    peak = np.fft.fftfreq(2048, 1 / rate)[np.argmax(spec)]
    assert abs(peak) < 2000.0


def test_cli_replay(tmp_path, capsys):
    fs = 400_000.0
    center = 851_000_000.0
    # NBFM channel at +37.5 kHz carrying a 700 Hz tone
    audio = np.sin(2 * np.pi * 700.0 * np.arange(6000) / 8000)
    iq = generators.nbfm_modulate(audio, 8000, fs)
    n = (len(iq) // 32) * 32
    off = 3 * 12500.0
    wb = (iq[:n] * np.exp(2j * np.pi * off * np.arange(n) / fs)
          ).astype(np.complex64)
    cap = tmp_path / "wb.wav"
    write_complex_wave(cap, wb, int(fs))
    pl = Playlist(channels=[ChannelConfig(
        name="FM1", source=SourceConfig(frequency_hz=center + off),
        decode=DecodeConfig(decoder="nbfm"))])
    ppath = tmp_path / "pl.json"
    pl.save(ppath)
    rc = cli.main(["replay", str(cap), "--playlist", str(ppath),
                   "--center-frequency", str(center)])
    assert rc == 0
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["summary"] and lines[-1]["channels"] == 1


def test_cli_replay_batched_digital(tmp_path, capsys):
    """Two P25P1 channels in one capture decode through the vmapped
    batched symbol-recovery path (one jit for the protocol group)."""
    from sdrtrunk_jax.protocol.p25p1.duid import DUID
    from sdrtrunk_jax.protocol.p25p1.framer import P25P1FrameAssembler
    from sdrtrunk_jax.protocol.p25p1.tsbk import tsbk_encode

    fs = 400_000.0
    center = 851_000_000.0
    rng = np.random.default_rng(2)
    asm = P25P1FrameAssembler(nac=0x293)
    tsbk = asm.assemble(DUID.TSBK, tsbk_encode(
        0x3A, rng.integers(0, 2, 64).astype(np.uint8)))
    # long alternating outer-level preamble for timing/PLL acquisition,
    # then the TSBK twice (either copy may land after convergence)
    preamble = np.tile([1, 3], 150).astype(np.uint8)
    dibits = np.concatenate([
        preamble, tsbk, rng.integers(0, 4, 20).astype(np.uint8),
        tsbk, rng.integers(0, 4, 20).astype(np.uint8)])
    chan_iq = generators.c4fm_modulate(dibits, fs)
    offs = [2 * 12500.0, -4 * 12500.0]
    n = (len(chan_iq) // 32) * 32
    t = np.arange(n)
    wb = sum(chan_iq[:n] * np.exp(2j * np.pi * o * t / fs)
             for o in offs).astype(np.complex64)
    cap = tmp_path / "wb2.wav"
    write_complex_wave(cap, wb, int(fs))
    pl = Playlist(channels=[
        ChannelConfig(name=f"P25-{i}",
                      source=SourceConfig(frequency_hz=center + o),
                      decode=DecodeConfig(decoder="p25p1", nac=0x293))
        for i, o in enumerate(offs)])
    ppath = tmp_path / "pl2.json"
    pl.save(ppath)
    rc = cli.main(["replay", str(cap), "--playlist", str(ppath),
                   "--center-frequency", str(center)])
    assert rc == 0
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["channels"] == 2
    tsbks = [l for l in lines if l.get("duid") == "TSBK" and l.get("valid")]
    channels_seen = {l["channel"] for l in tsbks}
    assert channels_seen == {"P25-0", "P25-1"}


def test_playlist_editor_cli(tmp_path, capsys):
    """Headless playlist editing: new -> add -> set -> disable ->
    remove round-trips through the versioned JSON with backups."""
    import json
    from sdrtrunk_jax.cli import main
    from sdrtrunk_jax.config import Playlist

    p = str(tmp_path / "p.json")
    assert main(["playlist", "new", "--playlist", p]) == 0
    assert main(["playlist", "add-channel", "--playlist", p,
                 "--name", "Ctrl", "--frequency", "460025000",
                 "--decoder", "p25p1", "--system", "Sys"]) == 0
    assert main(["playlist", "add-channel", "--playlist", p,
                 "--name", "FM", "--frequency", "154000000"]) == 0
    assert main(["playlist", "set", "--playlist", p, "--name", "FM",
                 "--field", "decode.squelch_threshold_db",
                 "--value", "-60"]) == 0
    assert main(["playlist", "set", "--playlist", p, "--name", "FM",
                 "--field", "record.audio", "--value", "true"]) == 0
    assert main(["playlist", "disable", "--playlist", p,
                 "--name", "Ctrl"]) == 0
    pl = Playlist.load(p)
    assert len(pl.channels) == 2
    fm = next(c for c in pl.channels if c.name == "FM")
    assert fm.decode.squelch_threshold_db == -60.0
    assert fm.record.audio is True
    assert not next(c for c in pl.channels if c.name == "Ctrl").enabled
    assert main(["playlist", "remove-channel", "--playlist", p,
                 "--name", "FM"]) == 0
    assert len(Playlist.load(p).channels) == 1
    capsys.readouterr()
    assert main(["playlist", "list", "--playlist", p]) == 0
    lines = [json.loads(l) for l in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[-1]["channels"] == 1
    # backup exists from the last save
    assert (tmp_path / "p.json.backup").exists()
