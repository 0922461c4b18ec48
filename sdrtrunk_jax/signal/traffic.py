"""Synthetic wideband traffic for the live slot-bank path.

Every usable bin of a 12.8 MS/s capture (1024 x 12.5 kHz) carries its own
copy of one protocol's call cycle, started at a random offset, summed
through the PR synthesis bank and quantized to the live wire format
(int8 IQ pairs). bench.py and chip_smoke.py share these generators, so
what the benchmark times is what the smoke checks.

Call cycles (what each slot transmits, so a decode can be checked
against it):
  * c4fm:  P25 Phase 1 LDU1/LDU2 x2 + TDULC, group voice LC
           talkgroup 0x457 / source 0xABCDE;
  * dmr:   voice header, 4 voice superframes with embedded LC, terminator
           (group 0x222, source 0x333);
  * p25p2: scrambled HDQPSK SACCH PTT + VOICE_4 fragments at 6000 baud,
           then END_PTT (talkgroup 0x457, source 0xABCDE);
  * nbfm:  a 700 Hz tone.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["BankTraffic", "bank_traffic", "bank_orchestrator",
           "synth_iq8_chunks", "TALKGROUP", "SOURCE", "P25P2_SYSTEM"]

M = 1024
SAMPLE_RATE = M * 12500.0
CENTER_HZ = 460e6
TALKGROUP, SOURCE = 0x457, 0xABCDE
DMR_GROUP, DMR_SOURCE = 0x222, 0x333
P25P2_SYSTEM = (0xA4BC3, 0x123, 0x29A)      # wacn, system, nac


def synth_iq8_chunks(base, starts, bins, k, m, total_chunks, chunk,
                     hmat, amp=0.5):
    """Synthesize int8 wideband chunks through the PR synthesis bank WITH
    filter-state carry across chunk boundaries: each call re-synthesizes
    the previous chunk's last 2T blocks (pad, even so block parity is
    preserved) and discards the warm-up, which equals one-shot synthesis
    exactly. Independent per-chunk synthesis would lose the overlap-add
    tail at every seam and corrupt ~2T*M/2 samples across ALL channels
    per boundary, an artifact a real capture never has."""
    from ..dsp.synthesizer import synthesize_bank
    hmat = np.asarray(hmat)
    pad = 2 * hmat.shape[0]
    half = m // 2
    tail = np.zeros((pad, m), np.complex64)
    xs = []
    for j in range(total_chunks):
        u = np.zeros((pad + k, m), np.complex64)
        u[:pad] = tail
        idx = starts[:, None] + j * k + np.arange(k)[None, :]
        u[pad:, bins] = base[idx].T * amp
        tail = u[-pad:].copy()
        xs.append(synthesize_bank(u, hmat)[pad * half: pad * half + chunk])
    scale = 118.0 / max(max(np.abs(x.real).max(), np.abs(x.imag).max())
                        for x in xs)
    return [np.clip(np.stack([x.real, x.imag], -1) * scale, -127, 127
                    ).astype(np.int8) for x in xs]


def _p25p1_cycle(rng) -> np.ndarray:
    from ..protocol.p25p1.duid import DUID
    from ..protocol.p25p1.framer import P25P1FrameAssembler
    from ..protocol.p25p1.hdu import tdulc_encode
    from ..protocol.p25p1.lc import lc_build_group_voice
    from ..protocol.p25p1.ldu import ldu1_encode, ldu2_encode
    asm = P25P1FrameAssembler()
    lc = lc_build_group_voice(TALKGROUP, SOURCE)
    p1 = ldu1_encode(lc, rng.integers(0, 2, (9, 144)).astype(np.uint8))
    p2 = ldu2_encode(rng.integers(0, 2, 72).astype(np.uint8), 0x80, 1,
                     rng.integers(0, 2, (9, 144)).astype(np.uint8))
    # two LDU pairs then a terminator, so calls END and the voice ->
    # AudioSegment egress runs
    return np.concatenate([asm.assemble(DUID.LDU1, p1),
                           asm.assemble(DUID.LDU2, p2),
                           asm.assemble(DUID.LDU1, p1),
                           asm.assemble(DUID.LDU2, p2),
                           asm.assemble(DUID.TDULC, tdulc_encode(lc))])


def _dmr_cycle(rng) -> np.ndarray:
    from ..protocol.bits import bits_to_dibits
    from ..protocol.dmr.framer import (DataType, DMRBurstAssembler,
                                       VOICE_FRAME_ORDER)
    from ..protocol.dmr.lc import (MASK_TERMINATOR, MASK_VOICE_HEADER,
                                   embedded_lc_encode, full_lc_encode,
                                   lc_build_group_voice)
    from ..protocol.dmr.sync import DMRSyncPattern
    from ..protocol.edac.bptc import bptc_196_96_encode
    asm = DMRBurstAssembler(color_code=1)
    lc = lc_build_group_voice(group=DMR_GROUP, source=DMR_SOURCE)
    vh = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
    tlc = bptc_196_96_encode(full_lc_encode(lc, MASK_TERMINATOR))
    frags = embedded_lc_encode(lc)
    cycle = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                            DataType.VOICE_HEADER, vh)]
    for _ in range(4):                      # 4 voice superframes
        ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
        cycle.append(asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE,
                                     ambe))
        for i, vf in enumerate(VOICE_FRAME_ORDER):
            cycle.append(asm.voice_burst(
                vf, ambe, emb_lcss=[1, 3, 3, 2, 0][i],
                lc_fragment=frags[i] if i < 4 else None))
    cycle.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                DataType.TLC, tlc))
    return bits_to_dibits(np.concatenate(cycle))


def _p25p2_cycle(rng) -> np.ndarray:
    from ..protocol.bits import from_int
    from ..protocol.p25p2 import P25P2FragmentAssembler
    from ..protocol.p25p2.timeslot import (MacPduType, sacch_encode,
                                           voice4_encode)
    wacn, system, nac = P25P2_SYSTEM
    asm = P25P2FragmentAssembler(wacn=wacn, system=system, nac=nac)
    ptt = np.zeros(180, np.uint8)
    ptt[0:3] = from_int(MacPduType.PTT.value, 3)
    ptt[80:88] = from_int(0x80, 8)
    ptt[104:128] = from_int(SOURCE, 24)
    ptt[128:144] = from_int(TALKGROUP, 16)
    endptt = np.zeros(180, np.uint8)
    endptt[0:3] = from_int(MacPduType.END_PTT.value, 3)
    endptt[104:128] = from_int(SOURCE, 24)
    endptt[128:144] = from_int(TALKGROUP, 16)
    frames = rng.integers(0, 2, (4, 72)).astype(np.uint8)
    frags = [asm.assemble(i, [sacch_encode(ptt, scrambled=True),
                              voice4_encode(frames),
                              sacch_encode(ptt, scrambled=True),
                              voice4_encode(frames)])
             for i in range(3)]
    # calls END once per cycle so voice -> AudioSegment egress runs
    frags.append(asm.assemble(0, [sacch_encode(endptt, scrambled=True),
                                  voice4_encode(frames),
                                  sacch_encode(endptt, scrambled=True),
                                  voice4_encode(frames)]))
    return P25P2FragmentAssembler.to_dibits(frags)


@dataclass
class BankTraffic:
    """int8 wideband chunks with every slot's transmission."""
    kind: str
    chunks: list
    offsets: list                 # baseband offset (Hz) of each slot
    chunk_samples: int
    cycle: np.ndarray | None = None     # dibits each slot repeats
    info: dict = field(default_factory=dict)

    def source(self):
        """Orchestrator source: read(num) -> the next whole chunk."""
        pos = 0

        def read(num):
            nonlocal pos
            j = pos // self.chunk_samples
            pos += num
            return self.chunks[j] if j < len(self.chunks) else None
        return read


def bank_traffic(kind: str, slots: int = 1023, total_chunks: int = 7,
                 chunk_blocks: int | None = None,
                 seed: int = 0) -> BankTraffic:
    """Synthesize `total_chunks` chunks of M * chunk_blocks samples with
    `slots` channels of `kind` ('c4fm', 'dmr', 'p25p2' or 'nbfm').
    chunk_blocks defaults to 5120 (5.24 MS, 0.41 s), and to 6400 for
    nbfm, whose 8 kHz resampler needs the per-channel block to be a
    multiple of 25."""
    if chunk_blocks is None:
        chunk_blocks = 6400 if kind == "nbfm" else 5120
    from ..dsp.channelizer import Channelizer
    from .generators import c4fm_modulate, lsm_modulate, nbfm_modulate
    chunk = M * chunk_blocks
    k = 2 * chunk // M                  # per-channel samples per chunk
    rng = np.random.default_rng(seed)
    ch = Channelizer.design(SAMPLE_RATE, 12500.0)
    offsets = [(i - M // 2 + 1) * 12500.0 for i in range(M - 1)][:slots]
    bins = np.array([ch.channel_for_frequency(o) for o in offsets])
    cycle, info = None, {}
    if kind == "nbfm":
        starts = rng.integers(0, 25000, slots)
        need_audio = int((total_chunks * k + M) / 25000.0 * 8000.0) + 8000
        audio = 0.7 * np.sin(2 * np.pi * 700.0 *
                             np.arange(need_audio) / 8000.0)
        base = nbfm_modulate(audio, 8000.0, 25000.0).astype(np.complex64)
    else:
        build, reps, mod = {
            "c4fm": (_p25p1_cycle, 5, c4fm_modulate),
            "dmr": (_dmr_cycle, 3, c4fm_modulate),
            "p25p2": (_p25p2_cycle, 3, lsm_modulate)}[kind]
        cycle = build(rng)
        # framed units per cycle (LDUs + TDULC; DMR bursts; P25P2
        # fragments) and the symbol rate, for decode-rate checks
        info = {"frames_per_cycle": {"c4fm": 5, "dmr": 26, "p25p2": 4}[kind],
                "baud": 6000.0 if kind == "p25p2" else 4800.0,
                "cycle_seconds": len(cycle) / (6000.0 if kind == "p25p2"
                                               else 4800.0)}
        # per-slot start offsets de-correlate sync lags; no wrap-around
        # (a mid-frame wrap would fabricate one corrupted frame per slot)
        starts = rng.integers(0, len(cycle) * reps, slots)
        need = int(starts.max()) + (total_chunks + 1) * k + len(cycle)
        dibits = np.tile(cycle, need // (len(cycle) * 4) + 2)
        if kind == "p25p2":
            base = mod(dibits, sample_rate=25000.0, symbol_rate=6000.0)
        else:
            base = mod(dibits, sample_rate=25000.0)
        base = base.astype(np.complex64)
        assert len(base) >= need
    chunks = synth_iq8_chunks(base, starts, bins, k, M, total_chunks,
                              chunk, ch.hmat)
    return BankTraffic(kind=kind, chunks=chunks, offsets=offsets,
                       chunk_samples=chunk, cycle=cycle, info=info)


def bank_orchestrator(traffic: BankTraffic, **kwargs):
    """The live Orchestrator over `traffic`: slot 0 pinned as the control
    channel, every other slot activated as a traffic channel, bank mode
    (auto at >= 32 slots; forced for nbfm). P25 Phase 2 slots get the
    system's scramble parameters (the control channel's preload in a
    deployment)."""
    from ..runtime.identifiers import IdentifierCollection
    from ..runtime.orchestrator import Orchestrator
    kind = traffic.kind
    slots = len(traffic.offsets)
    orch = Orchestrator(
        traffic.source(), SAMPLE_RATE, CENTER_HZ, [traffic.offsets[0]],
        slots=slots, decoder=kind, chunk_samples=traffic.chunk_samples,
        idle_teardown_seconds=1e9, ppm_correction=False,
        bank_mode=True if kind == "nbfm" else None, **kwargs)
    for off in traffic.offsets[1:]:
        orch._activate(CENTER_HZ + off, IdentifierCollection())
    if kind == "p25p2":
        wacn, system, nac = P25P2_SYSTEM
        if orch.bank_host is not None:
            for s in range(slots):
                orch.bank_host.reset_slot(
                    s, extra={"scramble_key": P25P2_SYSTEM},
                    frequency=CENTER_HZ + traffic.offsets[s])
        else:
            for s in range(slots):
                orch.bank_proc.framer.set_scramble_parameters(
                    s, wacn, system, nac)
                if orch.bank_proc.states[s] is not None:
                    orch.bank_proc.states[s].scramble_key = P25P2_SYSTEM
    return orch
