"""Golden-vector parity harness (VERDICT round-1 item 7; BASELINE.md
correctness row: "outputs match reference recordings within SNR/BER
bounds").

The reference community's workflow is record -> replay -> compare by
inspection (SURVEY.md §4.3, record/binary/BinaryRecorder.java:51). This
harness turns that into numbers:

  1. synthesize a known C4FM capture (ground-truth dibits + frames),
  2. decode it with the device path (the jitted C4FMDecoder chain),
  3. decode it with an INDEPENDENT host oracle — a scalar float64
     per-sample loop implementing the same published semantics
     (PSKDemodulator.java:101 receive -> CostasLoop -> interpolating
     buffer -> decision-directed evaluator) the way the reference runs
     it: one sample at a time, no vectorization, no float32 scan,
  4. compare: dibit BER of each path against ground truth, dibit
     agreement between paths, frame/event-stream equality, and a .bits
     round-trip through the reference byte format.

The oracle is this repo's own reimplementation from the update equations
(gains, clamps, orders documented in dsp/psk.py) — not a translation of
the Java — so agreement is evidence both derivations implement the spec,
and disagreement localizes to float32-vs-float64 or scan-vs-loop issues.
"""
from __future__ import annotations

import json
import math

import numpy as np

from .dsp.interpolator import CENTER, NSTEPS, interpolator_bank
from .dsp.psk import costas_gains

__all__ = ["host_c4fm_demod", "host_gardner_demod", "parity_report",
           "parity_report_dmr", "parity_report_gardner",
           "write_golden", "GOLDEN_PROTOCOLS"]

TWO_PI = 2.0 * math.pi


def host_c4fm_demod(iq: np.ndarray, sample_rate: float,
                    symbol_rate: float = 4800.0,
                    sample_counter_gain: float = 0.3,
                    loop_bandwidth: float = 300.0,
                    baseband_taps: np.ndarray | None = None,
                    agc_window: int = 32) -> np.ndarray:
    """Scalar float64 reference decode: returns the dibit stream.

    Mirrors the C4FMDecoder chain sample-by-sample: baseband FIR ->
    feed-forward AGC (trailing-window max) -> PLL mix -> interpolating
    buffer -> decision-directed symbol decision with timing/PLL feedback.
    """
    x = np.asarray(iq, np.complex128)
    if baseband_taps is not None:
        taps = np.asarray(baseband_taps, np.float64)
        x = np.convolve(x, taps)[:len(x)]     # causal, zero history
    # feed-forward AGC: per-sample gain from trailing window max envelope
    env = np.abs(x)
    agc_out = np.empty_like(x)
    for i in range(len(x)):
        w = env[max(0, i - agc_window + 1):i + 1]
        m = max(w.max(), 1e-4)
        agc_out[i] = x[i] / m
    x = agc_out

    sps = sample_rate / symbol_rate
    alpha, beta = costas_gains(loop_bandwidth)
    max_pll = TWO_PI * (symbol_rate / 2.0) / sample_rate
    dsps_gain = 0.1 * sample_counter_gain ** 2
    sps_min, sps_max = sps * 0.98, sps * 1.02
    bank = interpolator_bank()

    window = np.zeros(int(math.floor(2.0 * sps)), np.complex128)
    sampling_point = sps
    detected = sps
    pll_phase = 0.0
    pll_freq = 0.0
    prev_preceding = 0.0 + 0.0j
    prev_current = 0.0 + 0.0j
    dibits = []

    for s in x:
        pll_phase += pll_freq
        if pll_phase > TWO_PI:
            pll_phase -= TWO_PI
        elif pll_phase < -TWO_PI:
            pll_phase += TWO_PI
        mixed = s * complex(math.cos(pll_phase), math.sin(pll_phase))
        window[:-1] = window[1:]
        window[-1] = mixed
        sampling_point -= 1.0
        if sampling_point >= 1.0:
            continue

        mu = min(max(sampling_point, 0.0), 1.0)
        taps = bank[min(int(NSTEPS * mu), NSTEPS)]
        current = complex(np.dot(taps, window[:8].real),
                          np.dot(taps, window[:8].imag))
        preceding = window[CENTER]

        def norm(z):
            m = abs(z)
            return z / m if m > 1e-12 else 0.0j

        preceding_symbol = norm(preceding * prev_preceding.conjugate())
        current_symbol = norm(current * prev_current.conjugate())

        ci, cq = current_symbol.real, current_symbol.imag
        pq = preceding_symbol.imag
        if cq > 0.0:
            dibit = 0 if ci > 0.0 else 1
        else:
            dibit = 2 if ci > 0.0 else 3
        polarity = ((1.0 if pq > cq else -1.0) if ci > 0.0
                    else (1.0 if pq < cq else -1.0))
        ref_angle = math.pi / 4.0 + math.pi / 2.0 * {0: 0, 1: 1, 3: 2,
                                                     2: 3}[dibit]
        rot = current_symbol * complex(math.cos(ref_angle),
                                       -math.sin(ref_angle))
        err = min(max(rot.imag, -0.3), 0.3)
        phase_error = -err
        timing_error = err * polarity

        detected = min(max(detected + timing_error * dsps_gain, sps_min),
                       sps_max)
        sampling_point += detected + timing_error * sample_counter_gain

        perr = min(max(phase_error, -0.5), 0.5)
        pll_freq += beta * perr
        pll_phase += pll_freq + alpha * perr
        if pll_phase > TWO_PI:
            pll_phase -= TWO_PI
        elif pll_phase < -TWO_PI:
            pll_phase += TWO_PI
        pll_freq = min(max(pll_freq, -max_pll), max_pll)

        prev_preceding = preceding
        prev_current = current
        dibits.append(dibit)

    return np.asarray(dibits, np.uint8)


def host_gardner_demod(iq: np.ndarray, sample_rate: float,
                       symbol_rate: float = 4800.0,
                       sample_counter_gain: float = 0.3,
                       loop_bandwidth: float = 300.0,
                       baseband_taps: np.ndarray | None = None,
                       agc_window: int = 32) -> np.ndarray:
    """Scalar float64 Gardner-timing oracle (LSM / P25P2 core): mirrors
    GardnerDQPSKDemodulator sample-by-sample — two interpolation points
    per symbol (mid at mu, symbol at detectedSPS/2), amplitude-sensitive
    Gardner TED, same PLL/timing updates
    (DQPSKGardnerDemodulator.java:30-88,
    DQPSKGardnerSymbolEvaluator.java:63-106)."""
    x = np.asarray(iq, np.complex128)
    if baseband_taps is not None:
        taps = np.asarray(baseband_taps, np.float64)
        x = np.convolve(x, taps)[:len(x)]
    env = np.abs(x)
    agc_out = np.empty_like(x)
    for i in range(len(x)):
        w = env[max(0, i - agc_window + 1):i + 1]
        agc_out[i] = x[i] / max(w.max(), 1e-4)
    x = agc_out

    sps = sample_rate / symbol_rate
    alpha, beta = costas_gains(loop_bandwidth)
    max_pll = TWO_PI * (symbol_rate / 2.0) / sample_rate
    dsps_gain = 0.1 * sample_counter_gain ** 2
    sps_min, sps_max = sps * 0.98, sps * 1.02
    bank = interpolator_bank()
    window_len = max(int(math.floor(2.0 * sps)), int(sps * 1.02 / 2) + 9)

    window = np.zeros(window_len, np.complex128)
    sampling_point = sps
    detected = sps
    pll_phase = 0.0
    pll_freq = 0.0
    prev_mid = 0.0 + 0.0j
    prev_cur = 0.0 + 0.0j
    prev_cur_symbol = 0.0 + 0.0j
    dibits = []

    def interp(offset: float) -> complex:
        k = int(math.floor(offset))
        mu = offset - k
        taps = bank[min(int(NSTEPS * mu), NSTEPS)]
        base = min(max(k, 0), window_len - 8)
        w8 = window[base:base + 8]
        return complex(np.dot(taps, w8.real), np.dot(taps, w8.imag))

    def norm(z):
        m = abs(z)
        return z / m if m > 1e-12 else 0.0j

    for s in x:
        pll_phase += pll_freq
        if pll_phase > TWO_PI:
            pll_phase -= TWO_PI
        elif pll_phase < -TWO_PI:
            pll_phase += TWO_PI
        mixed = s * complex(math.cos(pll_phase), math.sin(pll_phase))
        window[:-1] = window[1:]
        window[-1] = mixed
        sampling_point -= 1.0
        if sampling_point >= 1.0:
            continue

        mu = min(max(sampling_point, 0.0), 1.0)
        mid_sample = interp(mu)
        cur_sample = interp(detected / 2.0)
        mid_symbol = norm(mid_sample * prev_mid.conjugate())
        cur_symbol = norm(cur_sample * prev_cur.conjugate())

        terr = ((prev_cur_symbol.real - cur_symbol.real) * mid_symbol.real
                + (prev_cur_symbol.imag - cur_symbol.imag) * mid_symbol.imag)
        terr = min(max(terr, -0.3), 0.3)

        ci, cq = cur_symbol.real, cur_symbol.imag
        if cq > 0.0:
            dibit = 0 if ci > 0.0 else 1
        else:
            dibit = 2 if ci > 0.0 else 3
        sgn_i = 1.0 if ci > 0.0 else -1.0
        sgn_q = 1.0 if cq > 0.0 else -1.0
        perr_raw = -(math.sqrt(0.5) * (cq * sgn_i - ci * sgn_q))
        perr_raw = min(max(perr_raw, -0.3), 0.3)

        detected = min(max(detected + terr * dsps_gain, sps_min), sps_max)
        sampling_point += detected + terr * sample_counter_gain

        perr = min(max(perr_raw, -0.5), 0.5)
        pll_freq += beta * perr
        pll_phase += pll_freq + alpha * perr
        if pll_phase > TWO_PI:
            pll_phase -= TWO_PI
        elif pll_phase < -TWO_PI:
            pll_phase += TWO_PI
        pll_freq = min(max(pll_freq, -max_pll), max_pll)

        prev_mid = mid_sample
        prev_cur = cur_sample
        prev_cur_symbol = cur_symbol
        dibits.append(dibit)

    return np.asarray(dibits, np.uint8)


def _aligned_ber(rx: np.ndarray, tx: np.ndarray, settle: int = 100,
                 span: int | None = None) -> float:
    """Best-alignment dibit error rate of rx against the known tx stream
    (2 bits per dibit counted as one symbol error)."""
    if span is None:
        span = len(tx) - settle - 50
    span = min(span, len(tx) - settle)
    best = 1.0
    for lag in range(0, max(1, len(rx) - settle - span)):
        seg = rx[lag + settle:lag + settle + span]
        if len(seg) < span:
            break
        best = min(best, float(np.mean(seg != tx[settle:settle + span])))
    return best


def parity_report(seed: int = 0, n_frames: int = 4,
                  sample_rate: float = 25000.0,
                  snr_db: float | None = None,
                  bits_path=None) -> dict:
    """Closed-loop parity numbers for the C4FM P25P1 chain."""
    import jax.numpy as jnp

    from .audio.recorder import BitsReader, BitsRecorder
    from .decoders.c4fm import C4FMConfig, C4FMDecoder
    from .protocol.p25p1.duid import DUID
    from .protocol.p25p1.framer import P25P1FrameAssembler, P25P1Framer
    from .protocol.p25p1.messages import decode_frame
    from .protocol.p25p1.tsbk import tsbk_encode
    from .signal import generators

    rng = np.random.default_rng(seed)
    asm = P25P1FrameAssembler(nac=0x293)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)]
    for _ in range(n_frames):
        parts += [asm.assemble(DUID.TSBK, tsbk_encode(0x3B, args)),
                  rng.integers(0, 4, 20).astype(np.uint8)]
    parts.append(np.zeros(40, np.uint8))
    tx = np.concatenate(parts)

    iq = generators.c4fm_modulate(tx, sample_rate).astype(np.complex64)
    if snr_db is not None:
        iq = generators.awgn(iq, snr_db, rng).astype(np.complex64)

    dec = C4FMDecoder(C4FMConfig(sample_rate=sample_rate))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    device_dibits = np.asarray(out["dibits"])[np.asarray(out["valid"])]

    host_dibits = host_c4fm_demod(
        iq, sample_rate, baseband_taps=np.asarray(dec.baseband_taps))

    def frames_of(dibits):
        out = []
        for f in P25P1Framer().process(dibits):
            m = decode_frame(f)
            if m.valid:
                out.append((m.duid.name, m.nac,
                            int(m.content.opcode)
                            if hasattr(m.content, "opcode") else -1))
        return out

    device_events = frames_of(device_dibits)
    host_events = frames_of(host_dibits)

    # .bits round trip in the reference byte format
    bits_roundtrip = None
    if bits_path is not None:
        rec = BitsRecorder(bits_path)
        rec.write(device_dibits)
        rec.close()
        back = BitsReader.read(bits_path)
        bits_roundtrip = bool(
            np.array_equal(back[:len(device_dibits)], device_dibits))

    n = min(len(device_dibits), len(host_dibits))
    return {
        "config": {"sample_rate": sample_rate, "frames": n_frames,
                   "snr_db": snr_db, "seed": seed},
        "tx_dibits": int(len(tx)),
        "device_dibits": int(len(device_dibits)),
        "host_dibits": int(len(host_dibits)),
        "device_ber_vs_truth": round(_aligned_ber(device_dibits, tx), 5),
        "host_ber_vs_truth": round(_aligned_ber(host_dibits, tx), 5),
        "path_agreement": round(
            float(np.mean(device_dibits[100:n] == host_dibits[100:n])), 5),
        "device_events": device_events,
        "host_events": host_events,
        "events_match": device_events == host_events,
        "frames_expected": n_frames,
        "frames_device": len(device_events),
        "frames_host": len(host_events),
        "bits_roundtrip_ok": bits_roundtrip,
    }


def _dmr_tx(seed: int = 0) -> np.ndarray:
    """Ground-truth DMR dibit stream: voice header + one AMBE voice
    superframe + terminator between filler runs."""
    from .protocol.dmr.framer import (DataType, DMRBurstAssembler,
                                      VOICE_FRAME_ORDER)
    from .protocol.dmr.lc import (MASK_TERMINATOR, MASK_VOICE_HEADER,
                                  embedded_lc_encode, full_lc_encode,
                                  lc_build_group_voice)
    from .protocol.dmr.sync import DMRSyncPattern
    from .protocol.edac.bptc import bptc_196_96_encode

    rng = np.random.default_rng(seed)
    asm = DMRBurstAssembler(color_code=1)
    ambe = rng.integers(0, 2, (3, 72)).astype(np.uint8)
    lc = lc_build_group_voice(group=0x222, source=0x333)
    vh = bptc_196_96_encode(full_lc_encode(lc, MASK_VOICE_HEADER))
    tlc = bptc_196_96_encode(full_lc_encode(lc, MASK_TERMINATOR))
    frags = embedded_lc_encode(lc)
    bursts = [asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                             DataType.VOICE_HEADER, vh),
              asm.voice_burst(DMRSyncPattern.BASE_STATION_VOICE, ambe)]
    for i, vf in enumerate(VOICE_FRAME_ORDER[:4]):
        bursts.append(asm.voice_burst(vf, ambe, emb_lcss=[1, 3, 3, 2][i],
                                      lc_fragment=frags[i]))
    bursts.append(asm.voice_burst(VOICE_FRAME_ORDER[4], ambe))
    bursts.append(asm.data_burst(DMRSyncPattern.BASE_STATION_DATA,
                                 DataType.TLC, tlc))
    return np.concatenate([
        rng.integers(0, 4, 150).astype(np.uint8),
        DMRBurstAssembler.to_dibits(bursts),
        np.zeros(40, np.uint8)])


def _dmr_events(dibits: np.ndarray) -> list:
    from .protocol.dmr.framer import DMRFramer
    return [(f.content_kind, int(f.timeslot))
            for f in DMRFramer().process(dibits)]


def parity_report_dmr(seed: int = 0,
                      sample_rate: float = 25000.0) -> dict:
    """Closed-loop parity for the DMR chain (DD core, timing gain 0.4)."""
    import jax.numpy as jnp

    from .decoders.dmr import DMRConfig, DMRDecoder
    from .signal import generators

    tx = _dmr_tx(seed)
    iq = generators.c4fm_modulate(tx, sample_rate).astype(np.complex64)

    dec = DMRDecoder(DMRConfig(sample_rate=sample_rate))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    device_dibits = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    host_dibits = host_c4fm_demod(
        iq, sample_rate, sample_counter_gain=0.4,
        baseband_taps=np.asarray(dec.baseband_taps))

    device_events = _dmr_events(device_dibits)
    host_events = _dmr_events(host_dibits)
    n = min(len(device_dibits), len(host_dibits))
    return {
        "protocol": "dmr",
        "device_ber_vs_truth": round(_aligned_ber(device_dibits, tx), 5),
        "host_ber_vs_truth": round(_aligned_ber(host_dibits, tx), 5),
        "path_agreement": round(
            float(np.mean(device_dibits[100:n] == host_dibits[100:n])), 5),
        "device_events": device_events,
        "host_events": host_events,
        "events_match": device_events == host_events,
        "frames_expected": 8,
        "frames_device": len(device_events),
    }


def parity_report_gardner(seed: int = 0,
                          sample_rate: float = 25000.0) -> dict:
    """Closed-loop parity for the Gardner-timed LSM chain (the P25P2
    core) on a linear pi/4 waveform with carrier offset + clock skew —
    the conditions the reference picked Gardner for."""
    import jax.numpy as jnp

    from .decoders.lsm import LSMConfig, LSMDecoder
    from .protocol.p25p1.duid import DUID
    from .protocol.p25p1.framer import P25P1FrameAssembler, P25P1Framer
    from .protocol.p25p1.messages import decode_frame
    from .protocol.p25p1.tsbk import tsbk_encode
    from .signal import generators

    rng = np.random.default_rng(seed)
    asm = P25P1FrameAssembler(nac=0x293)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)]
    for _ in range(4):
        parts += [asm.assemble(DUID.TSBK, tsbk_encode(0x3B, args)),
                  rng.integers(0, 4, 20).astype(np.uint8)]
    parts.append(np.zeros(40, np.uint8))
    tx = np.concatenate(parts)

    iq = generators.lsm_modulate(tx, sample_rate,
                                 symbol_rate=4800.0 * 1.01)
    t = np.arange(len(iq)) / sample_rate
    iq = (iq * np.exp(2j * np.pi * 200.0 * t)).astype(np.complex64)

    dec = LSMDecoder(LSMConfig(sample_rate=sample_rate))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    device_dibits = np.asarray(out["dibits"])[np.asarray(out["valid"])]
    host_dibits = host_gardner_demod(
        iq, sample_rate, baseband_taps=np.asarray(dec.baseband_taps))

    def frames_of(dibits):
        evts = []
        for f in P25P1Framer().process(dibits):
            m = decode_frame(f)
            if m.valid:
                evts.append((m.duid.name, m.nac))
        return evts

    device_events = frames_of(device_dibits)
    host_events = frames_of(host_dibits)
    n = min(len(device_dibits), len(host_dibits))
    return {
        "protocol": "lsm-gardner",
        "path_agreement": round(
            float(np.mean(device_dibits[100:n] == host_dibits[100:n])), 5),
        "device_events": device_events,
        "host_events": host_events,
        "events_match": device_events == host_events,
        "frames_expected": 4,
        "frames_device": len(device_events),
    }


# ------------------------------------------------------------- golden set

GOLDEN_PROTOCOLS = ("c4fm", "dmr", "lsm")


def write_golden(directory) -> dict:
    """Generate the checked-in golden fixture set: per protocol a
    reference-format .bits capture (the float64 HOST ORACLE's decode of
    a fixed-seed synthesized transmission — bit-deterministic across
    platforms, unlike XLA float32) plus the expected framed-event list.
    tests/test_golden.py re-derives both and compares byte-exactly."""
    import os

    from .audio.recorder import BitsRecorder
    from .protocol.p25p1.framer import P25P1Framer
    from .protocol.p25p1.messages import decode_frame

    os.makedirs(directory, exist_ok=True)
    manifest = {}

    rep = parity_report(seed=7)
    # c4fm: regenerate the host decode (parity_report doesn't return it)
    from .decoders.c4fm import C4FMConfig, C4FMDecoder
    from .protocol.p25p1.duid import DUID
    from .protocol.p25p1.framer import P25P1FrameAssembler
    from .protocol.p25p1.tsbk import tsbk_encode
    from .signal import generators

    rng = np.random.default_rng(7)
    asm = P25P1FrameAssembler(nac=0x293)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)]
    for _ in range(4):
        parts += [asm.assemble(DUID.TSBK, tsbk_encode(0x3B, args)),
                  rng.integers(0, 4, 20).astype(np.uint8)]
    parts.append(np.zeros(40, np.uint8))
    tx = np.concatenate(parts)
    iq = generators.c4fm_modulate(tx, 25000.0).astype(np.complex64)
    dec = C4FMDecoder(C4FMConfig(sample_rate=25000.0))
    dibits = host_c4fm_demod(iq, 25000.0,
                             baseband_taps=np.asarray(dec.baseband_taps))
    rec = BitsRecorder(os.path.join(directory, "c4fm.bits"))
    rec.write(dibits)
    rec.close()
    events = []
    for f in P25P1Framer().process(dibits):
        m = decode_frame(f)
        if m.valid:
            events.append([m.duid.name, int(m.nac),
                           int(m.content.opcode)
                           if hasattr(m.content, "opcode") else -1])
    manifest["c4fm"] = {"seed": 7, "sample_rate": 25000.0,
                        "dibits": int(len(dibits)), "events": events}

    # dmr
    tx = _dmr_tx(seed=7)
    iq = generators.c4fm_modulate(tx, 25000.0).astype(np.complex64)
    from .decoders.dmr import DMRConfig, DMRDecoder
    ddec = DMRDecoder(DMRConfig(sample_rate=25000.0))
    dibits = host_c4fm_demod(iq, 25000.0, sample_counter_gain=0.4,
                             baseband_taps=np.asarray(ddec.baseband_taps))
    rec = BitsRecorder(os.path.join(directory, "dmr.bits"))
    rec.write(dibits)
    rec.close()
    manifest["dmr"] = {"seed": 7, "sample_rate": 25000.0,
                       "dibits": int(len(dibits)),
                       "events": [[k, ts] for k, ts in _dmr_events(dibits)]}

    # lsm (gardner)
    rng = np.random.default_rng(7)
    asm = P25P1FrameAssembler(nac=0x293)
    args = rng.integers(0, 2, 64).astype(np.uint8)
    parts = [rng.integers(0, 4, 150).astype(np.uint8)]
    for _ in range(4):
        parts += [asm.assemble(DUID.TSBK, tsbk_encode(0x3B, args)),
                  rng.integers(0, 4, 20).astype(np.uint8)]
    parts.append(np.zeros(40, np.uint8))
    tx = np.concatenate(parts)
    iq = generators.lsm_modulate(tx, 25000.0).astype(np.complex64)
    from .decoders.lsm import LSMConfig, LSMDecoder
    ldec = LSMDecoder(LSMConfig(sample_rate=25000.0))
    dibits = host_gardner_demod(
        iq, 25000.0, baseband_taps=np.asarray(ldec.baseband_taps))
    rec = BitsRecorder(os.path.join(directory, "lsm.bits"))
    rec.write(dibits)
    rec.close()
    events = []
    for f in P25P1Framer().process(dibits):
        m = decode_frame(f)
        if m.valid:
            events.append([m.duid.name, int(m.nac)])
    manifest["lsm"] = {"seed": 7, "sample_rate": 25000.0,
                       "dibits": int(len(dibits)), "events": events}

    with open(os.path.join(directory, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def check_all(seed: int = 0, frames: int = 4, snr_db=None,
              protocols=("c4fm", "dmr", "lsm")) -> tuple[bool, list]:
    """Run the parity reports for `protocols` on JAX's default device and
    gate them: events match the host oracle, every frame is framed, and
    the device BER against the transmitted dibits is under 1% (c4fm,
    dmr). Returns (ok, [(name, report, passed)])."""
    import tempfile
    results = []
    if "c4fm" in protocols:
        with tempfile.NamedTemporaryFile(suffix=".bits") as f:
            rep = parity_report(seed=seed, n_frames=frames, snr_db=snr_db,
                                bits_path=f.name)
        results.append(("c4fm", rep, bool(
            rep["events_match"] and rep["frames_device"] == frames
            and rep["device_ber_vs_truth"] < 0.01)))
    if "dmr" in protocols:
        rep = parity_report_dmr(seed=seed)
        results.append(("dmr", rep, bool(
            rep["events_match"]
            and rep["frames_device"] == rep["frames_expected"]
            and rep["device_ber_vs_truth"] < 0.01)))
    if "lsm" in protocols:
        rep = parity_report_gardner(seed=seed)
        results.append(("lsm", rep, bool(
            rep["events_match"]
            and rep["frames_device"] == rep["frames_expected"])))
    return all(ok for _, _, ok in results), results


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="sdrtrunk_jax.parity")
    p.add_argument("--snr-db", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--protocols", default="c4fm,dmr,lsm",
                   help="comma list of c4fm,dmr,lsm")
    p.add_argument("--platform", choices=["cpu", "gpu"], default="cpu",
                   help="where the jitted decode chain runs (the host "
                        "oracle always runs in numpy float64)")
    p.add_argument("--write-golden", metavar="DIR", default=None,
                   help="regenerate the golden fixture set and exit")
    args = p.parse_args(argv)

    from .platform import select_platform
    select_platform(args.platform)
    if args.write_golden:
        print(json.dumps(write_golden(args.write_golden)))
        return 0

    ok, results = check_all(args.seed, args.frames, args.snr_db,
                            args.protocols.split(","))
    for _, rep, _ in results:
        print(json.dumps(rep))
    return 0 if ok else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
