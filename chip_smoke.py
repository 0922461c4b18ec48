"""On-card smoke test of the live 1023-channel receiver.

Runs the product path once on one GPU, in one process, with data made
from --seed, and checks every part against the repo's plain references:

  device     the card, its power limit, JAX's version and compile cache
  kernels    channelizer vs numpy float64; slot selection vs numpy
             indexing; both symbol-recovery kernels vs XLA's scan at
             real widths (identical on clean input; agreement reported
             on noisy input); kernel and XLA times
  parity     the parity reports (device chain vs float64 host oracle)
  live       the Orchestrator in bank mode at 1023 slots, 12.8 MS/s:
             C4FM bank, then P25 Phase 2 bank; then `cli monitor` on a
             generated capture
  gpu_tests  the tests marked `gpu`, in this process

    python chip_smoke.py                # the phases above, one GPU
    python chip_smoke.py --four-cards   # only the sharded pipeline on a
                                        # 4-GPU mesh vs the same on one card

Every phase prints JSON lines; any failure exits non-zero. The last line
of a passing run is {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import sys
import tempfile
import time
from dataclasses import dataclass

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


@dataclass(frozen=True)
class Sizes:
    """What each phase runs at; FULL is the real deployment width."""
    m: int = 1024                  # channelizer bins (12.8 MS/s / 12.5 kHz)
    chunk_blocks: int = 5120       # 5.24 MS chunks, 10240 outputs per bin
    slots: int = 1023              # usable bins
    warmup_chunks: int = 3
    checked_chunks: int = 2
    impl: str = "kernel"           # symbol-recovery kernels as compiled
    monitor_channels: int = 8
    monitor_chunks: int = 6
    monitor_chunk_blocks: int = 2048
    seed: int = 0


FULL = Sizes()


class SmokeFailure(AssertionError):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}, default=_jsonable),
          flush=True)


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, np.bool_):
        return bool(v)
    return str(v)


def timed(fn, *args, n: int = 3):
    """(result, first-call seconds incl. compile, steady ms per call)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(fn(*args))
    return out, first, (time.perf_counter() - t0) / n * 1e3


# ------------------------------------------------------------------ device

def phase_device(sz: Sizes, cards: int) -> dict:
    import jax

    from sdrtrunk_jax.platform import (configure_compile_cache,
                                       gpu_name_and_power_limit)
    dev = jax.devices()[0]
    check(dev.platform == "gpu",
          f"JAX finds no GPU (platform {dev.platform!r})")
    check(len(jax.devices()) >= cards,
          f"need {cards} GPUs, JAX finds {len(jax.devices())}")
    cache = configure_compile_cache()
    smi = gpu_name_and_power_limit()
    print(smi, flush=True)
    log("device", nvidia_smi=smi, platform=dev.platform,
        kind=dev.device_kind, count=len(jax.devices()),
        jax=jax.__version__, compile_cache=cache)
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


# ----------------------------------------------------------------- kernels

def _modulated_block(kind: str, c: int, t: int, rate: float, rng,
                     snr_db: float | None = None) -> np.ndarray:
    """(C, T) complex64: row i is one modulated stream shifted by 7*i
    samples (distinct symbols per row); optional complex AWGN."""
    from sdrtrunk_jax.signal.generators import c4fm_modulate, lsm_modulate
    baud = 6000.0 if kind == "p25p2" else 4800.0
    n = t + 7 * c + 64
    dib = rng.integers(0, 4, int(n * baud / rate) + 32).astype(np.uint8)
    if kind == "p25p2":
        base = lsm_modulate(dib, sample_rate=rate, symbol_rate=baud)
    else:
        base = c4fm_modulate(dib, sample_rate=rate)
    x = base[(np.arange(c) * 7)[:, None] + np.arange(t)[None, :]]
    if snr_db is not None:
        sig = np.sqrt(np.mean(np.abs(x) ** 2) / 10 ** (snr_db / 10) / 2)
        x = x + sig * (rng.standard_normal(x.shape)
                       + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def _compare_loops(name: str, demod, sz: Sizes, kind: str, c: int, t: int,
                   rng) -> dict:
    """Kernel (as compiled) vs XLA's scan on clean and noisy input."""
    import jax
    import jax.numpy as jnp
    from dataclasses import replace
    kern = replace(demod, impl=sz.impl)
    st = jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                      demod.init_state())
    scan = jax.jit(demod._scan_batched)
    fast = jax.jit(kern.batched)
    out = {}
    for case, snr in (("clean", None), ("noisy", 8.0)):
        x = jnp.asarray(_modulated_block(kind, c, t, demod.sample_rate,
                                         rng, snr))
        (ds, vs, _), scan_first, scan_ms = timed(scan, x, st)
        (dk, vk, _), kern_first, kern_ms = timed(fast, x, st)
        ds, vs, dk, vk = map(np.asarray, (ds, vs, dk, vk))
        same = np.all((vs == vk) & (ds == dk), axis=1)
        diverge = [int(np.argmax((vs[i] != vk[i]) | (ds[i] != dk[i])))
                   for i in np.nonzero(~same)[0]]
        both = vs & vk
        out[case] = {
            "valid_agreement": float(np.mean(vs == vk)),
            "dibit_agreement": float(np.mean(ds[both] == dk[both])),
            "rows_identical": int(same.sum()), "rows": c,
            "first_divergence": min(diverge) if diverge else None,
            "symbols": int(vk.sum()),
            "kernel_ms": kern_ms, "xla_scan_ms": scan_ms,
            "kernel_first_call_s": kern_first,
            "xla_scan_first_call_s": scan_first}
    log("kernels", part=name, shape=[c, t], precision="float32",
        tolerance="clean input: identical dibits and valid masks",
        **out)
    check(out["clean"]["rows_identical"] == c,
          f"{name}: kernel differs from the scan on clean input")
    return out


def phase_kernels(sz: Sizes) -> dict:
    import jax
    import jax.numpy as jnp

    from sdrtrunk_jax.decoders.c4fm import C4FMConfig, C4FMDecoder
    from sdrtrunk_jax.decoders.p25p2 import P25P2Config, P25P2Decoder
    from sdrtrunk_jax.dsp.channelizer import (Channelizer, _channelize_core,
                                              reference_channelize)
    from sdrtrunk_jax.receiver import _dynamic_select_mix

    rng = np.random.default_rng(sz.seed)
    m = sz.m
    ch = Channelizer.design(m * 12500.0, 12500.0)
    hmat = np.asarray(ch.hmat)
    n = hmat.shape[0] * m + m * sz.chunk_blocks
    xp = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    y, first, ms = timed(lambda v: _channelize_core(v, hmat, m),
                         jnp.asarray(xp))
    ref = reference_channelize(xp, hmat, m)
    rel = float(np.max(np.abs(np.asarray(y) - ref))
                / np.sqrt(np.mean(np.abs(ref) ** 2)))
    log("kernels", part="channelizer", shape=list(y.shape), ms=ms,
        first_call_s=first, precision="float32, cuFFT IFFT",
        max_abs_err_over_rms=rel, tolerance=1e-4,
        reference="numpy float64 polyphase + IFFT")
    check(rel < 1e-4, f"channelizer error {rel} over rms exceeds 1e-4")

    # slot selection: the live path's gather against numpy indexing, and
    # the exact one-hot matmul it replaced, for the time
    bins = rng.permutation(m)[:sz.slots].astype(np.int32)
    pair = jnp.asarray(np.stack([bins, bins], 1))
    zeros = jnp.zeros((sz.slots,), jnp.float32)
    sel = jax.jit(lambda y, b: _dynamic_select_mix(
        y, jnp.int32(0), zeros, b, zeros, m)[0])
    got, _, gather_ms = timed(sel, y, pair, n=10)

    def onehot(y, b):
        oh = (b[None, :, 0] == jnp.arange(m)[:, None]).astype(jnp.float32)
        hi = jax.lax.Precision.HIGHEST
        return jax.lax.complex(jnp.dot(y.real, oh, precision=hi),
                               jnp.dot(y.imag, oh, precision=hi)).T
    _, _, onehot_ms = timed(jax.jit(onehot), y, pair, n=10)
    exact = bool(np.array_equal(np.asarray(got), np.asarray(y)[:, bins].T))
    log("kernels", part="slot_selection", slots=sz.slots,
        gather_ms=gather_ms, onehot_highest_ms=onehot_ms,
        bit_exact_vs_numpy=exact, precision="gather (data movement)")
    check(exact, "slot selection is not bit-exact against numpy indexing")

    k = 2 * sz.chunk_blocks
    dd = C4FMDecoder(C4FMConfig(sample_rate=ch.channel_sample_rate)).demod
    gd = P25P2Decoder(P25P2Config(sample_rate=ch.channel_sample_rate)).demod
    return {
        "decision_directed": _compare_loops(
            "decision_directed", dd, sz, "c4fm", sz.slots, k, rng),
        "gardner": _compare_loops(
            "gardner", gd, sz, "p25p2", sz.slots, 2 * k, rng)}


# ------------------------------------------------------------------ parity

def phase_parity(sz: Sizes) -> dict:
    from sdrtrunk_jax.parity import check_all
    ok, results = check_all(seed=sz.seed)
    for name, rep, passed in results:
        log("parity", check=name, passed=passed, report=rep)
    check(ok, "parity: " + ", ".join(n for n, _, p in results if not p))
    return {name: passed for name, _, passed in results}


# -------------------------------------------------------------------- live

def _segment_ids(segments) -> tuple[set, set]:
    from sdrtrunk_jax.runtime.identifiers import IdentifierForm
    tgs, srcs = set(), set()
    for seg in segments:
        for ident in seg.identifiers.all():
            if ident.form == IdentifierForm.TALKGROUP:
                tgs.add(ident.value)
            elif ident.form == IdentifierForm.RADIO:
                srcs.add(ident.value)
    return tgs, srcs


def _live_bank(kind: str, sz: Sizes) -> dict:
    import jax

    from sdrtrunk_jax.signal.traffic import (SOURCE, TALKGROUP,
                                             bank_orchestrator, bank_traffic)
    t0 = time.perf_counter()
    traffic = bank_traffic(kind, sz.slots,
                           sz.warmup_chunks + sz.checked_chunks,
                           sz.chunk_blocks, seed=sz.seed)
    orch = bank_orchestrator(traffic)
    setup_s = time.perf_counter() - t0
    check(orch.bank_mode and len(orch.slots) == sz.slots,
          f"{kind}: expected a {sz.slots}-slot bank")

    # compile the live step ahead of time to read its memory analysis,
    # then let the orchestrator run that same executable
    dev_iq = orch._upload(orch._prepare(traffic.chunks[0]))
    plan = (jax.numpy.asarray(orch.bins), jax.numpy.asarray(orch.steps))
    t0 = time.perf_counter()
    compiled = orch.step.lower(dev_iq, orch.state, *plan).compile()
    compile_s = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    orch.step = compiled

    t0 = time.perf_counter()
    orch.run(max_chunks=sz.warmup_chunks)
    warm_s = time.perf_counter() - t0
    before = int(orch.bank_proc.frame_counts.sum())
    t0 = time.perf_counter()
    orch.run(max_chunks=sz.checked_chunks)
    run_s = time.perf_counter() - t0
    frames = int(orch.bank_proc.frame_counts.sum()) - before
    for slot in orch.slots:
        if slot.active:
            orch._slot_flush_drain(slot)
    segs = [s for s in orch.audio_segments if s.duration > 0]
    tgs, srcs = _segment_ids(segs)
    seconds = sz.checked_chunks * traffic.chunk_samples / 12.8e6
    info = traffic.info
    expected = sz.slots * seconds * info["frames_per_cycle"] \
        / info["cycle_seconds"]
    result = {
        "slots": sz.slots, "chunk_samples": traffic.chunk_samples,
        "setup_s": setup_s, "compile_s": compile_s, "warmup_s": warm_s,
        "checked_s": run_s,
        "realtime_factor_checked": seconds / run_s,
        "frames_checked": frames, "frames_expected": expected,
        "frames_per_slot_per_s": frames / sz.slots / seconds,
        "audio_segments": len(segs),
        "talkgroups": sorted(tgs), "sources": sorted(srcs),
        "memory_analysis": {
            f: int(getattr(mem, f)) for f in (
                "argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "generated_code_size_in_bytes")
            if hasattr(mem, f)},
    }
    orch.close()
    log("live", bank=kind, **result)
    check(frames >= 0.85 * expected,
          f"{kind}: {frames} frames decoded, {expected:.0f} transmitted")
    check(tgs == {TALKGROUP} and srcs == {SOURCE},
          f"{kind}: talkgroups {tgs} / sources {srcs} differ from the "
          f"transmitted {TALKGROUP:#x} / {SOURCE:#x}")
    check(len(segs) > 0, f"{kind}: no audio segments")
    return result


def _cli_monitor(sz: Sizes) -> dict:
    """`cli monitor` on a generated capture with an event log."""
    from sdrtrunk_jax import cli
    from sdrtrunk_jax.config import (ChannelConfig, DecodeConfig, Playlist,
                                     SourceConfig)
    from sdrtrunk_jax.io.wave import write_complex_wave
    from sdrtrunk_jax.signal.traffic import CENTER_HZ, bank_traffic

    traffic = bank_traffic("c4fm", sz.monitor_channels, sz.monitor_chunks,
                           sz.monitor_chunk_blocks, seed=sz.seed)
    iq = np.concatenate(traffic.chunks).astype(np.float32) / 127.0
    with tempfile.TemporaryDirectory() as tmp:
        capture = os.path.join(tmp, "capture.wav")
        write_complex_wave(capture, iq[:, 0] + 1j * iq[:, 1],
                           int(sz.m * 12500))
        playlist = Playlist(channels=[ChannelConfig(
            name=f"ch{i}", system="Smoke", site="S1",
            source=SourceConfig(frequency_hz=CENTER_HZ + off),
            decode=DecodeConfig(decoder="p25p1"))
            for i, off in enumerate(traffic.offsets)])
        ppath = os.path.join(tmp, "playlist.json")
        playlist.save(ppath)
        events = os.path.join(tmp, "events.jsonl")
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(["--platform", "gpu", "monitor",
                           "--playlist", ppath, "--input", capture,
                           "--center-frequency", str(CENTER_HZ),
                           "--audio-dir", os.path.join(tmp, "audio"),
                           "--event-log", events,
                           "--chunk-samples", str(sz.m * 512), "--quiet"])
        wall = time.perf_counter() - t0
        summary = [json.loads(line) for line in out.getvalue().splitlines()
                   if line.startswith("{") and '"summary"' in line][-1]
        n_events = len(open(events).read().strip().splitlines())
    result = {"rc": rc, "wall_s": wall, "events_logged": n_events,
              "events": summary["events"],
              "audio_segments": summary["audio_segments"],
              "channels": sz.monitor_channels}
    log("live", part="cli_monitor", **result)
    check(rc == 0, f"cli monitor exited {rc}")
    check(n_events > 0 and summary["audio_segments"] > 0,
          "cli monitor decoded no events or audio")
    return result


def phase_live(sz: Sizes) -> dict:
    import jax
    import jax.numpy as jnp

    # complex64 across the jit boundary on the card
    z = (np.arange(8) + 1j * np.arange(8)[::-1]).astype(np.complex64)
    back = np.asarray(jax.jit(lambda v: v * (1 + 1j))(jnp.asarray(z)))
    ok = bool(np.allclose(back, z * (1 + 1j)))
    log("live", part="complex64_jit_boundary", ok=ok)
    check(ok, "complex64 did not cross the jit boundary intact")
    out = {}
    for kind in ("c4fm", "p25p2"):
        t0 = time.perf_counter()
        out[kind] = _live_bank(kind, sz)
        out[kind]["wall_s"] = time.perf_counter() - t0
    out["cli_monitor"] = _cli_monitor(sz)
    return out


# --------------------------------------------------------------- gpu tests

def phase_gpu_tests(sz: Sizes) -> dict:
    import pytest
    rc = pytest.main(["-q", "-p", "no:cacheprovider", "-m", "gpu",
                      os.path.join(HERE, "tests", "test_gpu.py")])
    log("gpu_tests", exit_code=int(rc))
    check(rc == 0, f"gpu-marked tests failed (pytest exit {int(rc)})")
    return {"exit_code": int(rc)}


# -------------------------------------------------------------- four cards

def phase_four_cards(sz: Sizes) -> dict:
    """The sharded pipeline (time-sharded channelizer with the halo
    ppermute, all_to_all channel transpose) on a 4-device mesh, then both
    symbol-recovery kernels on the channel-sharded streams inside
    shard_map — compared with the same work on one card."""
    import jax
    import jax.numpy as jnp
    from dataclasses import replace
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from sdrtrunk_jax.dsp.channelizer import Channelizer
    from sdrtrunk_jax.dsp.extract import extract_channels, plan_channels
    from sdrtrunk_jax.dsp.psk import DQPSKDemodulator, GardnerDQPSKDemodulator
    from sdrtrunk_jax.parallel.pipeline import ShardedChannelizerPipeline
    from sdrtrunk_jax.signal.traffic import bank_traffic

    devs = jax.devices()[:4]
    mesh = Mesh(np.array(devs), ("shard",))
    m = sz.m
    ch = Channelizer.design(m * 12500.0, 12500.0)
    traffic = bank_traffic("c4fm", sz.slots, 1, sz.chunk_blocks,
                           seed=sz.seed)
    plan = plan_channels(ch, traffic.offsets)
    x = (traffic.chunks[0][:, 0] + 1j * traffic.chunks[0][:, 1]
         ).astype(np.complex64) / 127.0
    pipe = ShardedChannelizerPipeline(ch, plan, mesh)
    run4 = pipe.build()
    x4 = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("shard")))
    s4, first4, ms4 = timed(run4, x4)

    one = jax.jit(lambda v: extract_channels(ch(v)[0], plan)[0])
    x1 = jax.device_put(jnp.asarray(x), devs[0])
    s1, first1, ms1 = timed(one, x1)
    s4n, s1n = np.asarray(s4), np.asarray(s1)
    rel = float(np.max(np.abs(s4n - s1n))
                / np.sqrt(np.mean(np.abs(s1n) ** 2)))
    log("four_cards", part="sharded_channelizer", mesh=dict(mesh.shape),
        channels=plan.count, shape=list(s4n.shape),
        four_card_ms=ms4, one_card_ms=ms1, first_call_s=[first4, first1],
        max_abs_err_over_rms=rel, tolerance=1e-5)
    check(s4n.shape == s1n.shape and rel < 1e-5,
          f"sharded pipeline differs from one card ({rel})")

    out = {"channelizer_rel_err": rel}
    cp = pipe.padded_count
    rows = np.concatenate([s1n, np.repeat(s1n[-1:], cp - plan.count, 0)])
    for name, demod in (
            ("decision_directed", DQPSKDemodulator(ch.channel_sample_rate)),
            ("gardner", GardnerDQPSKDemodulator(ch.channel_sample_rate))):
        demod = replace(demod, impl=sz.impl)
        st = jax.tree.map(lambda a: jnp.broadcast_to(a, (cp,) + a.shape),
                          demod.init_state())
        shard = NamedSharding(mesh, P("shard"))
        f4 = jax.jit(jax.shard_map(
            demod.batched, mesh=mesh, in_specs=(P("shard"), P("shard")),
            out_specs=P("shard"), check_vma=False))
        (d4, v4, _), _, k4_ms = timed(
            f4, jax.device_put(jnp.asarray(rows), shard),
            jax.device_put(st, shard))
        (d1, v1, _), _, k1_ms = timed(
            jax.jit(demod.batched), jax.device_put(jnp.asarray(rows),
                                                   devs[0]),
            jax.device_put(st, devs[0]))
        same = bool(np.array_equal(np.asarray(d4), np.asarray(d1))
                    and np.array_equal(np.asarray(v4), np.asarray(v1)))
        log("four_cards", part=name, four_card_ms=k4_ms, one_card_ms=k1_ms,
            identical=same, symbols=int(np.asarray(v4).sum()))
        check(same, f"{name}: sharded kernel differs from one card")
        out[name] = {"four_card_ms": k4_ms, "one_card_ms": k1_ms}
    return out


# -------------------------------------------------------------------- main

PHASES = {"kernels": phase_kernels, "parity": phase_parity,
          "live": phase_live, "gpu_tests": phase_gpu_tests,
          "four_cards": phase_four_cards}


def select_phases(four_cards: bool) -> list[str]:
    """Phases after `device`: the one-card run, or only the four-card
    comparison."""
    if four_cards:
        return ["four_cards"]
    return ["kernels", "parity", "live", "gpu_tests"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the sharded pipeline on 4 GPUs and "
                             "its one-card comparison")
    parser.add_argument("--seed", type=int, default=FULL.seed)
    args = parser.parse_args(argv)
    sizes = Sizes(seed=args.seed)
    sys.path.insert(0, HERE)

    device = phase_device(sizes, 4 if args.four_cards else 1)
    walls = {}
    for name in select_phases(args.four_cards):
        t0 = time.perf_counter()
        try:
            PHASES[name](sizes)
        except Exception as e:
            log(name, ok=False, error=f"{type(e).__name__}: {e}")
            raise
        walls[name] = time.perf_counter() - t0
        log(name, ok=True, wall_s=walls[name])
    print(json.dumps({"ok": True, "device": device}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
