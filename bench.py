"""Benchmark: wideband IQ throughput through the receiver and the live loop.

Measures, in ONE process on one GPU (a second JAX process could not open
the card the first one holds):
  * nbfm / c4fm: 12.8 MS/s wideband -> 1024-bin polyphase channelizer ->
    all 1023 usable bins -> NBFM audio / DQPSK dibits (WidebandReceiver);
  * kernels_vs_xla: the symbol-recovery kernels against XLA's scan;
  * live_<kind>: the live Orchestrator in bank mode at 1023 slots on
    synthetic traffic (sdrtrunk_jax/signal/traffic.py), host framers,
    trunking state and audio included.

Timing: state-chained iterations end in block_until_ready. Every result
line names the platform, device kind, device count and the card's power
limit; the last line is a short headline. The peak table below is keyed by
device_kind; a device that is not in it is an error.

    python bench.py [--profile DIR]
"""
import json
import sys
import time

import numpy as np

# Published dense peaks per device_kind (float32 in the tensor cores as
# TF32; "fp32" outside them). H100 SXM: NVIDIA H100 Tensor Core GPU data
# sheet, at the 700 W power limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12, "tf32_flops": 495e12, "fp32_flops": 67e12,
        "hbm_bytes_per_s": 3.35e12,
        "source": "NVIDIA H100 SXM data sheet (dense, 700 W)"},
}


def peaks_for(device_kind: str) -> dict:
    """The PEAKS row for `device_kind`; an unknown device is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add a "
            f"row with its source to bench.PEAKS") from None


def device_label() -> dict:
    import jax

    from sdrtrunk_jax.platform import gpu_name_and_power_limit
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
            "nvidia_smi": gpu_name_and_power_limit()}


def roofline_nbfm(rx, msps: float, peaks: dict) -> dict:
    """Analytic FLOPs + bytes per wideband input sample for the NBFM
    receiver (complex MAC = 8 real flops): channelizer 2*T cmacs/sample +
    ~5*M*log2(M) IFFT flops per block; extraction + residual mix at 2C/M
    channel-samples per input; 63-tap FIR, discriminator, squelch,
    de-emphasis and 8 kHz resampling per channel sample. Bytes: input +
    one write and read of the (K, M) bin matrix + the per-channel
    streams — an upper bound, since XLA fusion removes some."""
    ch = rx.channelizer
    m, t, c = ch.channels, ch.taps_per_channel, rx.num_channels
    ratio = 2.0 * c / m
    per_ch = 63 * 8 + 14 + 4 + 4 + 12 * 2 * (8000.0 / ch.channel_sample_rate)
    flops = 2.0 * t * 8 + 10.0 * np.log2(m) + ratio * 22.0 + ratio * per_ch
    nbytes = 8 + 2 * 8 * 2 + ratio * 8 * 2
    rate = msps * 1e6
    return {
        "flops_per_sample": flops, "bytes_per_sample": nbytes,
        "achieved_flops": rate * flops, "achieved_bytes_per_s": rate * nbytes,
        "share_of_fp32_peak": rate * flops / peaks["fp32_flops"],
        "share_of_hbm_peak": rate * nbytes / peaks["hbm_bytes_per_s"],
        "peaks": peaks["source"],
    }


def bench_receiver(decoder: str, m: int = 1024, chunk_blocks: int = 5120,
                   iters: int = 12, pull_key: str = "power_db",
                   profile_dir: str | None = None):
    """Steady-state MS/s of WidebandReceiver over all M-1 usable bins."""
    import jax
    import jax.numpy as jnp

    from sdrtrunk_jax.receiver import WidebandReceiver

    fs = m * 12500.0
    offsets = [(i - m // 2 + 1) * 12500.0 for i in range(m - 1)]
    rx = WidebandReceiver(fs, offsets, decoder=decoder)
    step, state = rx.build_safe()
    n = m * chunk_blocks
    rng = np.random.default_rng(0)
    x = jnp.asarray(0.1 * rng.standard_normal((n, 2)).astype(np.float32))

    t0 = time.perf_counter()
    outputs, state = step(x, state)
    probe = np.asarray(outputs[pull_key][:2, :8])
    compile_s = time.perf_counter() - t0
    if not np.all(np.isfinite(np.asarray(probe, np.float32))):
        raise RuntimeError(f"{decoder} produced non-finite output")

    if profile_dir:
        jax.profiler.start_trace(profile_dir)
    t0 = time.perf_counter()
    for _ in range(iters):
        outputs, state = step(x, state)   # state-chained: no skipped work
    jax.block_until_ready((outputs, state))
    elapsed = time.perf_counter() - t0
    if profile_dir:
        jax.profiler.stop_trace()
    msps = n * iters / elapsed / 1e6
    return {"msps": msps, "realtime_factor": msps * 1e6 / fs,
            "channels": rx.num_channels, "chunk_samples": n,
            "iters": iters, "compile_s": compile_s}, rx


def bench_kernels_vs_xla(c: int = 1023, t: int = 10240) -> dict:
    """Symbol recovery alone on (C, T) blocks: the GPU kernel against
    XLA's scan, state-chained, for both loops (the Gardner loop at P25
    Phase 2's bank rate: 50 kS/s, 6000 baud, twice the samples)."""
    import jax
    import jax.numpy as jnp

    from sdrtrunk_jax.dsp.psk import DQPSKDemodulator, GardnerDQPSKDemodulator

    rng = np.random.default_rng(0)
    out = {}
    for name, cls, kw, tt in (
            ("decision_directed", DQPSKDemodulator,
             dict(sample_rate=25000.0), t),
            ("gardner", GardnerDQPSKDemodulator,
             dict(sample_rate=50000.0, symbol_rate=6000.0,
                  sample_counter_gain=0.1), 2 * t)):
        x = jnp.asarray((0.5 * (rng.standard_normal((c, tt))
                                + 1j * rng.standard_normal((c, tt))))
                        .astype(np.complex64))
        for impl in ("kernel", "xla"):
            demod = cls(impl=impl, **kw)
            st = jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                              demod.init_state())
            step = jax.jit(demod.batched)
            d, v, st = step(x, st)
            jax.block_until_ready(st)
            iters = 4
            t0 = time.perf_counter()
            for _ in range(iters):
                d, v, st = step(x, st)
            jax.block_until_ready(st)
            dt = (time.perf_counter() - t0) / iters
            out[f"{name}_{impl}_ms"] = dt * 1e3
            out[f"{name}_{impl}_mchan_samples_per_s"] = c * tt / dt / 1e6
        out[f"{name}_speedup"] = (out[f"{name}_xla_ms"]
                                  / out[f"{name}_kernel_ms"])
    return out


def bench_live(kind: str, slots: int = 1023, timed_chunks: int = 4,
               warmup: int = 3) -> dict:
    """The live Orchestrator at 12.8 MS/s with `slots` channels of
    synthetic `kind` traffic: int8 ingest, bank-mode device step, host
    framers, trunking state and audio. realtime_factor >= 1.0 means the
    product loop keeps up with the capture."""
    from sdrtrunk_jax.signal.traffic import bank_orchestrator, bank_traffic

    traffic = bank_traffic(kind, slots, warmup + timed_chunks)
    orch = bank_orchestrator(traffic)
    orch.run(max_chunks=warmup)                # compile + acquisition
    t0 = time.perf_counter()
    orch.run(max_chunks=timed_chunks)
    elapsed = time.perf_counter() - t0
    msps = traffic.chunk_samples * timed_chunks / elapsed / 1e6
    frames = sum(s["frames"] for s in orch.channel_status())
    result = {"msps": msps, "realtime_factor": msps / 12.8,
              "slots": slots, "chunk_samples": traffic.chunk_samples,
              "chunks": timed_chunks, "frames_decoded": int(frames),
              "audio_segments": len(orch.audio_segments)}
    orch.close()
    return result


def main():
    from sdrtrunk_jax.platform import configure_compile_cache, select_platform
    select_platform("gpu")
    configure_compile_cache()
    import jax
    profile_dir = (sys.argv[sys.argv.index("--profile") + 1]
                   if "--profile" in sys.argv else None)
    device = device_label()
    peaks = peaks_for(device["kind"])

    def emit(name, result):
        print(json.dumps({"bench": name, "device": device, **result}),
              flush=True)
        return result

    nbfm, rx = bench_receiver("nbfm", pull_key="audio",
                              profile_dir=profile_dir)
    emit("nbfm", {**nbfm, "roofline": roofline_nbfm(rx, nbfm["msps"], peaks)})
    c4fm, _ = bench_receiver("c4fm")
    emit("c4fm", c4fm)
    emit("kernels_vs_xla", bench_kernels_vs_xla())
    live = {kind: emit(f"live_{kind}", bench_live(kind))
            for kind in ("c4fm", "dmr", "p25p2", "nbfm")}
    print(json.dumps({
        "metric": "iq_msps", "value": nbfm["msps"], "unit": "Msamples/s",
        "device": {k: device[k] for k in ("platform", "kind", "count")},
        "power": device["nvidia_smi"],
        "c4fm_msps": c4fm["msps"],
        **{f"live_{k}_rt": v["realtime_factor"] for k, v in live.items()},
        "jax": jax.__version__}))


if __name__ == "__main__":
    main()
