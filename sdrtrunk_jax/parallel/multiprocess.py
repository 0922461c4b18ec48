"""True multi-host harness: N JAX processes, one global mesh, per-process
local ingest (VERDICT round-2 item 6; SURVEY §2.8 multi-host ingest row).

Each process owns a contiguous TIME slice of the capture — the multi-host
analog of one tuner/host feeding its own 10 MHz capture — and contributes
it via `jax.make_array_from_process_local_data`; the
ShardedChannelizerPipeline then runs unchanged over the global mesh, its
halo ppermute / all_to_all riding the cross-process collective backend
(gloo: this harness is CPU-only). Every process verifies ITS local
output shard against a locally computed single-device reference, so
correctness needs no gather.

Run one worker per process:

    python -m sdrtrunk_jax.parallel.multiprocess \
        --coordinator 127.0.0.1:PORT --num-processes 2 --process-id I

Each prints one JSON line: {"process": I, "ok": bool, "max_err": ...,
"msps_per_process": ...}. tests/test_multiprocess.py drives it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def worker(coordinator: str, num_processes: int, process_id: int,
           local_devices: int = 2, m: int = 32, blocks: int = 256,
           iters: int = 4) -> dict:
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count="
                               f"{local_devices}").strip()
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address=coordinator,
                               num_processes=num_processes,
                               process_id=process_id)
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from ..dsp.channelizer import Channelizer
    from ..dsp.extract import plan_channels
    from .pipeline import ShardedChannelizerPipeline

    devs = jax.devices()
    assert len(devs) == num_processes * local_devices
    mesh = Mesh(np.array(devs), ("shard",))

    fs = m * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=m)
    c = len(devs) * 2
    offsets = [((i % (m - 2)) - (m // 2 - 1)) * 12500.0 for i in range(c)]
    plan = plan_channels(ch, offsets)
    pipe = ShardedChannelizerPipeline(ch, plan, mesh)
    run = pipe.build()

    # the full capture is derived from a shared seed so every process can
    # compute the single-device reference; each contributes only its slice
    n = len(devs) * m * blocks
    rng = np.random.default_rng(7)
    x_np = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
            ).astype(np.complex64)
    shard_len = n // num_processes
    local = x_np[process_id * shard_len:(process_id + 1) * shard_len]
    sharding = NamedSharding(mesh, P("shard"))
    x = jax.make_array_from_process_local_data(sharding, local, (n,))

    y = run(x)
    # local verification: this process's addressable output rows vs a
    # single-device recompute of the same channels
    from ..dsp.extract import extract_channels
    y_ref, _ = ch(jnp.asarray(x_np))
    streams_ref, _ = extract_channels(y_ref, plan)
    streams_ref = np.asarray(streams_ref)
    max_err = 0.0
    for db in y.addressable_shards:
        ref = streams_ref[db.index[0]]
        max_err = max(max_err,
                      float(np.abs(np.asarray(db.data) - ref).max()))

    t0 = time.perf_counter()
    for _ in range(iters):
        y = run(x)
    jax.block_until_ready(y)
    dt = time.perf_counter() - t0
    msps = n * iters / dt / 1e6 / num_processes

    # --- multi-host LIVE ingest: consecutive chunks of ONE continuous
    # stream, each process contributing its time slice of every chunk,
    # with the streaming carry (channelizer tail + mixer phase) riding
    # across chunk boundaries — the distributed analog of the live
    # loop's chunked source (VERDICT r4 gap 4 multi-host live row)
    stream_run = pipe.build_streaming()
    carry = pipe.init_carry()
    n_chunks = 3
    x_all = (rng.standard_normal(n_chunks * n)
             + 1j * rng.standard_normal(n_chunks * n)
             ).astype(np.complex64)
    state = ch.init_state()
    phase = None
    stream_err = 0.0
    for j in range(n_chunks):
        chunk_np = x_all[j * n:(j + 1) * n]
        local_j = chunk_np[process_id * shard_len:
                           (process_id + 1) * shard_len]
        xj = jax.make_array_from_process_local_data(sharding, local_j,
                                                    (n,))
        yj, carry = stream_run(xj, carry)
        y_ref_j, state = ch(jnp.asarray(chunk_np), state)
        ref_j, phase = extract_channels(y_ref_j, plan, phase)
        ref_j = np.asarray(ref_j)
        for db in yj.addressable_shards:
            stream_err = max(stream_err, float(np.abs(
                np.asarray(db.data) - ref_j[db.index[0]]).max()))

    result = {"process": process_id,
              "ok": bool(max_err < 1e-3 and stream_err < 1e-3),
              "max_err": round(max_err, 8),
              "streaming_ok": bool(stream_err < 1e-3),
              "streaming_max_err": round(stream_err, 8),
              "streaming_chunks": n_chunks,
              "msps_per_process": round(msps, 2),
              "devices": len(devs), "channels": c, "samples": n}
    print(json.dumps(result), flush=True)
    jax.distributed.shutdown()
    return result


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--coordinator", required=True)
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    p.add_argument("--local-devices", type=int, default=2)
    p.add_argument("--blocks", type=int, default=256)
    args = p.parse_args()
    r = worker(args.coordinator, args.num_processes, args.process_id,
               args.local_devices, blocks=args.blocks)
    return 0 if r["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
