"""Sharded pipeline tests on the virtual 8-device CPU mesh: the sharded
channelize+extract must equal the single-device reference path exactly."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from sdrtrunk_jax.dsp.channelizer import Channelizer
from sdrtrunk_jax.dsp.extract import extract_channels, plan_channels
from sdrtrunk_jax.parallel.pipeline import ShardedChannelizerPipeline
from sdrtrunk_jax.signal import generators


@pytest.fixture(scope="module")
def mesh():
    return jax.make_mesh((8,), ("shard",))


def test_sharded_matches_single_device(mesh):
    M = 16
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    rng = np.random.default_rng(0)
    n = 8 * M * 32  # 8 shards of M*32 samples
    x = (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(np.complex64)

    offsets = [2 * 12500.0, 5 * 12500.0 + 3000.0, -3 * 12500.0,
               7 * 12500.0, -6 * 12500.0 - 2000.0, 12500.0,
               4 * 12500.0, -12500.0]
    plan = plan_channels(ch, offsets)

    # single-device reference
    y, _ = ch(jnp.asarray(x))
    ref_streams, _ = extract_channels(y, plan)

    pipe = ShardedChannelizerPipeline(ch, plan, mesh)
    run = pipe.build()
    out = np.asarray(run(jnp.asarray(x)))

    assert out.shape == ref_streams.shape
    assert np.max(np.abs(out - np.asarray(ref_streams))) < 1e-4


def test_sharded_streaming_matches_single_device(mesh):
    """Chunk-to-chunk continuity (VERDICT r4 gap 4): feeding one stream
    as consecutive chunks through build_streaming() must equal the
    single-device STREAMING path (carried channelizer state + carried
    mixer phase) on every chunk — no zeroed halo, no phase restart."""
    M = 16
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    rng = np.random.default_rng(3)
    chunk_n = 8 * M * 16
    chunks = [(rng.standard_normal(chunk_n)
               + 1j * rng.standard_normal(chunk_n)).astype(np.complex64)
              for _ in range(3)]

    offsets = [2 * 12500.0, 5 * 12500.0 + 3000.0, -3 * 12500.0,
               7 * 12500.0, -6 * 12500.0 - 2000.0, 12500.0,
               4 * 12500.0, -12500.0]
    plan = plan_channels(ch, offsets)

    pipe = ShardedChannelizerPipeline(ch, plan, mesh)
    run = pipe.build_streaming()
    carry = pipe.init_carry()

    state = ch.init_state()
    phase = None
    for i, x in enumerate(chunks):
        y, state = ch(jnp.asarray(x), state)
        ref, phase = extract_channels(y, plan, phase)
        out, carry = run(jnp.asarray(x), carry)
        err = np.max(np.abs(np.asarray(out) - np.asarray(ref)))
        # identical arithmetic, but XLA may contract the mixer's
        # mul+add into an FMA differently inside shard_map: at angle
        # magnitudes ~200 rad one f32 ulp is ~1.5e-5
        assert err < 5e-5, (i, err)


def test_sharded_streaming_tone_phase_continuous(mesh):
    """A tone split across chunks shows no phase step at chunk joins."""
    M = 16
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    f = 5 * 12500.0 + 3000.0
    n = 8 * M * 32
    x = generators.tone(f, fs, 3 * n)
    plan = plan_channels(ch, [f] + [i * 12500.0
                                    for i in (1, 2, 3, 4, 6, 7, -2)])
    pipe = ShardedChannelizerPipeline(ch, plan, mesh)
    run = pipe.build_streaming()
    carry = pipe.init_carry()
    outs = []
    for j in range(3):
        out, carry = run(jnp.asarray(x[j * n:(j + 1) * n]), carry)
        outs.append(np.asarray(out))
    s = np.concatenate([o[0] for o in outs])[64:]
    dphi = np.angle(s[1:] * np.conj(s[:-1]))
    # continuous stream: uniform tiny residual everywhere, including at
    # the two chunk joins
    assert np.abs(np.mean(dphi)) < 1e-3
    assert np.max(np.abs(dphi - np.mean(dphi))) < 0.05


def test_sharded_tone_decodes(mesh):
    """Tone through the sharded pipeline lands at DC on its channel."""
    M = 16
    fs = M * 12500.0
    ch = Channelizer.design(fs, 12500.0, 9, channels=M)
    f = 5 * 12500.0 + 3000.0
    n = 8 * M * 64
    x = generators.tone(f, fs, n)
    plan = plan_channels(ch, [f] + [i * 12500.0 for i in (1, 2, 3, 4, 6, 7, -2)])
    run = ShardedChannelizerPipeline(ch, plan, mesh).build()
    out = np.asarray(run(jnp.asarray(x)))
    s = out[0][64:]
    dphi = np.angle(s[1:] * np.conj(s[:-1]))
    assert np.abs(np.mean(dphi)) < 1e-3
