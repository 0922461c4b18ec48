"""Entry-point set-up on the CPU: platform choice, compile cache, the
benchmark's peak table, chip_smoke's phase selection, the float64
channelizer reference, uneven channel counts on a mesh, and the shared
synthetic traffic."""
import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parent.parent


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, ROOT / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_compile_cache_dir_follows_env(monkeypatch, tmp_path):
    from sdrtrunk_jax import platform
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.compile_cache_dir() == str(tmp_path)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
    assert platform.compile_cache_dir() == str(ROOT / ".jax_cache")
    # fixed: the same path on every call, never a temporary name
    assert platform.compile_cache_dir() == platform.compile_cache_dir()


def test_configure_compile_cache_sets_nothing_when_env_set(monkeypatch,
                                                           tmp_path):
    import jax

    from sdrtrunk_jax import platform
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert platform.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_cli_platform_gpu_fails_without_gpu(capsys):
    from sdrtrunk_jax import cli
    with pytest.raises(SystemExit, match="finds no GPU"):
        cli.main(["--platform", "gpu", "playlist", "list",
                  "--playlist", "x.json"])
    # monitor and bench take the GPU by default: no silent CPU run
    with pytest.raises(SystemExit, match="finds no GPU"):
        cli.main(["monitor", "--playlist", "x.json"])


def test_peak_table_rejects_unknown_device_kind():
    bench = _load("bench")
    row = bench.peaks_for("NVIDIA H100 80GB HBM3")
    assert row["bf16_flops"] == 989e12 and row["hbm_bytes_per_s"] == 3.35e12
    assert row["source"]
    with pytest.raises(ValueError, match="no published peaks"):
        bench.peaks_for("cpu")


def test_chip_smoke_phase_selection():
    smoke = _load("chip_smoke")
    assert smoke.select_phases(four_cards=True) == ["four_cards"]
    one = smoke.select_phases(four_cards=False)
    assert one == ["kernels", "parity", "live", "gpu_tests"]
    assert set(one) | {"four_cards"} == set(smoke.PHASES)
    assert smoke.FULL.slots == 1023 and smoke.FULL.m == 1024
    assert smoke.FULL.chunk_blocks == 5120 and smoke.FULL.impl == "kernel"


def test_chip_smoke_fails_without_gpu(capsys):
    smoke = _load("chip_smoke")
    with pytest.raises(smoke.SmokeFailure, match="no GPU"):
        smoke.main([])
    assert '"ok": true' not in capsys.readouterr().out


def test_channelizer_matches_float64_reference_m1024():
    import jax.numpy as jnp

    from sdrtrunk_jax.dsp.channelizer import (Channelizer, _channelize_core,
                                              reference_channelize)
    ch = Channelizer.design(1024 * 12500.0, 12500.0)
    h = np.asarray(ch.hmat)
    rng = np.random.default_rng(0)
    n = h.shape[0] * 1024 + 1024 * 32
    xp = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    y = np.asarray(_channelize_core(jnp.asarray(xp), h, 1024))
    ref = reference_channelize(xp, h, 1024)
    assert y.shape == ref.shape == (64, 1024)
    assert np.max(np.abs(y - ref)) / np.sqrt(np.mean(np.abs(ref) ** 2)) \
        < 1e-5


def test_sharded_pipeline_pads_uneven_channel_count():
    """7 channels over a 4-device mesh: padded rows are computed and
    sliced away; the result equals the single-device extraction."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from sdrtrunk_jax.dsp.channelizer import Channelizer
    from sdrtrunk_jax.dsp.extract import extract_channels, plan_channels
    from sdrtrunk_jax.parallel.pipeline import ShardedChannelizerPipeline
    m = 16
    ch = Channelizer.design(m * 12500.0, 12500.0, 9, channels=m)
    plan = plan_channels(ch, [(i - 3) * 12500.0 for i in range(7)])
    mesh = Mesh(np.array(jax.devices()[:4]), ("shard",))
    pipe = ShardedChannelizerPipeline(ch, plan, mesh)
    assert pipe.padded_count == 8
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4 * m * 32) + 1j * rng.standard_normal(
        4 * m * 32)).astype(np.complex64)
    got = np.asarray(pipe.build()(jnp.asarray(x)))
    y, _ = ch(jnp.asarray(x))
    want, _ = extract_channels(y, plan)
    assert got.shape == (7, 2 * len(x) // m)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_bank_traffic_shapes():
    from sdrtrunk_jax.signal.traffic import bank_traffic
    tr = bank_traffic("p25p2", slots=3, total_chunks=2, chunk_blocks=32)
    assert len(tr.chunks) == 2 and len(tr.offsets) == 3
    assert all(c.shape == (1024 * 32, 2) and c.dtype == np.int8
               for c in tr.chunks)
    assert tr.info["frames_per_cycle"] == 4 and tr.info["baud"] == 6000.0
    read = tr.source()
    assert read(tr.chunk_samples) is tr.chunks[0]
    assert read(tr.chunk_samples) is tr.chunks[1]
    assert read(tr.chunk_samples) is None
