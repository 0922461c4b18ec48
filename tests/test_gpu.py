"""Tests that need the GPU: the symbol-recovery kernels as compiled for
the card, and the float32 device paths whose precision the card decides.

They skip everywhere else. On the card, `python chip_smoke.py` runs them
in its own process (its `gpu_tests` phase); alone:

    python -m pytest -m gpu tests/test_gpu.py
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU (JAX's default backend is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


def _bstate(demod, c):
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                        demod.init_state())


def _rows(mod, c, t, rate, baud, seed):
    rng = np.random.default_rng(seed)
    dib = rng.integers(0, 4, int((t + 7 * c) * baud / rate) + 32
                       ).astype(np.uint8)
    if baud == 6000.0:
        base = mod(dib, sample_rate=rate, symbol_rate=baud)
    else:
        base = mod(dib, sample_rate=rate)
    return base[(np.arange(c) * 7)[:, None] + np.arange(t)[None, :]
                ].astype(np.complex64)


@pytest.mark.parametrize("loop", ["decision_directed", "gardner_p25p2"])
def test_kernel_identical_to_scan_on_gpu(gpu, loop):
    """Compiled kernel == XLA scan on the card, odd C and T, including
    the state it hands to the next chunk."""
    import jax
    import jax.numpy as jnp

    from sdrtrunk_jax.dsp.psk import DQPSKDemodulator, GardnerDQPSKDemodulator
    from sdrtrunk_jax.signal.generators import c4fm_modulate, lsm_modulate
    if loop == "decision_directed":
        kw = dict(sample_rate=25000.0)
        demod, x = DQPSKDemodulator(impl="kernel", **kw), _rows(
            c4fm_modulate, 37, 999, 25000.0, 4800.0, 1)
    else:
        kw = dict(sample_rate=50000.0, symbol_rate=6000.0,
                  sample_counter_gain=0.1)
        demod, x = GardnerDQPSKDemodulator(impl="kernel", **kw), _rows(
            lsm_modulate, 37, 1999, 50000.0, 6000.0, 2)
    st = _bstate(demod, x.shape[0])
    dk, vk, sk = jax.jit(demod.batched)(jnp.asarray(x), st)
    ds, vs, ss = jax.jit(demod._scan_batched)(jnp.asarray(x), st)
    np.testing.assert_array_equal(np.asarray(vk), np.asarray(vs))
    np.testing.assert_array_equal(np.asarray(dk), np.asarray(ds))
    for a, b in zip(jax.tree.leaves(sk), jax.tree.leaves(ss)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_channelizer_on_gpu_matches_float64(gpu):
    import jax.numpy as jnp

    from sdrtrunk_jax.dsp.channelizer import (Channelizer, _channelize_core,
                                              reference_channelize)
    ch = Channelizer.design(256 * 12500.0, 12500.0)
    h = np.asarray(ch.hmat)
    rng = np.random.default_rng(0)
    n = h.shape[0] * 256 + 256 * 64
    xp = (rng.standard_normal(n) + 1j * rng.standard_normal(n)
          ).astype(np.complex64)
    y = np.asarray(_channelize_core(jnp.asarray(xp), h, 256))
    ref = reference_channelize(xp, h, 256)
    # float32 with cuFFT: ~1e-6 of the output rms
    assert np.max(np.abs(y - ref)) / np.sqrt(np.mean(np.abs(ref) ** 2)) \
        < 1e-4


def test_slot_gather_exact_on_gpu(gpu):
    import jax
    import jax.numpy as jnp

    from sdrtrunk_jax.receiver import _dynamic_select_mix
    rng = np.random.default_rng(3)
    y = (rng.standard_normal((64, 128)) + 1j * rng.standard_normal((64, 128))
         ).astype(np.complex64)
    b = rng.permutation(128)[:100].astype(np.int32)
    zeros = jnp.zeros((100,), jnp.float32)
    got = jax.jit(lambda y, b: _dynamic_select_mix(
        y, jnp.int32(0), zeros, b, zeros, 128)[0])(
        jnp.asarray(y), jnp.asarray(np.stack([b, b], 1)))
    np.testing.assert_array_equal(np.asarray(got), y[:, b].T)


def test_iir_recurrence_precision_on_gpu(gpu):
    """The blocked IIR runs its matmuls at HIGHEST: float32-accurate on
    the card (TF32 would leave ~1e-3)."""
    import jax.numpy as jnp

    from sdrtrunk_jax.dsp import iir
    a = 1.0 - iir.deemphasis_alpha(8000.0)
    b = np.random.default_rng(4).standard_normal(8192).astype(np.float32)
    ref = np.zeros(len(b))
    acc = 0.0
    for i, v in enumerate(b.astype(np.float64)):
        acc = a * acc + v
        ref[i] = acc
    got = np.asarray(iir._linrec(a, jnp.asarray(b), jnp.float32(0.0)))
    assert np.max(np.abs(got - ref)) < 1e-4
