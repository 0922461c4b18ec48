"""The GPU symbol-recovery kernels (dsp/psk_kernels.py) on the CPU: run
in Pallas interpret mode against the XLA scans they translate, plus the
wrapper's shapes, padding and choice of path. The compiled kernels are
checked on the card by tests/test_gpu.py and chip_smoke.py."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from sdrtrunk_jax.dsp import psk
from sdrtrunk_jax.dsp.psk import (DQPSKDemodulator, GardnerDQPSKDemodulator,
                                  resolve_impl)
from sdrtrunk_jax.dsp.psk_kernels import kernel_batched
from sdrtrunk_jax.signal.generators import (awgn, c4fm_modulate,
                                            lsm_modulate, random_dibits)

LOOPS = {
    "dd_c4fm": (DQPSKDemodulator, dict(sample_rate=25000.0), 4800.0),
    "gardner_lsm": (GardnerDQPSKDemodulator, dict(sample_rate=25000.0),
                    4800.0),
    "gardner_p25p2": (GardnerDQPSKDemodulator,
                      dict(sample_rate=50000.0, symbol_rate=6000.0,
                           sample_counter_gain=0.1), 6000.0),
}


def _block(loop: str, c: int, t: int, seed: int = 7) -> jnp.ndarray:
    """(C, T) complex64, distinct symbols per channel, 30 dB SNR."""
    cls, kw, baud = LOOPS[loop]
    rate = kw["sample_rate"]
    rows = []
    for i in range(c):
        dib = random_dibits(int(t * baud / rate) + 16, seed=seed + i)
        if cls is DQPSKDemodulator:
            x = c4fm_modulate(dib, sample_rate=rate)
        else:
            x = lsm_modulate(dib, sample_rate=rate, symbol_rate=baud)
        rows.append(awgn(x[:t], snr_db=30.0,
                         rng=np.random.default_rng(seed + 100 + i)))
    return jnp.asarray(np.stack(rows).astype(np.complex64))


def _demod(loop: str, impl: str = "xla"):
    cls, kw, _ = LOOPS[loop]
    return cls(impl=impl, **kw)


def _bstate(demod, c):
    return jax.tree.map(lambda a: jnp.broadcast_to(a, (c,) + a.shape),
                        demod.init_state())


def _assert_same(a, b):
    """Identical dibits and valid masks; the carried state to float32
    rounding (XLA's CPU backend contracts multiply-adds differently in
    the scan and in the interpreted kernel; on the GPU neither contracts
    and tests/test_gpu.py holds the state bit-equal)."""
    d_a, v_a, s_a = a
    d_b, v_b, s_b = b
    np.testing.assert_array_equal(np.asarray(v_a), np.asarray(v_b))
    np.testing.assert_array_equal(np.asarray(d_a), np.asarray(d_b))
    for x, y in zip(jax.tree.leaves(s_a), jax.tree.leaves(s_b)):
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loop", sorted(LOOPS))
@pytest.mark.parametrize("c,t,block", [(5, 301, 4), (3, 203, 8)])
def test_kernel_interpret_matches_scan(loop, c, t, block):
    """Op-for-op translation: identical dibits, valid masks and final
    state. C is not a multiple of the block and T not a multiple of 8."""
    demod = _demod(loop)
    x = _block(loop, c, t)
    st = _bstate(demod, c)
    _assert_same(kernel_batched(demod, x, st, block=block, interpret=True),
                 demod._scan_batched(x, st))


@pytest.mark.parametrize("loop", ["dd_c4fm", "gardner_p25p2"])
def test_kernel_state_handoff(loop):
    """Two chunks with the carried state == one call over both (the
    streaming contract of the live loop)."""
    demod = _demod(loop)
    c, t = 3, 250
    x = _block(loop, c, t, seed=21)
    st = _bstate(demod, c)
    d_all, v_all, s_all = kernel_batched(demod, x, st, block=4,
                                         interpret=True)
    d1, v1, s1 = kernel_batched(demod, x[:, :117], st, block=4,
                                interpret=True)
    d2, v2, s2 = kernel_batched(demod, x[:, 117:], s1, block=4,
                                interpret=True)
    np.testing.assert_array_equal(np.concatenate([v1, v2], 1), v_all)
    np.testing.assert_array_equal(np.concatenate([d1, d2], 1), d_all)
    for a, b in zip(jax.tree.leaves(s2), jax.tree.leaves(s_all)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_kernel_padding_lanes_do_not_leak():
    """A channel's result does not depend on the block it shares with
    padding lanes or other channels."""
    demod = _demod("dd_c4fm")
    x = _block("dd_c4fm", 3, 150, seed=5)
    st = _bstate(demod, 3)
    d3, v3, _ = kernel_batched(demod, x, st, block=8, interpret=True)
    d1, v1, _ = kernel_batched(demod, x[1:2], _bstate(demod, 1), block=2,
                               interpret=True)
    np.testing.assert_array_equal(np.asarray(v3)[1], np.asarray(v1)[0])
    np.testing.assert_array_equal(np.asarray(d3)[1], np.asarray(d1)[0])


def test_kernel_shapes_and_block_rule():
    demod = _demod("gardner_lsm")
    st = _bstate(demod, 2)
    x = _block("gardner_lsm", 2, 40)
    d, v, s = kernel_batched(demod, x, st, block=4, interpret=True)
    assert d.shape == v.shape == (2, 40)
    assert d.dtype == jnp.int32 and v.dtype == jnp.bool_
    assert s.window.shape == (2, demod.window_len)
    assert s.window.dtype == jnp.complex64
    d0, v0, s0 = kernel_batched(demod, x[:, :0], st, block=4,
                                interpret=True)
    assert d0.shape == (2, 0) and s0 is st
    with pytest.raises(ValueError, match="power of two"):
        kernel_batched(demod, x, st, block=6, interpret=True)


def test_resolve_impl():
    assert resolve_impl("auto") == "xla"          # the CPU backend
    for impl in ("xla", "kernel", "interpret"):
        assert resolve_impl(impl) == impl
    with pytest.raises(ValueError, match="unknown impl"):
        resolve_impl("pallas")


def test_batched_dispatch_follows_impl():
    """impl='interpret' goes through the kernel and agrees with 'xla'."""
    x = _block("dd_c4fm", 2, 120, seed=3)
    a = _demod("dd_c4fm", "interpret")
    b = _demod("dd_c4fm", "xla")
    st = _bstate(a, 2)
    _assert_same(a.batched(x, st), b.batched(x, st))


def test_kernel_error_propagates(monkeypatch):
    """No fallback: a kernel that fails raises out of batched(), and
    impl='kernel' on the CPU (no Triton target) raises too."""
    demod = _demod("gardner_lsm", "interpret")
    x = _block("gardner_lsm", 1, 64)
    st = _bstate(demod, 1)

    def broken(*args, **kwargs):
        raise RuntimeError("kernel failed")
    import sdrtrunk_jax.dsp.psk_kernels as pk
    monkeypatch.setattr(pk, "kernel_batched", broken)
    with pytest.raises(RuntimeError, match="kernel failed"):
        demod.batched(x, st)
    monkeypatch.undo()
    with pytest.raises(Exception):
        jax.block_until_ready(_demod("gardner_lsm", "kernel").batched(x, st))


def test_arm_taps_gather_is_exact_row_selection():
    bank = jnp.asarray(np.asarray(DQPSKDemodulator(25000.0).bank))
    mu = jnp.asarray(np.random.default_rng(0).uniform(-0.1, 1.1, 257),
                     jnp.float32)
    got = np.asarray(psk._arm_taps(bank, mu))
    idx = np.clip((128 * np.asarray(mu)).astype(np.int32), 0, 128)
    np.testing.assert_array_equal(got, np.asarray(bank)[idx].T)


def test_dynamic_slot_selection_is_exact():
    """The live path's bin selection is a gather: bit-exact against
    numpy indexing (a float32 one-hot matmul would round on a GPU)."""
    from sdrtrunk_jax.receiver import _dynamic_select_mix
    rng = np.random.default_rng(1)
    y = (rng.standard_normal((32, 64)) + 1j * rng.standard_normal((32, 64))
         ).astype(np.complex64)
    b = rng.permutation(64)[:50].astype(np.int32)
    zeros = jnp.zeros((50,), jnp.float32)
    got, phase = _dynamic_select_mix(jnp.asarray(y), jnp.int32(0), zeros,
                                     jnp.asarray(np.stack([b, b], 1)),
                                     zeros, 64)
    np.testing.assert_array_equal(np.asarray(got), y[:, b].T)
    np.testing.assert_array_equal(np.asarray(phase), 0.0)
