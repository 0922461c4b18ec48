"""Instrumentation taps + carry-state checkpoint/resume."""
import numpy as np
import jax.numpy as jnp
import pytest

from sdrtrunk_jax.decoders import NBFMConfig, NBFMDecoder
from sdrtrunk_jax.dsp.instrument import (best_eye, constellation_metrics,
                                         dqpsk_constellation, eye_diagram,
                                         eye_opening, fsk_symbol_trace)
from sdrtrunk_jax.runtime.checkpoint import (StateCheckpointError,
                                             load_state, save_state,
                                             state_fingerprint)
from sdrtrunk_jax.signal import generators


class TestEyeDiagram:
    def _c4fm_audio(self, n_sym=400, fs=48000.0, baud=4800.0):
        rng = np.random.default_rng(5)
        dibits = rng.integers(0, 4, n_sym).astype(np.uint8)
        iq = generators.c4fm_modulate(dibits, fs, baud)
        # simple quadrature FM discriminator at full rate
        d = iq[1:] * np.conj(iq[:-1])
        return np.angle(d), fs / baud

    def test_clean_eye_opens(self):
        audio, sps = self._c4fm_audio()
        eye, offset, opening = best_eye(audio, sps)
        assert eye.shape[0] > 50 and eye.shape[1] == int(round(2 * sps))
        assert opening > 0.2, (offset, opening)

    def test_noise_closes_eye(self):
        audio, sps = self._c4fm_audio()
        rng = np.random.default_rng(6)
        noisy = audio + rng.normal(0, 2.0, len(audio))
        _, _, clean = best_eye(audio, sps)
        _, _, dirty = best_eye(noisy, sps)
        assert dirty < clean

    def test_symbol_trace_levels(self):
        from sdrtrunk_jax.dsp.instrument import integrate_and_dump
        audio, sps = self._c4fm_audio()
        filtered = integrate_and_dump(audio, sps)
        # search symbol phase for the best 4-level clustering
        best = None
        for off in np.arange(0.0, sps, 0.5):
            sym = fsk_symbol_trace(filtered, sps, offset=off)
            # quantise to 4 levels, measure dispersion
            lv = np.percentile(np.abs(sym), 98) / 3.0
            q = np.round(sym / lv)
            err = np.mean(np.abs(sym / lv - q))
            if best is None or err < best:
                best = err
        assert best < 0.1


class TestConstellation:
    def test_dqpsk_clusters(self):
        rng = np.random.default_rng(7)
        fs, baud = 24000.0, 4800.0
        dibits = rng.integers(0, 4, 500).astype(np.uint8)
        iq = generators.c4fm_modulate(dibits, fs, baud)
        pts = dqpsk_constellation(iq, fs / baud)
        m = constellation_metrics(pts)
        assert m["points"] > 400
        # C4FM differential phase clusters near +/-45 and +/-135
        assert m["evm_deg"] < 30.0
        assert all(o > 0 for o in m["occupancy"])

    def test_empty(self):
        m = constellation_metrics(np.zeros(0, np.complex128))
        assert m["points"] == 0 and m["evm_deg"] is None


class TestCheckpoint:
    def test_resume_is_bit_exact(self, tmp_path):
        fs = 25000.0
        audio_in = np.sin(2 * np.pi * 700.0 * np.arange(3000) / 8000.0)
        iq = generators.nbfm_modulate(audio_in, 8000.0, fs)
        dec = NBFMDecoder(NBFMConfig(sample_rate=fs,
                                     squelch_threshold_db=-120.0))
        # one-shot
        out_full, _ = dec(jnp.asarray(iq), dec.init_state())
        full = np.asarray(out_full["audio"])
        # chunked with a save/load boundary in the middle, split on a
        # full resampler phase cycle (25 in -> 8 out at 25 kHz -> 8 kHz)
        half = (len(iq) // 2 // 25) * 25
        out1, st = dec(jnp.asarray(iq[:half]), dec.init_state())
        path = str(tmp_path / "state.npz")
        save_state(path, st, {"position": half})
        restored, meta = load_state(path, dec.init_state())
        assert meta["position"] == half
        out2, _ = dec(jnp.asarray(iq[half:]), restored)
        resumed = np.concatenate([np.asarray(out1["audio"]),
                                  np.asarray(out2["audio"])])
        # the polyphase resampler may hold back a boundary sample at the
        # chunk split; the overlapping samples must match exactly
        assert abs(len(resumed) - len(full)) <= 2
        n = min(len(resumed), len(full))
        np.testing.assert_allclose(resumed[:n], full[:n], atol=2e-5)

    def test_fingerprint_guards_mismatch(self, tmp_path):
        dec1 = NBFMDecoder(NBFMConfig(sample_rate=25000.0))
        dec2 = NBFMDecoder(NBFMConfig(sample_rate=50000.0))
        s1 = dec1.init_state()
        path = str(tmp_path / "s.npz")
        save_state(path, s1)
        # same structure -> loads fine
        load_state(path, dec1.init_state())
        # different config changes leaf shapes -> refused
        if state_fingerprint(dec2.init_state()) != state_fingerprint(s1):
            with pytest.raises(StateCheckpointError):
                load_state(path, dec2.init_state())

    def test_nested_pytree_roundtrip(self, tmp_path):
        state = {"a": jnp.arange(5, dtype=jnp.float32),
                 "b": {"c": jnp.zeros((2, 3), jnp.complex64),
                       "d": jnp.array(7, jnp.int32)}}
        path = str(tmp_path / "n.npz")
        save_state(path, state)
        back, _ = load_state(path, state)
        np.testing.assert_array_equal(np.asarray(back["b"]["c"]),
                                      np.zeros((2, 3), np.complex64))
        assert int(back["b"]["d"]) == 7
