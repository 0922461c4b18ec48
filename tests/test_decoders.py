"""Decoder chain tests: NBFM/AM correctness and exact streaming equivalence."""
import numpy as np

import jax.numpy as jnp

from sdrtrunk_jax.decoders import AMConfig, AMDecoder, NBFMConfig, NBFMDecoder
from sdrtrunk_jax.signal import generators


def _nbfm_iq(fs=25000.0, fa=700.0, dur=0.4, dev=3000.0):
    audio = np.sin(2 * np.pi * fa * np.arange(int(dur * 8000)) / 8000)
    return generators.nbfm_modulate(audio, 8000, fs, deviation_hz=dev)


def test_nbfm_decoder_tone():
    fs = 25000.0
    iq = _nbfm_iq(fs)
    dec = NBFMDecoder(NBFMConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    audio = np.asarray(out["audio"])[1000:]
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1 / 8000.0)
    assert abs(freqs[np.argmax(spec)] - 700.0) < 20.0
    assert np.asarray(out["audio_gate"])[1600:].all()


def test_nbfm_streaming_equals_oneshot():
    fs = 25000.0
    iq = _nbfm_iq(fs)
    dec = NBFMDecoder(NBFMConfig(sample_rate=fs))
    full, _ = dec(jnp.asarray(iq), dec.init_state())
    state = dec.init_state()
    parts = []
    n = len(iq) - len(iq) % 500
    for i in range(0, n, 500):
        o, state = dec(jnp.asarray(iq[i:i + 500]), state)
        parts.append(np.asarray(o["audio"]))
    merged = np.concatenate(parts)
    assert np.allclose(merged, np.asarray(full["audio"])[: len(merged)],
                       atol=1e-5)


def test_nbfm_squelch_closes_on_silence():
    fs = 25000.0
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(8000) + 1j * rng.standard_normal(8000)
             ).astype(np.complex64) * 1e-6
    dec = NBFMDecoder(NBFMConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray(noise), dec.init_state())
    assert not np.asarray(out["audio_gate"]).any()


def test_am_decoder_tone():
    fs = 25000.0
    t = np.arange(int(0.4 * fs)) / fs
    msg = 1.0 + 0.8 * np.sin(2 * np.pi * 600.0 * t)
    iq = (0.5 * msg).astype(np.complex64) + 0j
    dec = AMDecoder(AMConfig(sample_rate=fs))
    out, _ = dec(jnp.asarray(iq), dec.init_state())
    audio = np.asarray(out["audio"])[1000:]
    spec = np.abs(np.fft.rfft(audio * np.hanning(len(audio))))
    freqs = np.fft.rfftfreq(len(audio), 1 / 8000.0)
    assert abs(freqs[np.argmax(spec)] - 600.0) < 20.0


def test_am_streaming_equals_oneshot():
    fs = 25000.0
    t = np.arange(10000) / fs
    iq = (0.5 * (1.0 + 0.5 * np.sin(2 * np.pi * 400.0 * t))).astype(np.complex64) + 0j
    dec = AMDecoder(AMConfig(sample_rate=fs))
    full, _ = dec(jnp.asarray(iq), dec.init_state())
    state = dec.init_state()
    parts = []
    for i in range(0, 10000, 500):
        o, state = dec(jnp.asarray(iq[i:i + 500]), state)
        parts.append(np.asarray(o["audio"]))
    merged = np.concatenate(parts)
    assert np.allclose(merged, np.asarray(full["audio"])[: len(merged)], atol=1e-5)
