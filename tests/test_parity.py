"""Golden-vector parity harness checks (VERDICT round-1 item 7)."""
import numpy as np
import pytest

from sdrtrunk_jax.parity import host_c4fm_demod, parity_report


def test_parity_clean(tmp_path):
    rep = parity_report(seed=0, n_frames=4,
                        bits_path=str(tmp_path / "cap.bits"))
    assert rep["device_ber_vs_truth"] == 0.0
    assert rep["host_ber_vs_truth"] == 0.0
    assert rep["path_agreement"] == 1.0
    assert rep["events_match"] and rep["frames_device"] == 4
    assert rep["bits_roundtrip_ok"]


def test_parity_with_noise():
    """At 12 dB SNR both decode paths must stay within the BER bound and
    keep producing the same event stream (BASELINE.md correctness row)."""
    rep = parity_report(seed=1, n_frames=4, snr_db=12.0)
    assert rep["device_ber_vs_truth"] < 0.01
    assert rep["host_ber_vs_truth"] < 0.01
    assert rep["path_agreement"] > 0.98
    assert rep["frames_device"] == 4 and rep["events_match"]
