"""Device-native acquisition (split-real, batched) vs two oracles.

tpudab.ofdm.sync_device.acquire_device is the production path (split-real,
no complex dtype on device); tpudab.ofdm.sync.acquire (complex-jnp) and
tpudab.ofdm.sync_np.acquire_np (pure NumPy, no JAX) are independent
oracles. All three implement the same algorithm and must agree."""

import numpy as np
import pytest

from tpudab.constants.ofdm_params import get_ofdm_params
from tpudab.synth.modulator import modulate_frame_bits, Impairments, apply_impairments
from tpudab.ofdm.sync import acquire
from tpudab.ofdm.sync_np import acquire_np
from tpudab.ofdm.sync_device import (acquire_device, acquire_host,
                                     fine_time_sync_device, fine_freq_device)


def _capture(seed, imp):
    rng = np.random.default_rng(seed)
    p = get_ofdm_params(1)
    frames = []
    for i in range(3):
        bits = rng.integers(0, 2, p.nb_frame_bits).astype(np.uint8)
        frames.append(modulate_frame_bits(bits, 1))
    return apply_impairments(np.concatenate(frames), imp)


@pytest.mark.parametrize("imp", [
    Impairments(freq_offset_hz=3400.0, delay_samples=1000, snr_db=20, phase=0.7, seed=1),
    Impairments(freq_offset_hz=-47350.0, delay_samples=7777, snr_db=10, phase=2.1, seed=2),
    Impairments(freq_offset_hz=412.0, delay_samples=3, snr_db=8, phase=0.0, seed=3),
])
def test_acquire_device_matches_oracle(imp):
    iq = _capture(5, imp)
    ref = acquire(iq)
    got = acquire_host(iq)
    ref2 = acquire_np(iq)
    assert got["frame_start"] == ref["frame_start"] == imp.delay_samples
    assert got["coarse_bins"] == ref["coarse_bins"]
    assert abs(got["net_freq_hz"] - imp.freq_offset_hz) < 20.0
    assert abs(got["net_freq_hz"] - ref["net_freq_hz"]) < 5.0
    assert got["time_quality"] > 3.0
    # pure-NumPy oracle (no JAX anywhere in its callchain)
    assert ref2["frame_start"] == ref["frame_start"]
    assert ref2["coarse_bins"] == ref["coarse_bins"]
    assert abs(ref2["net_freq_hz"] - ref["net_freq_hz"]) < 5.0


def test_acquire_device_batched():
    """One acquire_device call over a BATCH of differently-impaired
    ensembles (the multi-ensemble chip case) matches per-buffer results."""
    imps = [
        Impairments(freq_offset_hz=1200.0, delay_samples=50_000, snr_db=15, seed=4),
        Impairments(freq_offset_hz=-8000.0, delay_samples=123, snr_db=12, seed=5),
    ]
    iqs = [_capture(6 + i, imp) for i, imp in enumerate(imps)]
    n = min(x.shape[0] for x in iqs)
    re = np.stack([x.real[:n] for x in iqs]).astype(np.float32)
    im = np.stack([x.imag[:n] for x in iqs]).astype(np.float32)
    out = acquire_device(re, im)
    fs = np.asarray(out["frame_start"])
    net = np.asarray(out["net_freq_hz"])
    for i, imp in enumerate(imps):
        assert fs[i] == imp.delay_samples
        assert abs(net[i] - imp.freq_offset_hz) < 20.0


def test_fine_time_and_freq_device():
    """Streaming-tap estimators: timing recheck peak and residual CFO."""
    p = get_ofdm_params(1)
    imp = Impairments(freq_offset_hz=500.0, delay_samples=0, snr_db=20, seed=9)
    iq = _capture(11, imp)
    search = 64
    seg_start = p.nb_null_period + p.nb_cyclic_prefix - search
    seg = iq[seg_start: seg_start + 2 * search + p.nb_fft]
    peak, q = fine_time_sync_device(
        seg.real.astype(np.float32)[None], seg.imag.astype(np.float32)[None],
        np.float32(500.0), search=search)
    assert int(np.asarray(peak)[0]) == search  # PRS exactly at nominal
    assert float(np.asarray(q)[0]) > 3.0

    frame = iq[: p.nb_frame_length]
    resid = fine_freq_device(frame.real.astype(np.float32)[None],
                             frame.imag.astype(np.float32)[None],
                             np.float32(500.0))
    assert abs(float(np.asarray(resid)[0])) < 10.0
    resid2 = fine_freq_device(frame.real.astype(np.float32)[None],
                              frame.imag.astype(np.float32)[None],
                              np.float32(450.0))
    assert abs(float(np.asarray(resid2)[0]) - 50.0) < 10.0
