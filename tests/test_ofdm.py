"""OFDM front-end: modulator/demodulator round trips + acquisition under
CFO / timing offset / AWGN (SURVEY.md sec 4 golden-path strategy)."""

import numpy as np
import pytest

from tpudab.constants.ofdm_params import get_ofdm_params
from tpudab.synth.modulator import modulate_frame_bits, Impairments, apply_impairments
from tpudab.ofdm.demod import demod_frames
from tpudab.ofdm.sync import acquire, fine_freq_autocorr, prs_search_full


def _frame_and_bits(seed=0, mode=1):
    rng = np.random.default_rng(seed)
    p = get_ofdm_params(mode)
    bits = rng.integers(0, 2, p.nb_frame_bits).astype(np.uint8)
    return modulate_frame_bits(bits, mode), bits


@pytest.mark.parametrize("mode", [1, 2, 4])
def test_clean_roundtrip(mode):
    frame, bits = _frame_and_bits(mode=mode)
    soft, _ = demod_frames(frame[None], 0.0, mode=mode)
    hard = (np.asarray(soft)[0] < 0).astype(np.uint8)
    assert (hard != bits).mean() == 0.0


def test_batched_demod_multiframe():
    frames, bits = [], []
    for s in range(3):
        f, b = _frame_and_bits(seed=s)
        frames.append(f)
        bits.append(b)
    soft, stats = demod_frames(np.stack(frames), 0.0)
    hard = (np.asarray(soft) < 0).astype(np.uint8)
    assert (hard != np.stack(bits)).mean() == 0.0
    assert np.asarray(stats["mean_power"]).shape == (3,)


@pytest.mark.parametrize("imp", [
    Impairments(freq_offset_hz=3400.0, delay_samples=1000, snr_db=20, phase=0.7, seed=1),
    Impairments(freq_offset_hz=-47350.0, delay_samples=7777, snr_db=10, phase=2.1, seed=2),
    Impairments(freq_offset_hz=412.0, delay_samples=3, snr_db=8, phase=0.0, seed=3),
])
def test_acquire_and_demod_under_impairments(imp):
    frame, bits = _frame_and_bits()
    iq = apply_impairments(np.concatenate([frame] * 3), imp)
    res = acquire(iq)
    assert res["frame_start"] == imp.delay_samples
    assert abs(res["net_freq_hz"] - imp.freq_offset_hz) < 100.0
    soft, _ = demod_frames(iq[res["frame_start"]:][None, :196608], res["net_freq_hz"])
    ber = ((np.asarray(soft)[0] < 0).astype(np.uint8) != bits).mean()
    assert ber < 0.05


def test_acquire_midstream_start_large_cfo():
    rng = np.random.default_rng(11)
    frames = [_frame_and_bits(seed=100 + i)[0] for i in range(4)]
    full = apply_impairments(np.concatenate(frames),
                             Impairments(freq_offset_hz=88_000.0, snr_db=15, seed=4))
    drop = 123_456
    iq = full[drop:]
    res = acquire(iq)
    assert res["frame_start"] == (196_608 - drop % 196_608) % 196_608
    assert abs(res["net_freq_hz"] - 88_000.0) < 100.0


def test_fine_freq_autocorr_unaligned():
    frame, _ = _frame_and_bits()
    iq = apply_impairments(np.concatenate([frame] * 2),
                           Impairments(freq_offset_hz=230.0, snr_db=25, seed=5))
    est = float(fine_freq_autocorr(iq))
    assert abs(est - 230.0) < 30.0


def test_prs_search_quality_drops_without_signal():
    rng = np.random.default_rng(6)
    noise = (rng.standard_normal(2 * 196608) + 1j * rng.standard_normal(2 * 196608)) \
        .astype(np.complex64)
    _, q_noise = prs_search_full(noise)
    frame, _ = _frame_and_bits()
    _, q_sig = prs_search_full(np.concatenate([frame] * 2))
    assert float(q_sig) > 3 * float(q_noise)


def test_split_real_demod_matches_complex():
    """demod_frames_split (MXU matmul FFT, no complex dtype) must match the
    complex-FFT reference path to float32 tolerance."""
    from tpudab.ofdm.demod import demod_frames_split
    frame, bits = _frame_and_bits(seed=21)
    iq = apply_impairments(frame, Impairments(freq_offset_hz=800.0, snr_db=18, seed=9))
    iq = iq[None, :196608]
    soft_c, stats_c = demod_frames(iq, 800.0)
    soft_s, stats_s = demod_frames_split(iq.real.astype(np.float32),
                                         iq.imag.astype(np.float32), 800.0,
                                         dft_dtype="float32")
    np.testing.assert_allclose(np.asarray(soft_s), np.asarray(soft_c),
                               rtol=2e-3, atol=2e-3)
    hard = (np.asarray(soft_s)[0] < 0).astype(np.uint8)
    assert (hard != bits).mean() < 0.01


def test_split_real_demod_bf16():
    """The production bf16 DFT (f32 accumulation) must stay within ~-40 dB
    of the f32 soft bits — the 2048-point coherent sum keeps the per-element
    2^-9 rounding far below channel noise — and must not cost any bit errors
    at operating SNR."""
    from tpudab.ofdm.demod import demod_frames_split
    frame, bits = _frame_and_bits(seed=23)
    iq = apply_impairments(frame, Impairments(freq_offset_hz=500.0, snr_db=18,
                                              seed=11))
    iq = iq[None, :196608]
    re = iq.real.astype(np.float32)
    im = iq.imag.astype(np.float32)
    soft32, _ = demod_frames_split(re, im, 500.0, dft_dtype="float32")
    soft16, _ = demod_frames_split(re, im, 500.0)  # default bf16
    err = np.asarray(soft16) - np.asarray(soft32)
    rel_rms = np.sqrt((err ** 2).mean() / (np.asarray(soft32) ** 2).mean())
    assert rel_rms < 1e-2  # <= -40 dB
    hard = (np.asarray(soft16)[0] < 0).astype(np.uint8)
    assert (hard != bits).mean() == 0.0


def test_constellation_tap_and_snr():
    """demod exposes a decimated DQPSK constellation; the SNR estimate
    tracks the impairment level and the ASCII render shows 4 clusters."""
    from tpudab.ofdm.demod import demod_frames_split
    from tpudab.host.dashboard import constellation_snr_db, render_constellation
    frame, _ = _frame_and_bits(seed=31)
    iq_hi = apply_impairments(frame, Impairments(snr_db=30, seed=1))[None, :196608]
    iq_lo = apply_impairments(frame, Impairments(snr_db=8, seed=2))[None, :196608]
    snrs = []
    for iq in (iq_hi, iq_lo):
        _, stats = demod_frames_split(iq.real.astype(np.float32),
                                      iq.imag.astype(np.float32), 0.0)
        cre, cim = np.asarray(stats["const_re"]), np.asarray(stats["const_im"])
        assert cre.shape == cim.shape and cre.shape[0] >= 256
        snrs.append(constellation_snr_db(cre, cim))
        art = render_constellation(cre, cim)
        assert len(art.split("\n")) == 11
    assert snrs[0] > snrs[1] > 3.0
    assert snrs[0] > 20.0
