"""Device-native OFDM acquisition: split-real, batched over ensembles.

This is the production acquisition path (VERDICT round-1 #3): the five
estimators of tpudab.ofdm.sync re-expressed with NO complex dtype anywhere
— every FFT is tpudab.ops.matfft (matmuls on split re/im), angles are
arctan2, rotations are explicit cos/sin — and it takes a BATCH of buffers:
one call acquires all N ensembles of a multi-ensemble card (the reference's
sample-serial state machine is one-signal-at-a-time by construction;
SURVEY.md sec 2.2, sec 7 'Sync as data-parallel code').

Algorithm identical to tpudab.ofdm.sync.acquire (the complex CPU oracle —
parity-tested in tests/test_sync_device.py):
  null dip -> dip-end rise -> fractional CFO (lag-Tu autocorrelation) ->
  integer-bin CFO (differential-spectrum circular correlation vs the PRS
  reference) -> global PRS matched filter over one frame of lags ->
  one unconditional refinement pass (coarse at the exact PRS position +
  re-run of the matched filter) -> fractional CFO on the aligned frame.
The host-side conditional refinement of sync.acquire becomes an
unconditional second pass here (data-independent control flow for jit).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpudab.constants.ofdm_params import get_ofdm_params, SAMPLING_RATE
from tpudab.constants.prs import get_prs_time, get_prs_spectrum
from tpudab.ops.matfft import matfft


def _next_pow2(n: int) -> int:
    m = 1
    while m < n:
        m *= 2
    return m


@functools.lru_cache(maxsize=None)
def _coarse_tables(mode: int):
    """Constant conj(FFT(d_ref)) for the differential-spectrum correlation."""
    ref = get_prs_spectrum(mode)
    d_ref = ref * np.conj(np.roll(ref, 1))
    f = np.conj(np.fft.fft(d_ref))
    return f.real.astype(np.float32), f.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _prs_mf_tables(mode: int, nfft: int):
    """Constant conj(FFT(prs_time, nfft)) for the PRS matched filter."""
    ref = get_prs_time(mode)
    f = np.conj(np.fft.fft(ref, nfft))
    return f.real.astype(np.float32), f.imag.astype(np.float32)


def _rotate(re, im, freq_hz, t0=0):
    """Per-row mixer: (B, L) * exp(-2j pi f t), f (B,) Hz, t from sample t0."""
    l = re.shape[-1]
    t = (t0 + jnp.arange(l, dtype=jnp.float32)) / SAMPLING_RATE
    ph = -2.0 * jnp.pi * freq_hz[:, None] * t[None, :]
    c, s = jnp.cos(ph), jnp.sin(ph)
    return re * c - im * s, re * s + im * c


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _cmul_conj(ar, ai, br, bi):
    """(a) * conj(b) on split parts."""
    return ar * br + ai * bi, ai * br - ar * bi


def _coarse_split(win_re, win_im, mode: int, max_bins: int):
    """Integer-bin CFO from (B, nb_fft) PRS-aligned windows. Returns
    (offset_bins (B,) int32, quality (B,))."""
    p = get_ofdm_params(mode)
    sr, si = matfft(win_re, win_im)
    rr, ri = jnp.roll(sr, 1, axis=-1), jnp.roll(si, 1, axis=-1)
    dr, di = _cmul_conj(sr, si, rr, ri)
    fr, fi = matfft(dr, di)
    gr_c, gi_c = _coarse_tables(mode)
    gr, gi = _cmul(fr, fi, jnp.asarray(gr_c), jnp.asarray(gi_c))
    cr, ci = matfft(gr, gi, inverse=True)
    mag = jnp.sqrt(cr * cr + ci * ci)
    lags = np.concatenate([np.arange(0, max_bins + 1),
                           np.arange(p.nb_fft - max_bins, p.nb_fft)]).astype(np.int32)
    vals = mag[:, jnp.asarray(lags)]
    best = jnp.argmax(vals, axis=-1)
    lag = jnp.asarray(lags)[best]
    offset = jnp.where(lag <= max_bins, lag, lag - p.nb_fft)
    q = jnp.take_along_axis(vals, best[:, None], axis=-1)[:, 0] \
        / jnp.maximum(jnp.mean(mag, axis=-1), 1e-20)
    return offset.astype(jnp.int32), q


def _prs_search_split(seg_re, seg_im, mode: int, length: int,
                      peak_threshold_db: float = 15.0,
                      peak_distance_prob: float = 0.15):
    """Global PRS matched filter over (B, n) CFO-corrected segments
    (n >= length + nb_fft). Returns (peak (B,) int32, quality (B,)).

    Multipath first-path detection (reference impulse_peak_threshold_db /
    impulse_peak_distance_probability, render_radio_block.cpp:224-225;
    VERDICT r3 missing #2): real channels can put the STRONGEST correlation
    peak on a late echo — locking to it pushes the FFT window past the
    guard interval (ISI) while the earlier direct path was decodable. Among
    lags up to one cyclic prefix AHEAD of the strongest peak, each
    candidate's magnitude is boosted by the distance prior
    p^(-d/CP) (earlier = likelier first path) and must clear
    max * 10^(-threshold_db/20); the best boosted candidate wins.
    threshold_db <= 0 or p >= 1 reduces to plain argmax (bit-identical to
    the pre-r4 behavior on single-path channels either way: with one
    dominant peak no other lag clears the threshold)."""
    p = get_ofdm_params(mode)
    n = seg_re.shape[-1]
    nfft = _next_pow2(n)
    pad = nfft - n
    if pad:
        seg_re = jnp.pad(seg_re, ((0, 0), (0, pad)))
        seg_im = jnp.pad(seg_im, ((0, 0), (0, pad)))
    fr, fi = matfft(seg_re, seg_im)
    rr_c, ri_c = _prs_mf_tables(mode, nfft)
    gr, gi = _cmul(fr, fi, jnp.asarray(rr_c), jnp.asarray(ri_c))
    cr, ci = matfft(gr, gi, inverse=True)
    mag = jnp.sqrt(cr * cr + ci * ci)[:, :length]
    max_lag = jnp.argmax(mag, axis=-1)
    max_mag = jnp.take_along_axis(mag, max_lag[:, None], axis=-1)
    q = max_mag[:, 0] / jnp.maximum(jnp.mean(mag, axis=-1), 1e-20)
    if peak_threshold_db > 0.0 and 0.0 < peak_distance_prob < 1.0:
        cp = float(p.nb_cyclic_prefix)
        d = (max_lag[:, None] - jnp.arange(length)[None, :]).astype(jnp.float32)
        in_win = (d >= 0.0) & (d <= cp)
        boost = jnp.float32(peak_distance_prob) ** (-d / cp)
        thresh = max_mag * 10.0 ** (-peak_threshold_db / 20.0)
        score = jnp.where(in_win & (mag >= thresh), mag * boost, -1.0)
        peak = jnp.argmax(score, axis=-1)
    else:
        peak = max_lag
    return peak.astype(jnp.int32), q


def _cp_autocorr_split(fr_re, fr_im, mode: int):
    """Fractional CFO (Hz) from CP autocorrelation over all symbols of
    aligned (B, frame_len) frames."""
    p = get_ofdm_params(mode)
    b = fr_re.shape[0]
    def syms(x):
        return x[:, p.nb_null_period:].reshape(b, p.nb_symbols,
                                               p.nb_symbol_period)
    sr, si = syms(fr_re), syms(fr_im)
    h_r, h_i = sr[:, :, : p.nb_cyclic_prefix], si[:, :, : p.nb_cyclic_prefix]
    t_r = sr[:, :, p.nb_fft: p.nb_fft + p.nb_cyclic_prefix]
    t_i = si[:, :, p.nb_fft: p.nb_fft + p.nb_cyclic_prefix]
    acc_r = jnp.sum(h_r * t_r + h_i * t_i, axis=(1, 2))
    acc_i = jnp.sum(h_i * t_r - h_r * t_i, axis=(1, 2))
    ang = jnp.arctan2(acc_i, acc_r)
    return (-ang / (2.0 * jnp.pi) * (SAMPLING_RATE / p.nb_fft)).astype(jnp.float32)


def _slice_rows(x, starts, length: int):
    """(B, n), (B,) -> (B, length) per-row dynamic slices."""
    return jax.vmap(lambda row, s: jax.lax.dynamic_slice(row, (s,), (length,))
                    )(x, starts)


@functools.partial(jax.jit, static_argnames=("mode", "max_coarse_bins",
                                             "peak_threshold_db",
                                             "peak_distance_prob"))
def acquire_device(re, im, mode: int = 1, max_coarse_bins: int = 100,
                   peak_threshold_db: float = 15.0,
                   peak_distance_prob: float = 0.15):
    """Batched full acquisition: (B, n) split-real IQ (n >= 2 frames + fft).

    Returns a dict of (B,) arrays: frame_start, coarse_bins, coarse_hz,
    fine_hz, net_freq_hz, null_quality, coarse_quality, time_quality.
    One fully-jitted device program; no host round trips, no complex dtype.
    """
    p = get_ofdm_params(mode)
    b, n = re.shape
    spacing = SAMPLING_RATE / p.nb_fft
    assert n >= 2 * p.nb_frame_length, "need >= 2 frames for acquisition"

    # 1. null dip + dip-end rise
    power = re * re + im * im
    csum = jnp.concatenate([jnp.zeros((b, 1), power.dtype),
                            jnp.cumsum(power, axis=-1)], axis=-1)
    win = p.nb_null_period
    ma = (csum[:, win:] - csum[:, :-win]) / win
    cand = ma[:, : p.nb_frame_length]
    null_start = jnp.argmin(cand, axis=-1).astype(jnp.int32)
    mean_p = jnp.mean(power, axis=-1)
    null_q = jnp.take_along_axis(cand, null_start[:, None], axis=-1)[:, 0] \
        / jnp.maximum(mean_p, 1e-20)
    rise = 64
    ma_r = (csum[:, rise:] - csum[:, :-rise]) / rise
    idx = jnp.arange(ma_r.shape[-1], dtype=jnp.int32)
    risen = (ma_r > 0.5 * mean_p[:, None]) & (idx[None, :] >= null_start[:, None])
    null_end = jnp.where(jnp.any(risen, axis=-1),
                         jnp.argmax(risen, axis=-1).astype(jnp.int32),
                         null_start + p.nb_null_period)
    approx_prs = jnp.minimum(null_end + p.nb_cyclic_prefix,
                             jnp.int32(n - p.nb_fft))

    # 2. fractional CFO, alignment-free (lag-Tu autocorrelation)
    n2 = (2 * p.nb_frame_length - p.nb_fft) // 8 * 8
    a_r, a_i = re[:, :n2], im[:, :n2]
    b_r, b_i = re[:, p.nb_fft: p.nb_fft + n2], im[:, p.nb_fft: p.nb_fft + n2]
    acc_r = jnp.sum(a_r * b_r + a_i * b_i, axis=-1)
    acc_i = jnp.sum(a_i * b_r - a_r * b_i, axis=-1)
    fine_hz = (-jnp.arctan2(acc_i, acc_r) / (2.0 * jnp.pi) * spacing
               ).astype(jnp.float32)

    # 3. integer-bin CFO after removing the fractional part (half-carrier
    # ambiguity safe, as in sync.acquire step 3)
    w_re = _slice_rows(re, approx_prs, p.nb_fft)
    w_im = _slice_rows(im, approx_prs, p.nb_fft)
    w_re, w_im = _rotate(w_re, w_im, fine_hz)
    coarse_bins, coarse_q = _coarse_split(w_re, w_im, mode, max_coarse_bins)
    net_hz = coarse_bins.astype(jnp.float32) * spacing + fine_hz

    # 4. exact timing: PRS matched filter over one frame of lags
    n_corr = p.nb_frame_length + p.nb_fft
    s_re, s_im = _rotate(re[:, :n_corr], im[:, :n_corr], net_hz)
    peak, time_q = _prs_search_split(s_re, s_im, mode, p.nb_frame_length,
                                     peak_threshold_db, peak_distance_prob)
    frame_start = peak - p.nb_cyclic_prefix - p.nb_null_period
    frame_start = jnp.where(frame_start < 0,
                            frame_start + p.nb_frame_length, frame_start)

    # 5. refinement (unconditional: data-independent control flow): coarse
    # again at the exact PRS body, re-run timing with the refined net, then
    # fractional CFO on the aligned frame
    prs_body = jnp.minimum(frame_start + p.nb_null_period + p.nb_cyclic_prefix,
                           jnp.int32(n - p.nb_fft))
    w2_re = _slice_rows(re, prs_body, p.nb_fft)
    w2_im = _slice_rows(im, prs_body, p.nb_fft)
    w2_re, w2_im = _rotate(w2_re, w2_im, fine_hz, t0=0)
    coarse2, coarse_q2 = _coarse_split(w2_re, w2_im, mode, max_coarse_bins)
    net_hz = coarse2.astype(jnp.float32) * spacing + fine_hz
    s_re, s_im = _rotate(re[:, :n_corr], im[:, :n_corr], net_hz)
    peak, time_q = _prs_search_split(s_re, s_im, mode, p.nb_frame_length,
                                     peak_threshold_db, peak_distance_prob)
    frame_start = peak - p.nb_cyclic_prefix - p.nb_null_period
    frame_start = jnp.where(frame_start < 0,
                            frame_start + p.nb_frame_length, frame_start)

    safe_start = jnp.minimum(frame_start, jnp.int32(n - p.nb_frame_length))
    f_re = _slice_rows(re, safe_start, p.nb_frame_length)
    f_im = _slice_rows(im, safe_start, p.nb_frame_length)
    f_re, f_im = _rotate(f_re, f_im, net_hz)
    resid = _cp_autocorr_split(f_re, f_im, mode)
    fine_hz = fine_hz + resid
    coarse_hz = coarse2.astype(jnp.float32) * spacing
    net_hz = coarse_hz + fine_hz

    return {
        "frame_start": frame_start,
        "coarse_bins": coarse2,
        "coarse_hz": coarse_hz,
        "fine_hz": fine_hz,
        "net_freq_hz": net_hz,
        "null_quality": null_q,
        "coarse_quality": jnp.maximum(coarse_q, coarse_q2),
        "time_quality": time_q,
    }


@functools.partial(jax.jit, static_argnames=("mode", "search",
                                             "peak_threshold_db",
                                             "peak_distance_prob"))
def fine_time_sync_device(seg_re, seg_im, freq_hz, mode: int = 1,
                          search: int = 64,
                          peak_threshold_db: float = 15.0,
                          peak_distance_prob: float = 0.15):
    """Batched PRS matched filter for the streaming timing recheck:
    (B, 2*search + nb_fft [+margin]) segments expected to contain the PRS
    near sample `search`, rotated by freq_hz (B,) in here. Returns
    (peak (B,), quality (B,))."""
    seg_re, seg_im = _rotate(seg_re, seg_im, jnp.broadcast_to(
        jnp.asarray(freq_hz, jnp.float32), (seg_re.shape[0],)))
    return _prs_search_split(seg_re, seg_im, mode, 2 * search + 1,
                             peak_threshold_db, peak_distance_prob)


@functools.partial(jax.jit, static_argnames=("mode", "max_bins"))
def coarse_freq_device(seg_re, seg_im, freq_hz, mode: int = 1,
                       max_bins: int = 100):
    """Batched residual integer-bin CFO from (B, nb_fft) PRS-body windows
    after removing freq_hz (B,): the streaming CONTINUOUS coarse tap.
    Returns (residual_bins (B,) int32, quality (B,)). While locked the
    residual is 0; a slow oscillator walk past +/- half a carrier shows up
    as +/-1 and is folded into the tracked coarse offset instead of forcing
    a reacquisition (reference is_coarse_freq_correction +
    coarse_freq_slow_beta loop, render_radio_block.cpp:215-223)."""
    seg_re, seg_im = _rotate(seg_re, seg_im, jnp.broadcast_to(
        jnp.asarray(freq_hz, jnp.float32), (seg_re.shape[0],)))
    return _coarse_split(seg_re, seg_im, mode, max_bins)


@functools.partial(jax.jit, static_argnames=("mode",))
def fine_freq_device(f_re, f_im, freq_hz, mode: int = 1):
    """Batched residual fractional CFO of aligned (B, frame_len) frames
    after removing freq_hz (B,): the streaming fine-freq tracking tap."""
    f_re, f_im = _rotate(f_re, f_im, jnp.broadcast_to(
        jnp.asarray(freq_hz, jnp.float32), (f_re.shape[0],)))
    return _cp_autocorr_split(f_re, f_im, mode)


def acquire_host(iq: np.ndarray, mode: int = 1, max_coarse_bins: int = 100,
                 peak_threshold_db: float = 15.0,
                 peak_distance_prob: float = 0.15):
    """Host-facing single-buffer acquisition on the default JAX backend
    (the GPU when present): complex in, python scalars out."""
    iq = np.asarray(iq)
    out = acquire_device(
        jnp.asarray(np.ascontiguousarray(iq.real, dtype=np.float32))[None],
        jnp.asarray(np.ascontiguousarray(iq.imag, dtype=np.float32))[None],
        mode, max_coarse_bins, float(peak_threshold_db),
        float(peak_distance_prob))
    out = {k: np.asarray(v)[0] for k, v in out.items()}
    return {
        "frame_start": int(out["frame_start"]),
        "coarse_bins": int(out["coarse_bins"]),
        "coarse_hz": float(out["coarse_hz"]),
        "fine_hz": float(out["fine_hz"]),
        "net_freq_hz": float(out["net_freq_hz"]),
        "null_quality": float(out["null_quality"]),
        "coarse_quality": float(out["coarse_quality"]),
        "time_quality": float(out["time_quality"]),
    }
