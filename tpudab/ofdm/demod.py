"""Batched OFDM frame demodulation: aligned IQ frames -> soft bits.

Replaces the reference's per-symbol worker threads (OFDM_Demod symbol fan-out,
SURVEY.md sec 2.2 'pipeline threading') with a single batched program: all 76
symbols of all buffered frames are FFT'd at once; the PLL rotate, differential
demap, frequency deinterleave and soft quantization are elementwise/gather ops
XLA fuses around the FFT. Runs under jit; float32 complex throughout.
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from tpudab.constants.ofdm_params import get_ofdm_params, SAMPLING_RATE
from tpudab.constants.interleaver import get_carrier_map_positions


@functools.lru_cache(maxsize=None)
def active_bin_indices(mode: int) -> np.ndarray:
    """fft-bin indices of active carriers k=-K/2..K/2\\{0}, ascending k."""
    p = get_ofdm_params(mode)
    k_half = p.nb_data_carriers // 2
    ks = np.array([k for k in range(-k_half, k_half + 1) if k != 0])
    return (ks % p.nb_fft).astype(np.int32)


@functools.partial(jax.jit, static_argnames=("mode", "window_offset"))
def demod_frames(frames, freq_offset_hz, mode: int = 1, window_offset: int = 12):
    """Demodulate aligned transmission frames.

    Args:
      frames: (F, nb_frame_length) complex64, each starting at the first
        sample of the null symbol.
      freq_offset_hz: scalar or (F,) net CFO to remove (PLL/NCO stage;
        reference analog: apply_pll, SURVEY.md sec 2.2).
      mode: DAB transmission mode.
      window_offset: samples by which the FFT window is advanced into the
        cyclic prefix (timing-error margin; the common phase ramp it induces
        cancels in the differential demap).

    Returns:
      soft: (F, nb_frame_bits) float32 soft bits (+ => 0, - => 1), unit mean
        magnitude.
      stats: dict of per-frame diagnostics (mean power).
    """
    p = get_ofdm_params(mode)
    f = frames.shape[0]
    n_sym, n_fft, n_cp = p.nb_symbols, p.nb_fft, p.nb_cyclic_prefix

    # PLL: rotate out the net frequency offset
    freq = jnp.broadcast_to(jnp.asarray(freq_offset_hz, jnp.float32), (f,))
    t_idx = jnp.arange(p.nb_frame_length, dtype=jnp.float32) / SAMPLING_RATE
    rot = jnp.exp(-2j * jnp.pi * freq[:, None] * t_idx[None, :]).astype(jnp.complex64)
    x = frames * rot

    # carve symbols, FFT window advanced window_offset into the CP
    sym_region = x[:, p.nb_null_period:]
    sym = sym_region.reshape(f, n_sym, n_fft + n_cp)
    start = n_cp - window_offset
    windows = sym[:, :, start:start + n_fft]
    spec = jnp.fft.fft(windows, axis=-1)

    bins = jnp.asarray(active_bin_indices(mode))
    carriers = jnp.take(spec, bins, axis=-1)  # (F, n_sym, K)

    # differential demap
    diff = carriers[:, 1:, :] * jnp.conj(carriers[:, :-1, :])  # (F, n_sym-1, K)

    # frequency deinterleave: logical j lives at carrier position pos[j]
    pos = jnp.asarray(get_carrier_map_positions(mode).astype(np.int32))
    logical = jnp.take(diff, pos, axis=-1)

    soft = jnp.concatenate([jnp.real(logical), jnp.imag(logical)], axis=-1)
    soft = soft.reshape(f, p.nb_frame_bits)
    norm = jnp.mean(jnp.abs(soft), axis=-1, keepdims=True)
    soft = soft / jnp.maximum(norm, 1e-20)

    stats = {
        "mean_power": jnp.mean(jnp.abs(frames) ** 2, axis=-1),
    }
    return soft.astype(jnp.float32), stats


@functools.lru_cache(maxsize=None)
def _dense_demod_matrix(mode: int):
    """(nb_fft, K) split-real DFT matrix restricted to the active carriers,
    columns in LOGICAL carrier order.

    Folds three of the reference demod's stages (SURVEY.md sec 2.2: per-symbol
    FFT, active-bin extraction, frequency deinterleave via mapper_ref) into
    ONE dense matmul operand: column j is the DFT row of fft bin
    bins[pos[j]], so the matmul output is already deinterleaved — no gathers
    on the hot path, and the whole FFT is a single dense contraction
    instead of a two-stage Cooley-Tukey (3 relayout transposes + 8 matmuls
    per batch).
    """
    p = get_ofdm_params(mode)
    bins = active_bin_indices(mode)
    pos = get_carrier_map_positions(mode)
    cols = bins[pos.astype(np.int64)]
    ang = -2.0 * np.pi * np.outer(np.arange(p.nb_fft), cols) / p.nb_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.partial(jax.jit, static_argnames=("mode", "window_offset",
                                             "dft_dtype", "out_dtype"))
def demod_frames_split(frames_re, frames_im, freq_offset_hz, mode: int = 1,
                       window_offset: int = 12,
                       dft_dtype: str = "bfloat16",
                       out_dtype: str = "float32"):
    """Complex-free demod: split re/im float32 in, soft bits out.

    Numerically equivalent to demod_frames but complex-free: the FFT +
    bin-select + frequency deinterleave are one dense matmul per split part
    (see _dense_demod_matrix), and the PLL/NCO rotation is applied only to
    the FFT windows (the null symbol and the unused cyclic-prefix samples
    never enter the compute).

    Input frames may be (F, nb_frame_length) or the tiled
    (F, nb_frame_length//128, 128) form (a free numpy reshape).

    dft_dtype: matmul operand precision. "bfloat16" (default) rounds the
    windows and DFT matrix to bf16 with float32 accumulation — per-element
    rounding is ~2^-9 but the 2048-point coherent accumulation keeps the
    resulting soft-bit SNR at ~-55 dB (validated in
    tests/test_ofdm.py::test_split_real_demod_bf16).
    "float32" runs the products at HIGHEST precision (no TF32) for parity
    with demod_frames.
    """
    p = get_ofdm_params(mode)
    n_sym, n_fft, n_cp = p.nb_symbols, p.nb_fft, p.nb_cyclic_prefix
    rows_per_win = n_fft // 128
    start = n_cp - window_offset
    dt = jnp.dtype(dft_dtype)

    if frames_re.ndim == 2:
        f = frames_re.shape[0]
        re3 = frames_re.reshape(f, p.nb_frame_length // 128, 128)
        im3 = frames_im.reshape(f, p.nb_frame_length // 128, 128)
    else:
        f = frames_re.shape[0]
        re3, im3 = frames_re, frames_im
    freq = jnp.broadcast_to(jnp.asarray(freq_offset_hz, jnp.float32), (f,))

    flat_r = re3.reshape(f, p.nb_frame_length)
    flat_i = im3.reshape(f, p.nb_frame_length)

    def carve(x):
        sym = x[:, p.nb_null_period:].reshape(f, n_sym, n_fft + n_cp)
        return sym[:, :, start:start + n_fft]

    wr, wi = carve(flat_r), carve(flat_i)
    # PLL rotate the windows only. Absolute sample time of window sample
    # (sym, k) is null + sym*(fft+cp) + start + k; the common per-symbol
    # phase the timing offset induces cancels in the differential demap.
    t_sym = (p.nb_null_period + start
             + (n_fft + n_cp) * np.arange(n_sym)) / SAMPLING_RATE
    t_k = np.arange(n_fft) / SAMPLING_RATE
    t_abs = (t_sym[:, None] + t_k[None, :]).astype(np.float32)
    ph = -2.0 * jnp.pi * freq[:, None, None] * jnp.asarray(t_abs)[None]
    c, s = jnp.cos(ph), jnp.sin(ph)
    ar = (wr * c - wi * s).astype(dt).reshape(f, n_sym, rows_per_win, 128)
    ai = (wr * s + wi * c).astype(dt).reshape(f, n_sym, rows_per_win, 128)

    wre, wim = _dense_demod_matrix(mode)
    k = wre.shape[1]
    if dft_dtype == "bfloat16":
        # Karatsuba complex matmul — THREE contractions instead of four
        # (m1=(ar+ai)@Wre, m2=ai@(Wre+Wim), m3=ar@(Wim-Wre); cr=m1-m2,
        # ci=m3+m1) — and bf16 matmul outputs/demap intermediates, which
        # halves the HBM traffic of the bandwidth-bound differential-demap
        # stage. Soft-bit error vs the f32 4-matmul form is ~-45 dB (bf16
        # rounding of the demap products), ~25 dB below channel noise at
        # operating SNR.
        acc = jnp.bfloat16
        mm = lambda a, b: jax.lax.dot_general(
            a, b, dimension_numbers=(((2, 3), (0, 1)), ((), ())),
            preferred_element_type=acc)
        shp = (rows_per_win, 128, k)
        wc = jnp.asarray(wre.reshape(shp), dt)
        wcd = jnp.asarray((wre + wim).reshape(shp), dt)
        wdc = jnp.asarray((wim - wre).reshape(shp), dt)
        m1 = mm((ar + ai).astype(dt), wc)
        m2 = mm(ai, wcd)
        m3 = mm(ar, wdc)
        cr = m1 - m2
        ci = m3 + m1
    else:
        # float32 path: one (K, 2N) operand per split part, f32 products
        # and accumulation (HIGHEST: no TF32) — parity with demod_frames
        # (the complex oracle)
        mboth = jnp.asarray(np.concatenate([wre, wim], axis=1)
                            .reshape(rows_per_win, 128, 2 * k), dt)
        mm = lambda a, b: jax.lax.dot_general(
            a, b, dimension_numbers=(((2, 3), (0, 1)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)
        p1 = mm(ar, mboth)          # [ar@Wre | ar@Wim]
        p2 = mm(ai, mboth)          # [ai@Wre | ai@Wim]
        # (f, n_sym, K) spectra at active carriers, logical order
        cr = p1[..., :k] - p2[..., k:]
        ci = p1[..., k:] + p2[..., :k]

    # differential demap: z_l * conj(z_{l-1})
    dr = cr[:, 1:, :] * cr[:, :-1, :] + ci[:, 1:, :] * ci[:, :-1, :]
    di = ci[:, 1:, :] * cr[:, :-1, :] - cr[:, 1:, :] * ci[:, :-1, :]

    if dft_dtype == "bfloat16":
        # Normalize the PARTS before the concat: the mean reduce and the
        # divide fuse into the demap pass (re/im halves are equal-sized,
        # so the flat-array mean equals the average of the halves' means),
        # while normalizing AFTER the (F, 75, 3072) -> (F, nb_frame_bits)
        # flatten costs a separate full read+write pass over an array the
        # flatten just relaid out.
        norm = 0.5 * (jnp.mean(jnp.abs(dr).astype(jnp.float32),
                               axis=(1, 2), keepdims=True)
                      + jnp.mean(jnp.abs(di).astype(jnp.float32),
                                 axis=(1, 2), keepdims=True))
        denom = jnp.maximum(norm, 1e-20)
        odt = jnp.dtype(out_dtype)
        dr_n = (dr.astype(jnp.float32) / denom).astype(odt)
        di_n = (di.astype(jnp.float32) / denom).astype(odt)
        soft = jnp.concatenate([dr_n, di_n], axis=-1).reshape(
            f, p.nb_frame_bits)
    else:
        # f32 path: flat-array normalization, bit-accurate parity with the
        # complex oracle demod_frames (same reduction order)
        soft = jnp.concatenate([dr, di], axis=-1).reshape(f, p.nb_frame_bits)
        norm = jnp.mean(jnp.abs(soft).astype(jnp.float32),
                        axis=-1, keepdims=True)
        soft = (soft.astype(jnp.float32)
                / jnp.maximum(norm, 1e-20)).astype(jnp.dtype(out_dtype))

    # constellation tap (reference analog: OFDM_Demod::GetFrameDataVec,
    # /root/reference/src/render_radio_block.cpp:109-110,887-918): a
    # decimated slice of the last frame's differential symbols, normalized
    # to unit RMS — DQPSK points at +-pi/4, +-3pi/4. Nearly free: dr/di are
    # already materialized.
    n_pts = 480
    stride = max(1, ((p.nb_symbols - 1) * dr.shape[-1]) // n_pts)
    cr_pts = dr[-1].reshape(-1)[::stride][:n_pts].astype(jnp.float32)
    ci_pts = di[-1].reshape(-1)[::stride][:n_pts].astype(jnp.float32)
    scale = jax.lax.rsqrt(jnp.mean(cr_pts ** 2 + ci_pts ** 2) + 1e-20)

    stats = {"mean_power": jnp.mean(re3.astype(jnp.float32) ** 2
                                    + im3.astype(jnp.float32) ** 2,
                                    axis=(-2, -1)),
             "const_re": cr_pts * scale, "const_im": ci_pts * scale}
    return soft, stats
