"""Pure jittable receive step: aligned IQ frames -> decoded FIC + MSC bits.

This is the flagship device program (SURVEY.md sec 7 architecture:
`step(carry, iq_block) -> (carry, outputs)`): PLL + batched FFT demod +
FIC depuncture/Viterbi/descramble + per-subchannel time-deinterleave (ring
carry) + depuncture/Viterbi/descramble — everything on device, bit outputs
packed to bytes on device. The host only parses bytes (FIGs, superframes).

Used by __graft_entry__ (compile check), bench.py (throughput), and
tpudab.parallel (sharded multi-chip variant).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import jax
import jax.numpy as jnp

from tpudab.constants.ofdm_params import get_ofdm_params
from tpudab.constants.dab_params import get_dab_params
from tpudab.constants.puncture import FIC_PROFILE, FIC_PROFILE_MODE3
from tpudab.fec.prbs import prbs_bits
from tpudab.fec.depuncture import depuncture_t
from tpudab.msc.subchannel import SubchannelConfig, subch_cif_slices
from tpudab.msc.interleave import deinterleave_batch, TIME_INTERLEAVE_DEPTH
from tpudab.ofdm.demod import demod_frames_split
from tpudab.ops.viterbi_pallas import viterbi_decode_bytes_best_t
from tpudab.utils.bits import pack_bits


def _decode_descramble_t(punctured, profile, n_bits: int):
    """Transposed-layout decode chain: depuncture_t emits the Viterbi
    kernel's native (T2p, 8, B) soft layout straight from the one-hot
    matmul (flush-bias tail, so termination stays exact), deleting the
    (B, T, 4) -> (T2, 8, B) relayout from the hot path; then decode to
    packed bytes (the GPU kernel's traceback packs) + energy-dispersal
    descramble as a byte-level XOR — the (B, n_bits) bit plane is never
    materialized."""
    by = viterbi_decode_bytes_best_t(depuncture_t(punctured, profile),
                                     n_bits)
    prbs_by = jnp.asarray(pack_bits(prbs_bits(n_bits)))
    return by ^ prbs_by


@dataclasses.dataclass
class ReceiveStep:
    """Builds a jitted step for a fixed subchannel configuration.

    n_ensembles > 1 adds a leading ensemble axis to frames/carry/outputs:
    one chip decodes N independent ensembles per step, multiplying every
    Viterbi/demod batch by N (the single-chip form of BASELINE config 5's
    multi-ensemble batching — per-chip throughput is batch-bound).
    """

    mode: int
    subchannels: Tuple[SubchannelConfig, ...]
    window_offset: int = 12
    n_ensembles: int = 1
    # Soft-bit dtype for the FEC chain (deinterleave ring, depuncture).
    # bfloat16 halves the memory traffic of the chain's memory-bound
    # stages; Viterbi decisions are scale-invariant and the ~2^-9 rounding
    # sits ~30 dB below channel noise at operating SNR. Set "float32" for
    # bit-exact parity with the per-stage oracles.
    # (A merge-FIC-into-widest-MSC-call variant using the separator-flush
    # trick was measured slower on the first accelerator target and
    # removed; the trick itself stays validated in
    # tests/test_viterbi.py::test_merged_codewords_separator_flush.)
    soft_dtype: str = "bfloat16"

    def __post_init__(self):
        self.params = get_ofdm_params(self.mode)
        self.dab = get_dab_params(self.mode)
        self._fn = jax.jit(self._step)

    # -------- carry --------

    def init_carry(self) -> Dict[str, jnp.ndarray]:
        e = self.n_ensembles
        shape = lambda n: (TIME_INTERLEAVE_DEPTH - 1, n) if e == 1 \
            else (e, TIME_INTERLEAVE_DEPTH - 1, n)
        dt = jnp.dtype(self.soft_dtype)
        return {
            f"deint_{cfg.subch_id}": jnp.zeros(shape(cfg.slice_bits), dt)
            for cfg in self.subchannels
        }

    # -------- the step --------

    def _step(self, carry, frames_re, frames_im, freq_hz):
        """frames_re/_im: lane-tiled (F, frame_len//128, 128) — or
        (E, F, frame_len//128, 128) when n_ensembles > 1 — float32 aligned;
        freq_hz scalar or (E,). Callers reshape on the HOST (a free numpy
        view); passing flat (.., frame_len) frames through the jit boundary
        would force a device relayout (see demod_frames_split docstring).

        Split re/im keeps the device program complex-free (the FFT is one
        dense matmul, tpudab.ofdm.demod). Returns (carry, outputs):
          fic_bytes: ([E,] F * n_groups, group_bytes) uint8 (pre-CRC-check)
          subch: {id: ([E,] C, frame_bytes) uint8} decoded logical frames
                 (logical index alignment handled by the host wrapper)
        """
        p, dab = self.params, self.dab
        rows = p.nb_frame_length // 128
        e = self.n_ensembles
        if e > 1:
            f = frames_re.shape[1]
            flat_re = frames_re.reshape(e * f, rows, 128)
            flat_im = frames_im.reshape(e * f, rows, 128)
            freq_rep = jnp.repeat(jnp.broadcast_to(
                jnp.asarray(freq_hz, jnp.float32), (e,)), f)
        else:
            f = frames_re.shape[0]
            flat_re, flat_im, freq_rep = frames_re, frames_im, freq_hz
        soft, stats = demod_frames_split(flat_re, flat_im, freq_rep,
                                         self.mode, self.window_offset,
                                         out_dtype=self.soft_dtype)

        # ---- FIC: standalone transposed depuncture -> Viterbi decode ----
        fic_profile = FIC_PROFILE_MODE3 if self.mode == 3 else FIC_PROFILE
        g = dab.nb_fib_groups
        fic_groups = soft[:, : dab.nb_fic_bits].reshape(
            -1, dab.nb_fic_bits_per_group)
        fic_nbits = fic_profile.data_bits
        fic_bytes = _decode_descramble_t(fic_groups, fic_profile, fic_nbits)
        fic_bytes = fic_bytes.reshape(e, f * g, -1) if e > 1 else fic_bytes

        # ---- MSC ----
        # Subchannels with identical coding geometry (profile + size) batch
        # into ONE Viterbi call — across subchannels AND ensembles: per-chip
        # throughput scales with batch, not with per-trellis speed
        # (SURVEY.md sec 7 'Hard parts': lane-pack subchannels).
        c = f * dab.nb_cifs

        def subch_cifs(cfg):
            """Per-subchannel CIF slices straight from the flat soft (see
            msc.subchannel.subch_cif_slices); row-dim merges are free."""
            st = subch_cif_slices(soft, cfg, dab.nb_fic_bits, dab.nb_cifs)
            return st.reshape((e, c, cfg.slice_bits) if e > 1
                              else (c, cfg.slice_bits))

        new_carry = dict(carry)
        subch_out = {}
        groups: Dict[tuple, list] = {}
        for cfg in self.subchannels:
            key = (cfg.profile, cfg.slice_bits, cfg.padding_bits)
            groups.setdefault(key, []).append(cfg)

        for (profile, slice_bits, padding_bits), cfgs in groups.items():
            logicals = []
            for cfg in cfgs:
                sl = subch_cifs(cfg)
                hist = carry[f"deint_{cfg.subch_id}"]
                buf = jnp.concatenate([hist, sl], axis=-2)
                logicals.append(deinterleave_batch(buf, c))
                new_carry[f"deint_{cfg.subch_id}"] = \
                    buf[..., -(TIME_INTERLEAVE_DEPTH - 1):, :]
            # (n_sub * [E *] C, slice)
            logical = jnp.concatenate(
                [l.reshape(-1, slice_bits) for l in logicals], axis=0)
            body = logical[:, : slice_bits - padding_bits] \
                if padding_bits else logical
            n_bits = profile.data_bits
            # transposed depuncture -> Viterbi decode (no (B,T,4)->(T2,8,B)
            # relayout; flush-bias tail keeps termination exact)
            by = _decode_descramble_t(body, profile, n_bits)
            by = by.reshape((len(cfgs), e, c, -1) if e > 1
                            else (len(cfgs), c, -1))
            for i, cfg in enumerate(cfgs):
                subch_out[cfg.subch_id] = by[i]

        outputs = {"fic_bytes": fic_bytes, "subch": subch_out,
                   "mean_power": stats["mean_power"],
                   # decimated DQPSK constellation tap (dashboard SNR /
                   # scatter; reference GetFrameDataVec analog) — tiny,
                   # rides along with the batch fetch
                   "const_re": stats["const_re"],
                   "const_im": stats["const_im"]}
        return new_carry, outputs

    def _ensure_tiled(self, x):
        """Accept flat (.., frame_len) frames too; hot-path callers should
        tile on the host instead (np reshape is free, device reshape isn't)."""
        if x.shape[-1] != 128:
            x = x.reshape(x.shape[:-1]
                          + (self.params.nb_frame_length // 128, 128))
        return x

    def __call__(self, carry, frames_re, frames_im, freq_hz):
        return self._fn(carry, self._ensure_tiled(frames_re),
                        self._ensure_tiled(frames_im), freq_hz)

    def tile_frames(self, frames_flat: np.ndarray) -> np.ndarray:
        """Host-side free reshape (..., frame_len) -> (..., len//128, 128)."""
        return np.asarray(frames_flat).reshape(
            frames_flat.shape[:-1] + (self.params.nb_frame_length // 128, 128))

    def call_complex(self, carry, frames, freq_hz):
        """Convenience wrapper for complex64 host buffers."""
        frames = self.tile_frames(np.asarray(frames))
        return self._fn(carry, jnp.asarray(frames.real.astype(np.float32)),
                        jnp.asarray(frames.imag.astype(np.float32)), freq_hz)

    def example_args(self, n_frames: int = 4, seed: int = 0):
        rng = np.random.default_rng(seed)
        shape = (n_frames, self.params.nb_frame_length // 128, 128)
        if self.n_ensembles > 1:
            shape = (self.n_ensembles,) + shape
        re = rng.standard_normal(shape).astype(np.float32)
        im = rng.standard_normal(shape).astype(np.float32)
        return (self.init_carry(), jnp.asarray(re), jnp.asarray(im),
                jnp.float32(0.0))
