"""MSC subchannel decoding: CIF slices -> logical-frame bytes.

Reference parity: vendor/DAB-Radio MSC CIF extractor + time deinterleaver +
subchannel decoder (SURVEY.md sec 2.3). Batched design (SURVEY.md sec 7):
the reference's per-subchannel worker threads become batch dims — all CIFs in
a block are sliced/deinterleaved/depunctured at once and the Viterbi runs
batched across (logical frames x subchannels).

The 16-CIF deinterleaver history is an explicit carry (device array per
subchannel), making the streaming pipeline a pure step function.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import jax
import jax.numpy as jnp

from tpudab.constants.dab_params import CIF_BITS, CU_BITS
from tpudab.constants.puncture import PunctureProfile, eep_profile, UEPProfile
from tpudab.database.entities import Subchannel
from tpudab.fec.depuncture import depuncture
from tpudab.fec.prbs import descramble_bits
from tpudab.msc.interleave import deinterleave_batch, TIME_INTERLEAVE_DEPTH
# dispatching decode: Pallas ACS kernel on the GPU, XLA scan on CPU (bit-
# identical; VERDICT r3 item #1 — the host path must not pin the scan)
from tpudab.ops.viterbi_pallas import viterbi_decode_best as viterbi_decode
from tpudab.utils.bits import pack_bits


@dataclasses.dataclass(frozen=True)
class SubchannelConfig:
    """Static decode geometry for one subchannel (from the FIC database)."""

    subch_id: int
    start_cu: int
    size_cu: int
    profile: PunctureProfile
    padding_bits: int = 0  # UEP padding appended after the tail
    uep_key: Optional[tuple] = None  # (bitrate_kbps, protection_level) if UEP

    @property
    def slice_bits(self) -> int:
        return self.size_cu * CU_BITS

    @property
    def data_bits(self) -> int:
        """Decoded bits per 24 ms logical frame."""
        return self.profile.data_bits

    @classmethod
    def from_db(cls, sub: Subchannel) -> "SubchannelConfig":
        if sub.is_uep:
            from tpudab.constants.puncture import get_uep_profile_by_index
            uep: UEPProfile = get_uep_profile_by_index(sub.uep_index)
            return cls(sub.subch_id, sub.start_cu, uep.size_cu,
                       uep.to_profile(), uep.padding_bits,
                       uep_key=(uep.bitrate_kbps, uep.protection_level))
        profile = eep_profile(sub.size_cu, sub.eep_level, sub.eep_option)
        return cls(sub.subch_id, sub.start_cu, sub.size_cu, profile, 0)


def subch_cif_slices(soft, cfg: SubchannelConfig, nb_fic_bits: int,
                     nb_cifs: int):
    """(rows, nb_frame_bits) flat soft -> (rows, nb_cifs, slice_bits) CIF
    slices for one subchannel, taken DIRECTLY from the flat array: one
    contiguous column window per CIF position, stacked. Materializing the
    full (.., c, CIF_BITS) MSC band first — soft[:, fic:].reshape(.., c,
    CIF_BITS) — copies the whole band; these windows touch only the
    occupied CUs. Shared by ReceiveStep and ShardedReceiveStep (r5)."""
    lo = cfg.start_cu * CU_BITS
    parts = [jax.lax.slice_in_dim(
        soft, nb_fic_bits + k * CIF_BITS + lo,
        nb_fic_bits + k * CIF_BITS + lo + cfg.slice_bits,
        axis=-1) for k in range(nb_cifs)]
    return jnp.stack(parts, axis=-2)


class SubchannelDecoder:
    """Streaming decoder for one subchannel across consecutive CIFs.

    process(cif_soft_slices) consumes (C, slice_bits) soft CIF slices and
    returns (C, data_bytes) decoded logical frames plus a validity mask
    (False for the first 15 CIFs of history warm-up).
    """

    def __init__(self, config: SubchannelConfig):
        self.config = config
        n = config.slice_bits
        self._history = jnp.zeros((TIME_INTERLEAVE_DEPTH - 1, n), dtype=jnp.float32)
        self._n_seen = 0
        # Online self-calibration for budget-solved ('s') UEP rows: resolve
        # the region-table ambiguity from the broadcast itself before the
        # first frames are decoded (fec/uep_calibrate.py; VERDICT r4 item 2)
        self.calibration = None
        from tpudab.fec.uep_calibrate import needs_calibration
        self._cal_pending = (config.uep_key is not None
                             and needs_calibration(*config.uep_key))
        self._cal_buf: List[np.ndarray] = []

    def _run_calibration(self, frames: np.ndarray) -> None:
        """Calibrate on the given complete logical frames and swap
        self.config to the winning table (shared by the in-stream lock and
        the end-of-stream flush)."""
        from tpudab.fec import uep_calibrate as uc

        self._cal_pending = False
        res = uc.calibrate(frames, *self.config.uep_key)
        self.calibration = res
        if res.swapped:
            self.config = dataclasses.replace(
                self.config, profile=res.chosen.to_profile(),
                padding_bits=res.chosen.padding_bits)

    def _maybe_calibrate(self, logical, c: int) -> bool:
        """Accumulate complete logical frames and run the UEP table
        calibration, swapping self.config to the winning table. While
        pending, process() HOLDS all output (nothing is emitted under an
        unverified table, and on the live path the audio sink cannot prime
        and then starve during the calibration's Viterbi work — the mode-4
        realtime regression). Returns True once calibration is resolved."""
        from tpudab.fec import uep_calibrate as uc

        idx = np.arange(c) + self._n_seen - (TIME_INTERLEAVE_DEPTH - 1)
        fresh = np.asarray(logical)[idx >= 0]
        if fresh.shape[0]:
            self._cal_buf.append(fresh)
        have = sum(f.shape[0] for f in self._cal_buf)
        if have < uc.CALIBRATION_FRAMES:
            return False  # wait for more complete frames, holding output
        self._run_calibration(
            np.concatenate(self._cal_buf)[: uc.CALIBRATION_FRAMES])
        return True

    def _decode(self, logical, c: int):
        cfg = self.config
        n = cfg.slice_bits
        body = logical[:, : n - cfg.padding_bits] if cfg.padding_bits else logical
        mother = depuncture(body, cfg.profile)
        mother = mother.reshape(c, cfg.data_bits + 6, 4)
        bits = np.asarray(viterbi_decode(mother, cfg.data_bits))
        return pack_bits(np.stack([descramble_bits(b) for b in bits]))

    def process(self, cif_soft: np.ndarray):
        c, n = cif_soft.shape
        assert n == self.config.slice_bits
        buf = jnp.concatenate([self._history, jnp.asarray(cif_soft, jnp.float32)],
                              axis=0)  # (15 + C, n)
        logical = deinterleave_batch(buf, c)  # (C, n) soft codewords u_{m}
        self._history = buf[-(TIME_INTERLEAVE_DEPTH - 1):]

        if self._cal_pending:
            done = self._maybe_calibrate(logical, c)
            self._n_seen += c
            if not done:
                # hold: nothing decoded until the table is verified
                empty = np.zeros((0, self.config.data_bits // 8), np.uint8)
                return empty, np.zeros(0, bool), np.zeros(0, np.int64)
            # decode everything buffered (all complete frames so far) at
            # once under the winning table and emit with their indices
            frames = np.concatenate(self._cal_buf)
            self._cal_buf = []
            out = self._decode(frames, frames.shape[0])
            idx = np.arange(frames.shape[0])
            return out, np.ones(frames.shape[0], bool), idx

        out = self._decode(logical, c)
        # logical frame m = n_seen - 15 + row: with the new batch of C CIFs,
        # exactly frames n_seen-15 .. n_seen+C-16 became complete (frame m
        # needs CIFs m..m+15). Rows with m < 0 are warm-up (zero history).
        idx = np.arange(c) + self._n_seen - (TIME_INTERLEAVE_DEPTH - 1)
        valid = idx >= 0
        self._n_seen += c
        return out, valid, idx

    def flush(self):
        """End-of-stream: if calibration is still holding frames (capture
        shorter than CALIBRATION_FRAMES complete frames after discovery),
        calibrate on whatever is buffered and emit it. Returns
        (bytes, valid, idx) like process()."""
        empty = (np.zeros((0, self.config.data_bits // 8), np.uint8),
                 np.zeros(0, bool), np.zeros(0, np.int64))
        if not (self._cal_pending and self._cal_buf):
            return empty
        frames = np.concatenate(self._cal_buf)
        self._cal_buf = []
        self._run_calibration(frames)
        out = self._decode(frames, frames.shape[0])
        idx = np.arange(frames.shape[0])
        return out, np.ones(frames.shape[0], bool), idx

    def reset(self):
        self._history = jnp.zeros_like(self._history)
        self._n_seen = 0
        self._cal_buf = []  # the calibration LOCK itself survives a resync


class MSCDecoder:
    """Decodes all configured subchannels from transmission-frame soft bits.

    Orchestrates per-subchannel static slices; device work (deinterleave
    gather, depuncture scatter, batched Viterbi) is jitted per subchannel
    shape. Reference analog: BasicRadio's per-subchannel thread pool
    (/root/reference/src/radio_block.cpp:60) — here a batch dim.
    """

    def __init__(self, configs: List[SubchannelConfig], nb_cifs: int, cif_bits: int):
        self.configs = {c.subch_id: c for c in configs}
        self.decoders = {c.subch_id: SubchannelDecoder(c) for c in configs}
        self.nb_cifs = nb_cifs
        self.cif_bits = cif_bits

    def process_frames(self, msc_soft: np.ndarray) -> Dict[int, tuple]:
        """msc_soft: (F, nb_cifs * cif_bits) -> {subch_id: (bytes, valid, idx)}."""
        f = msc_soft.shape[0]
        cifs = np.asarray(msc_soft).reshape(f * self.nb_cifs, self.cif_bits)
        out = {}
        for subch_id, cfg in self.configs.items():
            lo = cfg.start_cu * CU_BITS
            sl = cifs[:, lo : lo + cfg.slice_bits]
            out[subch_id] = self.decoders[subch_id].process(sl)
        return out

    def reset(self):
        for d in self.decoders.values():
            d.reset()
