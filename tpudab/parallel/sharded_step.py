"""Sharded receive step over the (ensemble, time) mesh.

Multi-chip design (SURVEY.md sec 2.7, sec 5.7; BASELINE configs 4-5):
- 'ensemble' axis: independent DAB ensembles, pure data parallel, no comm.
- 'time' axis: each shard holds a contiguous run of transmission frames of
  the same ensemble. The only sequential coupling is the 16-CIF time
  deinterleaver; its 15-CIF history is exchanged with the left time-neighbor
  via ONE lax.ppermute carrying ALL subchannels' tails concatenated (a few
  hundred KB), after which every shard decodes its frames independently —
  continuous decode across block seams with zero host round trips. The
  shard's trailing (edge) frames are demodulated FIRST so the collective is
  issued before the bulk interior demod (VERDICT r2 item #1). The mesh
  follows the algorithm only: on GPUs every card reaches every other over
  NVLink at the same rate.

A step-level carry holds the stream tail so consecutive step calls are
seamless too (streaming resume, SURVEY.md sec 5.4).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from tpudab.constants.ofdm_params import get_ofdm_params
from tpudab.constants.dab_params import get_dab_params, CIF_BITS, CU_BITS
from tpudab.constants.puncture import FIC_PROFILE, FIC_PROFILE_MODE3
from tpudab.fec.depuncture import depuncture
from tpudab.fec.prbs import prbs_bits
from tpudab.msc.interleave import deinterleave_batch, TIME_INTERLEAVE_DEPTH
from tpudab.msc.subchannel import SubchannelConfig, subch_cif_slices
from tpudab.ofdm.demod import demod_frames_split
from tpudab.ops.viterbi_pallas import viterbi_decode_bytes_best
from tpudab.utils.bits import pack_bits

_H = TIME_INTERLEAVE_DEPTH - 1  # 15-CIF halo


@dataclasses.dataclass
class ShardedReceiveStep:
    """jit(shard_map(step)) over a Mesh(('ensemble', 'time'))."""

    mesh: Mesh
    mode: int
    subchannels: Tuple[SubchannelConfig, ...]
    window_offset: int = 12

    def __post_init__(self):
        self.params = get_ofdm_params(self.mode)
        self.dab = get_dab_params(self.mode)
        self.n_time = self.mesh.shape["time"]

        carry_spec = {f"deint_{c.subch_id}": P("ensemble", None, None)
                      for c in self.subchannels}
        out_spec = {
            "fic_bytes": P("ensemble", "time", None, None),
            "subch": {c.subch_id: P("ensemble", "time", None, None)
                      for c in self.subchannels},
            "tails": {c.subch_id: P("ensemble", "time", None, None)
                      for c in self.subchannels},
        }
        self._fn = jax.jit(jax.shard_map(
            self._step,
            mesh=self.mesh,
            in_specs=(carry_spec, P("ensemble", "time", None, None),
                      P("ensemble", "time", None, None), P("ensemble")),
            out_specs=(out_spec,),
            check_vma=False,
        ))

    # ---------------- carry ----------------

    def init_carry(self, n_ensembles: int):
        carry = {
            f"deint_{c.subch_id}": jnp.zeros((n_ensembles, _H, c.slice_bits),
                                             jnp.float32)
            for c in self.subchannels
        }
        sharding = NamedSharding(self.mesh, P("ensemble", None, None))
        return jax.device_put(carry, {k: sharding for k in carry})

    # ---------------- sharded step body (runs per shard) ----------------

    def _step(self, carry, frames_re, frames_im, freq_hz):
        """Shard-local shapes: frames_re/_im (E_l, T_l, frame_len//128, 128)
        float32 (lane-tiled; see demod_frames_split), freq (E_l,).
        Complex-free split-real path.

        Returns dict with shard-local outputs; the 'time' axis is re-inserted
        as a leading size-1 axis per shard so global outputs stack over time.
        """
        p, dab = self.params, self.dab
        e_l, t_l = frames_re.shape[:2]
        assert t_l * dab.nb_cifs >= _H, (
            f"need >= {-(-_H // dab.nb_cifs)} frames per time shard so the "
            f"15-CIF deinterleaver halo fits in one neighbor exchange "
            f"(got {t_l})")
        t_idx = lax.axis_index("time")
        tile = (p.nb_frame_length // 128, 128)

        def demod(re, im, nf):
            flat_re = re.reshape(e_l * nf, *tile)
            flat_im = im.reshape(e_l * nf, *tile)
            s, _ = demod_frames_split(flat_re, flat_im,
                                      jnp.repeat(freq_hz, nf), self.mode,
                                      self.window_offset)
            return s.reshape(e_l, nf, -1)

        # Demod the trailing edge frames FIRST: they alone determine the
        # 15-CIF halo, so the single batched ppermute below is issued before
        # the interior demod.
        edge_f = min(t_l, -(-_H // dab.nb_cifs))
        soft_edge = demod(frames_re[:, t_l - edge_f:],
                          frames_im[:, t_l - edge_f:], edge_f)
        cifs_tail = soft_edge[:, :, dab.nb_fic_bits:].reshape(
            e_l, edge_f * dab.nb_cifs, CIF_BITS)[:, -_H:]
        # ONE collective for ALL subchannels: concatenated tail columns.
        tail_cat = jnp.concatenate(
            [lax.slice_in_dim(cifs_tail, cfg.start_cu * CU_BITS,
                              cfg.start_cu * CU_BITS + cfg.slice_bits, axis=2)
             for cfg in self.subchannels], axis=2)
        if self.n_time > 1:
            halo_cat = lax.ppermute(
                tail_cat, "time",
                perm=[(i, i + 1) for i in range(self.n_time - 1)])
            # Pin the exchange EARLY in program order on every shard: the
            # sender's ppermute has no local consumers, so without this
            # barrier XLA's CPU thunk scheduler sinks the send to the end
            # of the sender's program and the receiver stalls through the
            # sender's ENTIRE step before it can decode (measured +40% on
            # a 2-process gloo run). The barrier makes every downstream op
            # wait for the exchange, right after the edge demod on both
            # sides. On four H100s over NCCL (2 x 2 mesh) the exchange
            # (one SendRecv kernel, 0.12-0.28 ms per step) is largely
            # serialised by it: 0.06-0.27 ms of that runs with no other
            # kernel beside it on the card.
            soft_edge, frames_re, frames_im, halo_cat = \
                lax.optimization_barrier(
                    (soft_edge, frames_re, frames_im, halo_cat))
        else:
            halo_cat = jnp.zeros_like(tail_cat)

        if edge_f < t_l:
            soft_int = demod(frames_re[:, : t_l - edge_f],
                             frames_im[:, : t_l - edge_f], t_l - edge_f)
            soft = jnp.concatenate([soft_int, soft_edge], axis=1)
        else:
            soft = soft_edge
        soft = soft.reshape(e_l * t_l, -1)

        # FIC
        fic_profile = FIC_PROFILE_MODE3 if self.mode == 3 else FIC_PROFILE
        g = dab.nb_fib_groups
        n_bits = fic_profile.data_bits
        groups = soft[:, : dab.nb_fic_bits].reshape(
            e_l * t_l * g, dab.nb_fic_bits_per_group)
        mother = depuncture(groups, fic_profile).reshape(-1, n_bits + 6, 4)
        prbs_by = jnp.asarray(pack_bits(prbs_bits(n_bits)))
        fic_bytes = (viterbi_decode_bytes_best(mother, n_bits)
                     ^ prbs_by).reshape(e_l, 1, t_l * g, -1)

        # MSC: the halo already arrived via the single batched ppermute above
        c_l = t_l * dab.nb_cifs

        def subch_cifs(cfg):
            """Per-subchannel CIF slices straight from the flat soft (see
            msc.subchannel.subch_cif_slices)."""
            return subch_cif_slices(
                soft, cfg, dab.nb_fic_bits, dab.nb_cifs
            ).reshape(e_l, c_l, cfg.slice_bits)

        subch_out, tails = {}, {}
        col = 0
        for cfg in self.subchannels:
            sl = subch_cifs(cfg)
            tail = lax.slice_in_dim(tail_cat, col, col + cfg.slice_bits,
                                    axis=2)
            halo = lax.slice_in_dim(halo_cat, col, col + cfg.slice_bits,
                                    axis=2)
            col += cfg.slice_bits
            # time-shard 0 takes the step-level carry instead of the ppermute
            # result (which is zeros there)
            hist = jnp.where(t_idx == 0, carry[f"deint_{cfg.subch_id}"], halo)
            buf = jnp.concatenate([hist, sl], axis=1)  # (E_l, 15 + C_l, n)

            logical = deinterleave_batch(buf, c_l)  # (E_l, C_l, n)

            body = logical[..., : cfg.slice_bits - cfg.padding_bits] \
                if cfg.padding_bits else logical
            mother = depuncture(body.reshape(e_l * c_l, -1), cfg.profile)
            prbs_s = jnp.asarray(pack_bits(prbs_bits(cfg.data_bits)))
            by = (viterbi_decode_bytes_best(
                mother.reshape(e_l * c_l, cfg.data_bits + 6, 4),
                cfg.data_bits) ^ prbs_s).reshape(e_l, 1, c_l, -1)
            subch_out[cfg.subch_id] = by
            tails[cfg.subch_id] = tail.reshape(e_l, 1, _H, cfg.slice_bits)

        return ({"fic_bytes": fic_bytes, "subch": subch_out, "tails": tails},)

    # ---------------- host-facing call ----------------

    def __call__(self, carry, frames_re, frames_im, freq_hz):
        """frames_re/_im: (E, T_total, frame_len//128, 128) float32 (tiled),
        T_total divisible by the time-mesh size. Returns (new_carry, outputs)
        where outputs' logical ordering over time is contiguous per ensemble.
        """
        (out,) = self._fn(carry, frames_re, frames_im, freq_hz)
        e = frames_re.shape[0]
        new_carry = {
            f"deint_{cfg.subch_id}": out["tails"][cfg.subch_id][:, -1]
            for cfg in self.subchannels
        }
        # merge (E, T_shards, per_shard, B) -> (E, total, B)
        fic = out["fic_bytes"].reshape(e, -1, out["fic_bytes"].shape[-1])
        subch = {k: v.reshape(e, -1, v.shape[-1]) for k, v in out["subch"].items()}
        return new_carry, {"fic_bytes": fic, "subch": subch}

    def shard_inputs(self, frames, freq_hz):
        """frames: complex (E, T, len) host array -> sharded, lane-tiled
        split re/im (the reshape is free on host)."""
        fs = NamedSharding(self.mesh, P("ensemble", "time", None, None))
        qs = NamedSharding(self.mesh, P("ensemble"))
        frames = np.asarray(frames)
        e, t = frames.shape[:2]
        tiled = (e, t, self.params.nb_frame_length // 128, 128)
        re = np.ascontiguousarray(frames.real, dtype=np.float32).reshape(tiled)
        im = np.ascontiguousarray(frames.imag, dtype=np.float32).reshape(tiled)
        return (jax.device_put(re, fs), jax.device_put(im, fs),
                jax.device_put(jnp.asarray(freq_hz), qs))
