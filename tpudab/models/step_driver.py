"""StepDriver: host-side owner of the jitted ReceiveStep for a live Receiver.

Shared by OfflinePipeline and StreamingRadio (VERDICT r3 item #1: the live
streaming path must run the same fused device program — demod + FIC
depuncture/Viterbi + MSC deinterleave/depuncture/Viterbi, the Pallas Viterbi
kernel on the GPU — that bench.py measures). The driver tracks the pieces that live across
batches: the jitted step (rebuilt when the FIC database discovers new
subchannels), the deinterleaver ring carry, and the logical-frame index of
each subchannel's next output row.

Reference analog: Radio_Block owning OFDM_Demod + BasicRadio across the
stream (/root/reference/src/radio_block.cpp:11-49) — here the analogous
long-lived state is the device carry of one pure step function.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from tpudab.msc.interleave import TIME_INTERLEAVE_DEPTH


class StepDriver:
    """Builds/rebuilds a jitted ReceiveStep from a Receiver's discovered
    subchannels and runs batches through it.

    Attributes (checkpointable, see tpudab.models.checkpoint):
      step: the current ReceiveStep (None until first discovery)
      carry: {deint_<id>: (15, slice_bits)} device arrays
      first_logical: {subch_id: logical index of the next output row 0}
    """

    def __init__(self, mode: int, window_offset: int):
        self.mode = mode
        self.window_offset = window_offset
        self.step = None
        self.carry: Optional[Dict] = None
        self.first_logical: Dict[int, int] = {}

    def maybe_build(self, receiver, total_frames: int) -> None:
        """(Re)build the jitted step from the receiver's discovered decoders.

        Initial build seeds the carry from each python decoder's
        deinterleaver history (seamless handoff from the host path that ran
        while the FIC was still discovering the layout). If the FIC later
        discovers additional subchannels, the step is rebuilt: existing
        carries are kept, new subchannels start with zero history (their
        first 15 logical frames are warm-up, as at stream start).
        """
        import jax.numpy as jnp
        from tpudab.models.step import ReceiveStep

        if not receiver.subch_decoders:
            return
        current = set(receiver.subch_decoders.keys())
        if self.step is not None and \
                current == {c.subch_id for c in self.step.subchannels}:
            return
        if any(getattr(d, "_cal_pending", False)
               for d in receiver.subch_decoders.values()):
            # A budget-solved UEP row is still self-calibrating
            # (fec/uep_calibrate.py); building now would bake the
            # unverified table into the jitted step. If a step is ALREADY
            # running (the pending subchannel was discovered after an
            # earlier build), demote to the host path — otherwise the
            # host decoder that runs the calibration never executes and
            # the new subchannel is never decoded (r5 review finding).
            # The device deinterleaver carries hand back to the python
            # decoders so the logical-frame sequence stays seamless; the
            # step rebuilds with every subchannel once the table locks.
            if self.step is not None:
                warmup = TIME_INTERLEAVE_DEPTH - 1
                for subch_id, dec in receiver.subch_decoders.items():
                    key = f"deint_{subch_id}"
                    if self.carry is not None and key in self.carry:
                        dec._history = self.carry[key]
                        dec._n_seen = self.first_logical[subch_id] + warmup
                self.step = None
                self.carry = None
                self.first_logical = {}
            return
        configs = tuple(d.config for d in receiver.subch_decoders.values())
        old_carry = self.carry or {}
        new_step = ReceiveStep(mode=self.mode, subchannels=configs,
                               window_offset=self.window_offset)
        carry = {}
        n_cifs_seen = total_frames * receiver.dab.nb_cifs
        warmup = TIME_INTERLEAVE_DEPTH - 1
        for subch_id, dec in receiver.subch_decoders.items():
            key = f"deint_{subch_id}"
            if key in old_carry:
                carry[key] = old_carry[key]
            elif self.step is None:
                carry[key] = jnp.asarray(dec._history)
                self.first_logical[subch_id] = dec._n_seen - warmup
            else:
                carry[key] = jnp.zeros(
                    (warmup, dec.config.slice_bits), jnp.float32)
                self.first_logical[subch_id] = n_cifs_seen - warmup
        self.step = new_step
        self.carry = carry

    def process(self, receiver, frames_re: np.ndarray, frames_im: np.ndarray,
                freq_hz) -> Tuple[Dict, Dict]:
        """Run one batch through the device step and hand the decoded bytes
        to the receiver. frames_re/_im: lane-tiled (F, len//128, 128) f32.

        Returns (outputs, step_stats) where outputs is the receiver's
        {subch_id: AudioChannelOutput} and step_stats carries the on-device
        diagnostics (mean_power, const_re/const_im) for dashboards.
        """
        nf = frames_re.shape[0]
        self.carry, step_out = self.step(self.carry, frames_re, frames_im,
                                         np.float32(freq_hz))
        subch_bytes = {k: np.asarray(v) for k, v in step_out["subch"].items()}
        outputs = receiver.process_step_outputs(
            np.asarray(step_out["fic_bytes"]), subch_bytes,
            dict(self.first_logical))
        for k in self.first_logical:
            self.first_logical[k] += nf * receiver.dab.nb_cifs
        return outputs, step_out
