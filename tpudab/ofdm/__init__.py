"""L3 OFDM front-end: IQ -> soft bits, as batched jitted JAX.

Batched replacement for vendor/DAB-Radio `ofdm_core` (SURVEY.md sec 2.2).
The reference's sample-serial, thread-fanned state machine becomes:
- block-parallel acquisition (null-dip scan + PRS matched filter + coarse/fine
  CFO estimation) over a whole buffered block (tpudab.ofdm.sync), and
- one batched demod for all 76 symbols x all frames: fused PLL rotate, FFT,
  differential demap, deinterleave, soft quantize (tpudab.ofdm.demod).
"""

from tpudab.ofdm.demod import demod_frames, active_bin_indices
from tpudab.ofdm.sync import (
    estimate_null_start, fine_time_sync, coarse_freq_estimate,
    fine_freq_estimate, acquire, SyncConfig,
)
