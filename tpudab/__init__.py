"""tpudab — a batched, device-native DAB (Digital Audio Broadcasting) receiver
framework.

Built from scratch in JAX/XLA/Pallas with the capabilities of the
SDRPlusPlus-DAB-Radio-Plugin reference (and its DAB-Radio core): the full chain
from raw 2.048 MS/s IQ samples through OFDM synchronization/demodulation, DAB
channel decoding (FIC/MSC, Viterbi, energy dispersal, time deinterleaving,
DAB+ Firecode + Reed-Solomon superframes) to AAC/MP2 audio, dynamic labels and
MOT slideshows.

Layer map (mirrors reference SURVEY.md §1, re-designed as batched device
programs):

  L3 OFDM front-end   tpudab.ofdm     (batched JAX + Pallas; ref: vendor/DAB-Radio/src/ofdm)
  L2 DAB decoder      tpudab.fec/fic/msc/database  (ref: vendor/DAB-Radio/src/dab)
  L2 orchestration    tpudab.models   (ref: vendor/DAB-Radio/src/basic_radio)
  L1 audio output     tpudab.audio    (ref: vendor/DAB-Radio/examples/audio)
  L4/L5 host runtime  tpudab.host     (ref: src/radio_block.cpp, src/dab_module.cpp)
  scale-out           tpudab.parallel (no reference analog; ensemble x time mesh)
"""

__version__ = "0.1.0"

from tpudab.constants.ofdm_params import OFDMParams, get_ofdm_params
from tpudab.constants.dab_params import DABParams, get_dab_params
