"""FEC layer: convolutional code, puncturing, scrambling, CRC, Reed-Solomon.

Batched replacement for the reference's vendored `viterbi_decoder` SIMD
package (/root/reference/CMakeLists.txt:53-54) and libcorrect
(/root/reference/CMakeLists.txt:27-40): the Viterbi decoder is a batched
JAX/Pallas program (tpudab.ops.viterbi); host-side byte-level checks (CRC,
firecode) stay NumPy.
"""

from tpudab.fec.conv import conv_encode, OUTPUT_SIGNS, PRED0, PRED1
from tpudab.fec.depuncture import depuncture, puncture
from tpudab.fec.prbs import prbs_bits, descramble_bits, descramble_bytes
from tpudab.fec.crc import crc16_ccitt, check_fib_crc, firecode_check
