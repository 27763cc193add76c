"""Device kernels (JAX/XLA and Pallas/Triton) for the DAB compute path."""

from tpudab.ops.viterbi import viterbi_decode, viterbi_decode_np, pad_mother_soft
