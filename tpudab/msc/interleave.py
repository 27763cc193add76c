"""MSC time interleaving, ETSI EN 300 401 sec 12 (Table 21 scattering rule).

Convention used by both the synthesizer and the receiver deinterleaver:
transmitted CIF n carries, at bit index i of a subchannel's slice,
    C_n(i) = u_{n - d(i mod 16)}(i)
where u_m is the m-th punctured logical-frame codeword and d is the
bit-reversed delay table below. The receiver reconstructs logical frame m
once CIF m+15 has arrived (16-CIF ring, 15-CIF latency) — on device the
ring is an array carried in the streaming state and the gather is a static
mask-select (SURVEY.md sec 7 'time deinterleaver (carry ring as device
array)').
"""

from __future__ import annotations

import functools

import numpy as np

TIME_INTERLEAVE_DEPTH = 16

# d(i mod 16): bit-reversed 0..15 sequence
_DELAYS = np.array([0, 8, 4, 12, 2, 10, 6, 14, 1, 9, 5, 13, 3, 11, 7, 15],
                   dtype=np.int32)


@functools.lru_cache(maxsize=None)
def interleave_delays(n_bits: int) -> np.ndarray:
    """Per-bit delay vector d(i mod 16) of length n_bits."""
    reps = -(-n_bits // 16)
    return np.tile(_DELAYS, reps)[:n_bits].copy()


def interleave_np(logical_frames: np.ndarray) -> np.ndarray:
    """Synthesizer-side interleave.

    logical_frames: (n_frames, n_bits) punctured codewords u_m (0/1 or soft).
    Returns transmitted CIF slices C_n of identical shape; frames with
    m < 0 contribute zeros.
    """
    n_frames, n_bits = logical_frames.shape
    d = interleave_delays(n_bits)
    rows = np.arange(n_frames)[:, None] - d[None, :]
    cols = np.broadcast_to(np.arange(n_bits)[None, :], rows.shape)
    valid = rows >= 0
    return np.where(valid, logical_frames[np.maximum(rows, 0), cols], 0)


def deinterleave_np(cif_slices: np.ndarray) -> np.ndarray:
    """Receiver-side oracle: C_n -> u_m (valid for m <= n_frames-1-15).

    Returns (n_frames, n_bits); rows m > n_frames-16 are partially zero
    (future CIFs unavailable).
    """
    n_frames, n_bits = cif_slices.shape
    d = interleave_delays(n_bits)
    rows = np.arange(n_frames)[:, None] + d[None, :]
    cols = np.broadcast_to(np.arange(n_bits)[None, :], rows.shape)
    valid = rows < n_frames
    return np.where(valid, cif_slices[np.minimum(rows, n_frames - 1), cols], 0)


def deinterleave_batch(buf, c: int):
    """Device-side batched deinterleave.

    buf: (..., c + 15, S) CIF slices with 15 rows of history prepended,
    S % 16 == 0. Returns (..., c, S) logical frames:
        out[..., i, col] = buf[..., i + d(col % 16), col].

    d depends only on col % 16, so instead of a general 2D gather (which
    XLA lowers to a slow per-element take at production batch) the result
    is a mask-select sum of 16 contiguous row-shifted slices
    buf[..., k : k+c, :], which XLA fuses into one pass over the output
    (each output element selects among 16 shifted reads of the buffer).
    """
    import jax
    import jax.numpy as jnp
    s = buf.shape[-1]
    assert s % TIME_INTERLEAVE_DEPTH == 0
    d = interleave_delays(s)
    out = None
    for k in range(TIME_INTERLEAVE_DEPTH):
        part = jnp.where(jnp.asarray(d == k),
                         jax.lax.slice_in_dim(buf, k, k + c, axis=-2), 0.0)
        out = part if out is None else out + part
    return out
