"""Batched soft-decision Viterbi decoder for the K=7 rate-1/4 DAB mother code.

Batched replacement for the reference's vendored SIMD `viterbi_decoder`
package (/root/reference/CMakeLists.txt:53-54; SURVEY.md sec 2.3 row 2 calls
this the #1 native-kernel target). Design rationale (SURVEY.md sec 7):
the 64-state trellis is sequential in time, so per-chip throughput comes from
*batching across codewords* (FIB groups x subchannels x CIFs x ensembles),
not from parallelizing one trellis:

- Branch metrics are a matmul against the +-1 output-sign table:
  metric[reg7] = sum_j soft_j * sign_j(reg7), at HIGHEST precision (a TF32
  product would round the soft bits; the +-1 signs are exact).
- The ACS recursion is a lax.scan over time with only static gathers
  (predecessor tables), max, and add — elementwise work batched over B.
- Traceback is a reverse scan over stored 1-bit decisions.

Codewords of different lengths batch together by right-padding with the
"virtual flush" pattern (+A on all four mother bits): since the encoder ends
in state 0 and u=0 keeps state 0 with all-zero output bits, appending
all-(+A) steps extends every path's metric by the same maximum amount along
the true path and strictly less along wrong paths, so the argmax is unchanged
(pad_mother_soft).

Soft-bit convention: +1 => bit 0, -1 => bit 1, 0 => erasure (depunctured).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from tpudab.fec.conv import OUTPUT_SIGNS, N_STATES

_NEG = -1e9


def pad_mother_soft(mother_soft: np.ndarray, target_steps: int,
                    amplitude: float = 1.0) -> np.ndarray:
    """Right-pad (..., T, 4) mother soft bits to (..., target_steps, 4).

    Padding uses +amplitude on all four generator outputs == perfect evidence
    for a continued zero-input flush; exact w.r.t. the decoded prefix.
    """
    t = mother_soft.shape[-2]
    if t == target_steps:
        return mother_soft
    pad = np.zeros(mother_soft.shape[:-2] + (target_steps - t, 4), dtype=mother_soft.dtype)
    pad += amplitude
    return np.concatenate([mother_soft, pad], axis=-2)


@functools.lru_cache(maxsize=None)
def _radix_tables(k: int):
    """Static tables for a radix-2^k trellis (k input bits per ACS step).

    A k-step super-transition is identified by reg = (j << 6) | s'' where
    s'' is the destination state and j in [0, 2^k) selects one of the 2^k
    predecessors pred_j = (s'' >> k) | (j << (6-k)).  The combined branch
    metric over the k constituent single-step transitions is one matmul:
    soft (B, 4k) @ SIGNS_K (4k, 64*2^k), because step i of super-transition
    reg is the single-step transition (reg >> (k-1-i)) & 127.
    """
    assert 1 <= k <= 6
    n_trans = N_STATES << k
    reg = np.arange(n_trans, dtype=np.int64)
    rows = []
    for i in range(k):
        reg7 = (reg >> (k - 1 - i)) & 127
        rows.append(OUTPUT_SIGNS[reg7, :].T)            # (4, n_trans)
    signs = np.ascontiguousarray(np.concatenate(rows, axis=0))  # (4k, n_trans)
    j = np.arange(1 << k, dtype=np.int32)[:, None]
    spp = np.arange(N_STATES, dtype=np.int32)[None, :]
    preds = (spp >> k) | (j << (6 - k))                 # (2^k, 64)
    return signs, preds


@functools.partial(jax.jit, static_argnames=("n_data_bits", "radix", "unroll"))
def viterbi_decode(mother_soft, n_data_bits: int, radix: int = 4,
                   unroll: int | None = None):
    """Decode batched codewords.

    Args:
      mother_soft: (B, T, 4) float32 depunctured mother-code soft bits
        (T = n_data_bits + 6 + optional virtual-flush padding).
      n_data_bits: number of data bits to return (tail/padding dropped).
      radix: trellis steps per scan iteration (2^radix-way ACS). Compacting
        the trellis cuts the sequential scan length by `radix`x at the cost
        of a wider (but still one-matmul) branch-metric step; radix=1 is the
        classic butterfly.

    Returns:
      bits: (B, n_data_bits) uint8 hard decisions.
    """
    k = radix
    mother_soft = mother_soft.astype(jnp.float32)
    b, t, _ = mother_soft.shape
    # Round T up to a multiple of k with virtual-flush padding (+1 on all
    # four mother bits == perfect evidence for continued zero-input flush;
    # see pad_mother_soft).
    t_pad = (-t) % k
    if t_pad:
        mother_soft = jnp.pad(mother_soft, ((0, 0), (0, t_pad), (0, 0)),
                              constant_values=1.0)
        t = t + t_pad

    signs_np, preds_np = _radix_tables(k)
    signs_t = jnp.asarray(signs_np)                     # (4k, 64*2^k)
    preds = jnp.asarray(preds_np)                       # (2^k, 64)
    shifts64 = jnp.asarray(np.concatenate([np.arange(32, dtype=np.uint32)] * 2))

    soft_t = jnp.moveaxis(
        mother_soft.reshape(b, t // k, 4 * k), 1, 0)    # (T/k, B, 4k)

    pm0 = jnp.full((b, N_STATES), _NEG, dtype=jnp.float32).at[:, 0].set(0.0)

    # Branch metrics are computed INSIDE the scan body (a skinny per-step
    # matmul): precomputing all of them would materialize a (T, B, 64*2^k)
    # f32 tensor — tens of GB of device-memory traffic at production batch
    # sizes, which dominates the whole decode. Decisions are bit-packed to 2k uint32 words
    # per codeword per super-step (same 2 bits/state/trellis-step as radix 1).
    def acs(pm, soft_step):
        bm = jax.lax.dot_general(
            soft_step, signs_t,
            dimension_numbers=(((1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=jnp.float32)         # (B, 64*2^k)
        cand = (jnp.take(pm, preds, axis=-1)            # (B, 2^k, 64)
                + bm.reshape(b, 1 << k, N_STATES))
        dec = jnp.argmax(cand, axis=1).astype(jnp.uint32)   # (B, 64)
        new_pm = jnp.max(cand, axis=1)
        # rebase on state 0's metric: the metric SPREAD is bounded by the
        # trellis (<= reachability diameter * max branch metric), so this
        # keeps absolute values bounded without a cross-state reduction
        new_pm = new_pm - new_pm[:, 0:1]
        words = []
        for i in range(k):
            bits = ((dec >> i) & 1) << shifts64[None, :]
            words.append(bits[:, :32].sum(axis=-1, dtype=jnp.uint32))
            words.append(bits[:, 32:].sum(axis=-1, dtype=jnp.uint32))
        return new_pm, jnp.stack(words, axis=-1)        # (B, 2k) u32

    if unroll is None:
        unroll = max(1, 4 // k)
    _, dec_words = lax.scan(acs, pm0, soft_t, unroll=unroll)  # (T/k, B, 2k)

    def traceback(state, dec_step):                     # dec_step (B, 2k)
        su = state.astype(jnp.uint32)
        j = jnp.zeros_like(su)
        for i in range(k):
            word = jnp.where(state < 32, dec_step[:, 2 * i],
                             dec_step[:, 2 * i + 1])
            j = j | (((word >> (su & 31)) & 1) << i)
        prev = (state >> k) | (j.astype(jnp.int32) << (6 - k))
        # bit emitted at in-super-step offset i is input u_{t+i} = bit
        # (k-1-i) of the destination state's low k bits
        out = jnp.stack([((state >> (k - 1 - i)) & 1).astype(jnp.uint8)
                         for i in range(k)], axis=-1)   # (B, k)
        return prev, out

    final_state = jnp.zeros((b,), dtype=jnp.int32)
    _, bits_rev = lax.scan(traceback, final_state, dec_words,
                           reverse=True, unroll=unroll)
    # scan(reverse=True) emits outputs in forward order: bits_rev[t] covers
    # trellis steps [t*k, (t+1)*k).
    bits = jnp.moveaxis(bits_rev, 0, 1).reshape(b, t)   # (B, T)
    return bits[:, :n_data_bits]


def viterbi_decode_np(mother_soft: np.ndarray, n_data_bits: int) -> np.ndarray:
    """NumPy oracle (identical algorithm) for unit tests."""
    mother_soft = np.asarray(mother_soft, dtype=np.float32)
    if mother_soft.ndim == 2:
        mother_soft = mother_soft[None]
        squeeze = True
    else:
        squeeze = False
    b, t, _ = mother_soft.shape
    bm = mother_soft @ OUTPUT_SIGNS.T  # (B, T, 128)
    pred0 = (np.arange(N_STATES) >> 1)
    pred1 = pred0 | 32
    pm = np.full((b, N_STATES), _NEG, dtype=np.float32)
    pm[:, 0] = 0.0
    decs = np.zeros((t, b, N_STATES), dtype=bool)
    for i in range(t):
        cand0 = pm[:, pred0] + bm[:, i, :N_STATES]
        cand1 = pm[:, pred1] + bm[:, i, N_STATES:]
        decs[i] = cand1 > cand0
        pm = np.maximum(cand0, cand1)
        pm -= pm[:, 0:1]
    state = np.zeros(b, dtype=np.int64)
    bits = np.zeros((b, t), dtype=np.uint8)
    for i in range(t - 1, -1, -1):
        bits[:, i] = state & 1
        d = decs[i][np.arange(b), state]
        state = (state >> 1) | (d.astype(np.int64) << 5)
    out = bits[:, :n_data_bits]
    return out[0] if squeeze else out
