"""Puncturing (synthesizer) and depuncturing (receiver) as static gathers.

The receiver-side depuncture expands a punctured soft-bit stream back to the
4*(I+6) mother-code positions, inserting 0.0 (erasure) at punctured slots.
On device this is a per-region block-diagonal one-hot matmul (the DAB
puncture pattern repeats every 128 mother bits within a protection region) —
the batched analog of the reference's scalar depuncture loops
(SURVEY.md sec 2.3 'Depuncturing'). The products run at HIGHEST precision:
with float32 operands a TF32 product would round the soft bits, and every
output is exactly one input (or the flush constant) only without it.
"""

from __future__ import annotations

import functools

import jax

import numpy as np
import jax.numpy as jnp

from tpudab.constants.puncture import PunctureProfile


@functools.lru_cache(maxsize=None)
def _keep_indices(profile: PunctureProfile) -> np.ndarray:
    mask = profile.mask()
    return np.nonzero(mask)[0].astype(np.int32)


def puncture(mother_bits: np.ndarray, profile: PunctureProfile) -> np.ndarray:
    """Keep only unpunctured mother bits (synthesizer side, NumPy)."""
    idx = _keep_indices(profile)
    return np.asarray(mother_bits)[..., idx]


@functools.lru_cache(maxsize=None)
def _block_runs(profile: PunctureProfile, block: int = 128):
    """Decompose the puncture mask into runs of identical `block`-bit block
    masks: [(n_blocks, kept_per_block, one_hot (kpb, block))]. DAB puncturing
    (EN 300 401 sec 11) is periodic per 128-bit mother block within each
    protection region, so runs are few (regions + tail)."""
    mask = profile.mask()
    n_mother = mask.shape[0]
    pad = (-n_mother) % block
    maskp = np.pad(mask, (0, pad))
    blocks = maskp.reshape(-1, block)
    runs = []
    i = 0
    while i < blocks.shape[0]:
        j = i
        while j + 1 < blocks.shape[0] and np.array_equal(blocks[j + 1], blocks[i]):
            j += 1
        bm = blocks[i]
        kept = np.nonzero(bm)[0]
        one_hot = np.zeros((kept.shape[0], block), np.float32)
        one_hot[np.arange(kept.shape[0]), kept] = 1.0
        runs.append((j - i + 1, int(kept.shape[0]), one_hot))
        i = j + 1
    return n_mother, tuple(runs)


def depuncture(soft_bits, profile: PunctureProfile):
    """Punctured soft bits (..., punctured_bits) -> (..., 4*(I+6)) with erasures.

    Works on jnp or np arrays; jit-safe (tables are trace-time constants).
    Implemented as per-region block-diagonal one-hot matmuls (the puncture
    pattern repeats every 128 mother bits within a protection region) in
    place of a column scatter.
    """
    soft_bits = jnp.asarray(soft_bits)
    n_mother, runs = _block_runs(profile)
    lead = soft_bits.shape[:-1]
    outs = []
    off = 0
    # Accumulate in the operand dtype: every output element is a sum with at
    # most ONE nonzero product (one-hot columns), so a bf16 accumulator is
    # exact up to the bf16 rounding the inputs already carry — and emitting
    # bf16 straight from the matmul halves the output traffic vs f32 +
    # downcast (the final astype becomes a no-op).
    acc_dt = soft_bits.dtype if soft_bits.dtype == jnp.bfloat16 \
        else jnp.float32
    for n_blocks, kpb, one_hot in runs:
        seg = jax.lax.slice_in_dim(soft_bits, off, off + n_blocks * kpb, axis=-1)
        seg = seg.reshape(lead + (n_blocks, kpb))
        # one_hot matches the operand dtype (a mixed bf16 x f32 dot would
        # upcast the whole operand)
        expanded = jax.lax.dot_general(
            seg, jnp.asarray(one_hot, dtype=seg.dtype),
            dimension_numbers=(((seg.ndim - 1,), (0,)), ((), ())),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=acc_dt)
        outs.append(expanded.reshape(lead + (n_blocks * one_hot.shape[1],)))
        off += n_blocks * kpb
    out = jnp.concatenate(outs, axis=-1) if len(outs) > 1 else outs[0]
    return out[..., :n_mother].astype(soft_bits.dtype)


def depuncture_t(soft_bits, profile: PunctureProfile):
    """Punctured soft (..., B, S) -> mother-TRANSPOSED (T2p, 8, B) with
    zeros at punctured slots and at the trailing 128-bit block pad;
    T2p = n_blocks * 16 (8 mother bits per radix-2 Viterbi super-step).

    This is the layout the Pallas Viterbi kernel consumes directly (batch
    minor, so a warp's threads read consecutive codewords of one step), so
    emitting it straight from the one-hot matmul — via a batched
    dot_general whose output is (n_blocks, 128, B) — deletes the full
    (B, T, 4) -> (T2, 8, B) transpose pass from the decode chain.

    The tail pad region (mother positions >= n_mother, i.e. past the six
    real tail bits) is filled with the +1.0 virtual-flush pattern (see
    ops.viterbi.pad_mother_soft). This keeps the ML path pinned to state 0
    through the pad, so the decode is bit-identical to the flush-padded
    (B, T, 4) production path — a plain ZERO pad would instead let
    traceback start from the argmax end state, which under noise can
    differ from the terminated state-0 path in the trailing bits
    (ADVICE r3 item 1). The bias is folded INTO the final run's one-hot
    matmul as an affine column (ones appended to the operand, the flush
    pattern appended to the table) — a separate elementwise add after the
    matmul materialized an extra full pass over the (T2p, 8, B) output.
    Exactness is preserved: every output position still receives at most
    ONE nonzero product (the one-hot hit or the bias, never both), so a
    bf16 accumulator stays exact up to input rounding.
    """
    soft_bits = jnp.asarray(soft_bits)
    b = soft_bits.shape[0]
    n_mother, runs = _block_runs(profile)
    acc_dt = soft_bits.dtype if soft_bits.dtype == jnp.bfloat16 \
        else jnp.float32
    outs = []
    off = 0
    moff = 0  # mother-position offset of the current run
    for n_blocks, kpb, one_hot in runs:
        seg = jax.lax.slice_in_dim(soft_bits, off, off + n_blocks * kpb,
                                   axis=-1).reshape(b, n_blocks, kpb)
        table = np.broadcast_to(one_hot.T[None],
                                (n_blocks,) + one_hot.T.shape)
        if moff + n_blocks * 128 > n_mother:
            # run overlaps the pad tail: affine flush-bias column
            flush = (np.arange(moff, moff + n_blocks * 128) >= n_mother
                     ).astype(np.float32).reshape(n_blocks, 128, 1)
            table = np.concatenate([table, flush], axis=2)
            seg = jnp.concatenate(
                [seg, jnp.ones((b, n_blocks, 1), seg.dtype)], axis=2)
        lhs = jnp.asarray(table, dtype=soft_bits.dtype)
        out = jax.lax.dot_general(
            lhs, seg,
            dimension_numbers=(((2,), (2,)), ((0,), (1,))),
            precision=jax.lax.Precision.HIGHEST,
            preferred_element_type=acc_dt)  # (n_blocks, 128, B)
        outs.append(out.astype(soft_bits.dtype))
        off += n_blocks * kpb
        moff += n_blocks * 128
    m = jnp.concatenate(outs, axis=0) if len(outs) > 1 else outs[0]
    nb = m.shape[0]
    return m.reshape(nb * 128 // 8, 8, b)


def depuncture_np(soft_bits: np.ndarray, profile: PunctureProfile) -> np.ndarray:
    idx = _keep_indices(profile)
    n_mother = profile.mask().shape[0]
    out = np.zeros(soft_bits.shape[:-1] + (n_mother,), dtype=np.float32)
    out[..., idx] = soft_bits
    return out
