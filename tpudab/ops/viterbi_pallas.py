"""Pallas Viterbi decoder (ACS + traceback) for the K=7 r=1/4 DAB code,
compiled through Triton for NVIDIA GPUs.

Why a kernel: the XLA decoder (tpudab.ops.viterbi) is a lax.scan whose
every step is a few small dependent operations — at radix 4 about 866
launches of a thin matmul, a take, an argmax and a bit-pack per MSC
codeword, plus a reverse-scan traceback of the same length. On a GPU that
is latency-bound. Here the whole trellis runs inside one program:

- One THREAD owns one codeword, and its 64 path metrics live in that
  thread's registers for the whole trellis: the state axis is 64 separate
  (BT,) arrays, so the radix-2 butterfly's predecessor "gather" is a static
  renaming of Python values — no shuffle, no shared memory, no
  device-memory round trip per step. A program is one warp (BT = 32
  codewords).
- Input is the (T2, 8, B) layout tpudab.fec.depuncture.depuncture_t emits
  (two trellis steps of 4 mother soft bits per row, batch minor), so the
  32 threads of a warp read 32 consecutive codewords: coalesced.
- Decisions leave the SM as two u32 words (64 bits) per trellis step,
  (T, 2, B) u32, batch minor; the traceback kernel reads them back in
  reverse and writes MSB-first packed bytes, 8 trellis steps per byte.

Exactness: per trellis step, decision = cand1 > cand0 (ties keep the
first predecessor, s' >> 1) — the rule of viterbi_decode_np; path metrics
are rebased on state 0 once per 8 trellis steps, which subtracts a
per-codeword constant and leaves decisions unchanged. With soft input on
a grid where every branch-metric sum is exact in float32, the decoded bits
equal tpudab.ops.viterbi.viterbi_decode's.

Soft-bit convention as in tpudab.ops.viterbi; codewords padded with the
virtual-flush pattern (+1 on all four mother bits) batch freely.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from tpudab.fec.conv import N_STATES, OUTPUT_SIGNS
from tpudab.utils.bits import jnp_pack_bits, jnp_unpack_bits
from tpudab.utils.runtime import platform

_NEG = -1e9
_BT = 32      # codewords per program: one per thread of one warp
_GROUP = 4    # (T2, 8, B) rows per loop iteration = 8 trellis steps = 1 byte
_PARAMS = pl_triton.CompilerParams(num_warps=1, num_stages=1)


def _branch_terms(reg7: int):
    """Transition reg7's branch metric sum_c sign_c * soft_c written as
    sign * base[idx], base = ((s0 +- s1) +- (s2 +- s3)): returns
    (idx, sign) with idx in 0..7 (which of the eight bases)."""
    sg = OUTPUT_SIGNS[reg7]
    x = 0 if sg[0] == sg[1] else 1          # s0+s1 or s0-s1
    y = 0 if sg[2] == sg[3] else 1          # s2+s3 or s2-s3
    same = (sg[0] * sg[2]) > 0              # relative sign of the halves
    return 4 * x + 2 * y + (0 if same else 1), float(sg[0])


_BM = tuple(_branch_terms(r) for r in range(2 * N_STATES))


def _acs(pm, s4):
    """One trellis step for all 64 states.

    pm: tuple of 64 (BT,) f32 path metrics; s4: 4 (BT,) f32 mother soft
    bits. Returns (new pm, low decision word, high decision word): bit s of
    word s // 32 is 1 where state s took its second predecessor."""
    a01, b01 = s4[0] + s4[1], s4[0] - s4[1]
    a23, b23 = s4[2] + s4[3], s4[2] - s4[3]
    base = (a01 + a23, a01 - a23, a01 + b23, a01 - b23,
            b01 + a23, b01 - a23, b01 + b23, b01 - b23)

    def cand(p, reg7):
        idx, sign = _BM[reg7]
        return p + base[idx] if sign > 0 else p - base[idx]

    new, words = [], []
    for half in range(2):
        w = None
        for s in range(32 * half, 32 * half + 32):
            c0 = cand(pm[s >> 1], s)
            c1 = cand(pm[(s >> 1) | 32], s | 64)
            d = c1 > c0
            new.append(jnp.where(d, c1, c0))
            bit = jnp.where(d, jnp.uint32(1 << (s & 31)), jnp.uint32(0))
            w = bit if w is None else w | bit
        words.append(w)
    return tuple(new), words[0], words[1]


def _fwd_kernel(soft_ref, dec_ref):
    """soft (T2, 8, BT) -> decisions (2*T2, 2, BT) u32; T2 % _GROUP == 0."""
    n_iter = soft_ref.shape[0] // _GROUP
    zero = jnp.zeros((_BT,), jnp.float32)
    pm0 = (zero,) + (zero + _NEG,) * (N_STATES - 1)

    def body(i, pm):
        for r in range(_GROUP):
            row = _GROUP * i + r
            soft = [soft_ref[row, c, :].astype(jnp.float32) for c in range(8)]
            for h in range(2):
                pm, lo, hi = _acs(pm, soft[4 * h:4 * h + 4])
                dec_ref[2 * row + h, 0, :] = lo
                dec_ref[2 * row + h, 1, :] = hi
        return tuple(p - pm[0] for p in pm)

    lax.fori_loop(0, n_iter, body, pm0)


def _tb_kernel(dec_ref, out_ref):
    """decisions (T, 2, BT) u32 -> packed bytes (T // 8, BT) u8, MSB first.
    Starts from state 0 (terminated codewords) at the last step."""
    n_bytes = out_ref.shape[0]

    def body(i, state):
        n = n_bytes - 1 - i
        # the 16 words of this byte's steps do not depend on the state:
        # issue all loads before the dependent chain
        lo = [dec_ref[8 * n + q, 0, :] for q in range(8)]
        hi = [dec_ref[8 * n + q, 1, :] for q in range(8)]
        acc = jnp.zeros((_BT,), jnp.uint32)
        for q in range(7, -1, -1):
            # state after step 8n+q; its low bit is that step's input bit
            acc = acc | ((state & 1) << (7 - q))
            word = jnp.where(state < 32, lo[q], hi[q])
            d = (word >> (state & 31)) & 1
            state = (state >> 1) | (d << 5)
        out_ref[n, :] = acc.astype(jnp.uint8)
        return state

    lax.fori_loop(0, n_bytes, body, jnp.zeros((_BT,), jnp.uint32))


def _pad_to(x, m, axis, value):
    r = x.shape[axis] % m
    if r == 0:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, m - r)
    return jnp.pad(x, pad, constant_values=value)


def _decode_t(soft_t, interpret: bool):
    """(T2, 8, B) soft -> (B, ceil(T2/4)) packed bytes of every trellis
    step (the flush tail included)."""
    b0 = soft_t.shape[2]
    if soft_t.dtype != jnp.bfloat16:
        soft_t = soft_t.astype(jnp.float32)
    # whole bytes: flush-pad the trellis (exact for terminated codewords);
    # whole programs: erasure-pad the batch (sliced away below)
    soft_t = _pad_to(soft_t, _GROUP, axis=0, value=1.0)
    soft_t = _pad_to(soft_t, _BT, axis=2, value=0.0)
    t2, _, b = soft_t.shape
    grid = (b // _BT,)
    decs = pl.pallas_call(
        _fwd_kernel,
        grid=grid,
        in_specs=[pl.BlockSpec((t2, 8, _BT), lambda j: (0, 0, j))],
        out_specs=pl.BlockSpec((2 * t2, 2, _BT), lambda j: (0, 0, j)),
        out_shape=jax.ShapeDtypeStruct((2 * t2, 2, b), jnp.uint32),
        compiler_params=_PARAMS,
        backend="triton",
        interpret=interpret,
        name="viterbi_acs",
    )(soft_t)
    packed = pl.pallas_call(
        _tb_kernel,
        grid=grid,
        in_specs=[pl.BlockSpec((2 * t2, 2, _BT), lambda j: (0, 0, j))],
        out_specs=pl.BlockSpec((t2 // _GROUP, _BT), lambda j: (0, j)),
        out_shape=jax.ShapeDtypeStruct((t2 // _GROUP, b), jnp.uint8),
        compiler_params=_PARAMS,
        backend="triton",
        interpret=interpret,
        name="viterbi_traceback",
    )(decs)
    return packed.T[:b0]


def _to_t_layout(mother_soft):
    """(B, T, 4) -> (T2, 8, B): flush-pad T to even, two steps per row."""
    soft = _pad_to(mother_soft, 2, axis=1, value=1.0)
    b, t, _ = soft.shape
    return jnp.moveaxis(soft.reshape(b, t // 2, 8), 0, 2)


@functools.partial(jax.jit, static_argnames=("n_data_bits", "interpret"))
def viterbi_decode_pallas_bytes_t(soft_t, n_data_bits: int,
                                  interpret: bool = False):
    """Viterbi decode from the transposed soft layout (T2, 8, B) — what
    tpudab.fec.depuncture.depuncture_t emits, flush tail included — to
    MSB-first packed bytes (B, n_data_bits // 8)."""
    assert n_data_bits % 8 == 0 and soft_t.shape[1] == 8
    return _decode_t(soft_t, interpret)[:, :n_data_bits // 8]


@functools.partial(jax.jit, static_argnames=("n_data_bits", "interpret"))
def viterbi_decode_pallas_bytes(mother_soft, n_data_bits: int,
                                interpret: bool = False):
    """(B, T, 4) mother soft -> MSB-first packed bytes (B, n_data_bits//8)."""
    assert n_data_bits % 8 == 0
    return _decode_t(_to_t_layout(mother_soft),
                     interpret)[:, :n_data_bits // 8]


@functools.partial(jax.jit, static_argnames=("n_data_bits", "interpret"))
def viterbi_decode_pallas(mother_soft, n_data_bits: int,
                          interpret: bool = False):
    """Drop-in equivalent of tpudab.ops.viterbi.viterbi_decode:
    (B, T, 4) -> (B, n_data_bits) uint8 bits."""
    by = _decode_t(_to_t_layout(mother_soft), interpret)
    return jnp_unpack_bits(by)[:, :n_data_bits]


def use_kernel(plat: str) -> bool:
    """The one backend rule: the Pallas kernel on "gpu", the XLA scan
    decoder on "cpu" (tests, virtual meshes); any other platform is an
    error, not a guess."""
    if plat == "gpu":
        return True
    if plat == "cpu":
        return False
    raise ValueError(f"no Viterbi decoder for JAX platform {plat!r}")


def viterbi_decode_bytes_best_t(soft_t, n_data_bits: int):
    """Backend-dispatching transposed-input decode to packed bytes. On the
    CPU the input is relaid to (B, T, 4) and decoded by the XLA scan
    (bit-identical for terminated codewords)."""
    if use_kernel(platform()):
        return viterbi_decode_pallas_bytes_t(soft_t, n_data_bits)
    from tpudab.ops.viterbi import viterbi_decode
    t2, _, b = soft_t.shape
    soft = jnp.moveaxis(soft_t, 2, 0).reshape(b, t2 * 2, 4)
    soft = soft[:, : n_data_bits + 6]
    return jnp_pack_bits(viterbi_decode(soft.astype(jnp.float32),
                                        n_data_bits))


def viterbi_decode_best(mother_soft, n_data_bits: int):
    """Backend-dispatching Viterbi decode to bits (B, n_data_bits)."""
    if use_kernel(platform()):
        return viterbi_decode_pallas(mother_soft, n_data_bits)
    from tpudab.ops.viterbi import viterbi_decode
    return viterbi_decode(mother_soft, n_data_bits)


def viterbi_decode_bytes_best(mother_soft, n_data_bits: int):
    """Backend-dispatching Viterbi decode to MSB-first packed bytes
    (n_data_bits % 8 == 0)."""
    if use_kernel(platform()):
        return viterbi_decode_pallas_bytes(mother_soft, n_data_bits)
    from tpudab.ops.viterbi import viterbi_decode
    return jnp_pack_bits(viterbi_decode(mother_soft, n_data_bits))
