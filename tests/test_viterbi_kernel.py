"""The GPU Viterbi kernel (tpudab.ops.viterbi_pallas): interpret-mode parity
with the XLA scan decoder, the wrapper's padding and layouts, the backend
rule, and the same parity compiled for the card (marked gpu)."""

import numpy as np
import pytest

import jax.numpy as jnp

from tpudab.fec.conv import conv_encode
from tpudab.ops import viterbi_pallas as vp
from tpudab.ops.viterbi import viterbi_decode, viterbi_decode_np
from tpudab.utils.bits import bits_to_soft, pack_bits

# 37 codewords: not a multiple of the 32-codeword program; 104 data bits:
# T = 110 trellis steps = 55 rows, flush-padded to whole bytes (56 rows).
_B, _N = 37, 104


def _quantized_soft(b, n_bits, seed, noise=0.9):
    """Coded noisy soft bits on a 1/8 grid within +-4, (B, n_bits + 6, 4):
    every branch-metric and path-metric sum is exact in float32 (and the
    values are exact in bfloat16), so decoders that differ only in
    summation order or rebase schedule must agree bit for bit. Exact ties
    do occur on a grid; the reference is the scan at radix 1, whose tie
    rule (first predecessor) is the kernel's and viterbi_decode_np's."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
    enc = np.stack([conv_encode(r) for r in bits])
    soft = bits_to_soft(enc) + rng.normal(0, noise, enc.shape)
    soft = np.clip(np.round(soft * 8) / 8, -4, 4).astype(np.float32)
    return soft.reshape(b, n_bits + 6, 4)


def _t_layout(soft):
    """(B, T, 4) -> (T/2, 8, B), T even (the depuncture_t layout)."""
    b, t, _ = soft.shape
    return np.moveaxis(soft.reshape(b, t // 2, 8), 0, 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("entry", ["bits", "bytes", "bytes_t"])
def test_kernel_matches_scan_interpret(entry, dtype):
    soft = _quantized_soft(_B, _N, seed=5)
    ref = np.asarray(viterbi_decode(jnp.asarray(soft), _N, radix=1))
    np.testing.assert_array_equal(ref, viterbi_decode_np(soft, _N))
    x = jnp.asarray(soft).astype(dtype)
    if entry == "bits":
        got = vp.viterbi_decode_pallas(x, _N, interpret=True)
        want = ref
    elif entry == "bytes":
        got = vp.viterbi_decode_pallas_bytes(x, _N, interpret=True)
        want = pack_bits(ref)
    else:
        got = vp.viterbi_decode_pallas_bytes_t(
            jnp.asarray(_t_layout(soft)).astype(dtype), _N, interpret=True)
        want = pack_bits(ref)
    assert got.shape == want.shape and got.dtype == jnp.uint8
    np.testing.assert_array_equal(np.asarray(got), want)


@pytest.mark.parametrize("plat,expect", [("cpu", False), ("gpu", True),
                                         ("metal", None), ("rocm", None)])
def test_backend_rule(plat, expect):
    if expect is None:
        with pytest.raises(ValueError, match=plat):
            vp.use_kernel(plat)
    else:
        assert vp.use_kernel(plat) is expect


@pytest.mark.parametrize("dispatcher,kernel", [
    ("viterbi_decode_best", "viterbi_decode_pallas"),
    ("viterbi_decode_bytes_best", "viterbi_decode_pallas_bytes"),
    ("viterbi_decode_bytes_best_t", "viterbi_decode_pallas_bytes_t"),
])
def test_dispatchers_pick_kernel_on_gpu(monkeypatch, dispatcher, kernel):
    calls = []
    monkeypatch.setattr(vp, "platform", lambda: "gpu")
    monkeypatch.setattr(vp, kernel, lambda *a, **k: calls.append(a) or "k")
    assert getattr(vp, dispatcher)(jnp.zeros((2, 14, 4)), 8) == "k"
    assert len(calls) == 1


@pytest.mark.gpu
def test_kernel_matches_scan_on_card(gpu):
    """Compiled (not interpreted) kernel == scan decoder, all entries."""
    soft = _quantized_soft(300, 256, seed=9)
    ref = np.asarray(viterbi_decode(jnp.asarray(soft), 256, radix=1))
    for dtype in ("float32", "bfloat16"):
        x = jnp.asarray(soft).astype(dtype)
        np.testing.assert_array_equal(
            np.asarray(vp.viterbi_decode_pallas(x, 256)), ref)
        np.testing.assert_array_equal(
            np.asarray(vp.viterbi_decode_pallas_bytes(x, 256)),
            pack_bits(ref))
        np.testing.assert_array_equal(
            np.asarray(vp.viterbi_decode_pallas_bytes_t(
                jnp.asarray(_t_layout(soft)).astype(dtype), 256)),
            pack_bits(ref))
