"""FEC layer: conv code, Viterbi vs brute force, puncturing round trip, PRBS,
CRC, firecode, Reed-Solomon."""

import itertools

import numpy as np
import pytest

from tpudab.fec.conv import conv_encode, OUTPUT_BITS, TAP_MASKS
from tpudab.fec.depuncture import puncture, depuncture_np
from tpudab.fec.prbs import prbs_bits, descramble_bits, descramble_bytes
from tpudab.fec.crc import crc16_ccitt, crc16_append, check_fib_crc, firecode_compute, firecode_check
from tpudab.fec import rs
from tpudab.constants.puncture import FIC_PROFILE, eep_profile
from tpudab.ops.viterbi import viterbi_decode, viterbi_decode_np, pad_mother_soft
from tpudab.utils.bits import bits_to_soft


def _ml_bruteforce(soft, n_bits):
    """Max-likelihood decode by exhaustive search (tiny n_bits only)."""
    best, best_m = None, -np.inf
    for cand in itertools.product([0, 1], repeat=n_bits):
        enc = conv_encode(np.array(cand, dtype=np.uint8))
        m = float(np.sum(soft * (1.0 - 2.0 * enc)))
        if m > best_m:
            best_m, best = m, np.array(cand, dtype=np.uint8)
    return best


def test_conv_encode_known_zero_and_impulse():
    assert np.all(conv_encode(np.zeros(8, dtype=np.uint8)) == 0)
    # single 1 produces the generator impulse response
    out = conv_encode(np.array([1], dtype=np.uint8)).reshape(-1, 4)
    # step t: reg7 = 1<<t for t=0..6
    expect = OUTPUT_BITS[[1, 2, 4, 8, 16, 32, 64]]
    np.testing.assert_array_equal(out, expect)


def test_tap_masks_match_standard_polys():
    # G1=1+x^2+x^3+x^5+x^6, G2=1+x+x^2+x^3+x^6, G3=1+x+x^4+x^6, G4=G1
    def taps(mask):
        return {k for k in range(7) if (mask >> k) & 1}
    assert taps(TAP_MASKS[0]) == {0, 2, 3, 5, 6}
    assert taps(TAP_MASKS[1]) == {0, 1, 2, 3, 6}
    assert taps(TAP_MASKS[2]) == {0, 1, 4, 6}
    assert taps(TAP_MASKS[3]) == taps(TAP_MASKS[0])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_matches_bruteforce_ml(seed):
    rng = np.random.default_rng(seed)
    n = 8
    bits = rng.integers(0, 2, n).astype(np.uint8)
    enc = conv_encode(bits)
    soft = bits_to_soft(enc) + rng.normal(0, 0.8, enc.shape).astype(np.float32)
    got = viterbi_decode_np(soft.reshape(-1, 4), n)
    want = _ml_bruteforce(soft, n)
    np.testing.assert_array_equal(got, want)


def test_viterbi_jax_matches_numpy():
    rng = np.random.default_rng(3)
    b, n = 5, 120
    bits = rng.integers(0, 2, (b, n)).astype(np.uint8)
    enc = np.stack([conv_encode(row) for row in bits])
    soft = bits_to_soft(enc) + rng.normal(0, 0.7, enc.shape).astype(np.float32)
    soft = soft.reshape(b, n + 6, 4)
    got_np = viterbi_decode_np(soft, n)
    got_jax = np.asarray(viterbi_decode(soft, n))
    np.testing.assert_array_equal(got_np, got_jax)
    np.testing.assert_array_equal(got_np, bits)  # low noise: exact recovery


def test_viterbi_noiseless_long():
    rng = np.random.default_rng(4)
    n = 768
    bits = rng.integers(0, 2, n).astype(np.uint8)
    soft = bits_to_soft(conv_encode(bits)).reshape(1, n + 6, 4)
    np.testing.assert_array_equal(np.asarray(viterbi_decode(soft, n))[0], bits)


def test_virtual_flush_padding_is_exact():
    rng = np.random.default_rng(5)
    n = 32
    bits = rng.integers(0, 2, n).astype(np.uint8)
    enc = conv_encode(bits)
    soft = bits_to_soft(enc) + rng.normal(0, 1.0, enc.shape).astype(np.float32)
    soft = soft.reshape(1, n + 6, 4)
    unpadded = viterbi_decode_np(soft, n)
    padded = viterbi_decode_np(pad_mother_soft(soft, n + 6 + 40), n)
    np.testing.assert_array_equal(unpadded, padded)


@pytest.mark.parametrize("profile", [
    FIC_PROFILE,
    eep_profile(48, 1, 0),   # EEP 1-A
    eep_profile(32, 2, 0),   # EEP 2-A
    eep_profile(8, 2, 0),    # EEP 2-A n=1 special case
    eep_profile(36, 3, 0),   # EEP 3-A
    eep_profile(16, 4, 0),   # EEP 4-A
    eep_profile(54, 3, 1),   # EEP 3-B
])
def test_puncture_viterbi_roundtrip(profile):
    rng = np.random.default_rng(6)
    n = profile.data_bits
    bits = rng.integers(0, 2, n).astype(np.uint8)
    enc = conv_encode(bits)
    punctured = puncture(enc, profile)
    assert punctured.shape[0] == profile.punctured_bits - 12 + 12
    soft = bits_to_soft(punctured) + rng.normal(0, 0.4, punctured.shape).astype(np.float32)
    mother = depuncture_np(soft, profile).reshape(1, n + 6, 4)
    got = np.asarray(viterbi_decode(mother, n))[0]
    np.testing.assert_array_equal(got, bits)


def test_prbs_first_bits():
    # register all-ones: outputs stay 0 until the fed-back zeros reach the
    # x^5 tap (5 shifts), then 1s: first byte is 0b00000111 = 0x07
    bits = prbs_bits(16)
    np.testing.assert_array_equal(bits[:8], [0, 0, 0, 0, 0, 1, 1, 1])
    # period is 2^9 - 1
    long = prbs_bits(2 * 511)
    np.testing.assert_array_equal(long[:511], long[511:1022])


def test_descramble_involution():
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, 768).astype(np.uint8)
    assert np.array_equal(descramble_bits(descramble_bits(bits)), bits)
    data = rng.integers(0, 256, 96).astype(np.uint8)
    assert np.array_equal(descramble_bytes(descramble_bytes(data)), data)


def test_prbs_bytes_match_bits():
    from tpudab.fec.prbs import prbs_bytes
    np.testing.assert_array_equal(
        np.unpackbits(prbs_bytes(12)), prbs_bits(96))


def test_crc16_known_vector():
    # CRC-16/CCITT-FALSE of b"123456789" is 0x29B1; DAB transmits complement
    data = np.frombuffer(b"123456789", dtype=np.uint8)
    assert crc16_ccitt(data) == (~0x29B1) & 0xFFFF


def test_fib_crc_roundtrip():
    rng = np.random.default_rng(8)
    fib = crc16_append(rng.integers(0, 256, 30).astype(np.uint8))
    assert fib.shape[0] == 32
    assert check_fib_crc(fib[None])[0]
    bad = fib.copy()
    bad[3] ^= 0x40
    assert not check_fib_crc(bad[None])[0]


def test_firecode_roundtrip():
    rng = np.random.default_rng(9)
    head = rng.integers(0, 256, 16).astype(np.uint8)
    fc = int(firecode_compute(head[2:11]))
    head[0], head[1] = fc >> 8, fc & 0xFF
    assert firecode_check(head[None])[0]
    head[5] ^= 1
    assert not firecode_check(head[None])[0]


def test_rs_encode_decode_clean():
    rng = np.random.default_rng(10)
    msg = rng.integers(0, 256, (4, rs.K)).astype(np.uint8)
    cw = rs.rs_encode(msg)
    out, nerr, failed = rs.rs_decode(cw)
    np.testing.assert_array_equal(out, cw)
    np.testing.assert_array_equal(nerr, 0)
    assert not failed.any()


@pytest.mark.parametrize("n_errors", [1, 2, 3, 4, 5])
def test_rs_corrects_up_to_t(n_errors):
    rng = np.random.default_rng(11 + n_errors)
    msg = rng.integers(0, 256, (8, rs.K)).astype(np.uint8)
    cw = rs.rs_encode(msg)
    corrupted = cw.copy()
    for row in corrupted:
        pos = rng.choice(rs.N, n_errors, replace=False)
        row[pos] ^= rng.integers(1, 256, n_errors).astype(np.uint8)
    out, nerr, failed = rs.rs_decode(corrupted)
    assert not failed.any()
    np.testing.assert_array_equal(out, cw)
    np.testing.assert_array_equal(nerr, n_errors)


def test_rs_detects_failure_beyond_t():
    rng = np.random.default_rng(20)
    msg = rng.integers(0, 256, (16, rs.K)).astype(np.uint8)
    cw = rs.rs_encode(msg)
    corrupted = cw.copy()
    for row in corrupted:
        pos = rng.choice(rs.N, 9, replace=False)
        row[pos] ^= rng.integers(1, 256, 9).astype(np.uint8)
    out, nerr, failed = rs.rs_decode(corrupted)
    # with 9 random errors, miscorrection is possible but failure should be
    # flagged in the overwhelming majority of cases
    assert failed.sum() >= 14


def test_viterbi_radix_compaction_matches_oracle():
    """radix-2^k trellis compaction (k steps per scan iteration) is exact
    for every k, including lengths not divisible by k (virtual-flush pad)."""
    rng = np.random.default_rng(31)
    b, n = 6, 201
    bits = rng.integers(0, 2, (b, n)).astype(np.uint8)
    enc = np.stack([conv_encode(r) for r in bits])
    soft = bits_to_soft(enc) + rng.normal(0, 0.5, enc.shape).astype(np.float32)
    soft = soft.reshape(b, n + 6, 4)
    want = viterbi_decode_np(soft, n)
    for k in (1, 2, 3, 4, 6):
        got = np.asarray(viterbi_decode(soft, n, radix=k))
        np.testing.assert_array_equal(got, want, err_msg=f"radix={k}")
