"""Viterbi decoder batching tricks (codeword merging)."""

import numpy as np
def test_merged_codewords_separator_flush():
    """Chaining terminated codewords with 6 large-amplitude virtual-flush
    separator steps decodes bit-identically to independent decodes (the
    ReceiveStep merges the FIC codewords into the MSC Viterbi call this way)."""
    import jax.numpy as jnp
    from tpudab.ops.viterbi import viterbi_decode
    from tpudab.fec.conv import conv_encode
    rng = np.random.default_rng(42)
    n_bits, n_cw = 100, 6
    cws = []
    softs = []
    for i in range(n_cw):
        bits = rng.integers(0, 2, n_bits).astype(np.uint8)
        coded = conv_encode(bits).reshape(-1, 4)  # (n_bits+6, 4) hard bits
        soft = (1.0 - 2.0 * coded.astype(np.float32))
        soft += 0.6 * rng.standard_normal(soft.shape).astype(np.float32)
        cws.append(bits)
        softs.append(soft)
    # independent decodes
    sep_t = n_bits + 6
    batch = np.stack(softs)  # (n_cw, sep_t, 4)
    indep = np.asarray(viterbi_decode(jnp.asarray(batch), n_bits))
    # merged row: cw0, 6xflush(A), cw1, ...
    a = 100.0
    parts = []
    for i, soft in enumerate(softs):
        parts.append(soft)
        if i < n_cw - 1:
            parts.append(np.full((6, 4), a, np.float32))
    merged = np.concatenate(parts, axis=0)[None]  # (1, T, 4)
    dec = np.asarray(viterbi_decode(jnp.asarray(merged), merged.shape[1]))
    stride = sep_t + 6
    for i in range(n_cw):
        np.testing.assert_array_equal(
            dec[0, i * stride: i * stride + n_bits], indep[i],
            err_msg=f"codeword {i} mismatch")


def _coded_noisy(profile, b, noise, seed, dtype):
    """Random payloads -> conv encode -> puncture -> AWGN soft bits."""
    import jax.numpy as jnp
    from tpudab.fec.conv import conv_encode
    from tpudab.fec.depuncture import puncture
    from tpudab.utils.bits import bits_to_soft
    rng = np.random.default_rng(seed)
    n_bits = profile.data_bits
    bits = rng.integers(0, 2, (b, n_bits)).astype(np.uint8)
    enc = np.stack([conv_encode(r) for r in bits])
    soft = bits_to_soft(puncture(enc, profile)).astype(np.float32)
    soft += noise * rng.standard_normal(soft.shape).astype(np.float32)
    out = jnp.asarray(soft)
    return out.astype(jnp.bfloat16) if dtype == "bfloat16" else out


def test_transposed_chain_matches_production_f32_and_bf16():
    """The production chain viterbi_decode_pallas_bytes_t(depuncture_t(x))
    (the GPU kernel, interpret mode) must be byte-identical to the
    exact-termination XLA scan decode on coded NOISY data at low SNR — the
    regime where a plain zero pad tail lets traceback start from the argmax
    end state instead of the terminated state-0 path.
    depuncture_t's +1.0 flush-bias tail is what guarantees this."""
    import jax.numpy as jnp
    from tpudab.constants.puncture import eep_profile, FIC_PROFILE
    from tpudab.fec.depuncture import depuncture, depuncture_t
    from tpudab.ops.viterbi import viterbi_decode
    from tpudab.ops.viterbi_pallas import viterbi_decode_pallas_bytes_t
    from tpudab.utils.bits import jnp_pack_bits
    for profile in (eep_profile(8, 2, 0), FIC_PROFILE):
        n_bits = profile.data_bits
        for dtype in ("float32", "bfloat16"):
            # noise 1.2 ~ raw-channel BER where trailing-bit divergence
            # between zero-pad and termination shows up readily
            soft = _coded_noisy(profile, b=8, noise=1.2, seed=3, dtype=dtype)
            got = np.asarray(viterbi_decode_pallas_bytes_t(
                depuncture_t(soft, profile), n_bits, interpret=True))
            mother = depuncture(soft, profile)
            ref_exact = np.asarray(jnp_pack_bits(viterbi_decode(
                mother.reshape(-1, n_bits + 6, 4).astype(jnp.float32),
                n_bits)))
            np.testing.assert_array_equal(
                got, ref_exact,
                err_msg=f"{profile} {dtype}: transposed != exact-termination")


def test_depuncture_t_layout_and_flush_tail():
    """depuncture_t emits the (T2p, 8, B) transpose of depuncture's output
    with +1.0 at every mother position past the real tail."""
    import jax.numpy as jnp
    from tpudab.constants.puncture import eep_profile
    from tpudab.fec.depuncture import depuncture, depuncture_t
    profile = eep_profile(8, 2, 0)
    rng = np.random.default_rng(11)
    n_punct = int(profile.mask().sum())
    x = jnp.asarray(rng.standard_normal((3, n_punct)).astype(np.float32))
    t = np.asarray(depuncture_t(x, profile))          # (T2p, 8, B)
    flat = np.moveaxis(t, 2, 0).reshape(3, -1)        # (B, T2p*8)
    n_mother = profile.mask().shape[0]
    ref = np.asarray(depuncture(x, profile))
    np.testing.assert_allclose(flat[:, :n_mother], ref, rtol=0, atol=0)
    np.testing.assert_array_equal(flat[:, n_mother:],
                                  np.ones_like(flat[:, n_mother:]))
