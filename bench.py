"""Benchmark: full-ensemble DAB receive throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
Exits non-zero, after printing the error, on any failure — including when
JAX finds no GPU (a CPU number is never reported as a device number).

Metric: real-time factor per card — how many simultaneous 2.048 MS/s DAB
ensembles one card can demodulate AND fully channel-decode (OFDM demod +
FIC Viterbi + all-subchannel MSC deinterleave/depuncture/Viterbi, 6 x 144 kbps
DAB+ services filling 648 of 864 CU). vs_baseline is against the reference's
real-time CPU pipeline (1.0 = real time, its design throughput —
SURVEY.md sec 6: the reference has no published numbers; real-time sustain is
its stated operating point).

Also reported: Viterbi decoder throughput (Mbit/s of decoded payload) at the
step's MSC batch, ms per step, and the card's name and power limit.
"""

import json
import os
import sys
import time
import traceback

import numpy as np


def _synth_bench_frames(subchannels, n_frames: int):
    """Synthesize a REAL DAB ensemble matching the bench subchannel layout
    (6 x 108 CU EEP 3-A) with a known payload in subchannel 1, so the bench
    measures — and asserts — a correct decode, not noise-shaped compute."""
    from tpudab.synth import (EnsembleSpec, ServiceSpec, SubchannelSpec,
                              EnsembleSynthesizer, ASCTY_DAB_PLUS)
    from tpudab.synth.modulator import modulate_frame_bits

    spec = EnsembleSpec(
        ensemble_id=0xBE9C, label="Bench Ensemble",
        services=[ServiceSpec(0xC200 + c.subch_id, f"Bench {c.subch_id}",
                              [(0, ASCTY_DAB_PLUS, c.subch_id)])
                  for c in subchannels],
        subchannels=[SubchannelSpec(c.subch_id, start_cu=c.start_cu,
                                    size_cu=c.size_cu, protection=("eep", 3, 0))
                     for c in subchannels])
    synth = EnsembleSynthesizer(spec, seed=1)
    rng = np.random.default_rng(2)
    n_logical = n_frames * 4
    payload_bytes = subchannels[0].data_bits // 8
    data = rng.integers(0, 256, (n_logical, payload_bytes)).astype(np.uint8)
    synth.payload_fn[subchannels[0].subch_id] = lambda m: data[m].tobytes()
    frames = np.stack([modulate_frame_bits(synth.frame_bits(i))
                       for i in range(n_frames)])
    return frames, data


def main():
    import jax
    import jax.numpy as jnp

    from __graft_entry__ import _bench_subchannels
    from tpudab.models.step import ReceiveStep
    from tpudab.ops.viterbi_pallas import viterbi_decode_bytes_best_t
    from tpudab.fec.crc import check_fib_crc
    from tpudab.constants.ofdm_params import SAMPLING_RATE
    from tpudab.utils.runtime import (card_name_and_power_limit,
                                      enable_compile_cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"bench needs a GPU; JAX platform is "
                           f"{dev.platform!r}")
    enable_compile_cache()
    n_frames = int(os.environ.get("TPUDAB_BENCH_FRAMES", "16"))
    n_ens = int(os.environ.get("TPUDAB_BENCH_ENSEMBLES", "32"))

    subch = _bench_subchannels()
    step = ReceiveStep(mode=1, subchannels=subch, n_ensembles=n_ens)
    carry = step.init_carry()

    # real synthesized signal, same frames for every ensemble slot
    frames, payload = _synth_bench_frames(subch, n_frames)
    tiled = step.tile_frames(frames.reshape(n_frames, -1))
    # bf16 IQ on the hot path: SDR front-ends deliver 8-12 bit ADC samples;
    # bf16's 8-bit significand represents 8-bit codes exactly (12-bit codes
    # round by ~2^-9 relative, ~30 dB below channel noise) — halves the
    # host-to-device transfer and the demod's input stream.
    import ml_dtypes
    re = np.ascontiguousarray(tiled.real, dtype=ml_dtypes.bfloat16)
    im = np.ascontiguousarray(tiled.imag, dtype=ml_dtypes.bfloat16)
    if n_ens > 1:
        re = np.ascontiguousarray(np.broadcast_to(re, (n_ens,) + re.shape))
        im = np.ascontiguousarray(np.broadcast_to(im, (n_ens,) + im.shape))
    freq = jnp.float32(0.0)
    carry = jax.device_put(carry, dev)
    frames_re = jax.device_put(re, dev)
    frames_im = jax.device_put(im, dev)

    # ---- correctness gate: FIB CRCs + known payload decode ----
    _, out0 = step(carry, frames_re, frames_im, freq)
    fic = np.asarray(out0["fic_bytes"])              # ([E,] F*4, 96)
    ok = check_fib_crc(fic.reshape(-1, 3, 32))
    if ok.mean() != 1.0:
        raise AssertionError(f"FIB CRC pass rate {ok.mean():.3f} != 1.0")
    got = np.asarray(out0["subch"][subch[0].subch_id])  # ([E,] C, bytes)
    if n_ens > 1:
        got = got[0]
    # deinterleaver ramp: logical frames 15.. are fully formed in step 1
    if got.shape[0] > 15:
        np.testing.assert_array_equal(got[15:], payload[:got.shape[0] - 15])

    # warm-up, then calibrate the iteration count on one synced step
    carry, out = jax.block_until_ready(step(carry, frames_re, frames_im, freq))
    t0 = time.perf_counter()
    carry, out = jax.block_until_ready(step(carry, frames_re, frames_im, freq))
    t_one = time.perf_counter() - t0
    iters = max(3, min(20, int(5.0 / max(t_one, 1e-3))))

    t0 = time.perf_counter()
    for _ in range(iters):
        carry, out = step(carry, frames_re, frames_im, freq)
    jax.block_until_ready((carry, out))
    dt = time.perf_counter() - t0
    samples = iters * n_ens * n_frames * step.params.nb_frame_length
    samples_per_s = samples / dt
    realtime_factor = samples_per_s / SAMPLING_RATE

    # Viterbi at the step's MSC batch (6 subch x n_ens x 4*n_frames CIFs),
    # through the production entry (transposed bf16 soft, packed bytes);
    # 3 repetitions x 10 queued calls, best rep plus the rep spread
    b, n_bits = 6 * n_ens * 4 * n_frames, 3456
    t2 = (n_bits + 6 + 1) // 2
    soft_t = jax.device_put(jax.random.normal(
        jax.random.PRNGKey(1), (t2, 8, b), jnp.bfloat16), dev)
    jax.block_until_ready(viterbi_decode_bytes_best_t(soft_t, n_bits))
    reps = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(10):
            by = viterbi_decode_bytes_best_t(soft_t, n_bits)
        jax.block_until_ready(by)
        reps.append(10 * b * n_bits / (time.perf_counter() - t0) / 1e6)

    return {
        "metric": "realtime_factor_per_chip",
        "value": realtime_factor,
        "unit": "x_realtime_full_ensemble_decode",
        "vs_baseline": realtime_factor,
        "samples_per_s": samples_per_s,
        "ms_per_step": dt / iters * 1e3,
        "viterbi_mbit_s": max(reps),
        "viterbi_mbit_s_spread": (max(reps) - min(reps)) / max(reps),
        "viterbi_batch": b,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card_name_and_power_limit().splitlines()[0],
        "n_frames_per_step": n_frames,
        "n_ensembles_per_step": n_ens,
    }


if __name__ == "__main__":
    try:
        out = main()
    except Exception as e:
        traceback.print_exc(file=sys.stderr)
        print(json.dumps({"metric": "realtime_factor_per_chip",
                          "error": f"{type(e).__name__}: {str(e)[:200]}"}))
        sys.exit(1)
    print(json.dumps(out))
