"""End-to-end check that the receiver runs on one NVIDIA GPU.

    python chip_smoke.py          # phases 1-4 on one card
    python chip_smoke.py --four   # the sharded step on four cards, only

Phases (each prints its own lines; any failure exits non-zero):
  1. device: JAX must report platform "gpu" (no CPU fallback); prints the
     device kind and the card's name and power limit from nvidia-smi.
  2. kernel parity: the Pallas Viterbi kernel at the bench widths (12,288
     MSC codewords of 3,456 bits, 2,048 FIC codewords of 768 bits) against
     the XLA scan decoder and the NumPy oracle; the bf16 and float32 demod
     against the complex jnp.fft (cuFFT) demod; the `gpu`-marked tests.
  3. main path: ReceiveStep over 32 ensembles x 16 frames of the bench
     ensemble (6 x 108-CU EEP 3-A DAB+ subchannels), bf16 IQ: compile time,
     memory analysis, FIB CRC and payload gates, ms per step, real-time
     factor.
  4. live path: StreamingRadio on an in-memory synthesized capture, default
     settings: it must pick the device step by itself and decode the
     synthesized services.
  5. (--four) ShardedReceiveStep over a (2 ensemble x 2 time) mesh of four
     cards must match ReceiveStep on one card byte for byte.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

N_ENS, N_FRAMES = 32, 16          # the bench's step: 32 ensembles x 16 frames
FOUR_ENS, FOUR_FRAMES = 8, 16     # --four: 4 ensembles x 8 frames per card
# Viterbi parity widths: the step's MSC batch (6 subchannels x 32 ensembles
# x 64 CIFs) and its FIC batch (32 ensembles x 16 frames x 4 FIB groups)
VITERBI_WIDTHS = (("MSC", 12288, 3456), ("FIC", 2048, 768))


def phase_device(n_cards: int):
    import jax
    devs = jax.devices()
    plat = devs[0].platform
    if plat != "gpu":
        raise SystemExit(f"chip_smoke: JAX platform is {plat!r}, not 'gpu'")
    if len(devs) < n_cards:
        raise SystemExit(f"chip_smoke: {len(devs)} GPU(s), need {n_cards}")
    from tpudab.utils.runtime import (card_name_and_power_limit,
                                      enable_compile_cache)
    card = card_name_and_power_limit().splitlines()[0]
    print(f"[device] platform={plat} kind={devs[0].device_kind} "
          f"count={len(devs)} compile_cache={enable_compile_cache()}")
    print(f"[device] nvidia-smi name, power.limit: {card}")
    return devs, card


def _timed(fn, *args, reps=3):
    """(median seconds of fn(*args) with a block_until_ready barrier,
    last output); the first call is a warm-up."""
    import jax
    out = jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), out


def _coded_soft(key, b, n_bits, noise=0.9):
    """Random payloads, conv-encoded (vectorised over the batch), plus
    Gaussian noise, quantised to a 1/8 grid within +-4 — exact in bf16, and
    every branch- and path-metric sum is exact in float32. Returns
    (bits (B, n) u8 host, soft (B, n+6, 4) f32 device)."""
    import jax
    import jax.numpy as jnp
    from tpudab.fec.conv import OUTPUT_BITS
    rng = np.random.default_rng(b)
    bits = rng.integers(0, 2, (b, n_bits), dtype=np.uint8)
    padded = np.concatenate([bits, np.zeros((b, 6), np.uint8)], axis=1)
    reg7 = np.zeros(padded.shape, np.uint8)
    for k in range(7):
        reg7[:, k:] |= padded[:, : padded.shape[1] - k] << k
    coded = jnp.asarray(OUTPUT_BITS[reg7])                # (B, n+6, 4)
    soft = 1.0 - 2.0 * coded.astype(jnp.float32)
    soft = soft + noise * jax.random.normal(key, soft.shape)
    return bits, jnp.clip(jnp.round(soft * 8) / 8, -4, 4)


def phase_kernel_parity(card):
    import jax
    import jax.numpy as jnp
    import pytest
    from tpudab.ops.viterbi import viterbi_decode, viterbi_decode_np
    from tpudab.ops.viterbi_pallas import viterbi_decode_pallas_bytes_t
    from tpudab.utils.bits import jnp_pack_bits, pack_bits

    print("[parity] Viterbi: soft on a 1/8 grid (exact in bf16 and in f32 "
          "sums); tolerance 0 bytes; kernel input bf16 (T2, 8, B), "
          "reference float32 scan at radix 1 (same first-predecessor tie "
          "rule) and the NumPy oracle on 64 codewords")
    for name, b, n in VITERBI_WIDTHS:
        bits, soft = _coded_soft(jax.random.PRNGKey(b), b, n)
        soft_t = jnp.moveaxis(soft.reshape(b, (n + 6) // 2, 8), 0, 2)
        t_k, got = _timed(lambda s: viterbi_decode_pallas_bytes_t(s, n),
                          soft_t.astype(jnp.bfloat16), reps=3)
        got = np.asarray(got)
        ref = np.asarray(jnp_pack_bits(viterbi_decode(soft, n, radix=1)))
        bad = int((got != ref).any(axis=1).sum())
        oracle = pack_bits(viterbi_decode_np(np.asarray(soft[:64]), n))
        bad_np = int((got[:64] != oracle).any(axis=1).sum())
        r4 = np.asarray(jnp_pack_bits(viterbi_decode(soft, n)))
        ties = int((got != r4).any(axis=1).sum())
        ber = float((np.unpackbits(got, axis=1) != bits).mean())
        print(f"[parity] Viterbi {name} B={b} n={n}: kernel "
              f"{t_k * 1e3:.3f} ms ({card}); codewords differing from "
              f"scan radix 1: {bad}, from NumPy oracle: {bad_np}/64; from "
              f"scan radix 4 (tie order): {ties}; payload BER {ber:.2e}")
        assert bad == 0 and bad_np == 0, f"Viterbi {name} parity failed"

    from bench import _synth_bench_frames
    from __graft_entry__ import _bench_subchannels
    from tpudab.ofdm.demod import demod_frames, demod_frames_split
    frames, _ = _synth_bench_frames(_bench_subchannels(), N_FRAMES)
    frames = frames.reshape(N_FRAMES, -1)
    ref, _ = demod_frames(jnp.asarray(frames), 350.0)
    ref = np.asarray(ref)
    for dt, limit in (("bfloat16", -40.0), ("float32", -70.0)):
        soft, _ = demod_frames_split(
            jnp.asarray(frames.real.astype(np.float32)),
            jnp.asarray(frames.imag.astype(np.float32)), 350.0,
            dft_dtype=dt)
        err = np.asarray(soft, np.float64) - ref
        db = 10 * np.log10((err ** 2).mean() / (ref ** 2).mean())
        print(f"[parity] demod dft_dtype={dt} vs complex jnp.fft demod: "
              f"soft-bit error {db:.1f} dB (limit {limit} dB)")
        assert db < limit, f"demod {dt} error {db:.1f} dB"

    env = dict(os.environ)
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(ROOT, "tests", "test_viterbi_kernel.py")])
    os.environ.clear()
    os.environ.update(env)
    print(f"[parity] gpu-marked tests: pytest exit {int(rc)}")
    assert rc == 0, "gpu-marked tests failed"


def phase_main_path(dev, card):
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from bench import _synth_bench_frames
    from __graft_entry__ import _bench_subchannels
    from tpudab.constants.ofdm_params import SAMPLING_RATE
    from tpudab.fec.crc import check_fib_crc
    from tpudab.models.step import ReceiveStep

    subch = _bench_subchannels()
    step = ReceiveStep(mode=1, subchannels=subch, n_ensembles=N_ENS)
    frames, payload = _synth_bench_frames(subch, N_FRAMES)
    tiled = step.tile_frames(frames.reshape(N_FRAMES, -1))
    shape = (N_ENS,) + tiled.shape
    re = np.broadcast_to(tiled.real.astype(ml_dtypes.bfloat16), shape)
    im = np.broadcast_to(tiled.imag.astype(ml_dtypes.bfloat16), shape)
    carry = jax.device_put(step.init_carry(), dev)
    re, im = jax.device_put(np.ascontiguousarray(re), dev), \
        jax.device_put(np.ascontiguousarray(im), dev)
    freq = jnp.float32(0.0)
    print(f"[main] ReceiveStep mode 1, {len(subch)} subchannels, "
          f"{N_ENS} ensembles x {N_FRAMES} frames, bf16 IQ "
          f"{(re.nbytes + im.nbytes) / 1e6:.0f} MB per step")

    t0 = time.perf_counter()
    compiled = step._fn.lower(carry, re, im, freq).compile()
    print(f"[main] compile {time.perf_counter() - t0:.1f} s")
    print(f"[main] memory_analysis: {compiled.memory_analysis()}")

    new_carry, out = jax.block_until_ready(step(carry, re, im, freq))
    ok = check_fib_crc(np.asarray(out["fic_bytes"]).reshape(-1, 3, 32))
    got = np.asarray(out["subch"][subch[0].subch_id])[0]
    print(f"[main] FIB CRC pass {ok.mean() * 100:.1f}% of {ok.size}; "
          f"subchannel {subch[0].subch_id} rows {got.shape}")
    assert ok.mean() == 1.0, "FIB CRC pass rate below 100%"
    # deinterleaver ramp: logical frames 15.. are whole in the first step
    np.testing.assert_array_equal(got[15:], payload[:got.shape[0] - 15])
    print("[main] payload bit-exact from logical frame 15")

    n_steps = 5
    carry = new_carry
    t0 = time.perf_counter()
    for _ in range(n_steps):
        carry, out = step(carry, re, im, freq)
    jax.block_until_ready((carry, out))
    dt = (time.perf_counter() - t0) / n_steps
    samples = N_ENS * N_FRAMES * step.params.nb_frame_length
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use", 0)
    print(f"[main] {dt * 1e3:.3f} ms per step over {n_steps} steps; "
          f"real-time factor {samples / dt / SAMPLING_RATE:.1f}x "
          f"({samples / dt / 1e6:.1f} MS/s); peak device memory "
          f"{peak / 1e9:.2f} GB ({card})")


def phase_live():
    from tpudab.host.streaming import StreamingRadio
    from tpudab.synth import (EnsembleSpec, ServiceSpec, SubchannelSpec,
                              EnsembleSynthesizer, ASCTY_DAB_PLUS)
    from tpudab.synth.modulator import modulate_frame_bits

    n_frames, svc = 36, {1: 0xC301, 2: 0xC302}
    spec = EnsembleSpec(
        ensemble_id=0x5A5A, label="Smoke Mux",
        services=[ServiceSpec(sid, f"Smoke {s}", [(0, ASCTY_DAB_PLUS, s)])
                  for s, sid in svc.items()],
        subchannels=[SubchannelSpec(s, start_cu=48 * (s - 1), size_cu=48,
                                    protection=("eep", 3, 0)) for s in svc])
    synth = EnsembleSynthesizer(spec, seed=5)
    rng = np.random.default_rng(6)
    data = {s: rng.integers(0, 256, (n_frames * 4 + 20, 48 * 4),
                            dtype=np.uint8) for s in svc}
    for s in svc:
        synth.payload_fn[s] = lambda m, s=s: data[s][m].tobytes()
    iq = np.concatenate([modulate_frame_bits(synth.frame_bits(i))
                         for i in range(n_frames)]).astype(np.complex64)
    pos = [0]

    def source(n):
        lo = pos[0]
        pos[0] = min(lo + n, iq.shape[0])
        return iq[lo:pos[0]]

    rows = {s: [] for s in svc}

    def on_outputs(outputs):
        for s, o in outputs.items():
            if o.raw_frames is not None and len(o.raw_frames):
                rows[s].append(np.asarray(o.raw_frames))

    radio = StreamingRadio(source, mode=1, batch_frames=4)
    assert radio.use_device_step, "StreamingRadio did not pick the device step"
    t0 = time.perf_counter()
    radio.run(on_outputs=on_outputs)
    assert radio._driver.step is not None, "device step never ran"
    db = radio.receiver.db
    print(f"[live] device step auto-selected; {radio.stats.total_frames} "
          f"frames in {time.perf_counter() - t0:.1f} s (compiles included); "
          f"ensemble {db.ensemble.label!r}, services "
          f"{sorted(hex(k) for k in db.services)}")
    assert db.ensemble.label == "Smoke Mux"
    for s, sid in svc.items():
        assert db.services[sid].label == f"Smoke {s}"
        got = np.concatenate(rows[s])
        # row 0 is logical frame 1 (first CIF after acquisition)
        assert got.shape[0] >= n_frames * 4 - 24, got.shape
        np.testing.assert_array_equal(got[1:], data[s][1:got.shape[0]])
        print(f"[live] subchannel {s}: {got.shape[0]} logical frames "
              f"match the payload")


def phase_four(devs, card):
    import jax
    import jax.numpy as jnp
    from bench import _synth_bench_frames
    from __graft_entry__ import _bench_subchannels
    from tpudab.models.step import ReceiveStep
    from tpudab.parallel.mesh import default_mesh_shape, make_mesh
    from tpudab.parallel.sharded_step import ShardedReceiveStep

    n_ens, n_frames = FOUR_ENS, FOUR_FRAMES
    shape = default_mesh_shape(4)
    mesh = make_mesh(4, shape)
    subch = _bench_subchannels()
    frames, _ = _synth_bench_frames(subch, n_frames)
    frames = np.broadcast_to(frames.reshape(n_frames, -1),
                             (n_ens, n_frames, frames.size // n_frames))
    sharded = ShardedReceiveStep(mesh, mode=1, subchannels=subch)
    fr, fi, fq = sharded.shard_inputs(frames, np.zeros(n_ens, np.float32))
    carry = sharded.init_carry(n_ens)
    print(f"[four] mesh (ensemble, time) = {shape} over "
          f"{[d.id for d in mesh.devices.flat]}; {n_ens} ensembles x "
          f"{n_frames} frames")
    t0 = time.perf_counter()
    _, out = jax.block_until_ready(sharded(carry, fr, fi, fq))
    print(f"[four] first sharded step (compile included) "
          f"{time.perf_counter() - t0:.1f} s")

    single = ReceiveStep(mode=1, subchannels=subch, n_ensembles=n_ens,
                         soft_dtype="float32")
    tiled = single.tile_frames(np.asarray(frames))
    with jax.default_device(devs[0]):
        _, ref = single(single.init_carry(),
                        jnp.asarray(tiled.real.astype(np.float32)),
                        jnp.asarray(tiled.imag.astype(np.float32)),
                        jnp.zeros(n_ens, jnp.float32))
    pairs = [("fic_bytes", out["fic_bytes"], ref["fic_bytes"])]
    pairs += [(f"subch {c.subch_id}", out["subch"][c.subch_id],
               ref["subch"][c.subch_id]) for c in subch]
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=name)
    print(f"[four] sharded == single-card ReceiveStep(float32): "
          f"{len(pairs)} outputs byte-identical")

    def run(c):
        return sharded(c, fr, fi, fq)

    t, _ = _timed(run, carry, reps=5)
    print(f"[four] {t * 1e3:.3f} ms per sharded step ({card} x4)")

    trace_dir = os.path.join(ROOT, "chiprun_out", "four_trace")
    jax.profiler.start_trace(trace_dir)
    for _ in range(2):
        jax.block_until_ready(run(carry))
    jax.profiler.stop_trace()
    print(f"[four] NCCL kernels in trace: {_collective_time(trace_dir, 2)}")


def _collective_time(trace_dir, n_steps):
    """Per device and per NCCL kernel (SendRecv is the halo ppermute), ms
    per step in the trace and the part of it during which no other kernel
    ran on that device (exposed)."""
    import glob
    from jax.profiler import ProfileData
    paths = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                      recursive=True)
    if not paths:
        return "no trace written"
    prof = ProfileData.from_file(max(paths, key=os.path.getmtime))
    rows = []
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        coll, other = {}, []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue            # module/op summary lines span everything
            for ev in line.events:
                iv = (ev.start_ns, ev.start_ns + ev.duration_ns)
                if ev.name.startswith("ncclDevKernel_"):
                    kind = ev.name[len("ncclDevKernel_"):].split("(")[0]
                    coll.setdefault(kind, []).append(iv)
                else:
                    other.append(iv)
        merged = []
        for s, e in sorted(other):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        for kind, ivs in sorted(coll.items()):
            total = sum(e - s for s, e in ivs)
            covered = sum(max(0, min(e, oe) - max(s, os_))
                          for s, e in ivs for os_, oe in merged)
            rows.append(f"{plane.name} {kind}: "
                        f"{total / n_steps / 1e6:.3f} ms/step, exposed "
                        f"{(total - covered) / n_steps / 1e6:.3f}")
    return "; ".join(rows) or "no NCCL kernels in the trace"


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args()
    devs, card = phase_device(4 if args.four else 1)
    if args.four:
        phase_four(devs, card)
    else:
        phase_kernel_parity(card)
        phase_main_path(devs[0], card)
        phase_live()
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))


if __name__ == "__main__":
    main()
