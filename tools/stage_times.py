"""Stage times of the receive step on one GPU, hand kernel vs plain XLA.

    python tools/stage_times.py [--trace-dir DIR]

Prints, each line labelled with the card's name and power limit:
  - Viterbi at the step's MSC and FIC batches: the Pallas kernel vs the XLA
    scan decoder at radix 1, 2, 3 and 4 (the CPU path's relayout + scan +
    pack, as the dispatcher would run it);
  - the full ReceiveStep (32 ensembles x 16 frames, bf16 IQ) with the
    kernel and with the scan, in turns (kernel, scan, kernel);
  - the time deinterleave and the demod's carve + PLL rotate against one
    read-plus-write pass over the same bytes;
  - with --trace-dir, a profiler trace of two steps reduced to per-kernel
    device time and the device's idle share over the window.
Needs a GPU; one process for the card.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from chip_smoke import _timed  # noqa: E402


def timed(fn, *args, reps=5):
    """Median seconds of fn(*args) (chip_smoke._timed without the output)."""
    return _timed(fn, *args, reps=reps)[0]


def viterbi(card):
    import jax
    import jax.numpy as jnp
    from tpudab.ops import viterbi_pallas as vp
    from tpudab.ops.viterbi import viterbi_decode
    from tpudab.utils.bits import jnp_pack_bits

    def scan_bytes_t(soft_t, n, radix):
        t2, _, b = soft_t.shape
        soft = jnp.moveaxis(soft_t, 2, 0).reshape(b, t2 * 2, 4)[:, :n + 6]
        return jnp_pack_bits(viterbi_decode(soft.astype(jnp.float32), n,
                                            radix=radix))

    # (T2p, 8, B) as depuncture_t emits it: T2p = 16 * ceil(4 (n+6) / 128)
    for name, b, n in (("MSC", 12288, 3456), ("FIC", 2048, 768)):
        t2 = 16 * -(-4 * (n + 6) // 128)
        soft_t = jax.random.normal(jax.random.PRNGKey(b), (t2, 8, b),
                                   jnp.bfloat16)
        k = timed(jax.jit(lambda s: vp.viterbi_decode_pallas_bytes_t(s, n)),
                  soft_t)
        print(f"[viterbi] {name} B={b} n={n}: pallas kernel {k * 1e3:.3f} ms "
              f"= {b * n / k / 1e6:.0f} Mbit/s ({card})", flush=True)
        for radix in (1, 2, 3, 4):
            t = timed(jax.jit(lambda s, r=radix: scan_bytes_t(s, n, r)),
                      soft_t, reps=3)
            print(f"[viterbi] {name} B={b} n={n}: xla scan radix {radix} "
                  f"{t * 1e3:.3f} ms ({card})", flush=True)


def full_step(card):
    import jax
    import jax.numpy as jnp
    import ml_dtypes
    from bench import _synth_bench_frames
    from __graft_entry__ import _bench_subchannels
    from tpudab.models.step import ReceiveStep
    from tpudab.ops import viterbi_pallas as vp

    n_ens, n_frames = 32, 16
    subch = _bench_subchannels()
    frames, _ = _synth_bench_frames(subch, n_frames)
    probe = ReceiveStep(mode=1, subchannels=subch, n_ensembles=n_ens)
    tiled = probe.tile_frames(frames.reshape(n_frames, -1))
    shape = (n_ens,) + tiled.shape
    re = jnp.asarray(np.ascontiguousarray(np.broadcast_to(
        tiled.real.astype(ml_dtypes.bfloat16), shape)))
    im = jnp.asarray(np.ascontiguousarray(np.broadcast_to(
        tiled.imag.astype(ml_dtypes.bfloat16), shape)))
    freq = jnp.float32(0.0)
    rule = vp.use_kernel
    steps = {}
    for label, use in (("kernel", rule), ("scan", lambda p: False)):
        vp.use_kernel = use
        step = ReceiveStep(mode=1, subchannels=subch, n_ensembles=n_ens)
        carry = step.init_carry()
        t0 = time.perf_counter()
        jax.block_until_ready(step(carry, re, im, freq))
        print(f"[step] {label}: compile + first step "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        steps[label] = (step, carry)
    vp.use_kernel = rule
    for label in ("kernel", "scan", "kernel"):
        step, carry = steps[label]
        t = timed(lambda: step(carry, re, im, freq))
        print(f"[step] {label} Viterbi: {t * 1e3:.3f} ms per step, "
              f"real-time factor "
              f"{n_ens * n_frames * 196608 / t / 2.048e6:.1f}x ({card})",
              flush=True)
    return steps["kernel"], (re, im, freq)


def memory_bound_stages(card):
    import jax
    import jax.numpy as jnp
    from tpudab.constants.ofdm_params import get_ofdm_params, SAMPLING_RATE
    from tpudab.msc.interleave import deinterleave_batch

    # deinterleave at the step's shape: 32 ensembles, 64 CIFs + 15 history,
    # one 108-CU subchannel (6,912 bits), bf16; six per step
    c, s = 64, 108 * 64
    buf = jax.random.normal(jax.random.PRNGKey(0), (32, c + 15, s),
                            jnp.bfloat16)
    t_d = timed(jax.jit(lambda x: deinterleave_batch(x, c)), buf)
    t_p = timed(jax.jit(lambda x: x[:, 15:] * 2), buf)
    print(f"[deint] one subchannel (32, {c}+15, {s}) bf16: "
          f"{t_d * 1e3:.3f} ms vs read+write pass {t_p * 1e3:.3f} ms "
          f"(ratio {t_d / t_p:.2f}) ({card})", flush=True)

    # demod carve + PLL rotate (the XLA form that replaced the carve
    # kernel) at 512 frames of bf16 IQ, vs one pass writing the same bytes
    p = get_ofdm_params(1)
    f, n_sym, n_fft, n_cp = 512, p.nb_symbols, p.nb_fft, p.nb_cyclic_prefix
    x = jax.random.normal(jax.random.PRNGKey(1), (2, f, p.nb_frame_length),
                          jnp.bfloat16)
    start = n_cp - 12
    t_abs = ((p.nb_null_period + start
              + (n_fft + n_cp) * np.arange(n_sym))[:, None]
             + np.arange(n_fft)[None, :]) / SAMPLING_RATE

    def carve_rotate(x, freq):
        def carve(v):
            sym = v[:, p.nb_null_period:].reshape(f, n_sym, n_fft + n_cp)
            return sym[:, :, start:start + n_fft]
        wr, wi = carve(x[0]), carve(x[1])
        ph = -2.0 * jnp.pi * freq * jnp.asarray(t_abs, jnp.float32)
        c_, s_ = jnp.cos(ph), jnp.sin(ph)
        return ((wr * c_ - wi * s_).astype(jnp.bfloat16),
                (wr * s_ + wi * c_).astype(jnp.bfloat16))

    t_c = timed(jax.jit(carve_rotate), x, jnp.float32(300.0))
    t_p = timed(jax.jit(lambda v: v * 2), x)
    print(f"[carve] carve + rotate, 512 frames bf16: {t_c * 1e3:.3f} ms vs "
          f"read+write pass of the frames {t_p * 1e3:.3f} ms "
          f"(ratio {t_c / t_p:.2f}) ({card})", flush=True)

    from tpudab.ofdm.demod import demod_frames_split
    fr = x.reshape(2, f, -1, 128)
    t_dm = timed(jax.jit(lambda a, b: demod_frames_split(
        a, b, 0.0, out_dtype="bfloat16")), fr[0], fr[1])
    print(f"[demod] full demod, 512 frames bf16: {t_dm * 1e3:.3f} ms "
          f"({card})", flush=True)


def trace(step_state, args, trace_dir, card):
    import jax
    from jax.profiler import ProfileData
    step, carry = step_state
    jax.block_until_ready(step(carry, *args))
    jax.profiler.start_trace(trace_dir)
    for _ in range(2):
        jax.block_until_ready(step(carry, *args))
    jax.profiler.stop_trace()
    path = max(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                         recursive=True), key=os.path.getmtime)
    prof = ProfileData.from_file(path)
    for plane in prof.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        per, ivs = {}, []
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                per[ev.name] = per.get(ev.name, 0) + ev.duration_ns
                ivs.append((ev.start_ns, ev.start_ns + ev.duration_ns))
        if not ivs:
            continue
        ivs.sort()
        busy, cur = 0, list(ivs[0])
        for s, e in ivs[1:]:
            if s <= cur[1]:
                cur[1] = max(cur[1], e)
            else:
                busy += cur[1] - cur[0]
                cur = [s, e]
        busy += cur[1] - cur[0]
        window = ivs[-1][1] - ivs[0][0]
        print(f"[trace] {plane.name}: 2 steps, device busy "
              f"{busy / 1e6:.3f} ms of {window / 1e6:.3f} ms window, idle "
              f"share {1 - busy / window:.3f} ({card})")
        for name, ns in sorted(per.items(), key=lambda kv: -kv[1])[:25]:
            print(f"[trace]   {ns / 2e6:9.3f} ms/step  {name[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trace-dir", default=None)
    args = ap.parse_args()
    import jax
    from tpudab.utils.runtime import (card_name_and_power_limit,
                                      enable_compile_cache)
    if jax.devices()[0].platform != "gpu":
        raise SystemExit("stage_times needs a GPU")
    enable_compile_cache()
    card = card_name_and_power_limit().splitlines()[0]
    print(f"[device] {jax.devices()[0].device_kind}; {card}", flush=True)
    viterbi(card)
    memory_bound_stages(card)
    step_state, step_args = full_step(card)
    if args.trace_dir:
        trace(step_state, step_args, args.trace_dir, card)


if __name__ == "__main__":
    main()
