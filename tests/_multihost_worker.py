"""Worker process for the 2-process jax.distributed CPU test.

Run by tests/test_multihost.py (and usable standalone via
tools/launch_multihost.py). Each process owns 4 forced-host CPU devices;
together they form the 8-device (ensemble=4, time=2) global mesh and run the
full ShardedReceiveStep on a synthesized capture. Every process verifies the
FIB CRCs and the known MSC payload on its *addressable* output shards, so a
pass proves the cross-process halo exchange (lax.ppermute over 'time' rides
the distributed runtime, not shared memory) decodes bit-exactly.

Mirrors the multi-host design of SURVEY.md sec 2.7 / BASELINE config 5
(reference analog: the plugin's single-process thread pipeline,
/root/reference/src/radio_block.cpp — the reference has no multi-host story;
this is the batched scale-out path).

Usage: _multihost_worker.py <process_id> <num_processes> <coordinator>
"""

import os
import sys

# Must be set before importing jax.
os.environ.setdefault(
    "XLA_FLAGS",
    "--xla_force_host_platform_device_count=4")

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")


def main():
    pid, nproc, coord = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc, jax.process_count()
    n_local = jax.local_device_count()
    n_global = jax.device_count()
    assert n_global == nproc * n_local, (n_global, nproc, n_local)

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tpudab.constants.dab_params import get_dab_params
    from tpudab.constants.puncture import eep_profile
    from tpudab.fec.crc import check_fib_crc
    from tpudab.msc.subchannel import SubchannelConfig
    from tpudab.parallel.mesh import make_mesh
    from tpudab.parallel.sharded_step import ShardedReceiveStep
    from tpudab.synth import (EnsembleSpec, ServiceSpec, SubchannelSpec,
                              EnsembleSynthesizer, ASCTY_DAB_PLUS)
    from tpudab.synth.modulator import modulate_frame_bits
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_ens, n_time = 4, 2
    t_total = 8  # 4 frames per time shard -> 16 CIFs >= 15-CIF halo
    t_l = t_total // n_time
    mesh = make_mesh(shape=(n_ens, n_time))
    dab = get_dab_params(1)

    # Deterministic capture: every process synthesizes the same global input.
    cfg = SubchannelConfig(subch_id=1, start_cu=0, size_cu=24,
                           profile=eep_profile(24, 3, 0))
    frames_np, payloads = [], []
    for e in range(n_ens):
        spec = EnsembleSpec(
            ensemble_id=0x5000 + e, label=f"MH {e}",
            services=[ServiceSpec(0xC300 + e, f"Svc {e}",
                                  [(0, ASCTY_DAB_PLUS, 1)])],
            subchannels=[SubchannelSpec(1, start_cu=0, size_cu=24,
                                        protection=("eep", 3, 0))])
        synth = EnsembleSynthesizer(spec, seed=e)
        rng = np.random.default_rng(700 + e)
        data = rng.integers(0, 256, (t_total * 4, cfg.data_bits // 8)
                            ).astype(np.uint8)
        synth.payload_fn[1] = lambda m, d=data: d[m].tobytes()
        frames_np.append(np.stack([modulate_frame_bits(synth.frame_bits(i))
                                   for i in range(t_total)]))
        payloads.append(data)
    frames = np.stack(frames_np)  # (E, T, frame_len) complex

    step = ShardedReceiveStep(mesh=mesh, mode=1, subchannels=(cfg,))
    tiled = (n_ens, t_total, step.params.nb_frame_length // 128, 128)
    re = np.ascontiguousarray(frames.real, np.float32).reshape(tiled)
    im = np.ascontiguousarray(frames.imag, np.float32).reshape(tiled)
    freq = np.zeros(n_ens, np.float32)

    # Build GLOBAL arrays (devices span both processes, so device_put of the
    # host value would fail — each process contributes its addressable shards).
    fspec = NamedSharding(mesh, P("ensemble", "time", None, None))
    g_re = jax.make_array_from_callback(re.shape, fspec, lambda i: re[i])
    g_im = jax.make_array_from_callback(im.shape, fspec, lambda i: im[i])
    g_fq = jax.make_array_from_callback(
        freq.shape, NamedSharding(mesh, P("ensemble")), lambda i: freq[i])
    cspec = NamedSharding(mesh, P("ensemble", None, None))
    cz = np.zeros((n_ens, 15, cfg.slice_bits), np.float32)
    carry = {f"deint_{cfg.subch_id}": jax.make_array_from_callback(
        cz.shape, cspec, lambda i: cz[i])}

    (out,) = step._fn(carry, g_re, g_im, g_fq)

    # Verify only addressable shards: FIB CRCs + known payload bytes.
    # Output row r (global CIF index) holds logical frame r-15; rows < 15 are
    # deinterleaver warm-up (zero history), skipped.
    n_fib_checked = n_pay_checked = 0
    for sh in out["fic_bytes"].addressable_shards:
        fibs = np.asarray(sh.data).reshape(-1, 32)
        assert check_fib_crc(fibs).all(), \
            f"FIB CRC failure in shard {sh.index}"
        n_fib_checked += len(fibs)
    for sh in out["subch"][cfg.subch_id].addressable_shards:
        e0 = sh.index[0].start or 0
        t0 = sh.index[1].start or 0
        blk = np.asarray(sh.data)  # (E_l, 1, c_l, bytes)
        got = blk.reshape(blk.shape[0], -1, cfg.data_bits // 8)
        c_start = t0 * t_l * dab.nb_cifs
        for j in range(got.shape[0]):
            e = e0 + j
            for c in range(got.shape[1]):
                ci = c_start + c
                if ci < 15:
                    continue
                np.testing.assert_array_equal(got[j, c], payloads[e][ci - 15])
                n_pay_checked += 1
    assert n_fib_checked > 0 and n_pay_checked > 0
    print(f"MULTIHOST_OK pid={pid} fibs={n_fib_checked} "
          f"payload_cifs={n_pay_checked}", flush=True)


if __name__ == "__main__":
    main()
