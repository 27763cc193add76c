"""2-process jax.distributed CPU test (SURVEY.md sec 4, BASELINE config 5).

Spawns two OS processes, each with 4 forced-host CPU devices, joined into one
8-device global mesh via jax.distributed + gloo CPU collectives. The worker
(tests/_multihost_worker.py) runs the full ShardedReceiveStep — the ppermute
deinterleaver halo crosses the PROCESS boundary — and bit-verifies its
addressable output shards.

This test covers the jax.distributed layer of the scale-out design on CPU
processes; the four-GPU sharded path runs via `chip_smoke.py --four`.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_decode():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", coord],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=os.path.dirname(os.path.dirname(_WORKER)))
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "MULTIHOST_OK" in out, f"worker {pid} no OK marker:\n{out}"
