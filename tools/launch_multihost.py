#!/usr/bin/env python
"""Multi-host launch script for tpudab (BASELINE config 5 scaffolding).

Two modes:

  local   — spawn N worker processes on this machine (forced-host CPU
            devices) joined via jax.distributed + gloo; smoke-tests the
            full distributed decode path with the ppermute halo crossing
            process boundaries. Every worker runs on the CPU, so none of
            them competes for a GPU another process holds.

      python tools/launch_multihost.py local --num-processes 2

  worker  — run ONE process of an N-host job (invoke once per host, e.g.
            from a pod scheduler / mpirun / gnu-parallel over ssh):

      python tools/launch_multihost.py worker \
          --coordinator host0:12345 --num-processes 4 --process-id $IDX

Each process contributes --xla_force_host_platform_device_count CPU
devices.
"""

import argparse
import os
import socket
import subprocess
import sys

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "tests", "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_local(n: int, devices_per_proc: int) -> int:
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = (
        f"--xla_force_host_platform_device_count={devices_per_proc}")
    env["JAX_PLATFORMS"] = "cpu"
    procs = [subprocess.Popen([sys.executable, _WORKER, str(i), str(n), coord],
                              env=env, cwd=_REPO) for i in range(n)]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def run_worker(coordinator: str, n: int, pid: int) -> int:
    return subprocess.call([sys.executable, _WORKER, str(pid), str(n),
                            coordinator], cwd=_REPO)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="mode", required=True)
    lo = sub.add_parser("local")
    lo.add_argument("--num-processes", type=int, default=2)
    lo.add_argument("--devices-per-process", type=int, default=4)
    wk = sub.add_parser("worker")
    wk.add_argument("--coordinator", required=True)
    wk.add_argument("--num-processes", type=int, required=True)
    wk.add_argument("--process-id", type=int, required=True)
    args = ap.parse_args()
    if args.mode == "local":
        rc = run_local(args.num_processes, args.devices_per_process)
    else:
        rc = run_worker(args.coordinator, args.num_processes, args.process_id)
    sys.exit(rc)


if __name__ == "__main__":
    main()
