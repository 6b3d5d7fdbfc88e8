"""Multi-process jax.distributed smoke test (VERDICT round-1 item 4).

Launches two real OS processes, each with 2 virtual CPU devices, joined
through jax.distributed.initialize — the same code path a multi-host
deployment uses (coordinator handshake, global mesh spanning
non-addressable devices, cross-process collectives).  The reference's
scale-out analog is the MATLAB parfor pool (Vs_M_par.m:145); this test
proves the replacement end-to-end without accelerators.
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_distributed_solve():
    port = _free_port()
    env = dict(os.environ)
    # Children configure their own JAX_PLATFORMS / XLA_FLAGS; scrub the
    # parent pytest values so the forced 8-device flag doesn't leak in.
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, str(pid), "2", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, env=env)
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=600)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()

    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:\n{out}\nstderr:\n{err}"
    # Process 0 reports the globally-reduced NMSE.
    assert any("DISTRIBUTED_OK 4" in out for _, out, _ in outs), outs
