"""Multi-process distributed BA: 2 jax.distributed processes x 4 virtual
CPU devices = one global 8-device mesh whose Schur psum crosses the process
boundary (Gloo) — the shape of multi-host BA (SURVEY.md §2.4 north
star "global BA sharded across hosts over DCN"; BASELINE.md ">=70% BA
scaling at 2+ hosts")."""
import os
import socket
import subprocess
import sys

import pytest


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_dist_ba():
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "_dist_ba_worker.py")
    port = str(_free_port())
    env = dict(os.environ)
    # the workers pin their own platform/flags; scrub the conftest's
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""
    procs = [subprocess.Popen([sys.executable, worker, port, str(i)],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env)
             for i in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=420)
        outs.append(out)
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {i} failed:\n{out[-4000:]}"
        assert "CONVERGED" in out, f"process {i} did not converge:\n{out[-4000:]}"
