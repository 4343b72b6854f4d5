"""Multi-host process runtime test: 2 OS processes, one global mesh.

SURVEY.md §4(e)'s posture — the fake-backend multi-host capability the
reference lacks. Two localhost processes each hold 4 virtual CPU
devices; ``jax.distributed.initialize`` (via
``perception.parallel.multihost``) joins them into an 8-device
fleet, and the distributed ICP + BA steps run sharded across the
process boundary with gloo collectives, asserting sharded == single.

Replaces the role of Caffe's NCCL bootstrap
(``3rdparty/caffe/src/caffe/parallel.cpp:117-340``).
"""

import os
import socket
import subprocess
import sys

import pytest

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.slow
def test_two_process_cpu_mesh():
    port = _free_port()
    nproc, n_local = 2, 4
    env = dict(os.environ)
    # The workers configure their own backend; scrub the parent test
    # harness's single-process device forcing.
    env.pop("XLA_FLAGS", None)
    repo_root = os.path.dirname(os.path.dirname(WORKER))
    env["PYTHONPATH"] = repo_root + os.pathsep + env.get("PYTHONPATH", "")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(i), str(nproc), str(port), str(n_local)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.path.dirname(WORKER),
        )
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=600)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("multihost workers timed out:\n" + "\n".join(outs))

    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed (rc={p.returncode}):\n{out}"
        assert "MULTIHOST ICP OK" in out, f"worker {i} missing ICP OK:\n{out}"
        assert "MULTIHOST BA OK" in out, f"worker {i} missing BA OK:\n{out}"
        assert f"proc {i}: DONE" in out
        assert f"({nproc} processes x {n_local} devices)" in out
