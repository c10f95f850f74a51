"""Multi-process (multi-"host") smoke test of parallel/mesh.init_distributed.

Spawns two real OS processes, each owning 2 virtual CPU devices, that
coordinate through ``jax.distributed`` (gRPC) and run a shard_map psum
over the 4-device global mesh — the multi-process branch of
parallel/mesh.py that a multi-host deployment takes, exercised end to end.
Skips cleanly where the environment cannot support the coordination
service (no localhost networking, old jaxlib).
"""

import os
import socket
import subprocess
import sys

import pytest

_WORKER = os.path.join(os.path.dirname(__file__), "_multihost_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_psum():
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    env = {
        k: v
        for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "XLA_FLAGS")
    }
    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coordinator, "2", str(i)],
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
            env=env,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        for i in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.skip("jax.distributed coordination timed out in this sandbox")

    combined = "\n".join(outs)
    if any(p.returncode != 0 for p in procs):
        lowered = combined.lower()
        if any(
            marker in lowered
            for marker in (
                "failed to connect",
                "deadline exceeded",
                "unavailable",
                "permission denied",
                "not implemented",
                "unimplemented",
            )
        ):
            pytest.skip(
                "jax.distributed unsupported here: " + combined[-500:]
            )
        raise AssertionError(combined[-2000:])
    assert combined.count("MULTIHOST OK") == 2, combined[-2000:]
