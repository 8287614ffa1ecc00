"""The port's multi-process bootstrap (plvio_tpu_torch/parallel/
multihost.py): two real processes on localhost (gloo, the PLVIO_*
environment, a free port) run the port's worker, which mirrors
scripts/multihost_worker.py: the chain BA over the two processes' shards,
then a landmark-sharded inertial window solve.  Each process's results
equal, bit for bit, the same problems on a 2-shard mesh in this one
process: a halo exchange is a copy and a two-way sum is the same either
way.  The workers run port modules only; a hard limit kills both and
fails the test."""
import json
import os
import socket
import subprocess
import sys

import pytest
import torch

from plvio_tpu_torch.parallel import multihost as MH
from plvio_tpu_torch.parallel.mesh import Mesh

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
LIMIT_S = 150


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(n: int = 2):
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if not k.startswith("XLA")}
    env.update(PLVIO_COORDINATOR=f"127.0.0.1:{port}",
               PLVIO_NUM_PROCS=str(n), PYTHONPATH=os.path.abspath(ROOT),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "plvio_tpu_torch.parallel.multihost",
         "--device", "cpu"],
        env={**env, "PLVIO_PROC_ID": str(r)}, cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(n)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=LIMIT_S)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"the workers did not finish within {LIMIT_S} s")
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} failed:\n{out[-3000:]}"
        assert "MULTIHOST_OK" in out, out[-3000:]
        assert "2 global shards" in out, out[-2000:]
    return [json.loads([x for x in out.splitlines()
                        if x.startswith("MULTIHOST_RESULT = ")][-1]
                       .split(" = ", 1)[1]) for out in outs]


def test_two_processes_equal_one_process_mesh():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = _run_workers()
        mesh = Mesh(["cpu", "cpu"])
        poses, pts = MH.chain_case(mesh)
        dl = MH.dist_case(mesh)
    finally:
        torch.set_num_threads(n)
    for r in range(2):
        assert res[r]["rank"] == r and res[r]["shards"] == 2
        assert MH._digest([poses[r:r + 1], pts[r:r + 1]]) == res[r]["chain"]
        local = list(dl[:4]) + [dl[4][r:r + 1], dl[5][r:r + 1]]
        assert MH._digest(local) == res[r]["dist"]


def test_card_default_raises_without_a_card(monkeypatch):
    """The worker and the helpers default to the card: without one they
    raise before any process group is joined."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MH.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MH.init("127.0.0.1:1", 2, 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MH.init_from_env()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MH.global_mesh()
