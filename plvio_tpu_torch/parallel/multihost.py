"""The multi-process bootstrap (port of plvio_tpu/parallel/multihost.py).

The sharded solvers of this package run on a shard mesh
(parallel/mesh.py).  Across processes (or hosts) the mesh's collectives
ride a `torch.distributed` process group: gloo for CPU tensors, NCCL when
each process has a card of its own.  The environment names the group, as
the reference's launcher does:

  PLVIO_COORDINATOR  host:port of process 0   (e.g. "10.0.0.1:9876")
  PLVIO_NUM_PROCS    the number of processes
  PLVIO_PROC_ID      this process's rank

Run as a module, it is the worker of scripts/multihost_worker.py: every
process joins the group, builds the same chain (`inputs.
build_multihost_chain`, two keyframes a shard) and runs the
chain-partitioned BA over the global mesh, then a landmark-sharded
inertial window solve (`inputs.build_dist_window`, 8 keyframes); it
prints one JSON line of its results (`MULTIHOST_RESULT = {...}`) and
`MULTIHOST_OK`.

    PLVIO_COORDINATOR=127.0.0.1:29500 PLVIO_NUM_PROCS=2 PLVIO_PROC_ID=0 \\
        python -m plvio_tpu_torch.parallel.multihost [--device cpu]

Every process's shard is the card unless `--device` (or the helpers'
`device` / `devices`) names the CPU; without a card a CUDA request
raises.
"""
from __future__ import annotations

import argparse
import datetime
import json
import os
import sys
from typing import Optional

import numpy as np
import torch

from ..cuda import resolve_device
from .mesh import Mesh

TIMEOUT_S = 120.0


def init_from_env(device="cuda", backend: Optional[str] = None) -> bool:
    """Join the process group the PLVIO_* environment names.  True when a
    group of more than one process was joined.  `device` is this
    process's shard (the card by default; raises without one)."""
    resolve_device(device)
    coord = os.environ.get("PLVIO_COORDINATOR")
    if not coord:
        return False
    return init(coord, int(os.environ["PLVIO_NUM_PROCS"]),
                int(os.environ["PLVIO_PROC_ID"]), device=device,
                backend=backend)


def init(coordinator: str, num_processes: int, process_id: int,
         device="cuda", backend: Optional[str] = None,
         timeout_s: float = TIMEOUT_S) -> bool:
    """Explicit init (idempotent): `tcp://coordinator`, a finite timeout;
    by default gloo for a CPU mesh and NCCL for one card a process (NCCL
    takes no two ranks on one card: processes that share one pass gloo,
    whose send / recv the mesh stages through host memory)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if num_processes <= 1:
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=f"tcp://{coordinator}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def global_mesh(devices=("cuda",)) -> Mesh:
    """The mesh over every process's shards: this process holds
    `devices` (one shard each; the card by default, which raises without
    one), every process as many."""
    import torch.distributed as dist
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh(list(devices), group=group)


def host_local_view(arr, mesh: Mesh) -> torch.Tensor:
    """This process's shards of a full [D, ...] host array, each on its
    device: [n_local, ...] (on the mesh's first device)."""
    a = torch.as_tensor(np.asarray(arr))
    return torch.stack([a[mesh.axis_index(i)].to(mesh.first)
                        for i in range(mesh.n_local)])


def addressable_checksum(t: torch.Tensor) -> float:
    """The sum of |x| over this process's shards."""
    return float(t.detach().abs().double().sum().cpu())


def chain_case(mesh: Mesh, outer_iters: int = 2, halo: int = 1,
               plain: bool = False):
    """scripts/multihost_worker.py's chain over `mesh`: (poses [n_local,
    Wh,3,4], pts [n_local,Pl,3])."""
    from .. import inputs as I
    from . import chain_ba as CB
    poses, pts, okf, opt, ouv = I.build_multihost_chain(mesh.size)
    C = len(poses)
    data, layout = CB.partition_chain(
        mesh.size, halo, np.arange(C), poses, okf, opt, ouv,
        np.ones(len(okf), np.float32), pts, fixed_kf=np.array([0, 1]))
    run = CB.make_chain_ba(I.K_MULTIHOST, mesh, layout["Wh"],
                           data.pt_xyz.shape[1], data.obs_kf.shape[1],
                           outer_iters=outer_iters, halo=halo, plain=plain)
    return run(data)


def dist_case(mesh: Mesh, n_kf: int = 8, seed: int = 0,
              plain: bool = False):
    """A landmark-sharded inertial window solve over `mesh` (the window of
    `inputs.build_dist_window`): (pose, vel, bg, ba, pt [n_local,Pl,3],
    ln [n_local,Ll,6])."""
    from .. import inputs as I
    from . import dist_liba as DL
    d = I.build_dist_window(seed, n_kf=n_kf, n_pts=300, n_lns=16)
    data, _ = DL.build_dist_liba(
        mesh.size, d["pose_wb"], d["vel"], d["bg"], d["ba"], d["kf_free"],
        d["kf_free_bias"], d["obs_kf"], d["obs_pt"], d["obs_uv"],
        d["obs_is2"], d["pt_xyz"], d["pre_stack"], d["imu_info"],
        d["edge_valid"], d["rw_g"], d["rw_a"], lobs_kf=d["lobs_kf"],
        lobs_ln=d["lobs_ln"], lobs_eq=d["lobs_eq"], ln_ep=d["ln_ep"])
    run = DL.make_dist_liba(I.K_CHAIN_VI, mesh, n_kf, data.pt_xyz.shape[1],
                            data.obs_kf.shape[1], data.ln_ep.shape[1],
                            data.lobs_kf.shape[1], np.eye(3), np.zeros(3),
                            9.81, plain=plain)
    return run(data)


def _digest(ts) -> list:
    """The float32 bits of each tensor as a list of ints (bit-for-bit
    comparisons across processes)."""
    return [t.detach().cpu().contiguous().view(torch.int32).reshape(-1)
            .tolist() for t in ts]


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="this process's shard: cuda[:<i>] (the default; "
                    "raises without a card), or cpu")
    ap.add_argument("--backend", default=None, choices=("gloo", "nccl"),
                    help="the process group's backend (default: gloo on "
                    "the CPU, nccl on a card)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.set_num_threads(1)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not init_from_env(dev, args.backend):
        print("PLVIO_COORDINATOR is not set", file=sys.stderr)
        return 2
    import torch.distributed as dist
    rank = dist.get_rank()
    if dev.type == "cuda":
        # process 0 builds the kernels of both cases first; the others
        # load its libraries after the barrier instead of running nvcc too
        if rank == 0:
            from .. import cuda
            cuda.build(["ba_linearize", "inertial_chain", "schur_solve"])
        dist.barrier()
    mesh = global_mesh([dev])
    print(f"[proc {rank}] {mesh.size} global shards "
          f"({mesh.n_local} local, {dist.get_backend()})", flush=True)
    poses, pts = chain_case(mesh)
    dl = dist_case(mesh)
    out = {"rank": rank, "shards": mesh.size,
           "chain": _digest([poses, pts]), "dist": _digest(dl)}
    cs = addressable_checksum(poses)
    ok = bool(np.isfinite(cs)) and all(bool(torch.isfinite(t).all())
                                       for t in dl)
    print("MULTIHOST_RESULT = " + json.dumps(out), flush=True)
    dist.barrier()
    dist.destroy_process_group()
    if ok:
        print(f"[proc {rank}] MULTIHOST_OK checksum={cs:.3f}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
