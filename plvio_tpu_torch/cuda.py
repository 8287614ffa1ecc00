"""Build and bind the hand-written CUDA kernels of `csrc/`.

Each `csrc/<name>.cu` has a plain C interface and is compiled on its own
at first use:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/lib<name>-<hash>.so csrc/<name>.cu

(with `SOURCE_FLAGS` added for the sources that name some)

into `build/` beside this file (ignored by git), named by a hash of the
sources and flags so that an edited kernel is rebuilt.  The library is
loaded with ctypes; every pointer and the stream are passed as
`c_void_p`, and the kernel runs on `torch.cuda.current_stream()`.

`--fmad=false` keeps every multiply and add separately rounded, as the
plain PyTorch versions are, so that a kernel and its plain version agree
bit for bit where their operations agree in order.  (Eager CUDA divides by
a Python scalar as a multiply by its reciprocal: a plain version that must
agree divides by a tensor.)

A `Kernel` counts its launches in the plain integer `launches`; a run can
reset it to 0 and read it after, to show that a path went through the
kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Sequence

import numpy as np
import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
# flags of one source besides NVCC_FLAGS.  pose_graph.cu: the NVVM
# optimizer at its default -O3 (nvcc 12.9) returns NaN for the rho rows of
# the forward-mode Dual residual of csrc/sim3.cuh (a standalone kernel of
# that chain reproduces it; -O2, -G and __noinline__ give the host's
# values), so its front end runs at -O2
SOURCE_FLAGS = {"pose_graph": ("-Xcicc", "-O2")}

_lock = threading.Lock()


def nvcc_path() -> str:
    """nvcc from $NVCC, $PATH, or $CUDA_HOME/bin (default /usr/local/cuda)."""
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found: set NVCC or CUDA_HOME, or put nvcc "
                       "on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS
                                + SOURCE_FLAGS.get(name, ())).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _compile_cmd(name: str, out: Path, ptxas_info: bool) -> list:
    cmd = [nvcc_path(), *NVCC_FLAGS, *SOURCE_FLAGS.get(name, ()), "-o",
           str(out), str(CSRC / f"{name}.cu")]
    if ptxas_info:
        cmd[1:1] = ["-Xptxas", "-v"]
    return cmd


def build(names: Sequence[str], ptxas_info: bool = False) -> Dict[str, str]:
    """Compile the named kernels (in parallel) unless already built.
    Returns the compiler's messages per kernel ('' when it was cached)."""
    out = {}
    with _lock:
        BUILD.mkdir(parents=True, exist_ok=True)
        procs = {}
        for name in names:
            path = _lib_path(name)
            if path.exists():
                out[name] = ""
                continue
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (subprocess.Popen(
                _compile_cmd(name, tmp, ptxas_info), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True), tmp, path)
        for name, (proc, tmp, path) in procs.items():
            msg, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {name}:\n{msg}")
            os.replace(tmp, path)
            out[name] = msg
    return out


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(index: int = None) -> ctypes.c_void_p:
    """The current stream of CUDA device `index` (default: the current
    device), as a pointer, without building a torch Stream object."""
    if index is None:
        index = torch.cuda.current_device()
    return ctypes.c_void_p(torch._C._cuda_getCurrentRawStream(index))


class Kernel:
    """One kernel library: built and loaded at its first launch."""

    def __init__(self, name: str, entry: str, argtypes: Sequence):
        self.name = name
        self.source = f"plvio_tpu_torch/csrc/{name}.cu"
        self.launches = 0
        self._entry = entry
        self._argtypes = list(argtypes)
        self._fn = None
        self._err = None

    def _load(self):
        if self._fn is None:
            build([self.name])
            lib = ctypes.CDLL(str(_lib_path(self.name)))
            fn = getattr(lib, self._entry)
            fn.argtypes = self._argtypes
            fn.restype = ctypes.c_int
            err = lib.plvio_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._fn, self._err = fn, err
        return self._fn

    def launch(self, *args, kernels: int = 1) -> None:
        """Call the entry point, which launches `kernels` kernels (one
        unless it launches several in a row: each counts)."""
        fn = self._load()
        rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name}: CUDA error {rc}: "
                               f"{self._err(rc).decode()}")
        self.launches += kernels


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent
    (the port never runs a CUDA request on the CPU).  Entry points and
    factories default to the card and take `device="cpu"` only when the
    caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but no CUDA device "
                           "is available")
    return dev


class HostIO:
    """Store arrays to the owner's device and kernel results back to
    numpy, for the host bookkeeping that runs between device calls; the
    owner sets `device` and counts each device-to-host read in
    `host_syncs`."""
    device: torch.device
    host_syncs: int

    def _dev(self, a) -> torch.Tensor:
        """A numpy array on the owner's device (uint32 descriptors as int32
        views with the same bits)."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.from_numpy(a).to(self.device, non_blocking=True)

    def _host(self, t: torch.Tensor) -> np.ndarray:
        """A kernel output back in numpy (a host sync on the card)."""
        if t.device.type != "cpu":
            self.host_syncs += 1
        return t.detach().cpu().numpy()

    def _host_many(self, *ts) -> list:
        """Several kernel outputs back in numpy with one read of the
        device (what the reference reads at one point)."""
        if ts and ts[0].device.type != "cpu":
            self.host_syncs += 1
            flat = torch.cat([t.detach().reshape(-1).to(torch.float64)
                              for t in ts]).cpu().numpy()
            out, off = [], 0
            for t in ts:
                n = t.numel()
                a = flat[off:off + n].reshape(tuple(t.shape))
                out.append(a.astype(str(t.dtype).replace("torch.", "")))
                off += n
            return out
        return [t.detach().numpy() for t in ts]


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous tensor on one CUDA device."""
    dev = tensors[0].device
    for i, t in enumerate(tensors):
        if t.device != dev or dev.type != "cuda":
            raise ValueError(f"{name}: all tensors must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor {i} {tuple(t.shape)} is not "
                             "contiguous")
