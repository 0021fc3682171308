"""Loader and wrapper of the CUDA DILI lookup kernel
(`csrc/dili_search.cu`), the port of the Pallas kernel in
`repro/kernels/dili_search.py`.

Build: at first use on a CUDA tensor, `nvcc` compiles the source for
`sm_90a` into a shared library with a plain C entry point under
`kernels/_build/` (listed in .gitignore), named by the source's hash so an
edited source is rebuilt.  The library is loaded with `ctypes` and the
kernel launches on PyTorch's current stream.  Nothing here runs at import
time, so the CPU tests import this module on machines with no compiler.

Dispatch: a CUDA tensor launches the kernel or raises (no `nvcc`, a
failed build, a refused launch); a CPU tensor runs the plain version
`ref.dili_search_ref`.  There is no silent fallback between the two.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from ..obs import watchdog
from .ref import dili_search_ref

BLOCK_Q = 2048   # query padding granule kept from the TPU kernel (ops.py)

_SRC = Path(__file__).parent / "csrc" / "dili_search.cu"
_BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): cannot build the DILI "
                       "lookup kernel")


class DiliSearchKernel:
    """The built library plus its launch counter.  `launches` counts
    kernel launches only (one per `launch` call that reached the card);
    callers may reset it to 0 to count a window."""

    def __init__(self):
        self._lib = None
        self._lock = threading.Lock()
        self.launches = 0
        self.build_s = 0.0          # wall seconds of the build, 0 until built

    @property
    def built(self) -> bool:
        return self._lib is not None

    def build(self) -> None:
        """Compile (if this source's library is not on disk) and load."""
        with self._lock:
            if self._lib is not None:
                return
            t0 = time.perf_counter()
            digest = hashlib.sha256(_SRC.read_bytes()
                                    + " ".join(NVCC_FLAGS).encode())
            lib_path = _BUILD_DIR / f"dili_search_{digest.hexdigest()[:16]}.so"
            if not lib_path.exists():
                _BUILD_DIR.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
                cmd = [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)]
                res = subprocess.run(cmd, capture_output=True, text=True)
                if res.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({res.returncode}) building "
                        f"{_SRC.name}:\n{res.stdout}\n{res.stderr}")
                os.replace(tmp, lib_path)
                watchdog.note_compile()
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.dili_search_launch
            fn.argtypes = ([ctypes.c_void_p] * 10
                           + [ctypes.c_longlong, ctypes.c_int]
                           + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
            self._lib = lib
            self.build_s = time.perf_counter() - t0

    def launch(self, tables: tuple, queries: torch.Tensor, max_depth: int,
               out: torch.Tensor, found: torch.Tensor,
               fallback: torch.Tensor) -> None:
        self.build()
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = self._lib.dili_search_launch(
            *(t.data_ptr() for t in tables), queries.data_ptr(),
            queries.numel(), int(max_depth), out.data_ptr(),
            found.data_ptr(), fallback.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"dili_search kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1


#: the process's one kernel instance (its `launches` is the counter the
#: smoke run reads)
kernel = DiliSearchKernel()
watchdog.register_jit_provider("kernels.dili_search",
                               lambda: int(kernel.built))

_F32 = ("a", "b", "key")
_NAMES = ("a", "b", "base", "fo", "dense", "tag", "key", "val", "root")


def _check(tables: dict, queries: torch.Tensor) -> None:
    dev = queries.device
    if queries.dtype != torch.float32 or queries.dim() != 1:
        raise TypeError(f"queries must be 1-D float32, got "
                        f"{queries.dtype} {tuple(queries.shape)}")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")
    for name in _NAMES:
        t = tables[name]
        want = torch.float32 if name in _F32 else torch.int32
        if t.dtype != want or t.dim() != 1:
            raise TypeError(f"{name} must be 1-D {want}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n_nodes = tables["a"].numel()
    n_slots = tables["tag"].numel()
    for name in ("b", "base", "fo", "dense"):
        if tables[name].numel() != n_nodes:
            raise ValueError(f"{name} has {tables[name].numel()} rows, "
                             f"a has {n_nodes}")
    for name in ("key", "val"):
        if tables[name].numel() != n_slots:
            raise ValueError(f"{name} has {tables[name].numel()} rows, "
                             f"tag has {n_slots}")
    if tables["root"].numel() != 1:
        raise ValueError("root must hold exactly one node id")


def dili_search(a, b, base, fo, dense, tag, key, val, root, queries,
                max_depth: int):
    """(vals i32, found bool, needs_fallback bool) for a batch of f32
    queries over the kernel tables (`ops.kernel_arrays`).  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    tables = dict(a=a, b=b, base=base, fo=fo, dense=dense, tag=tag, key=key,
                  val=val, root=root)
    _check(tables, queries)
    if queries.device.type == "cpu":
        return dili_search_ref(a, b, base, fo, dense, tag, key, val, root,
                               queries, max_depth)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    nq = queries.numel()
    out = torch.empty(nq, dtype=torch.int32, device=queries.device)
    found = torch.empty(nq, dtype=torch.bool, device=queries.device)
    fallback = torch.empty(nq, dtype=torch.bool, device=queries.device)
    kernel.launch((a, b, base, fo, dense, tag, key, val, root), queries,
                  max_depth, out, found, fallback)
    return out, found, fallback
