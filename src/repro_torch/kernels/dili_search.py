"""Loader and wrapper of the CUDA DILI lookup kernel
(`csrc/dili_search.cu`), the port of the Pallas kernel in
`repro/kernels/dili_search.py` together with the XLA recheck of its
flagged lanes: one launch returns each query's final (val, found).

Build: at first use on a CUDA tensor, `nvcc` compiles the source for
`sm_90a` into a shared library with a plain C entry point under
`kernels/_build/` (listed in .gitignore), named by the source's hash so an
edited source is rebuilt; a fresh build keeps ptxas's register and
shared-memory report in `kernel.ptxas_report`.  The library is loaded
with `ctypes` and the kernel launches on PyTorch's current stream.
Nothing here runs at import time, so the CPU tests import this module on
machines with no compiler.

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

_SRC = Path(__file__).parent / "csrc" / "dili_search.cu"
_BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
        self.ptxas_report = ""      # `-Xptxas -v` lines of a fresh build

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
                self.ptxas_report = "\n".join(
                    ln for ln in (res.stdout + res.stderr).splitlines()
                    if "ptxas info" in ln)
            lib = ctypes.CDLL(str(lib_path))
            fn = lib.dili_search_f32_launch
            fn.argtypes = ([ctypes.c_void_p] * 3
                           + [ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_longlong, ctypes.c_int]
                           + [ctypes.c_void_p] * 3)
            fn.restype = ctypes.c_int
            self._lib = lib
            self.build_s = time.perf_counter() - t0

    def launch(self, node_rec: torch.Tensor, slot_rec: torch.Tensor,
               key: torch.Tensor, queries: torch.Tensor, root: int,
               max_depth: int, out: torch.Tensor,
               found: torch.Tensor) -> None:
        self.build()
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = self._lib.dili_search_f32_launch(
            node_rec.data_ptr(), slot_rec.data_ptr(), key.data_ptr(),
            int(root), queries.data_ptr(), queries.numel(), int(max_depth),
            out.data_ptr(), found.data_ptr(), stream)
        if err != 0:
            raise RuntimeError(f"dili_search kernel launch failed: CUDA "
                               f"error {err}")
        self.launches += 1


#: the process's one kernel instance (its `launches` is the counter the
#: smoke run reads)
kernel = DiliSearchKernel()
watchdog.register_jit_provider("kernels.dili_search",
                               lambda: int(kernel.built))


def _check(node_rec: torch.Tensor, slot_rec: torch.Tensor,
           key: torch.Tensor, queries: torch.Tensor, root: int,
           max_depth: int) -> None:
    dev = queries.device
    if queries.dtype != torch.float32 or queries.dim() != 1:
        raise TypeError(f"queries must be 1-D float32, got "
                        f"{queries.dtype} {tuple(queries.shape)}")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")
    for name, t, dtype, width, align in (
            ("node_rec", node_rec, torch.int32, 4, 16),
            ("slot_rec", slot_rec, torch.int32, 2, 8),
            ("key", key, torch.float32, None, 4)):
        shape = (t.shape[0], width) if width else (t.shape[0],)
        if t.dtype != dtype or tuple(t.shape) != shape:
            want = f"[n, {width}]" if width else "[n]"
            raise TypeError(f"{name} must be {dtype} {want}, got {t.dtype} "
                            f"{tuple(t.shape)}")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, queries on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if dev.type == "cuda" and t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned")
    if slot_rec.shape[0] != key.shape[0]:
        raise ValueError(f"slot_rec has {slot_rec.shape[0]} rows, key has "
                         f"{key.shape[0]}")
    if not 0 <= int(root) < node_rec.shape[0]:
        raise ValueError(f"root {root} is not a node of {node_rec.shape[0]}")
    if int(max_depth) < 0:
        raise ValueError(f"max_depth must be >= 0, got {max_depth}")


def dili_search(node_rec, slot_rec, key, queries, root: int,
                max_depth: int):
    """(vals i32, found bool) for a batch of f32 queries over the kernel
    tables (`ops.pack_tables`); vals is -1 where not found.  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    _check(node_rec, slot_rec, key, queries, root, max_depth)
    if queries.device.type == "cpu":
        return dili_search_ref(node_rec, slot_rec, key, queries, root,
                               max_depth)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    nq = queries.numel()
    out = torch.empty(nq, dtype=torch.int32, device=queries.device)
    found = torch.empty(nq, dtype=torch.bool, device=queries.device)
    kernel.launch(node_rec, slot_rec, key, queries, root, max_depth, out,
                  found)
    return out, found
