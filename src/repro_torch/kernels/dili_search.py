"""Loader and wrappers of the CUDA DILI lookup kernel
(`csrc/dili_search.cu`), the port of the Pallas kernel in
`repro/kernels/dili_search.py` together with the XLA recheck of its
flagged lanes: one launch returns each query's final (val, found).  Three
instances: `dili_search` (f32 keys, i32 payloads; the `pallas` engine),
and, with the overlay resolve fused in, `dili_search_f64` (f64 keys, i64
payloads) and `dili_search_f32_i64` (f32 keys, i64 payloads): the local
engine at f64 and at f32, in place of the reference's XLA
`core/search.py::search_with_overlay`.

Build: at first use on a CUDA tensor, `nvcc` compiles the source for
`sm_90a` into one shared library with a plain C entry point per
instance under `kernels/_build/` (listed in .gitignore), named by the
source's hash so an edited source is rebuilt; a fresh build keeps
ptxas's register and shared-memory report (every instance) in
`kernel.ptxas_report`.  The build holds a lock, so threads that meet an
unbuilt library at once run nvcc once.  The library is loaded
with `ctypes` and the kernel launches on PyTorch's current stream.
Nothing here runs at import time, so the CPU tests import this module on
machines with no compiler.

Dispatch: a CUDA tensor launches the kernel or raises (no `nvcc`, a
failed build, a refused launch); a CPU tensor runs the plain version
(`ref.dili_search_ref`, `ref.search_with_overlay_ref`).  There is no
silent fallback between the two.  Launch counters are updated under a
lock: the local engine's readers and its maintenance worker launch from
several threads.
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

import numpy as np
import torch

from ..obs import watchdog
from .ref import dili_search_ref, filter_hash, search_with_overlay_ref

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


_F32_ARGS = ([ctypes.c_void_p] * 3
             + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int]
             + [ctypes.c_void_p] * 3)
_F64_ARGS = (_F32_ARGS[:7] + [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
             + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3)
_OCCUPANCY_ARGS = [ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3


def overlay_filter(keys, dtype=torch.float64) -> torch.Tensor:
    """The membership bitmap of overlay keys (host numpy, cast to the
    mirror's key `dtype`) as int32 words, 16 bits a key and at least
    1024, a power of two: bit h(k) is set for every key k (the +inf
    padding included; `ref.filter_hash`).  The i64 instances skip the
    overlay for a query whose bit is clear, which no key equals, when the
    mirror carries this as its "filter"."""
    kdt = np.float64 if dtype == torch.float64 else np.float32
    k = np.asarray(keys).astype(kdt)
    log2m = max(10, (16 * max(len(k), 1) - 1).bit_length())
    bits = np.zeros(1 << log2m, bool)
    bits[filter_hash(k, log2m)] = True
    # bit j of word w is bits[32 w + j] (little-endian words)
    return torch.from_numpy(np.packbits(bits, bitorder="little").view(
        "<i4").astype(np.int32))


class _Library:
    """The shared library of `csrc/dili_search.cu` (every instance), built
    once per process."""

    def __init__(self):
        self.lib = None
        self._lock = threading.Lock()
        self.build_s = 0.0          # wall seconds of the build, 0 until built
        self.ptxas_report = ""      # `-Xptxas -v` lines of a fresh build

    def load(self) -> ctypes.CDLL:
        """Compile (if this source's library is not on disk) and load."""
        with self._lock:
            if self.lib is not None:
                return self.lib
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
            for name, argtypes in (("dili_search_f32_launch", _F32_ARGS),
                                   ("dili_search_f64_launch", _F64_ARGS),
                                   ("dili_search_f32_i64_launch",
                                    _F64_ARGS),
                                   ("dili_search_occupancy",
                                    _OCCUPANCY_ARGS)):
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            self.lib = lib
            self.build_s = time.perf_counter() - t0
            return lib


_library = _Library()


class DiliSearchKernel:
    """One instance of the kernel (one C entry point of the shared
    library) plus its launch counter.  `launches` counts this instance's
    kernel launches only (one per `launch` call that reached the card);
    callers may reset it to 0 to count a window.  `build()` builds the
    library, which holds every instance.  An empty batch launches
    nothing and is not counted."""

    def __init__(self, entry: str, instance: int):
        self.entry = entry
        self.instance = instance       # dili_search_occupancy's number
        self.launches = 0
        self._count_lock = threading.Lock()

    @property
    def built(self) -> bool:
        return _library.lib is not None

    @property
    def build_s(self) -> float:
        return _library.build_s

    @property
    def ptxas_report(self) -> str:
        return _library.ptxas_report

    def build(self) -> None:
        _library.load()

    def occupancy(self) -> dict:
        """Registers a thread, local (spill) bytes and resident blocks of
        256 threads per SM of this instance's kernel, from the CUDA
        runtime (builds the library)."""
        out = [ctypes.c_int(0) for _ in range(3)]
        err = _library.load().dili_search_occupancy(
            self.instance, *map(ctypes.byref, out))
        if err != 0:
            raise RuntimeError(f"dili_search_occupancy failed: CUDA error "
                               f"{err}")
        return dict(regs=out[0].value, local_bytes=out[1].value,
                    blocks_per_sm=out[2].value)

    def launch(self, queries: torch.Tensor, *ptrs) -> None:
        """Launch on `queries`' device and current stream; `ptrs` are the
        entry point's arguments before the stream."""
        fn = getattr(_library.load(), self.entry)
        stream = torch.cuda.current_stream(queries.device).cuda_stream
        err = fn(*ptrs, stream)
        if err != 0:
            raise RuntimeError(f"{self.entry} failed: CUDA error {err}")
        if queries.numel():           # the entry point returns early on 0
            with self._count_lock:
                self.launches += 1


#: the f32/i32 instance (the `pallas` engine's kernel) and the f64/i64
#: and f32/i64 instances with the overlay resolve (the local engine's at
#: f64 and at f32); their `launches` are the counters the smoke run reads
kernel = DiliSearchKernel("dili_search_f32_launch", 0)
kernel_f64 = DiliSearchKernel("dili_search_f64_launch", 1)
kernel_f32_i64 = DiliSearchKernel("dili_search_f32_i64_launch", 2)
watchdog.register_jit_provider("kernels.dili_search",
                               lambda: int(kernel.built))

# per (key, payload) dtype: the word dtypes of the node records [n, 4]
# and of the slot records [n, 2], and the slot record's alignment in bytes
# (the node record's is 16)
_RECORDS = {(torch.float32, torch.int32): (torch.int32, torch.int32, 8),
            (torch.float64, torch.int64): (torch.int64, torch.int64, 16),
            (torch.float32, torch.int64): (torch.int32, torch.int64, 16)}


def _check(node_rec: torch.Tensor, slot_rec: torch.Tensor,
           key: torch.Tensor, queries: torch.Tensor, root: int,
           max_depth: int, key_dtype: torch.dtype,
           val_dtype: torch.dtype) -> None:
    dev = queries.device
    if queries.dtype != key_dtype or queries.dim() != 1:
        raise TypeError(f"queries must be 1-D {key_dtype}, got "
                        f"{queries.dtype} {tuple(queries.shape)}")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")
    node_dtype, slot_dtype, slot_align = _RECORDS[key_dtype, val_dtype]
    for name, t, dtype, width, align in (
            ("node_rec", node_rec, node_dtype, 4, 16),
            ("slot_rec", slot_rec, slot_dtype, 2, slot_align),
            ("key", key, key_dtype, None, key_dtype.itemsize)):
        _check_tensor(name, t, dtype, width, align, dev)
    if slot_rec.shape[0] != key.shape[0]:
        raise ValueError(f"slot_rec has {slot_rec.shape[0]} rows, key has "
                         f"{key.shape[0]}")
    if not 0 <= int(root) < node_rec.shape[0]:
        raise ValueError(f"root {root} is not a node of {node_rec.shape[0]}")
    if int(max_depth) < 0:
        raise ValueError(f"max_depth must be >= 0, got {max_depth}")


def _check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype,
                  width: int | None, align: int, dev: torch.device) -> None:
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


def _check_overlay(ov: dict, dev: torch.device,
                   key_dtype: torch.dtype) -> int:
    """The overlay mirror's length (its capacity); 1-D keys of the
    queries' dtype, i64 vals and i8 tomb of one length on the queries'
    device."""
    n = ov["keys"].shape[0]
    for name, dtype, size in (("keys", key_dtype, key_dtype.itemsize),
                              ("vals", torch.int64, 8),
                              ("tomb", torch.int8, 1)):
        _check_tensor(f"overlay {name}", ov[name], dtype, None, size, dev)
        if ov[name].shape[0] != n:
            raise ValueError(f"overlay {name} has {ov[name].shape[0]} rows, "
                             f"keys have {n}")
    if n == 0:
        raise ValueError("an overlay needs at least one row (its capacity)")
    if "filter" in ov:
        f = ov["filter"]
        _check_tensor("overlay filter", f, torch.int32, None, 4, dev)
        if f.shape[0] < 32 or f.shape[0] & (f.shape[0] - 1):
            raise ValueError(f"overlay filter has {f.shape[0]} words, not "
                             f"a power of two >= 32")
    return n


def _device_type(queries: torch.Tensor) -> str:
    if queries.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {queries.device}")
    return queries.device.type


def dili_search(node_rec, slot_rec, key, queries, root: int,
                max_depth: int):
    """(vals i32, found bool) for a batch of f32 queries over the kernel
    tables (`ops.pack_tables`); vals is -1 where not found.  CUDA tensors
    launch the kernel; CPU tensors run the plain version."""
    _check(node_rec, slot_rec, key, queries, root, max_depth, torch.float32,
           torch.int32)
    if _device_type(queries) == "cpu":
        return dili_search_ref(node_rec, slot_rec, key, queries, root,
                               max_depth)
    nq = queries.numel()
    out = torch.empty(nq, dtype=torch.int32, device=queries.device)
    found = torch.empty(nq, dtype=torch.bool, device=queries.device)
    kernel.launch(queries, node_rec.data_ptr(), slot_rec.data_ptr(),
                  key.data_ptr(), int(root), queries.data_ptr(), nq,
                  int(max_depth), out.data_ptr(), found.data_ptr())
    return out, found


def dili_search_f64(node_rec, slot_rec, key, queries, root: int,
                    max_depth: int, ov: dict | None = None,
                    early_exit: bool = True):
    """(vals i64, found bool) for a batch of f64 queries over the f64
    kernel tables (`ops.pack_tables(..., dtype=torch.float64)`), with the
    overlay mirror `ov` (`online.overlay.overlay_device_arrays`: keys,
    vals, tomb at its capacity, and optionally its membership "filter",
    `overlay_filter`) resolved over the snapshot's result, as the
    reference's `search_with_overlay`.  CUDA tensors launch the f64
    instance, walk, dense probe and overlay in one launch; CPU tensors run
    the plain version.  `early_exit` changes nothing in the result: the
    plain version stops the batch once every lane is done, and on the card
    each thread stops on its own whatever it says.  Nor does the filter,
    which only lets the card's kernel skip the overlay's bisection."""
    return _with_overlay(kernel_f64, torch.float64, node_rec, slot_rec, key,
                         queries, root, max_depth, ov, early_exit)


def dili_search_f32_i64(node_rec, slot_rec, key, queries, root: int,
                        max_depth: int, ov: dict | None = None,
                        early_exit: bool = True):
    """`dili_search_f64` at f32 keys with i64 payloads: the tables of
    `ops.pack_tables(..., dtype=torch.float32, val_dtype=torch.int64)`,
    f32 queries and an overlay mirror with f32 keys
    (`overlay_device_arrays(ov, torch.float32)`); the local engine at
    dtype=float32.  CUDA tensors launch the f32/i64 instance."""
    return _with_overlay(kernel_f32_i64, torch.float32, node_rec, slot_rec,
                         key, queries, root, max_depth, ov, early_exit)


def _with_overlay(kern: DiliSearchKernel, key_dtype: torch.dtype, node_rec,
                  slot_rec, key, queries, root, max_depth, ov, early_exit):
    _check(node_rec, slot_rec, key, queries, root, max_depth, key_dtype,
           torch.int64)
    ov_n = 0 if ov is None else _check_overlay(ov, queries.device,
                                               key_dtype)
    if _device_type(queries) == "cpu":
        return search_with_overlay_ref(node_rec, slot_rec, key, queries,
                                       root, max_depth, ov,
                                       early_exit=early_exit)
    nq = queries.numel()
    out = torch.empty(nq, dtype=torch.int64, device=queries.device)
    found = torch.empty(nq, dtype=torch.bool, device=queries.device)
    ov_ptrs = ((0, 0, 0) if ov is None else
               (ov["keys"].data_ptr(), ov["vals"].data_ptr(),
                ov["tomb"].data_ptr()))
    filt = None if ov is None else ov.get("filter")
    kern.launch(queries, node_rec.data_ptr(), slot_rec.data_ptr(),
                key.data_ptr(), int(root), queries.data_ptr(), nq,
                int(max_depth), *ov_ptrs, ov_n,
                0 if filt is None else filt.data_ptr(),
                0 if filt is None else (32 * filt.shape[0]).bit_length() - 1,
                out.data_ptr(), found.data_ptr())
    return out, found
