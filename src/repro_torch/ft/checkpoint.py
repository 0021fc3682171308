"""Fault-tolerant checkpointing: npz + manifest, atomic publish, corruption
fallback (port of `repro/ft/checkpoint.py`).

Layout (the reference's, so a directory written by either package
restores in the other):
    <dir>/step_000123/
        shard_00000.npz       # the state's leaves, leaf_00000, ...
        manifest.json         # step, leaf paths, per-leaf CRC32, extra
    <dir>/latest              # text file naming the newest VALID step dir

Writes go to `step_X.tmp/` then os.replace -> atomic.  `restore` walks
checkpoints newest-first and falls back past unreadable/corrupt ones
(validated against the manifest's per-leaf checksums).

The state is a nested dict (lists and tuples allowed) of tensors or
arrays in place of a JAX pytree.  Leaves are flattened in the reference's
order — dict keys sorted, sequences by index — and named by the same
"/"-joined paths, so the manifests of the two packages are equal.

A bfloat16 leaf is saved as the reference saves one: its bits as a 2-byte
void array under the `'<V2'` header that ml_dtypes' bfloat16 gives
`np.savez` (`_write_npz`), so the npz members, the CRC32s and the
manifest are the reference's.  Such a leaf reads back as `|V2`, which
neither package casts to a dtype: `restore` skips that step, as the
reference does (`a.astype(tmpl.dtype)` fails there), and the walk falls
back.
"""

from __future__ import annotations

import json
import os
import shutil
import zipfile
import zlib

import numpy as np
import torch

from ..device import resolve_device

# ---------------------------------------------------------------------------
# shared atomic-publish helpers (also used by repro_torch.durability
# .checkpoint): every checkpoint directory follows the same protocol —
# write into `step_X.tmp/`, fsync-free `os.replace` to publish atomically,
# maintain a best-effort `latest` pointer, walk candidates newest-first on
# restore and fall back past corrupt ones.
# ---------------------------------------------------------------------------


def step_name(step: int) -> str:
    return f"step_{step:08d}"


def make_tmp_dir(ckpt_dir: str, name: str) -> str:
    """Fresh `<name>.tmp` staging dir under `ckpt_dir` (replacing stale
    leftovers from a crashed writer)."""
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    return tmp


def publish_dir(ckpt_dir: str, name: str) -> str:
    """Atomically publish `<name>.tmp` -> `<name>` (os.replace), then move
    the `latest` pointer.  A crash before the replace leaves only a .tmp
    (ignored by restore); a crash after it leaves a fully valid step that
    the newest-first walk finds even without the pointer."""
    tmp = os.path.join(ckpt_dir, name + ".tmp")
    final = os.path.join(ckpt_dir, name)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    write_latest(ckpt_dir, name)
    return final


def write_latest(ckpt_dir: str, name: str) -> None:
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(name)
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))


def step_candidates(ckpt_dir: str) -> list[str]:
    """Published step dir names, newest first, `latest` pointer (when valid)
    promoted to the front — the restore walk order."""
    candidates = sorted((d for d in os.listdir(ckpt_dir)
                         if d.startswith("step_") and not d.endswith(".tmp")),
                        reverse=True)
    latest = os.path.join(ckpt_dir, "latest")
    if os.path.exists(latest):
        with open(latest) as f:
            name = f.read().strip()
        if name in candidates:
            candidates.remove(name)
            candidates.insert(0, name)
    return candidates


def gc_steps(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_")
                   and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def _flatten(tree, path=()):
    """[(path tuple, leaf)] in the reference's pytree order: dict keys
    sorted, list/tuple items by index; anything else is a leaf."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(tree, leaves):
    """`tree`'s structure with its leaves replaced, in `_flatten` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _path_name(path) -> str:
    return "/".join(str(k) for k in path)


BF16_DESCR = "<V2"     # the npy header of an ml_dtypes bfloat16 array


def to_numpy(leaf) -> np.ndarray:
    """A leaf as the host array the reference saves: a bfloat16 tensor as
    its bits in a 2-byte void array (`.numpy()` has no bfloat16)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _write_npz(path: str, arrays: dict) -> None:
    """`np.savez`'s archive (stored, zip64 members `<key>.npy`), with a
    2-byte void leaf under the bfloat16 header the reference writes,
    which a plain void dtype cannot carry (numpy writes it as `|V2`)."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, a in arrays.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as fid:
                if a.dtype == np.dtype("V2"):
                    np.lib.format.write_array_header_1_0(fid, dict(
                        descr=BF16_DESCR, fortran_order=False,
                        shape=a.shape))
                    fid.write(np.ascontiguousarray(a).tobytes())
                else:
                    np.lib.format.write_array(fid, a, allow_pickle=False)


def save(ckpt_dir: str, step: int, state, extra: dict | None = None,
         keep: int = 3) -> str:
    name = step_name(step)
    tmp = make_tmp_dir(ckpt_dir, name)
    flat = _flatten(state)
    arrays = {}
    checksums = {}
    for i, (_, leaf) in enumerate(flat):
        key = f"leaf_{i:05d}"
        a = to_numpy(leaf)
        arrays[key] = a
        checksums[key] = zlib.crc32(a.tobytes())
    _write_npz(os.path.join(tmp, "shard_00000.npz"), arrays)
    manifest = dict(step=step, paths=[_path_name(p) for p, _ in flat],
                    checksums=checksums, extra=extra or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    final = publish_dir(ckpt_dir, name)
    gc_steps(ckpt_dir, keep)
    return final


def _load_dir(path: str, template, device, prefix: str = ""):
    """Leaves are matched BY PATH (exact, with optional sub-tree prefix), not
    by flatten index, so a sub-tree template (e.g. prefix="params" out of a
    full train state) restores correctly and reordered states stay valid.
    Each leaf takes the template leaf's dtype and lands on `device`."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    saved_paths = manifest["paths"]
    leaves = []
    with np.load(os.path.join(path, "shard_00000.npz")) as data:
        for tpath, tmpl in _flatten(template):
            tname = _path_name(tpath)
            if prefix:
                tname = prefix + "/" + tname
            if tname not in saved_paths:
                raise IOError(f"no saved leaf for path {tname} in {path}")
            key = f"leaf_{saved_paths.index(tname):05d}"
            a = data[key]
            if zlib.crc32(a.tobytes()) != manifest["checksums"][key]:
                raise IOError(f"checksum mismatch for {key} in {path}")
            if tuple(a.shape) != tuple(tmpl.shape):
                raise IOError(f"shape mismatch for {tname}: {a.shape} vs "
                              f"{tuple(tmpl.shape)}")
            if a.dtype.kind == "V":
                # the reference's `astype` has no cast from a void array
                raise IOError(f"{tname}: no cast from {a.dtype.str} to "
                              f"{_torch_dtype(tmpl)}")
            leaves.append(torch.from_numpy(a).to(
                device=device, dtype=_torch_dtype(tmpl)))
    return _unflatten(template, iter(leaves)), manifest


def _torch_dtype(tmpl) -> torch.dtype:
    if isinstance(tmpl, torch.Tensor):
        return tmpl.dtype
    return torch.from_numpy(np.zeros(0, np.asarray(tmpl).dtype)).dtype


def restore(ckpt_dir: str, template, device="cuda", prefix: str = ""):
    """Load the newest valid checkpoint as tensors on `device`; fall back
    past corrupt ones.  `prefix` restores a sub-tree (e.g. prefix="params")
    of a saved state.  Returns (state, manifest) or (None, None) when
    nothing is restorable."""
    device = resolve_device(device)
    if not os.path.isdir(ckpt_dir):
        return None, None
    for name in step_candidates(ckpt_dir):
        path = os.path.join(ckpt_dir, name)
        try:
            return _load_dir(path, template, device, prefix)
        except Exception as e:     # corrupt/partial: fall back
            print(f"[ckpt] skipping {name}: {e}")
    return None, None
