"""Fault-tolerant checkpointing: atomic, manifest-driven, elastic.

The torch counterpart of ``repro.checkpoint.ckpt``, byte-compatible with
it, so that a checkpoint written by either package restores in the
other. Layout of a checkpoint directory::

    <dir>/step_000123/          # finished checkpoints only (atomic rename)
        manifest.json           # step, index (per leaf: file, shape,
                                # dtype, crc32), meta, n_chunks
        arrays_00.npz ...       # leaf chunks of at most 1 GiB, keys with
                                # "/" written as "::"

- **Atomicity**: writes go to ``<dir>/.tmp_step_X`` and are renamed into
  place only after every chunk file *and* the manifest are fsynced — a
  killed job never leaves a half checkpoint that restore could pick up.
- **Integrity**: the manifest records a crc32 per leaf; ``restore``
  verifies them by default, so a truncated or bit-flipped chunk raises
  :class:`CheckpointCorruptError` instead of silently resuming from
  garbage.
- **Degraded restore**: ``valid_steps``/``latest_step`` consider only a
  ``step_*`` dir with a parseable manifest (dangling ``.tmp_step_*`` and
  manifest-less dirs are skipped, never crashed on), and
  ``restore(step=None)`` falls back newest-first, quarantining corrupt
  dirs (renamed to ``.corrupt_step_*``) so later scans skip them.
- **Bounded retry**: ``save`` retries transient I/O failures with
  exponential backoff, cleaning its temp dir between attempts.
- **Elasticity**: leaves are saved as logical (whole) arrays, so a
  restore may target any layout; ``restore(device=...)`` places every
  leaf on one device, ``restore(shardings=...)`` distributes leaves over
  a ``DeviceMesh`` (the JAX package's ``device_put`` onto shardings).
- **Sharded trees**: a tree with DTensor leaves is gathered leaf by leaf
  (``full_tensor()``, a collective every rank of the mesh calls), the
  mesh's first rank writes, and every rank of the mesh waits for the
  write before ``save`` returns (``wait`` does it for ``save_async``).
  The files are the same as for whole arrays.
- **Async**: ``save_async`` copies to host memory now and writes in a
  background thread; ``wait`` joins before the next save or exit.

Leaves are numpy arrays or torch tensors on any device (a CUDA tensor is
copied to the host after a synchronize). dtypes numpy lacks — bfloat16,
float8_e4m3fn, float8_e5m2 — are written as their uint16/uint8 bits under
the logical dtype name (the names ml_dtypes gives them, as the JAX
package writes them) and come back as CPU torch tensors of that dtype;
every other leaf comes back as a numpy array.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import zipfile
import zlib
from typing import Any

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, distribute_tensor

from repro_torch.models.params import leaf_paths, unflatten

__all__ = ["save", "save_async", "wait", "restore", "latest_step",
           "valid_steps", "CheckpointCorruptError"]

_MAX_CHUNK_BYTES = 1 << 30
# (writer thread or None, the mesh whose ranks wait for the write or None)
_pending: list[tuple] = []
# dtypes numpy lacks: the logical name on disk, and the unsigned view
# (torch's signed one, for from_numpy) that holds their bits
_VIEWED = {torch.bfloat16: ("bfloat16", np.uint16, torch.int16),
           torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8, torch.uint8),
           torch.float8_e5m2: ("float8_e5m2", np.uint8, torch.uint8)}
_BY_NAME = {name: (dt, signed) for dt, (name, _, signed) in _VIEWED.items()}


class CheckpointCorruptError(RuntimeError):
    """A checkpoint dir exists but fails integrity checks (missing or
    truncated chunk files, crc32 mismatch, unreadable manifest)."""


def crc32(a: np.ndarray) -> int:
    """crc32 of an array's bytes in C order (``zlib.crc32(a.tobytes())``
    without the copy)."""
    return zlib.crc32(np.ascontiguousarray(a).reshape(-1).view(np.uint8))


def _to_host(v, copy: bool) -> tuple[np.ndarray, str]:
    """(the array written to disk, its logical dtype name); with ``copy``
    it shares no memory with ``v``, which the caller may then change. A
    DTensor is gathered whole first (every rank of its mesh calls this)."""
    if isinstance(v, DTensor):
        v, copy = v.full_tensor(), False
    if not isinstance(v, torch.Tensor):
        a = np.array(v, copy=True) if copy else np.asarray(v)
        return a, str(a.dtype)
    if v.is_cuda:
        torch.cuda.synchronize(v.device)
    t = v.detach().cpu().contiguous()
    if copy and t.data_ptr() == v.data_ptr():
        t = t.clone()
    if t.dtype in _VIEWED:
        name, unsigned, signed = _VIEWED[t.dtype]
        return t.view(signed).numpy().view(unsigned), name
    a = t.numpy()
    return a, str(a.dtype)


def _host_tree(tree: dict, copy: bool = False) -> dict[str, tuple[np.ndarray, str]]:
    return {"/".join(map(str, path)): _to_host(v, copy)
            for path, v in leaf_paths(tree)}


def _mesh_of(tree):
    """The mesh of ``tree``'s DTensor leaves, or None for a tree of whole
    arrays."""
    for _, v in leaf_paths(tree):
        if isinstance(v, DTensor):
            return v.device_mesh
    return None


def _writes(mesh) -> bool:
    """Whether this process writes: always for whole arrays, on the mesh's
    first rank for a sharded tree."""
    return mesh is None or not any(mesh.get_coordinate())


def _mesh_barrier(mesh) -> None:
    """Wait for every rank of ``mesh`` (a one-element reduction)."""
    if mesh is not None:
        one = torch.zeros(1, device=mesh.device_type)
        DTensor.from_local(one, mesh, [Partial()] * mesh.ndim,
                           run_check=False).full_tensor()


def save(ckpt_dir: str, step: int, tree: dict, *, meta: dict | None = None,
         retries: int = 2, backoff: float = 0.05):
    """Synchronous atomic save of a tree (nested dicts) of arrays.

    Transient ``OSError`` during the write is retried up to ``retries``
    times with exponential backoff (the temp dir is removed between
    attempts so every attempt starts clean); the last failure re-raises.
    A sharded tree is written by its mesh's first rank; every rank of the
    mesh calls this and returns once the checkpoint is in place.
    """
    mesh = _mesh_of(tree)
    host = _host_tree(tree)
    if _writes(mesh):
        _write_with_retry(ckpt_dir, step, host, meta or {}, retries, backoff)
    _mesh_barrier(mesh)


def save_async(ckpt_dir: str, step: int, tree: dict, *,
               meta: dict | None = None, retries: int = 2,
               backoff: float = 0.05):
    """Copy to host now (the caller may change the leaves once this
    returns); write (with the same bounded retry) in the background. A
    sharded tree is gathered now and written by its mesh's first rank;
    :func:`wait` then waits for every rank of the mesh."""
    mesh = _mesh_of(tree)
    host = _host_tree(tree, copy=True)
    t = None
    if _writes(mesh):
        t = threading.Thread(
            target=_write_with_retry,
            args=(ckpt_dir, step, host, meta or {}, retries, backoff),
            daemon=True)
        t.start()
    _pending.append((t, mesh))


def wait():
    """Join every pending background write (and, for a sharded tree, wait
    for the mesh's ranks)."""
    while _pending:
        t, mesh = _pending.pop(0)
        if t is not None:
            t.join()
        _mesh_barrier(mesh)


def _write_with_retry(ckpt_dir: str, step: int, host: dict, meta: dict,
                      retries: int, backoff: float):
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    for attempt in range(retries + 1):
        try:
            _write(ckpt_dir, step, host, meta)
            return
        except OSError:
            shutil.rmtree(tmp, ignore_errors=True)
            if attempt == retries:
                raise
            time.sleep(backoff * (2 ** attempt))


def _write(ckpt_dir: str, step: int, host: dict[str, tuple[np.ndarray, str]],
           meta: dict):
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = os.path.join(ckpt_dir, f".tmp_step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    # chunk leaves into bounded npz files
    chunks: list[dict[str, np.ndarray]] = [{}]
    size = 0
    index = {}
    for k, (v, logical_dtype) in host.items():
        if size > _MAX_CHUNK_BYTES:
            chunks.append({})
            size = 0
        chunks[-1][k] = v
        index[k] = {"file": len(chunks) - 1, "shape": list(v.shape),
                    "dtype": logical_dtype, "crc32": crc32(v)}
        size += v.nbytes
    for i, c in enumerate(chunks):
        # npz keys cannot contain '/', escape; fsync each chunk so the
        # final rename publishes only fully-durable data files
        with open(os.path.join(tmp, f"arrays_{i:02d}.npz"), "wb") as f:
            np.savez(f, **{k.replace("/", "::"): v for k, v in c.items()})
            f.flush()
            os.fsync(f.fileno())
    manifest = {"step": step, "index": index, "meta": meta,
                "n_chunks": len(chunks)}
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):  # overwrite-save of same step
        shutil.rmtree(final)
    os.rename(tmp, final)


def _read_manifest(d: str) -> dict | None:
    """The dir's manifest, or None when missing/unparseable (a partial
    or torn checkpoint — never an exception)."""
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError):
        return None


def valid_steps(ckpt_dir: str) -> list[int]:
    """Sorted steps of every *candidate* checkpoint: a ``step_*`` dir
    whose manifest parses. Dangling ``.tmp_step_*`` dirs, quarantined
    ``.corrupt_step_*`` dirs, manifest-less and torn-manifest dirs are
    all skipped. Chunk contents are *not* verified here — that is
    restore's job (crc32 per leaf)."""
    if not os.path.isdir(ckpt_dir):
        return []
    steps = []
    for d in os.listdir(ckpt_dir):
        if not d.startswith("step_"):
            continue
        try:
            step = int(d.split("_")[1])
        except (IndexError, ValueError):
            continue
        if _read_manifest(os.path.join(ckpt_dir, d)) is not None:
            steps.append(step)
    return sorted(steps)


def latest_step(ckpt_dir: str) -> int | None:
    """Newest step with a readable manifest (None when there is none)."""
    steps = valid_steps(ckpt_dir)
    return steps[-1] if steps else None


def _quarantine(ckpt_dir: str, step: int) -> None:
    """Rename a corrupt ``step_*`` dir to ``.corrupt_step_*`` so later
    ``valid_steps`` scans skip it without re-verifying. Best-effort: a
    failed rename (e.g. read-only fs) must not mask the original
    corruption."""
    src = os.path.join(ckpt_dir, f"step_{step:08d}")
    dst = os.path.join(ckpt_dir, f".corrupt_step_{step:08d}")
    try:
        if os.path.exists(dst):
            shutil.rmtree(dst)
        os.rename(src, dst)
    except OSError:
        pass


def _load(d: str, verify: bool) -> tuple[dict, dict]:
    """Load one checkpoint dir -> (flat leaves, manifest). Raises
    CheckpointCorruptError on any integrity failure."""
    manifest = _read_manifest(d)
    if manifest is None:
        raise CheckpointCorruptError(f"missing/unreadable manifest in {d}")
    loaded: dict[str, Any] = {}
    index = manifest["index"]
    for i in range(manifest["n_chunks"]):
        path = os.path.join(d, f"arrays_{i:02d}.npz")
        try:
            with np.load(path) as z:
                for k in z.files:
                    loaded[k.replace("::", "/")] = z[k]
        except (OSError, ValueError, EOFError, zlib.error,
                zipfile.BadZipFile) as e:
            raise CheckpointCorruptError(
                f"unreadable chunk {path}: {e}") from e
    for key, entry in index.items():
        if key not in loaded:
            raise CheckpointCorruptError(f"leaf {key!r} missing from {d}")
        v = loaded[key]
        want_crc = entry.get("crc32")  # absent in pre-integrity checkpoints
        if verify and want_crc is not None:
            got = crc32(v)
            if got != want_crc:
                raise CheckpointCorruptError(
                    f"crc mismatch for leaf {key!r} in {d}: "
                    f"{got:#010x} != {want_crc:#010x}")
        want = entry["dtype"]
        if str(v.dtype) != want:  # un-view the dtypes numpy lacks
            if want not in _BY_NAME:
                raise ValueError(f"leaf {key!r} in {d} has dtype {want!r}, "
                                 f"which this package cannot hold")
            dt, signed = _BY_NAME[want]
            v = torch.from_numpy(v).view(signed).view(dt)
        loaded[key] = v
    return loaded, manifest


def restore(ckpt_dir: str, step: int | None = None, *,
            device: "str | torch.device | None" = None, shardings=None,
            verify: bool = True, quarantine: bool = True) -> tuple[dict, dict]:
    """Returns (tree, meta). ``device``: place every leaf on it as a torch
    tensor (elastic restore onto the caller's device); None leaves numpy
    arrays, and CPU tensors for the dtypes numpy lacks. ``shardings``: a
    tree (matching the checkpoint's, possibly in part) of ``(mesh,
    placements)`` pairs, or a callable ``(path, value) -> (mesh,
    placements) or None``; each leaf it names becomes a DTensor on that
    mesh (every rank of the mesh restores the same checkpoint), the others
    follow ``device``.

    ``verify`` (default on) checks every leaf against its manifest crc32.
    With ``step=None`` the newest valid checkpoint is tried first and
    corrupt/partial dirs **fall back** to the next older one (the dir is
    quarantined — renamed ``.corrupt_step_*`` — unless
    ``quarantine=False``); an explicit ``step`` raises
    :class:`CheckpointCorruptError` instead of falling back.
    """
    if step is not None:
        loaded, manifest = _load(
            os.path.join(ckpt_dir, f"step_{step:08d}"), verify)
        return _finish(loaded, manifest, device, shardings)
    last_err: Exception | None = None
    for cand in reversed(valid_steps(ckpt_dir)):
        try:
            loaded, manifest = _load(
                os.path.join(ckpt_dir, f"step_{cand:08d}"), verify)
            return _finish(loaded, manifest, device, shardings)
        except CheckpointCorruptError as e:
            last_err = e
            if quarantine:
                _quarantine(ckpt_dir, cand)
    if last_err is not None:
        raise FileNotFoundError(
            f"no restorable checkpoint under {ckpt_dir} "
            f"(newest failures: {last_err})")
    raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")


def _finish(loaded: dict, manifest: dict, device, shardings) -> tuple[dict, dict]:
    if shardings is None:
        where = lambda path, v: None
    elif callable(shardings):
        where = shardings
    else:
        flat = {"/".join(map(str, path)): s for path, s in leaf_paths(shardings)}
        where = lambda path, v: flat.get(path)
    out = {}
    for k, v in loaded.items():
        target = where(k, v)
        if target is not None:
            mesh, pl = target
            v = distribute_tensor(torch.as_tensor(v), mesh, pl)
        elif device is not None:
            v = torch.as_tensor(v).to(device)
        out[tuple(k.split("/"))] = v
    return unflatten(out), manifest["meta"]
