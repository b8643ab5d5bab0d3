"""Distributed checkpoint; counterpart of
``paddle_tpu/distributed/checkpoint/__init__.py`` (ref:
``python/paddle/distributed/checkpoint/save_state_dict.py``,
``metadata.py``, ``load_state_dict.py``).

The JAX package saves global arrays through orbax from one controller.
Here each process is one rank and holds only its part of the state, so
this module keeps the reference's own design:

* **Pieces.**  ``save_state_dict`` lists what this rank holds of each
  global tensor (:mod:`.pieces`): a plain tensor whole, an mp-split
  parameter as its boxes (three for a packed ``[q | k | v]``), a ZeRO
  shard as a flat range of a parameter.  A model's ``state_dict()``
  reaches its live layout through the wrapper that split it
  (``parallel._mark_checkpoint_owner``: ``DataParallel``, the group-
  sharded stages, ``TensorParallel``); an optimizer's ``state_dict()``
  is remembered as that optimizer's, which lists its live accumulators
  by the parameter's structured name (a sharded optimizer its shards:
  the save gathers nothing).  Both are recorded in one table
  (``parallel._remember_checkpoint_owner``), so the save and the load
  read the live state behind a dict when they run, as for any torch
  state dict whose tensors share the live storage.  Python values
  (``GradScaler.state_dict()``'s, the optimizer's ``global_step``) go
  into the metadata.
* **On disk.**  A version directory holds one data file per rank
  (``<rank>_0.distcp``: the raw bytes of its pieces, one after another)
  and the metadata file ``0.metadata`` (JSON: each piece's key, global
  shape, dtype, boxes, range, file and offset; the values).  Ranks
  gather their pieces' descriptions first; a piece held the same on
  several ranks (a replicated tensor) is written once, by the lowest
  such rank.
* **Load.**  Each rank reads, for every piece it holds now, only the
  parts of the saved pieces that overlap it (each part read from its
  first byte to its last, so a rank holds one part at a time), and
  writes them in place (``copy_`` under ``no_grad``: the destination
  keeps its dtype and device), so any layout loads any other.  A load
  into a dict of copies (``GroupShardedStage3.state_dict()``) changes
  the copies only.

Kwarg semantics and the crash-safety layer are the JAX package's:

* ``async_save`` — this rank's pieces are copied to host memory before
  the call returns and written on a thread; ``wait_async_save()`` (a
  collective call; the next save or load of the same path joins too)
  commits.  A failed write raises :class:`AsyncSaveError` at the join —
  on every rank — so a later load can never silently read the previous
  version;
* ``unique_id`` — versioned save into ``path/<unique_id>``; load with
  ``unique_id=None`` picks the newest VALID version (below);
* ``process_group`` / ``coordinator_rank`` — the checkpoint spans every
  rank and rank 0 writes the metadata: another group or coordinator
  raises ``ValueError``, as the JAX package's ``_check_group_rank``;
* ``offload=True`` — each tensor of the dict is replaced by a CPU tensor
  holding the loaded values instead of being written in place (a live
  optimizer's or a ZeRO stage-3 model's state raises
  ``NotImplementedError``).

Crash safety (``paddle_tpu_torch.resilience``):

* every save ends with the coordinator writing the ``_COMMIT`` manifest
  atomically — every rank's piece digests (sha256 of dtype, shape and
  raw bytes, taken from the bytes written), gathered, and the caller's
  ``metadata`` — only after a collective proves every rank's data file
  has landed.  A rank that dies mid-save leaves a version without
  ``_COMMIT``: torn by construction;
* ``load_state_dict(unique_id=None)`` scans versions newest-first and
  skips uncommitted, unreadable or digest-mismatched versions with a
  warning (the digests are checked before anything is written, the
  pieces split over the ranks); legacy versions without a manifest
  still load, with a warning; an explicit ``unique_id`` whose digests
  mismatch raises ``ValueError``;
* ``keep_last_k=K`` on save (or :func:`gc_versions`) keeps the newest K
  committed versions and clears older ones plus stale torn versions;
* disk writes retry transient ``OSError`` (``resilience.with_retries``);
* the ``ckpt_write`` fault point sits in the torn window (this rank's
  data file written, ``_COMMIT`` not yet).
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import shutil
import threading
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ... import flags as _flags  # noqa: F401 — FLAGS_* env ingestion
from ...observability import events as obs_events
from ...observability import metrics as obs_metrics
from ...resilience.faults import maybe_fault
from ...resilience.retry import with_retries
from . import pieces as _pc

__all__ = ["save_state_dict", "load_state_dict", "wait_async_save",
           "AsyncSaveError", "read_commit", "latest_committed",
           "gc_versions", "last_load_info", "COMMIT_FILE"]

COMMIT_FILE = "_COMMIT"
COMMIT_SCHEMA_VERSION = 1
METADATA_FILE = "0.metadata"
_FORMAT = "paddle_tpu_torch.distcp"
_READ_BLOCK = 64 << 20           # bytes hashed per read at verification

# in-flight async saves: version dir -> {"thread", "box", "values",
# "meta", "keep_last_k", "base"} (joined and committed on demand)
_ASYNC_SAVES: Dict[str, Dict[str, Any]] = {}

# what the most recent load_state_dict restored (the version picked, its
# manifest metadata, the versions skipped); the resilient driver reads
# the resume step from here
_LAST_LOAD: Optional[Dict[str, Any]] = None


def _ckpt_hist(op: str):
    """Shared latency histogram for checkpoint I/O (save/commit/restore),
    one family across every checkpoint dir in the process."""
    return obs_metrics.histogram(
        "paddle_checkpoint_seconds",
        "checkpoint I/O wall time by operation",
        labels=("op",), buckets=obs_metrics.TIME_BUCKETS).labels(op=op)


class AsyncSaveError(RuntimeError):
    """A background (async_save=True) checkpoint save failed; raised at
    the join so the failure cannot be silently absorbed."""

    def __init__(self, path: str, cause: BaseException):
        super().__init__(f"async checkpoint save to {path!r} failed: "
                         f"{type(cause).__name__}: {cause}")
        self.path = path


# ---------------------------------------------------------------------------
# ranks
# ---------------------------------------------------------------------------

def _world() -> Tuple[int, int]:
    import torch.distributed as tdist
    if tdist.is_available() and tdist.is_initialized():
        return tdist.get_rank(), tdist.get_world_size()
    return 0, 1


def _gather(obj) -> list:
    """``obj`` of every rank, in rank order (a collective call)."""
    import torch.distributed as tdist
    rank, world = _world()
    if world == 1:
        return [obj]
    out = [None] * world
    tdist.all_gather_object(out, obj)
    return out


def _check_group_rank(process_group, coordinator_rank):
    if process_group is not None:
        raise ValueError(
            "paddle_tpu_torch checkpoints span every rank; per-group "
            "checkpointing is expressed by the state's own layout, not by "
            "passing process_group (got a non-None group)")
    if coordinator_rank != 0:
        raise ValueError(
            "the coordinator that writes the metadata and the commit "
            f"manifest is rank 0 (got {coordinator_rank})")


# ---------------------------------------------------------------------------
# version directories
# ---------------------------------------------------------------------------

def _versioned_path(path: str, unique_id) -> str:
    path = os.path.abspath(path)
    if unique_id is None:
        return path
    return os.path.join(path, str(unique_id))


def _is_checkpoint_dir(path: str) -> bool:
    """Does ``path`` itself hold checkpoint data (unversioned layout)?"""
    return any(os.path.exists(os.path.join(path, marker))
               for marker in (METADATA_FILE, COMMIT_FILE))


def _version_subdirs_newest_first(base: str) -> List[str]:
    """Version subdirectories of ``base``, newest first.  Numeric names
    order by value; non-numeric by mtime with a NAME tie-break, so two
    versions written within one mtime granule cannot flap between
    runs."""
    try:
        subs = [d for d in os.listdir(base)
                if os.path.isdir(os.path.join(base, d))]
    except OSError:
        return []

    def _key(d: str):
        try:
            return (1, int(d), d)
        except ValueError:
            try:
                mtime = os.path.getmtime(os.path.join(base, d))
            except OSError:
                mtime = 0.0
            return (0, mtime, d)

    return [os.path.join(base, d)
            for d in sorted(subs, key=_key, reverse=True)]


def _latest_version(path: str) -> str:
    """Legacy newest-version pick (no commit-marker requirement) — the
    fallback when no version carries a ``_COMMIT`` manifest."""
    if _is_checkpoint_dir(path):
        return path
    subs = _version_subdirs_newest_first(path)
    return subs[0] if subs else path


# ---------------------------------------------------------------------------
# commit manifest
# ---------------------------------------------------------------------------

def _commit_path(version_dir: str) -> str:
    return os.path.join(version_dir, COMMIT_FILE)


def _atomic_json(path: str, payload) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(payload, fh, sort_keys=True)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _write_commit(version_dir: str, digests: Dict[str, Any],
                  metadata: Optional[Dict[str, Any]]) -> None:
    """Atomic (tmp + rename) manifest write, retried on transient
    OSError — the commit marker is the ONE file whose presence means
    'this version is real'."""
    payload = {"v": COMMIT_SCHEMA_VERSION, "t": time.time(),
               "arrays": digests, "meta": dict(metadata or {})}
    with _ckpt_hist("commit").time() as t:
        with_retries(lambda: _atomic_json(_commit_path(version_dir),
                                          payload),
                     attempts=3, retry_on=(OSError,), label="ckpt_commit")
    obs_events.emit("ckpt_commit", dur_s=round(t.seconds, 6),
                    path=version_dir)


def read_commit(version_dir: str) -> Optional[Dict[str, Any]]:
    """The parsed ``_COMMIT`` manifest, or None when the version is
    uncommitted / the manifest is torn or schema-skewed (all of which
    mean: do not trust this version)."""
    try:
        with open(_commit_path(version_dir), "r", encoding="utf-8") as fh:
            payload = json.load(fh)
    except (OSError, ValueError):
        return None
    if not isinstance(payload, dict) or \
            payload.get("v") != COMMIT_SCHEMA_VERSION or \
            "arrays" not in payload:
        return None
    return payload


def latest_committed(path: str) -> Optional[Tuple[str, Dict[str, Any]]]:
    """Newest version under ``path`` with a valid commit manifest, as
    ``(version_dir, manifest)``; None when nothing is committed."""
    base = os.path.abspath(path)
    if _is_checkpoint_dir(base):
        manifest = read_commit(base)
        return (base, manifest) if manifest is not None else None
    for vdir in _version_subdirs_newest_first(base):
        manifest = read_commit(vdir)
        if manifest is not None:
            return vdir, manifest
    return None


def last_load_info() -> Optional[Dict[str, Any]]:
    """Details of the most recent ``load_state_dict`` in this process:
    ``{"source", "version", "committed", "metadata", "skipped"}``."""
    return dict(_LAST_LOAD) if _LAST_LOAD is not None else None


# ---------------------------------------------------------------------------
# retention GC
# ---------------------------------------------------------------------------

def gc_versions(path: str, keep_last_k: int) -> int:
    """Keep the newest ``keep_last_k`` committed versions; remove older
    committed versions AND torn (uncommitted) versions older than the
    newest committed one.  Versions with an in-flight async save are
    never touched.  Returns the number of version dirs removed."""
    if keep_last_k is None or int(keep_last_k) < 1:
        return 0
    base = os.path.abspath(path)
    if _is_checkpoint_dir(base):
        return 0                      # unversioned layout: nothing to GC
    subs = _version_subdirs_newest_first(base)
    committed = [p for p in subs if read_commit(p) is not None]
    keep = set(committed[:int(keep_last_k)])
    if not committed:
        return 0
    newest_committed_rank = subs.index(committed[0])
    removed = 0
    for rank, vdir in enumerate(subs):
        if vdir in keep or vdir in _ASYNC_SAVES:
            continue
        is_committed = read_commit(vdir) is not None
        # a torn version NEWER than the newest committed one may be a
        # save that is still landing out-of-band — leave it alone
        if not is_committed and rank <= newest_committed_rank:
            continue
        try:
            shutil.rmtree(vdir)
            removed += 1
        except OSError as e:
            warnings.warn(f"checkpoint GC could not remove {vdir!r}: {e}",
                          stacklevel=2)
    return removed


# ---------------------------------------------------------------------------
# the state dict's pieces
# ---------------------------------------------------------------------------

def _live_owner(d):
    """The optimizer whose ``state_dict()`` made ``d``, or None
    (``parallel._checkpoint_owners``: the one table of who made a
    dict)."""
    from ..parallel import _checkpoint_owners
    return next((o for _, o in _checkpoint_owners(d)
                 if not isinstance(o, torch.nn.Module)), None)


def _owner_params(d) -> Dict[str, torch.nn.Parameter]:
    """Key -> parameter of a model state dict made by a marked module."""
    from ..parallel import _checkpoint_owners
    out = {}
    for prefix, mod in _checkpoint_owners(d):
        if isinstance(mod, torch.nn.Module):
            for n, p in mod.named_parameters(remove_duplicate=False):
                out[prefix + n] = p
    return out


def _dicts(tree, prefix=""):
    """``(prefix, dict)`` of ``tree`` and of every dict inside it that
    is not an optimizer's live state dict (those are yielded too, not
    entered)."""
    yield prefix, tree
    if _live_owner(tree) is not None:
        return
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _dicts(v, f"{prefix}{k}.")


def _param_names(tree) -> Dict[int, str]:
    """id(parameter) -> its structured name (its key in its model state
    dict) for every optimizer of ``tree``: from the marked modules, else
    by the storage a plain model's state dict shares with it."""
    names: Dict[int, str] = {}
    by_ptr: Dict[tuple, str] = {}
    owners = []
    for _, d in _dicts(tree):
        owner = _live_owner(d)
        if owner is not None:
            owners.append(owner)
            continue
        for k, p in _owner_params(d).items():
            names.setdefault(id(p), str(k))
        for k, v in d.items():
            if isinstance(v, torch.Tensor) and v.numel():
                by_ptr.setdefault((v.data_ptr(), tuple(v.shape), v.dtype),
                                  str(k))
    for owner in owners:
        for group in owner.param_groups:
            for p in group["params"]:
                if id(p) not in names and p.numel():
                    name = by_ptr.get((p.data_ptr(), tuple(p.shape),
                                       p.dtype))
                    if name is not None:
                        names[id(p)] = name
    return names


def _collect(tree, offload: bool = False):
    """``(pieces, values, setters, owners, empty)`` of ``tree``: this
    rank's pieces of its tensors, its Python values by key, where each
    value lives (``(dict, key)``, for a load), the live optimizers
    (``(prefix, optimizer)``), whose pieces come from
    ``_checkpoint_pieces``, and the keys of empty tensors whose layout
    is unknown (a load must not pass them silently)."""
    from ..fleet.meta_parallel.parallel_layers.mp_layers import (
        _checkpoint_layout)
    from ..parallel import reducer_of
    out, values, setters, owners, empty = [], {}, {}, [], []
    for prefix, d in _dicts(tree):
        owner = _live_owner(d)
        if owner is not None:
            if offload:
                raise NotImplementedError(
                    "load_state_dict(offload=True) into an optimizer's live "
                    "state")
            owners.append((prefix, owner))
            continue
        params = _owner_params(d)
        stage3: Dict[int, tuple] = {}
        for k, v in list(d.items()):
            key = f"{prefix}{k}"
            if isinstance(v, dict) or v is None:
                continue
            if not isinstance(v, torch.Tensor):
                values[key] = v
                setters[key] = (d, k)
                continue
            p = params.get(str(k))
            red = reducer_of(p) if p is not None else None
            if red is not None and red.mode == "stage3":
                if offload:
                    raise NotImplementedError(
                        "load_state_dict(offload=True) into a ZeRO stage-3 "
                        "model's shards")
                stage3.setdefault(id(red), (red, []))[1].append((key, p))
                continue
            if offload:
                v = d[k] = torch.empty(v.shape, dtype=v.dtype, device="cpu")
            if not v.numel():
                empty.append(key)
                continue
            if p is not None:
                gshape, axis, boxes = _checkpoint_layout(p, v.shape)
                out.append(_pc.piece(key, v, v.shape, gshape, axis, boxes))
            else:
                out.append(_pc.whole(key, v))
        for red, keyed in stage3.values():
            out += red._checkpoint_pieces(keyed)
    return out, values, setters, owners, empty


def _owner_pieces(owners, names, create: bool):
    pieces, values = [], {}
    for prefix, owner in owners:
        pcs, vals = owner._checkpoint_pieces(prefix, names, create=create)
        pieces += pcs
        values.update(vals)
    return pieces, values


def _same(desc: dict) -> str:
    return json.dumps(desc, sort_keys=True)


# ---------------------------------------------------------------------------
# save
# ---------------------------------------------------------------------------

def _data_file(rank: int) -> str:
    return f"{rank}_0.distcp"


def _digest_bytes(dtype: str, numel: int, chunks) -> Dict[str, Any]:
    h = hashlib.sha256()
    h.update(dtype.encode())
    h.update(str((numel,)).encode())
    for c in chunks:
        h.update(c)
    return {"sha256": h.hexdigest(), "dtype": dtype, "shape": [numel]}


def _host_bytes(t: torch.Tensor) -> np.ndarray:
    """The raw bytes of a 1-D tensor, on the host."""
    t = t.detach()
    if t.device.type != "cpu":
        t = t.cpu()
    t = t.contiguous()
    if not t.numel():
        return np.zeros(0, dtype=np.uint8)
    return t.view(torch.uint8).numpy()


def _write_pieces(dest: str, rank: int, pieces) -> List[Dict[str, Any]]:
    """Write ``pieces``' data one after another into this rank's data
    file (each copied to the host in turn); their records (description,
    file, offset, bytes, digest)."""
    fname = _data_file(rank)

    def _write():
        records, off = [], 0
        with open(os.path.join(dest, fname), "wb") as f:
            for p in pieces:
                raw = _host_bytes(p.data)
                digest = _digest_bytes(p.dtype, p.numel, [raw])
                f.write(memoryview(raw))
                records.append(dict(p.desc(), file=fname, offset=off,
                                    nbytes=int(raw.nbytes), digest=digest))
                off += raw.nbytes
            f.flush()
            os.fsync(f.fileno())
        return records

    return with_retries(_write, attempts=2, retry_on=(OSError,),
                        label="ckpt_save")


def _piece_id(r: Dict[str, Any]) -> str:
    return f"{r['key']}@{r['file']}:{r['offset']}"


def _commit(dest: str, records, values, metadata, keep_last_k,
            base) -> None:
    """The collective end of a save: every rank's records gathered, the
    coordinator writes the metadata file and ``_COMMIT`` (then retention
    GC); no rank returns before the commit has landed."""
    rank, world = _world()
    everyone = _gather(records)
    if rank == 0:
        allrec = [r for rs in everyone for r in rs]
        meta = {"v": COMMIT_SCHEMA_VERSION, "format": _FORMAT,
                "world": world, "values": values,
                "pieces": [{k: v for k, v in r.items() if k != "digest"}
                           for r in allrec]}
        with_retries(lambda: _atomic_json(
            os.path.join(dest, METADATA_FILE), meta), attempts=3,
            retry_on=(OSError,), label="ckpt_metadata")
        _write_commit(dest, {_piece_id(r): r["digest"] for r in allrec},
                      metadata)
        if keep_last_k and base is not None:
            gc_versions(base, keep_last_k)
    _gather(0)


def _owned(everyone, rank: int) -> List[int]:
    """Indices of this rank's pieces it writes: a piece held the same on
    several ranks is written by the lowest of them."""
    first = {}
    for r, descs in enumerate(everyone):
        for d in descs:
            first.setdefault(_same(d), r)
    return [i for i, d in enumerate(everyone[rank])
            if first[_same(d)] == rank]


def wait_async_save(path: Optional[str] = None):
    """Join outstanding async saves — all of them, or those under `path`
    (prefix match, so waiting on the base dir joins versioned saves made
    with unique_id into ``path/<unique_id>``).  A collective call: every
    rank joins the same saves.

    On success each joined save gets its ``_COMMIT`` manifest (the save
    is only now durable) and its retention GC.  A failed background
    write on any rank raises :class:`AsyncSaveError` on every rank AFTER
    every other pending save has been joined — a crash in one save never
    orphans the others."""
    if path is None:
        keys = list(_ASYNC_SAVES)
    else:
        p = os.path.abspath(path)
        keys = [k for k in _ASYNC_SAVES
                if k == p or k.startswith(p + os.sep)]
    first_error: Optional[Tuple[str, BaseException]] = None
    for k in keys:
        pending = _ASYNC_SAVES.pop(k, None)
        if pending is None:
            continue
        pending["thread"].join()
        box = pending["box"]
        err = box.get("error")
        status = _gather(None if err is None else
                         f"{type(err).__name__}: {err}")
        bad = [(r, s) for r, s in enumerate(status) if s is not None]
        if bad:
            if first_error is None:
                first_error = (k, err if err is not None else RuntimeError(
                    f"rank {bad[0][0]}'s write failed: {bad[0][1]}"))
            continue                   # no commit marker: torn version
        _commit(k, box["records"], pending["values"], pending["meta"],
                pending["keep_last_k"], pending["base"])
    if first_error is not None:
        k, e = first_error
        raise AsyncSaveError(k, e) from e


def save_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id=None, async_save: bool = False,
                    metadata: Optional[Dict[str, Any]] = None,
                    keep_last_k: Optional[int] = None):
    """ref: checkpoint/save_state_dict.py — sharded save, a collective
    call: every rank writes its pieces (module docstring).

    ``metadata`` (e.g. ``{"step": 1234}``) is recorded in the ``_COMMIT``
    manifest; ``keep_last_k`` runs retention GC after the commit (only
    meaningful with ``unique_id`` versioning)."""
    _check_group_rank(process_group, coordinator_rank)
    rank, _ = _world()
    base = os.path.abspath(path)
    dest = _versioned_path(path, unique_id)
    wait_async_save(dest)  # one in-flight save per path
    if async_save:
        # bound in-flight saves: join the oldest beyond a small window so
        # a save-every-epoch loop can't accumulate writer threads
        while len(_ASYNC_SAVES) >= 4:
            wait_async_save(next(iter(_ASYNC_SAVES)))
    with _ckpt_hist("save").time() as t:
        tensors, values, _, owners, _ = _collect(state_dict)
        opt, opt_values = _owner_pieces(owners, _param_names(state_dict),
                                        create=False)
        tensors += opt
        values.update(opt_values)
        json.dumps(values)             # the values must be JSON
        descs = [p.desc() for p in tensors]
        mine = [tensors[i] for i in _owned(_gather(descs), rank)]
        if rank == 0:
            os.makedirs(dest, exist_ok=True)
            # a version saved again is torn until its new commit lands
            if os.path.exists(_commit_path(dest)):
                os.unlink(_commit_path(dest))
        _gather(0)
        if async_save:
            # the snapshot: this rank's pieces on the host now, so a
            # later update cannot reach the saved version
            snap = [_pc.Piece(**{**p.__dict__, "data":
                                 p.data.detach().to("cpu", copy=True)})
                    for p in mine]
            box: Dict[str, Any] = {}

            def _run():
                try:
                    box["records"] = _write_pieces(dest, rank, snap)
                except Exception as e:  # noqa: PTL401 — stored, then
                    # raised at the join as AsyncSaveError
                    box["error"] = e
            thread = threading.Thread(target=_run, daemon=True,
                                      name="ckpt-async-save")
            thread.start()
            _ASYNC_SAVES[dest] = {
                "thread": thread, "box": box, "values": values,
                "meta": metadata, "keep_last_k": keep_last_k,
                "base": base if unique_id is not None else None}
        else:
            records = _write_pieces(dest, rank, mine)
    # dur_s of an async save is the snapshot's; the durable commit is
    # the ckpt_commit event at the join
    obs_events.emit("ckpt_save", dur_s=round(t.seconds, 6), path=dest,
                    version=str(unique_id) if unique_id is not None
                    else None, async_save=bool(async_save),
                    arrays=len(descs))
    # the torn window: this rank's data is on disk (or in flight), the
    # _COMMIT is not — a crash or injected damage here is exactly what a
    # load must survive
    maybe_fault("ckpt_write", path=dest)
    if not async_save:
        _commit(dest, records, values, metadata, keep_last_k,
                base if unique_id is not None else None)


# ---------------------------------------------------------------------------
# load
# ---------------------------------------------------------------------------

def _read_metadata(src: str) -> Dict[str, Any]:
    """The version's metadata, its data files checked present and long
    enough (a missing or truncated file raises)."""
    with open(os.path.join(src, METADATA_FILE), "r",
              encoding="utf-8") as fh:
        meta = json.load(fh)
    if not isinstance(meta, dict) or meta.get("format") != _FORMAT:
        raise ValueError(f"{src!r} holds no {_FORMAT} checkpoint")
    need: Dict[str, int] = {}
    for r in meta["pieces"]:
        need[r["file"]] = max(need.get(r["file"], 0),
                              r["offset"] + r["nbytes"])
    for fname, n in need.items():
        size = os.path.getsize(os.path.join(src, fname))
        if size < n:
            raise OSError(f"data file {fname!r} holds {size} bytes, its "
                          f"pieces need {n}")
    return meta


def _file_digest(src: str, r: Dict[str, Any]) -> str:
    with open(os.path.join(src, r["file"]), "rb") as f:
        f.seek(r["offset"])
        left = r["nbytes"]

        def blocks():
            nonlocal left
            while left > 0:
                b = f.read(min(left, _READ_BLOCK))
                if not b:
                    raise OSError("short read")
                left -= len(b)
                yield b
        return _digest_bytes(r["dtype"], r["hi"] - r["lo"],
                             blocks())["sha256"]


def _digest_mismatches(src: str, meta, manifest) -> List[str]:
    """Names whose saved bytes do not match the committed digests
    (missing pieces count as mismatches).  The pieces are split over the
    ranks, each hashing its share from the files (a collective call)."""
    rank, world = _world()
    recs = {_piece_id(r): r for r in meta["pieces"]}
    want = manifest.get("arrays", {})
    bad = []
    for i, (pid, d) in enumerate(sorted(want.items())):
        if i % world != rank:
            continue
        r = recs.get(pid)
        if r is None:
            bad.append(pid + " (missing)")
            continue
        try:
            got = _file_digest(src, r)
        except OSError:
            got = None
        if got != d.get("sha256"):
            bad.append(pid)
    return sorted(b for part in _gather(bad) for b in part)


def _read_region(fd: int, at: int, npdt, bshape, bsl, sreg) -> np.ndarray:
    """``block[bsl][sreg]`` of the row-major block of ``bshape`` whose
    first element is at byte ``at`` of the file ``fd``, reading only the
    bytes from the region's first element to its last."""
    es = np.dtype(npdt).itemsize
    starts, lens = [], []
    for n, b, r in zip(bshape, bsl, sreg):
        b0, b1, _ = b.indices(n)
        r0, r1, _ = r.indices(b1 - b0)
        starts.append(b0 + r0)
        lens.append(r1 - r0)
    strides = [math.prod(bshape[d + 1:]) for d in range(len(bshape))]
    first = sum(s * st for s, st in zip(starts, strides))
    last = sum((s + n - 1) * st for s, n, st in zip(starts, lens, strides))
    buf = np.empty((last - first + 1) * es, dtype=np.uint8)
    view, done = memoryview(buf), 0
    while done < buf.nbytes:
        got = os.preadv(fd, [view[done:]], at + first * es + done)
        if not got:
            raise OSError(f"short read at byte {at + first * es + done}")
        done += got
    return np.lib.stride_tricks.as_strided(
        buf.view(npdt), shape=lens, strides=[st * es for st in strides])


def _copy_overlaps(dst_pieces, saved, src: str, fds) -> None:
    """Write into each destination piece the parts of the saved pieces
    of its key that overlap it (``fds``: the data files opened so far,
    by name)."""
    for dp in dst_pieces:
        srcs = saved.get(dp.key)
        if not srcs:
            continue                       # not in this checkpoint
        if tuple(srcs[0][0].gshape) != tuple(dp.gshape):
            raise ValueError(
                f"checkpoint {src!r}: '{dp.key}' has global shape "
                f"{list(srcs[0][0].gshape)}, the destination "
                f"{list(dp.gshape)}")
        dchunks = _pc.chunks(dp)
        covered = 0
        for sp, r in srcs:
            npdt = _pc.numpy_dtype(sp.dtype)
            es = np.dtype(npdt).itemsize
            fd = fds.get(r["file"])
            if fd is None:
                fd = fds[r["file"]] = os.open(os.path.join(src, r["file"]),
                                              os.O_RDONLY)
            for dc, sc, dreg, sreg in _pc.overlaps(dchunks, _pc.chunks(sp)):
                _, _, start, bshape, bsl = sc
                arr = np.ascontiguousarray(_read_region(
                    fd, r["offset"] + start * es, npdt, bshape, bsl, sreg))
                t = torch.from_numpy(arr)
                if sp.dtype == "bfloat16":
                    t = t.view(torch.bfloat16)
                _pc.block_view(dp.data, dc)[dreg].copy_(t)
                covered += arr.size
        if covered != dp.numel:
            raise ValueError(
                f"checkpoint {src!r}: the saved pieces of '{dp.key}' cover "
                f"{covered} of the {dp.numel} elements this rank holds")


@torch.no_grad()
def _restore(state_dict, src: str, meta, offload: bool) -> None:
    saved: Dict[str, list] = {}
    for r in meta["pieces"]:
        saved.setdefault(r["key"], []).append((_pc.Piece.from_desc(r), r))
    fds: Dict[str, int] = {}
    names = _param_names(state_dict)
    tensors, _, setters, owners, empty = _collect(state_dict,
                                                   offload=offload)
    lost = [k for k in empty
            if any(math.prod(p.gshape) for p, _ in saved.get(k, ()))]
    if lost:
        raise ValueError(
            f"checkpoint {src!r}: the destination's {', '.join(lost[:4])} "
            "hold no elements (a ZeRO stage-3 model's parameters between "
            "steps): pass the state_dict() of the model the wrapper wraps")
    try:
        _copy_overlaps(tensors, saved, src, fds)
        # the optimizers after the model: a state made now starts from
        # the loaded parameters
        opt, _ = _owner_pieces(owners, names, create=True)
        _copy_overlaps(opt, saved, src, fds)
    finally:
        for fd in fds.values():
            os.close(fd)
    vals = meta.get("values", {})
    for key, (d, k) in setters.items():
        if key in vals:
            d[k] = vals[key]
    for prefix, owner in owners:
        key = prefix + "global_step"
        if key in vals:
            getattr(owner, "_inner_opt", owner)._global_step = \
                int(vals[key])


def _select(base: str, verify: bool):
    """Newest-first scan over committed versions; returns
    ``(src, manifest_or_None, meta, skipped)`` — skipping torn,
    unreadable, and digest-mismatched versions with a warning each."""
    skipped: List[str] = []
    if _is_checkpoint_dir(base):
        candidates = [base]
    else:
        candidates = _version_subdirs_newest_first(base) or [base]
    any_committed = False
    for vdir in candidates:
        manifest = read_commit(vdir)
        if manifest is None:
            if vdir != base:
                warnings.warn(
                    f"checkpoint version {vdir!r} has no {COMMIT_FILE} "
                    "manifest (torn or in-flight save) — skipping",
                    stacklevel=3)
                skipped.append(vdir)
            continue
        any_committed = True
        try:
            meta = _read_metadata(vdir)
            err = None
        except (OSError, ValueError, KeyError) as e:
            err = e
        # every rank must agree before any of them moves on
        errs = _gather(None if err is None else
                       f"{type(err).__name__}: {err}")
        err = next((e for e in errs if e is not None), None)
        if err is not None:
            warnings.warn(
                f"checkpoint version {vdir!r} is committed but failed to "
                f"restore ({err}) — skipping", stacklevel=3)
            skipped.append(vdir)
            continue
        if verify:
            bad = _digest_mismatches(vdir, meta, manifest)
            if bad:
                warnings.warn(
                    f"checkpoint version {vdir!r} failed digest "
                    f"verification for {', '.join(sorted(bad)[:4])}"
                    f"{'…' if len(bad) > 4 else ''} — skipping",
                    stacklevel=3)
                skipped.append(vdir)
                continue
        return vdir, manifest, meta, skipped
    # nothing committed+valid: legacy fallback (checkpoints written
    # before commit markers existed), loud but functional
    legacy = _latest_version(base)
    if any_committed or skipped:
        warnings.warn(
            f"no committed checkpoint version under {base!r} survived "
            f"validation; falling back to newest-by-name {legacy!r}",
            stacklevel=3)
    return legacy, None, _read_metadata(legacy), skipped


def load_state_dict(state_dict: Dict[str, Any], path: str,
                    process_group=None, coordinator_rank: int = 0,
                    unique_id=None, offload: bool = False,
                    verify: bool = True):
    """ref: checkpoint/load_state_dict.py — loads INTO the given
    state_dict, in place, resharding each saved tensor to the layout the
    destination holds now (a collective call; module docstring).

    ``unique_id=None`` picks the newest VALID version (committed +
    digest-clean), skipping torn ones with a warning.  An explicit
    ``unique_id`` is honored verbatim, but a digest mismatch on a
    committed version raises (the caller asked for THIS version; giving
    them silently corrupt bytes is worse than failing)."""
    global _LAST_LOAD
    _check_group_rank(process_group, coordinator_rank)
    wait_async_save()  # a pending async save must land before any load;
    #                    a FAILED one raises here instead of letting this
    #                    load silently read the previous version
    base = os.path.abspath(path)
    skipped: List[str] = []
    with _ckpt_hist("restore").time() as _t:
        if unique_id is not None:
            src = _versioned_path(path, unique_id)
            manifest = read_commit(src)
            meta = _read_metadata(src)
            if manifest is not None and verify:
                bad = _digest_mismatches(src, meta, manifest)
                if bad:
                    raise ValueError(
                        f"checkpoint version {src!r} failed digest "
                        f"verification for: {', '.join(sorted(bad))}")
            elif manifest is None:
                warnings.warn(
                    f"loading explicitly-requested checkpoint {src!r} "
                    f"with no {COMMIT_FILE} manifest (pre-commit-marker "
                    "save, or torn)", stacklevel=2)
        else:
            src, manifest, meta, skipped = _select(base, verify)
        _restore(state_dict, src, meta, offload)
    obs_events.emit("ckpt_restore", dur_s=round(_t.seconds, 6),
                    path=base,
                    version=os.path.basename(src) if src != base
                    else None,
                    committed=manifest is not None,
                    skipped=len(skipped))
    _LAST_LOAD = {
        "source": src,
        "version": os.path.basename(src) if src != base else None,
        "committed": manifest is not None,
        "metadata": dict(manifest.get("meta", {})) if manifest else {},
        "skipped": list(skipped),
    }
    return state_dict
