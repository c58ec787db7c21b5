"""Async sharded checkpoint service (counterpart of
``mxnet_tpu/checkpoint.py``): the same ``mxnet_tpu-checkpoint-v2``
layout, commit protocol, environment switches, fault-injection sites
and telemetry, with a CUDA snapshot.

Checkpoint/restore is the failure-handling design: a preempted worker
loses at most the work since the last *published* checkpoint, and a
restarted worker resumes from it.  Three phases, only the first on the
step path::

    step path          background writer thread
    ---------          ------------------------------------------
    ckpt.snapshot  ─▶  ckpt.serialize            ─▶  ckpt.commit
    (device copy of    (waits for the copy, one      (manifest
     every leaf + one   shard file per device         written last,
     D2H launch into    written + fsynced to a tmp    tmp dir renamed
     pinned memory)     dir, SHA-256 a file)          into place,
                                                      parent fsynced)

- **snapshot** (CUDA leaves) copies every leaf into a 16-byte aligned
  slice of one flat device buffer with one ``torch._foreach_copy_`` on
  the current stream — the stream the trainers' graphs replay on, so
  the copy is ordered after the step that produced the values — then
  one ``non_blocking`` copy of that buffer into a pinned host twin on a
  side stream that waits on an event recorded after the device copy.
  The host does not wait for either.  Both buffers are made at the
  first save of a device and reused; the next snapshot waits until the
  writer has finished reading the previous one (``Snapshot.release``).
  Host tensors and numpy arrays are copied at once.  ``snapshot_ms``
  (the host's time in ``snapshot``) is the only cost on the step path.
- **serialize** runs on the writer thread: it waits on the copy's
  completion event (never on ``torch.cuda.synchronize()``), then writes
  one ``shard-d<device>.npz`` with every leaf's slice, recording each
  leaf's global shape and slice in the manifest, so that ``load``
  reassembles global arrays from any shard layout (a checkpoint the
  reference wrote on an 8-device mesh, one slice per owning device,
  loads here).  Types numpy lacks (bfloat16, fp8) are stored as their
  bit patterns.  Every shard file's SHA-256 goes into the manifest and
  is checked on every load and by the background verifier
  (``checkpoint_gc``).
- **commit** writes ``manifest.json`` last inside the tmp dir, then
  publishes by renames: ``tag`` → ``tag.old``, tmp → ``tag``, and
  ``tag.old`` retires into the ``step-<n>`` history (keep-last-N GC).
  Some complete checkpoint is loadable at every instant, even after a
  kill between the two renames.  The parent directory is fsynced after
  the renames.

**Multi-process commit barrier** (``world > 1``): every rank writes its
shards into the same tmp dir (``shard-r<rank>-…``), fsyncs them and
writes a ``commit-r<rank>.ready`` marker with its manifest fragment;
only rank 0 publishes, after waiting (``MXNET_CKPT_BARRIER_TIMEOUT_S``)
for every marker of the same commit id.  The other ranks wait for the
published manifest the same way and raise ``MXNetError`` on expiry.
Rank/world resolve per save: explicit arguments >
``MXNET_CKPT_RANK``/``MXNET_CKPT_WORLD`` > :func:`set_rank` >
``torch.distributed`` when it is initialized > (0, 1).

Failure semantics: transient IO errors retry ``MXNET_CKPT_RETRIES``
times with ``MXNET_CKPT_BACKOFF_MS`` exponential backoff (a barrier
expiry does not retry); a save that still fails increments
``checkpoint.failures`` and logs.  An *async* save never raises into
the training step; a *blocking* save raises ``MXNetError``.  Every
IO/commit site calls ``faultinject.fire``.

Telemetry: ``checkpoint.save_ms`` (serialize + commit, writer thread),
``checkpoint.snapshot_ms`` (the step path's cost),
``checkpoint.barrier_wait_ms``, ``checkpoint.bytes``,
``checkpoint.saves`` / ``failures`` / ``coalesced``; spans
``ckpt.snapshot`` / ``ckpt.serialize`` / ``ckpt.commit``.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import re
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as onp
import torch

from . import faultinject
from . import telemetry
from . import tracing
from .base import (MXNetError, getenv, getenv_bool, numpy_bits,
                   tensor_from_bits)

__all__ = ["snapshot", "save", "load", "wait_pending", "Snapshot",
           "PendingSave", "FORMAT", "MANIFEST", "set_rank", "rank_world",
           "step_history"]

FORMAT = "mxnet_tpu-checkpoint-v2"
MANIFEST = "manifest.json"
_STEP_TAG_RE = re.compile(r"step-(\d+)$")

# created at import so that the metrics read zero before the first save
_C_SAVES = telemetry.counter("checkpoint.saves")
_C_FAILURES = telemetry.counter("checkpoint.failures")
_C_COALESCED = telemetry.counter("checkpoint.coalesced")
_C_BYTES = telemetry.counter("checkpoint.bytes")
_H_SAVE_MS = telemetry.histogram("checkpoint.save_ms")
_H_SNAP_MS = telemetry.histogram("checkpoint.snapshot_ms")
_H_BARRIER_MS = telemetry.histogram("checkpoint.barrier_wait_ms")
_C_BARRIER_MS = telemetry.counter("checkpoint.barrier_wait_ms_total")


def _observe_barrier_wait(t0: float) -> None:
    ms = (time.perf_counter() - t0) * 1e3
    _H_BARRIER_MS.observe(ms)
    _C_BARRIER_MS.inc(ms)


def async_enabled() -> bool:
    """``MXNET_CKPT_ASYNC`` (default on): serialize and publish on the
    writer thread; ``0`` makes every save block."""
    return getenv_bool("MXNET_CKPT_ASYNC", True)


def _env_number(name: str, default, cast, what: str):
    v = getenv(name)
    if v is None or v == "":
        return default
    try:
        return max(cast(0), cast(v))
    except ValueError:
        raise MXNetError(f"invalid {name}={v!r}; expected {what}") from None


def _retries() -> int:
    return _env_number("MXNET_CKPT_RETRIES", 3, int, "an integer")


def _backoff_s() -> float:
    return _env_number("MXNET_CKPT_BACKOFF_MS", 50.0, float,
                       "a number") / 1e3


def _barrier_timeout_s() -> float:
    return _env_number("MXNET_CKPT_BARRIER_TIMEOUT_S", 120.0, float,
                       "a number of seconds")


def _logger():
    from .log import get_logger
    return get_logger("mxnet_tpu_torch.checkpoint")


# -- rank/world plumbing ----------------------------------------------------

_rank_override: Optional[Tuple[int, int]] = None


def set_rank(rank: int, world: int) -> None:
    """Register this process's (rank, world size) for the commit
    barrier.  ``MXNET_CKPT_RANK`` / ``MXNET_CKPT_WORLD`` still win."""
    global _rank_override
    _rank_override = (int(rank), max(1, int(world)))


def rank_world() -> Tuple[int, int]:
    """(rank, world) a save uses when it is not given them: the
    environment, else :func:`set_rank`, else ``torch.distributed`` when
    it is initialized, else (0, 1) — no barrier."""
    r, w = getenv("MXNET_CKPT_RANK"), getenv("MXNET_CKPT_WORLD")
    if r not in (None, ""):
        try:
            return int(r), max(1, int(w or "1"))
        except ValueError:
            raise MXNetError(
                f"invalid MXNET_CKPT_RANK={r!r}/MXNET_CKPT_WORLD={w!r}; "
                f"expected integers") from None
    if _rank_override is not None:
        return _rank_override
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


# -- snapshot (the only step-path phase) ------------------------------------

class _LeafSnap:
    """One leaf: its global shape, dtype name and shards
    ``[(start, stop, device index, host array)]``; a host array holds
    the stored form (bit patterns for types numpy lacks)."""

    __slots__ = ("shape", "dtype", "shards")

    def __init__(self, shape, dtype, shards):
        self.shape = shape
        self.dtype = dtype
        self.shards = shards


class _Staging:
    """A device's snapshot buffers: one flat device buffer, its pinned
    host twin and the side stream that copies one into the other.
    ``free`` is set while no snapshot holds them."""

    def __init__(self, device: torch.device, nbytes: int):
        self.device = device
        self.dev = torch.empty(nbytes, dtype=torch.uint8, device=device)
        self.host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        self.stream = torch.cuda.Stream(device)
        self.free = threading.Event()
        self.free.set()


_STAGING: Dict[torch.device, _Staging] = {}
_STAGING_LOCK = threading.Lock()


def _acquire_staging(device: torch.device, nbytes: int) -> _Staging:
    """The device's buffers, at least ``nbytes`` long, once the writer has
    released them (made, or made larger, here)."""
    with _STAGING_LOCK:
        stg = _STAGING.get(device)
    if stg is not None:
        stg.free.wait()
        stg.free.clear()
        if stg.dev.numel() >= nbytes:
            return stg
        stg.free.set()
    stg = _STAGING[device] = _Staging(device, nbytes)
    stg.free.clear()
    return stg


def staging_bytes() -> int:
    """Device bytes the snapshot buffers hold (each has a pinned host
    twin of the same size)."""
    return sum(s.dev.numel() for s in _STAGING.values())


def _align(n: int) -> int:
    return (n + 15) // 16 * 16


class Snapshot:
    """A consistent host copy of one flat tree, safe against later
    in-place updates of the tensors it was taken from.  CUDA leaves are
    readable once :meth:`materialize` returns; the writer calls
    :meth:`release` once it has read them."""

    def __init__(self, leaves: Dict[str, _LeafSnap], header: dict,
                 pending=()):
        self.leaves = leaves
        self.header = dict(header or {})
        # [(staging, completion event)] of the CUDA copies in flight
        self._pending = list(pending)

    def nbytes(self) -> int:
        return sum(int(d.nbytes) for leaf in self.leaves.values()
                   for (_, _, _, d) in leaf.shards)

    def materialize(self) -> None:
        """Wait for the device-to-host copies (their events only)."""
        for _, done in self._pending:
            done.synchronize()

    def release(self) -> None:
        """Hand the staging buffers to the next snapshot (after the
        copies have landed)."""
        pending, self._pending = self._pending, []
        for stg, done in pending:
            done.synchronize()
            stg.free.set()

    def __del__(self):
        try:
            self.release()
        except Exception:                   # noqa: BLE001 (interpreter exit)
            pass


def _host_leaf(t) -> _LeafSnap:
    """A host tensor or array (a copy: the owner may update it)."""
    if isinstance(t, torch.Tensor):
        host, name = numpy_bits(t.detach().clone())
    else:
        host = onp.array(t)
        name = host.dtype.name
    shape = tuple(host.shape)
    return _LeafSnap(shape, name, [((0,) * len(shape), shape, 0, host)])


def _device_copy(named: List[Tuple[str, torch.Tensor]], leaves: dict):
    """Every CUDA leaf of one device into the staging buffers (one fused
    device copy, one D2H launch); fills ``leaves`` with host views of the
    pinned buffer and returns ``(staging, completion event)``."""
    dev = named[0][1].device
    offsets, total = [], 0
    for _, t in named:
        offsets.append(total)
        total += _align(t.numel() * t.element_size())
    stg = _acquire_staging(dev, max(total, 16))

    def view(buf, off, t):
        n = t.numel() * t.element_size()
        return buf[off:off + n].view(t.dtype).view(t.shape)

    with torch.cuda.device(dev):
        torch._foreach_copy_([view(stg.dev, o, t)
                              for o, (_, t) in zip(offsets, named)],
                             [t.detach() for _, t in named])
        ready = torch.cuda.Event()
        ready.record()
        with torch.cuda.stream(stg.stream):
            stg.stream.wait_event(ready)
            stg.host[:total].copy_(stg.dev[:total], non_blocking=True)
            done = torch.cuda.Event()
            done.record(stg.stream)
    for o, (name, t) in zip(offsets, named):
        host, dtype = numpy_bits(view(stg.host, o, t))
        shape = tuple(t.shape)
        leaves[name] = _LeafSnap(shape, dtype, [
            ((0,) * len(shape), shape, dev.index or 0, host)])
    return stg, done


def snapshot(tree: Dict[str, Any], header: Optional[dict] = None) -> Snapshot:
    """Capture ``tree`` (flat name → tensor, NDArray or array) for a
    save without waiting for the device: CUDA leaves go through one
    device copy and one asynchronous copy to pinned memory per device
    (see the module doc), ordered after the work already queued on the
    current stream; host leaves are copied at once."""
    t0 = time.perf_counter()
    with tracing.span("ckpt.snapshot", leaves=len(tree)):
        leaves: Dict[str, _LeafSnap] = {}
        by_dev: Dict[torch.device, List[Tuple[str, torch.Tensor]]] = {}
        for name, arr in tree.items():
            arr = getattr(arr, "_data", arr)        # NDArray → tensor
            if isinstance(arr, torch.Tensor) and arr.is_cuda:
                by_dev.setdefault(arr.device, []).append((name, arr))
            else:
                leaves[name] = _host_leaf(arr)
        pending = [_device_copy(named, leaves) for named in by_dev.values()]
        leaves = {name: leaves[name] for name in tree}      # tree order
    _H_SNAP_MS.observe((time.perf_counter() - t0) * 1e3)
    return Snapshot(leaves, header, pending)


# -- serialize + commit (writer thread) -------------------------------------

def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise MXNetError(f"checkpoint leaf of unknown dtype {name!r}")
    return dt


def _fsync_dir(path: str) -> None:
    """Make renames/creates IN ``path`` durable: fsyncing a file does
    not persist its directory entry (satellite of the rename
    protocol's durability claim).  Best-effort on platforms where
    directories can't be opened."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _serialize_shards(snap: Snapshot, tmp: str, rank: int, world: int
                      ) -> Tuple[int, Dict[str, dict], Dict[str, dict]]:
    """Write THIS rank's shard files into ``tmp`` (created if needed;
    a multi-rank save shares the dir, so nothing here deletes other
    ranks' files).  Returns ``(payload_bytes, leaves_fragment,
    files_fragment)``: the manifest pieces this rank contributes."""
    os.makedirs(tmp, exist_ok=True)
    snap.materialize()
    prefix = f"shard-r{rank}-d" if world > 1 else "shard-d"
    by_dev: Dict[int, Dict[str, onp.ndarray]] = {}
    leaves_frag: Dict[str, dict] = {}
    nbytes = 0
    for name, leaf in snap.leaves.items():
        entries = []
        for start, stop, dev, host in leaf.shards:
            arrays = by_dev.setdefault(dev, {})
            key = f"a{len(arrays)}"                 # the manifest maps it
            arrays[key] = host
            nbytes += int(host.nbytes)
            entries.append({"file": f"{prefix}{dev}.npz", "key": key,
                            "start": list(start), "stop": list(stop)})
        leaves_frag[name] = {"shape": list(leaf.shape),
                             "dtype": leaf.dtype, "shards": entries}
    files_frag: Dict[str, dict] = {}
    for dev, arrays in by_dev.items():
        fname = f"{prefix}{dev}.npz"
        fpath = os.path.join(tmp, fname)
        faultinject.fire("shard_write", rank=rank, file=fname)
        with open(fpath, "wb") as f:
            onp.savez(f, **arrays)
            f.flush()
            faultinject.fire("fsync", rank=rank, file=fname)
            os.fsync(f.fileno())
        # the digest of the bytes on disk, which load and the verifier
        # hash again
        files_frag[fname] = {"sha256": _sha256_file(fpath),
                             "bytes": os.path.getsize(fpath)}
    _fsync_dir(tmp)
    return nbytes, leaves_frag, files_frag


def _write_manifest(tmp: str, doc: dict, rank: int) -> None:
    """Manifest written last + fsynced: its presence marks the shard
    set complete, so a torn serialize can never masquerade as a
    checkpoint."""
    faultinject.fire("manifest_write", rank=rank)
    mpath = os.path.join(tmp, MANIFEST)
    with open(mpath + ".tmp", "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(mpath + ".tmp", mpath)
    _fsync_dir(tmp)


def _marker_name(rank: int) -> str:
    return f"commit-r{rank}.ready"


def _write_marker(tmp: str, rank: int, commit: str, nbytes: int,
                  leaves_frag: dict, files_frag: dict) -> None:
    """Per-rank readiness signal of the commit barrier: written (and
    fsynced) only AFTER this rank's shard files are durable, carrying
    the rank's manifest fragment so rank 0 can assemble the full
    manifest without re-reading anything."""
    faultinject.fire("marker_write", rank=rank)
    doc = {"format": FORMAT, "rank": rank, "commit": commit,
           "nbytes": int(nbytes), "leaves": leaves_frag,
           "files": files_frag}
    path = os.path.join(tmp, _marker_name(rank))
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(path + ".tmp", path)
    _fsync_dir(tmp)


class _BarrierTimeout(MXNetError):
    """Commit-barrier expiry: a peer never signalled (or rank 0 never
    published).  Deliberately NOT retried — the peer is dead or
    partitioned, not transiently slow; retrying would just double the
    wait while the training step stalls behind a blocking save."""


def _rank_health_hint(missing) -> str:
    """One clause of clustermon's rank health for a barrier timeout: was
    a missing rank already degraded or demoted before the barrier gave
    up on it?  Runs only on the failure path; empty when no aggregator
    runs in this process."""
    try:
        from . import clustermon
        health = clustermon.rank_health()
    except Exception:
        return ""
    parts = []
    for r in sorted(missing):
        h = health.get(r)
        if h is None:
            continue
        status = h.get("status", "?")
        if h.get("cause"):
            status += f"({h['cause']})"
        parts.append(f"rank {r}: {status}, last spool step "
                     f"{h.get('last_rank_step', 0)} "
                     f"{h.get('since_s', 0.0):.0f}s ago")
    return ("; clustermon rank health: " + "; ".join(parts)) if parts \
        else ""


def _collect_markers(tmp: str, world: int, commit: str,
                     timeout: float, rank: int) -> Dict[int, dict]:
    """Rank 0's half of the barrier: bounded wait for every non-zero
    rank's ready marker of THIS commit (stale markers from a crashed
    earlier save carry a different commit id and are ignored)."""
    faultinject.fire("barrier_wait", rank=rank)
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    missing = set(range(1, world))
    frags: Dict[int, dict] = {}
    with tracing.span("ckpt.barrier", world=world, commit=commit):
        while missing:
            for r in sorted(missing):
                path = os.path.join(tmp, _marker_name(r))
                try:
                    with open(path) as f:
                        doc = json.load(f)
                except (OSError, ValueError):
                    continue            # absent or mid-write
                if doc.get("format") != FORMAT or \
                        str(doc.get("commit")) != str(commit):
                    continue            # stale marker from an old save
                frags[r] = doc
                missing.discard(r)
            if not missing:
                break
            if time.monotonic() >= deadline:
                raise _BarrierTimeout(
                    f"rank 0 commit barrier timed out after {timeout}s "
                    f"waiting for ready markers from rank(s) "
                    f"{sorted(missing)} (commit {commit!r}) — NOT "
                    f"publishing; the previous checkpoint stays live"
                    + _rank_health_hint(missing))
            time.sleep(0.02)
    _observe_barrier_wait(t0)
    return frags


def _await_publish(directory: str, tag: str, commit: str,
                   timeout: float, rank: int) -> str:
    """Non-zero ranks' half of the barrier: bounded wait for rank 0's
    published manifest of THIS commit."""
    faultinject.fire("barrier_wait", rank=rank)
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    final = os.path.join(directory, tag)
    mpath = os.path.join(final, MANIFEST)
    with tracing.span("ckpt.barrier", rank=rank, commit=commit):
        while True:
            try:
                with open(mpath) as f:
                    doc = json.load(f)
                if doc.get("format") == FORMAT and \
                        str(doc.get("commit")) == str(commit):
                    break
            except (OSError, ValueError):
                pass                    # not published yet / mid-swap
            if time.monotonic() >= deadline:
                raise _BarrierTimeout(
                    f"rank {rank} timed out after {timeout}s waiting "
                    f"for rank 0 to publish {final!r} (commit "
                    f"{commit!r}) — coordinator dead or partitioned")
            time.sleep(0.05)
    _observe_barrier_wait(t0)
    return final


def _merge_fragments(own_leaves: dict, own_files: dict,
                     frags: Dict[int, dict]) -> Tuple[dict, dict, int]:
    """Assemble the full manifest from rank 0's fragment plus every
    marker's.  Replicated leaves appear in several fragments with the
    same slice — deduped; partitioned leaves contribute disjoint
    slices that tile the global array."""
    leaves = {k: dict(v, shards=list(v["shards"]))
              for k, v in own_leaves.items()}
    files = dict(own_files)
    extra = 0
    for r in sorted(frags):
        doc = frags[r]
        for name, leaf in (doc.get("leaves") or {}).items():
            if name not in leaves:
                leaves[name] = dict(leaf, shards=list(leaf["shards"]))
                continue
            base = leaves[name]
            if list(base["shape"]) != list(leaf["shape"]) or \
                    base["dtype"] != leaf["dtype"]:
                raise MXNetError(
                    f"commit barrier: rank {r} disagrees on leaf "
                    f"{name!r} ({leaf['shape']}/{leaf['dtype']} vs "
                    f"{base['shape']}/{base['dtype']}) — aborting "
                    f"publish")
            seen = {(tuple(s["start"]), tuple(s["stop"]))
                    for s in base["shards"]}
            for s in leaf["shards"]:
                if (tuple(s["start"]), tuple(s["stop"])) not in seen:
                    base["shards"].append(s)
        files.update(doc.get("files") or {})
        extra += int(doc.get("nbytes", 0))
    return leaves, files, extra


def _clean_stale(tmp: str, files: Dict[str, dict]) -> None:
    """Drop barrier markers and any shard file the merged manifest
    does not reference (leftovers of a crashed earlier save sharing
    the tmp dir) so the published dir is exactly the manifest's
    content."""
    try:
        names = os.listdir(tmp)
    except OSError:
        return
    for name in names:
        if name == MANIFEST or name in files:
            continue
        try:
            os.remove(os.path.join(tmp, name))
        except OSError:
            pass


def _publish(directory: str, tag: str, tmp: str, rank: int = 0) -> str:
    """Atomic rename publish: the previous checkpoint survives as
    ``tag.old`` until the new one is in place, so a kill between the
    two renames still leaves a loadable checkpoint (load falls back
    to ``tag.old``).  After the renames the parent directory is
    fsynced (rename durability) and the superseded checkpoint is
    retired into the ``step-<n>`` history for keep-last-N GC."""
    final = os.path.join(directory, tag)
    backup = os.path.join(directory, f"{tag}.old")
    if os.path.exists(final):
        # clear a stale backup only while a live 'final' still covers
        # us; if a prior crash left ONLY the backup, it stays untouched
        # until the new publish lands
        if os.path.exists(backup):
            shutil.rmtree(backup)
        faultinject.fire("rename", rank=rank, src=final, dst=backup)
        os.replace(final, backup)       # keep the old one until...
    faultinject.fire("rename", rank=rank, src=tmp, dst=final)
    os.replace(tmp, final)              # ...the new one is in place
    _fsync_dir(directory)               # make the renames durable
    if os.path.exists(backup):
        from . import checkpoint_gc
        checkpoint_gc.retire(directory, backup)
        _fsync_dir(directory)
    return final


class PendingSave:
    """Handle for one submitted save.  ``wait()`` blocks until the
    checkpoint is published (or the save failed or was coalesced away);
    ``result()`` also raises the failure."""

    def __init__(self, directory: str, tag: str, snap: Snapshot,
                 rank: int = 0, world: int = 1,
                 commit: Optional[str] = None):
        self.directory = directory
        self.tag = tag
        self.snapshot = snap
        self.rank = int(rank)
        self.world = max(1, int(world))
        self.commit = commit if commit is not None else ""
        self.path: Optional[str] = None
        self.error: Optional[BaseException] = None
        self.superseded = False
        self._done = threading.Event()

    def wait(self, timeout: Optional[float] = None) -> Optional[str]:
        if not self._done.wait(timeout):
            raise MXNetError(
                f"checkpoint save of {self.directory!r}:{self.tag!r} "
                f"did not complete within {timeout}s")
        return self.path

    def result(self, timeout: Optional[float] = None) -> str:
        self.wait(timeout)
        if self.error is not None:
            raise MXNetError(
                f"checkpoint save to {os.path.join(self.directory, self.tag)} "
                f"failed after retries: {self.error}") from self.error
        if self.superseded:
            raise MXNetError(
                "checkpoint save was superseded by a newer save of the "
                "same tag before it started")
        return self.path

    def done(self) -> bool:
        return self._done.is_set()


def _run_single(job: "PendingSave", tmp: str) -> Tuple[str, int]:
    """world == 1: exclusive tmp dir, serialize, manifest, publish."""
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    with tracing.span("ckpt.serialize", tag=job.tag):
        nbytes, leaves, files = _serialize_shards(job.snapshot, tmp, 0, 1)
        doc = {"format": FORMAT, "header": job.snapshot.header,
               "commit": job.commit, "world": 1,
               "leaves": leaves, "files": files}
        _write_manifest(tmp, doc, rank=0)
    with tracing.span("ckpt.commit", tag=job.tag):
        path = _publish(job.directory, job.tag, tmp, rank=0)
    return path, nbytes


def _run_multirank(job: "PendingSave", tmp: str) -> Tuple[str, int]:
    """world > 1: the rank-0 commit protocol over the shared tmp dir."""
    rank, world, commit = job.rank, job.world, job.commit
    timeout = _barrier_timeout_s()
    with tracing.span("ckpt.serialize", tag=job.tag, rank=rank):
        nbytes, leaves, files = _serialize_shards(
            job.snapshot, tmp, rank, world)
    if rank != 0:
        _write_marker(tmp, rank, commit, nbytes, leaves, files)
        path = _await_publish(job.directory, job.tag, commit,
                              timeout, rank)
        return path, nbytes
    frags = _collect_markers(tmp, world, commit, timeout, rank)
    leaves, files, extra = _merge_fragments(leaves, files, frags)
    # markers collected, manifest not yet live: the window in which a
    # coordinator's death costs most (a fault-injection site)
    faultinject.fire("commit", rank=rank, tag=job.tag)
    _clean_stale(tmp, files)
    doc = {"format": FORMAT, "header": job.snapshot.header,
           "commit": commit, "world": world,
           "leaves": leaves, "files": files}
    _write_manifest(tmp, doc, rank=rank)
    with tracing.span("ckpt.commit", tag=job.tag):
        path = _publish(job.directory, job.tag, tmp, rank=rank)
    return path, nbytes + extra


def _run_job(job: PendingSave) -> None:
    t0 = time.perf_counter()
    tmp = os.path.join(job.directory, f".{job.tag}.tmp")
    attempts = _retries() + 1
    backoff = _backoff_s()
    for attempt in range(attempts):
        try:
            os.makedirs(job.directory, exist_ok=True)
            if job.world > 1:
                job.path, nbytes = _run_multirank(job, tmp)
            else:
                job.path, nbytes = _run_single(job, tmp)
            _C_SAVES.inc()
            _C_BYTES.inc(nbytes)
            _H_SAVE_MS.observe((time.perf_counter() - t0) * 1e3)
            if job.rank == 0:
                _after_publish(job)
            return
        except _BarrierTimeout as e:    # peers dead: never retried
            job.error = e
            _C_FAILURES.inc()
            _logger().error("%s", e)
            return
        except Exception as e:          # noqa: BLE001 (the IO layer)
            try:
                # a shared multi-rank tmp dir holds other ranks' shards:
                # only the exclusive single-rank one is ours to clear
                if job.world == 1 and os.path.exists(tmp):
                    shutil.rmtree(tmp)
            except OSError:
                pass
            if attempt == attempts - 1:
                job.error = e
                _C_FAILURES.inc()
                _logger().exception(
                    "checkpoint save to %s failed after %d attempt(s); "
                    "training continues on the previous checkpoint",
                    os.path.join(job.directory, job.tag), attempts)
            else:
                time.sleep(backoff * (2 ** attempt))


def _after_publish(job: PendingSave) -> None:
    """Rank 0, after a publish: keep-last-N GC and registration with the
    background verifier.  Never fails the save, which is durable."""
    from . import checkpoint_gc
    try:
        checkpoint_gc.collect(job.directory, rank=job.rank)
    except Exception:                   # noqa: BLE001
        _logger().exception("checkpoint GC of %s failed (non-fatal; "
                            "history kept)", job.directory)
    try:
        checkpoint_gc.note_save(job.directory, job.tag)
    except Exception:                   # noqa: BLE001
        _logger().exception("background-verify registration failed")


# one writer thread per rank: a rank's saves run in submission order (a
# blocking save drains the ones before it), and threads-as-ranks get a
# writer each, so that rank 0's barrier wait cannot hold rank 1's marker
_LOCK = threading.Lock()
_QUEUES: Dict[int, List[PendingSave]] = {}
_PENDING: List[PendingSave] = []
_WAKE = threading.Condition(_LOCK)
_writers: Dict[int, threading.Thread] = {}


def _writer_loop(key: int) -> None:
    tracing.register_thread(f"ckpt-writer-{key}")
    while True:
        with _LOCK:
            while not _QUEUES.get(key):
                _WAKE.wait()
            job = _QUEUES[key].pop(0)
        try:
            if not job.superseded:
                _run_job(job)
        finally:
            job.snapshot.release()
            job._done.set()
            with _LOCK:
                if job in _PENDING:
                    _PENDING.remove(job)


def _submit(job: PendingSave) -> None:
    key = job.rank
    with _LOCK:
        queue = _QUEUES.setdefault(key, [])
        # coalesce: a queued save of the same target that has not
        # started is stale once a newer snapshot of it arrives
        for old in queue:
            if (old.directory, old.tag) == (job.directory, job.tag) \
                    and not old.superseded:
                old.superseded = True
                _C_COALESCED.inc()
        queue.append(job)
        _PENDING.append(job)
        w = _writers.get(key)
        if w is None or not w.is_alive():
            w = threading.Thread(target=_writer_loop, args=(key,),
                                 name=f"ckpt-writer-{key}", daemon=True)
            _writers[key] = w
            w.start()
        _WAKE.notify_all()


def pending_targets() -> List[Tuple[str, str]]:
    """(directory, tag) of every save submitted but not finished: the
    GC's do-not-touch list."""
    with _LOCK:
        return [(j.directory, j.tag) for j in _PENDING]


def save(directory: str, tree: Dict[str, Any],
         header: Optional[dict] = None, tag: str = "latest",
         block: Optional[bool] = None, rank: Optional[int] = None,
         world: Optional[int] = None,
         commit: Optional[str] = None) -> PendingSave:
    """Checkpoint ``tree`` (flat name → tensor, NDArray or array, or a
    :class:`Snapshot`) under ``directory/tag``.

    The caller pays only the snapshot; serialization and the publish run
    on the writer thread.  ``block=None`` follows ``MXNET_CKPT_ASYNC``
    (async by default); ``block=True`` waits for the publish and raises
    ``MXNetError`` on failure; ``block=False`` returns at once, and a
    failed save logs and counts ``checkpoint.failures`` but never
    raises.  ``rank``/``world`` (default :func:`rank_world`) select the
    commit protocol; ``commit`` names the save across ranks (default:
    the header's ``num_update``)."""
    snap = tree if isinstance(tree, Snapshot) else snapshot(tree, header)
    if header is not None and isinstance(tree, Snapshot):
        snap.header = dict(header)
    if rank is None or world is None:
        d_rank, d_world = rank_world()
        rank = d_rank if rank is None else rank
        world = d_world if world is None else world
    if commit is None:
        nu = snap.header.get("num_update")
        commit = "" if nu is None else str(nu)
    job = PendingSave(str(directory), str(tag), snap,
                      rank=rank, world=world, commit=commit)
    _submit(job)
    if block is None:
        block = not async_enabled()
    if block:
        job.result()
    return job


def wait_pending(timeout: Optional[float] = None) -> None:
    """Block until every submitted save is published (or failed); call
    before the process exits so that the last async save lands."""
    deadline = None if timeout is None else time.monotonic() + timeout
    while True:
        with _LOCK:
            jobs = list(_PENDING)
        if not jobs:
            return
        for j in jobs:
            left = None if deadline is None \
                else max(0.0, deadline - time.monotonic())
            j.wait(left)


# -- load -------------------------------------------------------------------

def _read_manifest(path: str) -> dict:
    mpath = os.path.join(path, MANIFEST)
    try:
        with open(mpath) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        raise MXNetError(f"{mpath}: unreadable checkpoint manifest "
                         f"({e})") from e
    if doc.get("format") != FORMAT:
        raise MXNetError(f"{mpath}: unknown checkpoint format "
                         f"{doc.get('format')!r} (expected {FORMAT!r})")
    return doc


def _open_shard_file(path: str, fname: str, files_meta: Dict[str, dict]):
    """One shard npz, its SHA-256 checked against the manifest's when
    the save recorded one."""
    fpath = os.path.join(path, fname)
    want = ((files_meta or {}).get(fname) or {}).get("sha256")
    try:
        if want:
            with open(fpath, "rb") as f:
                raw = f.read()
            got = hashlib.sha256(raw).hexdigest()
            if got != want:
                raise MXNetError(
                    f"{fpath}: checkpoint shard digest mismatch — "
                    f"shard file {fname!r} is corrupt (manifest sha256 "
                    f"{want[:16]}…, on-disk bytes hash {got[:16]}…)")
            return onp.load(io.BytesIO(raw), allow_pickle=False)
        return onp.load(fpath, allow_pickle=False)
    except MXNetError:
        raise
    except Exception as e:
        raise MXNetError(
            f"{fpath}: corrupted or truncated checkpoint "
            f"shard file ({type(e).__name__}: {e})") from e


def _assemble(path: str, doc: dict) -> Dict[str, torch.Tensor]:
    """Every leaf's global array on the host, placed from its shards'
    ``start``/``stop`` slices whatever the number of shard files (or of
    devices and hosts that wrote them), each file digest-checked before
    it is parsed."""
    files_meta = doc.get("files") or {}
    cache: Dict[str, Any] = {}
    out: Dict[str, torch.Tensor] = {}
    try:
        for name, leaf in doc["leaves"].items():
            arr = torch.empty(tuple(leaf["shape"]),
                              dtype=_torch_dtype(leaf["dtype"]))
            for shd in leaf["shards"]:
                z = cache.get(shd["file"])
                if z is None:
                    z = _open_shard_file(path, shd["file"], files_meta)
                    cache[shd["file"]] = z
                try:
                    raw = z[shd["key"]]
                except Exception as e:
                    raise MXNetError(
                        f"{os.path.join(path, shd['file'])}: missing or "
                        f"unreadable shard entry {shd['key']!r} for leaf "
                        f"{name!r} ({type(e).__name__}: {e})") from e
                sl = tuple(slice(a, b)
                           for a, b in zip(shd["start"], shd["stop"]))
                arr[sl] = tensor_from_bits(raw, leaf["dtype"], "cpu")
            out[name] = arr
    finally:
        for z in cache.values():
            z.close()
    return out


def step_history(directory: str) -> List[Tuple[int, str]]:
    """The retained ``step-<n>`` checkpoint directories under
    ``directory`` that hold a manifest, newest first."""
    try:
        names = os.listdir(str(directory))
    except OSError:
        return []
    out = []
    for name in names:
        m = _STEP_TAG_RE.fullmatch(name)
        if not m:
            continue
        path = os.path.join(str(directory), name)
        if os.path.isfile(os.path.join(path, MANIFEST)):
            out.append((int(m.group(1)), path))
    out.sort(reverse=True)
    return out


def load(directory: str, tag: str = "latest"
         ) -> Optional[Tuple[Dict[str, torch.Tensor], dict]]:
    """The published checkpoint at ``directory/tag`` (falling back to
    ``tag.old`` after an interrupted publish, then to the newest
    ``step-<n>`` history entry that loads; each fallback is logged), as
    ``(leaves, header)`` with every leaf a global host tensor, or None
    when no checkpoint exists.  Corruption with no intact fallback
    raises ``MXNetError``."""
    primary = os.path.join(str(directory), tag)
    cands = [(primary, None),
             (os.path.join(str(directory), f"{tag}.old"),
              f"publish of {tag!r} was interrupted; restored the "
              f"{tag}.old backup")]
    first_err: Optional[MXNetError] = None
    for cand, note in cands:
        if not os.path.isfile(os.path.join(cand, MANIFEST)):
            continue
        try:
            doc = _read_manifest(cand)
            leaves = _assemble(cand, doc)
        except MXNetError as e:
            if first_err is None:
                first_err = e
            _logger().warning("checkpoint %s unreadable (%s); trying "
                              "fallbacks", cand, e)
            continue
        if note:
            _logger().warning("%s (%s)", note, cand)
        return leaves, dict(doc.get("header") or {})
    for step, cand in step_history(directory):
        try:
            doc = _read_manifest(cand)
            leaves = _assemble(cand, doc)
        except MXNetError as e:
            if first_err is None:
                first_err = e
            _logger().warning("checkpoint history %s unreadable (%s); "
                              "trying older", cand, e)
            continue
        _logger().warning(
            "checkpoint %s and its backup are missing or unreadable; "
            "fell back to retained history %s (step %d)",
            primary, cand, step)
        return leaves, dict(doc.get("header") or {})
    if first_err is not None:
        raise first_err
    return None
