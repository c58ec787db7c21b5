"""Checkpoint retention (keep-last-N GC) and background verification
(counterpart of ``mxnet_tpu/checkpoint_gc.py``).

``checkpoint.py`` holds the commit protocol; this module keeps
checkpoints from accumulating forever or rotting silently until the
restore that needed them.

**Retention.**  ``_publish`` retires each superseded ``latest`` into a
``step-<num_update>`` history directory (:func:`retire`) instead of
deleting it; :func:`collect` then prunes the history down to
``MXNET_CKPT_KEEP`` total retained checkpoints (the live tag counts as
one), newest first.  GC runs on the checkpoint writer thread right
after a publish — never on the step path — and refuses to touch any
directory an in-flight :class:`~mxnet_tpu_torch.checkpoint.PendingSave`
still targets, so a slow save can never have its tag deleted from
under it.  Deletions only happen AFTER the newer publish is durable
(collect is called post-publish, post-fsync).

**Verification.**  Every manifest records per-shard SHA-256 digests.
:func:`verify_checkpoint` re-reads the newest published checkpoint and
re-hashes every shard file against them; :func:`verify_and_heal`
additionally *quarantines* a corrupt checkpoint by renaming its
directory to ``<tag>.quarantine-<k>`` — a name neither ``load`` nor
the history scan will ever pick up — so the next ``load`` falls back
to the previous good checkpoint (``tag.old`` or the ``step-<n>``
history) instead of dying mid-restore.  A publish racing the verify
pass is detected (the manifest's commit id changed under the reader)
and treated as "retry next tick", never as corruption.

Set ``MXNET_CKPT_VERIFY_SEC`` to run :func:`verify_and_heal`
periodically on a background daemon thread over every directory this
process has saved to (``0``/unset disables).  Counters:
``checkpoint.gc_removed``, ``checkpoint.verify_passes``,
``checkpoint.verify_failures``.
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Dict, List, Optional, Tuple

from . import checkpoint as _ckpt
from . import faultinject
from . import telemetry
from . import tracing
from .base import MXNetError, getenv

__all__ = ["keep_n", "verify_sec", "collect", "retire",
           "verify_checkpoint", "verify_and_heal", "note_save",
           "start", "stop"]

_C_GC = telemetry.counter("checkpoint.gc_removed")
_C_VPASS = telemetry.counter("checkpoint.verify_passes")
_C_VFAIL = telemetry.counter("checkpoint.verify_failures")


def keep_n() -> int:
    """``MXNET_CKPT_KEEP`` (default 3): total retained checkpoints per
    directory — the live tag plus the newest ``step-<n>`` history
    entries.  ``1`` keeps only the live tag (plus its transient
    ``.old`` during a publish); ``0`` disables GC entirely (retain
    everything, the pre-phase-2 behavior)."""
    v = getenv("MXNET_CKPT_KEEP")
    if v is None or v == "":
        return 3
    try:
        return max(0, int(v))
    except ValueError:
        raise MXNetError(
            f"invalid MXNET_CKPT_KEEP={v!r}; expected an integer >= 0")


def verify_sec() -> float:
    """``MXNET_CKPT_VERIFY_SEC`` (default 0 = off): period of the
    background digest-verification sweep."""
    v = getenv("MXNET_CKPT_VERIFY_SEC")
    if v is None or v == "":
        return 0.0
    try:
        return max(0.0, float(v))
    except ValueError:
        raise MXNetError(
            f"invalid MXNET_CKPT_VERIFY_SEC={v!r}; expected a number "
            f"of seconds")


def _logger():
    from .log import get_logger
    return get_logger("mxnet_tpu_torch.checkpoint_gc")


def retire(directory: str, backup: str) -> Optional[str]:
    """Move the just-superseded checkpoint at ``backup`` (the
    ``tag.old`` a publish produced) into the ``step-<n>`` history,
    keyed by its header's ``num_update``.  Falls back to deleting it
    when retention is off (``MXNET_CKPT_KEEP<=1``) or the manifest
    carries no usable step.  Returns the history path, or None when
    the backup was dropped."""
    step = None
    try:
        doc = _ckpt._read_manifest(backup)
        step = int(doc.get("header", {}).get("num_update"))
    except (MXNetError, TypeError, ValueError):
        pass
    if keep_n() <= 1 or step is None:
        shutil.rmtree(backup, ignore_errors=True)
        return None
    dst = os.path.join(directory, f"step-{step}")
    if os.path.exists(dst):            # re-save of the same step wins
        shutil.rmtree(dst, ignore_errors=True)
    os.replace(backup, dst)
    return dst


def collect(directory: str, rank: int = 0,
            keep: Optional[int] = None) -> int:
    """Prune ``directory``'s ``step-<n>`` history down to ``keep``
    total retained checkpoints (default :func:`keep_n`; the live tag
    counts as one).  Skips — without counting — any directory an
    in-flight save still targets.  Returns how many directories were
    removed.  Only rank 0 collects: it is the only rank that
    publishes, and two ranks racing rmtree on a shared filesystem
    helps nobody."""
    if rank != 0:
        return 0
    keep = keep_n() if keep is None else keep
    if keep <= 0:
        return 0
    history = _ckpt.step_history(directory)      # newest first
    excess = history[max(0, keep - 1):]
    if not excess:
        return 0
    inflight = {os.path.abspath(os.path.join(d, t))
                for d, t in _ckpt.pending_targets()}
    removed = 0
    with tracing.span("ckpt.gc", directory=str(directory),
                      excess=len(excess)):
        for step, path in excess:
            if os.path.abspath(path) in inflight:
                continue
            faultinject.fire("gc_remove", rank=rank, path=path)
            try:
                shutil.rmtree(path)
            except OSError as e:
                _logger().warning("GC could not remove %s (%s); will "
                                  "retry after the next publish",
                                  path, e)
                continue
            removed += 1
            _C_GC.inc()
        if removed:
            _ckpt._fsync_dir(str(directory))
    return removed


# -- digest verification + quarantine ---------------------------------------

def _newest_published(directory: str, tag: str
                      ) -> Optional[Tuple[str, str]]:
    """(path, label) of the newest checkpoint ``load`` would resolve:
    the tag, else its ``.old`` backup, else the newest history entry."""
    for label in (tag, f"{tag}.old"):
        path = os.path.join(str(directory), label)
        if os.path.isfile(os.path.join(path, _ckpt.MANIFEST)):
            return path, label
    hist = _ckpt.step_history(directory)
    if hist:
        return hist[0][1], os.path.basename(hist[0][1])
    return None


def verify_checkpoint(directory: str, tag: str = "latest"
                      ) -> Optional[dict]:
    """Re-hash every shard file of the newest published checkpoint
    against its manifest digests.  Returns ``None`` when there is
    nothing to verify, else a report dict: ``path``, ``ok``,
    ``files`` (count checked), ``bad`` (offending file names),
    ``commit`` (manifest commit id, for race detection), ``error``
    (manifest-level failure, if any)."""
    resolved = _newest_published(directory, tag)
    if resolved is None:
        return None
    path, _ = resolved
    report = {"path": path, "ok": True, "files": 0, "bad": [],
              "commit": None, "error": None}
    try:
        doc = _ckpt._read_manifest(path)
    except MXNetError as e:
        report.update(ok=False, error=str(e))
        return report
    report["commit"] = doc.get("commit")
    files = doc.get("files") or {}
    for fname, meta in sorted(files.items()):
        want = (meta or {}).get("sha256")
        if not want:
            continue
        report["files"] += 1
        fpath = os.path.join(path, fname)
        try:
            faultinject.fire("verify_read", file=fname)
            got = _ckpt._sha256_file(fpath)
        except (OSError, MXNetError) as e:
            report["ok"] = False
            report["bad"].append(fname)
            report["error"] = str(e)
            continue
        if got != want:
            report["ok"] = False
            report["bad"].append(fname)
    return report


def _quarantine(path: str) -> str:
    """Demote a corrupt checkpoint directory to a quarantine name that
    no load path (tag, ``.old``, history scan) will ever resolve, so
    restores fall back to the previous good checkpoint while the bytes
    stay on disk for a post-mortem."""
    k = 0
    while True:
        dst = f"{path}.quarantine-{k}"
        if not os.path.exists(dst):
            break
        k += 1
    os.replace(path, dst)
    _ckpt._fsync_dir(os.path.dirname(path) or ".")
    return dst


def verify_and_heal(directory: str, tag: str = "latest"
                    ) -> Optional[bool]:
    """One verification pass with self-healing: quarantine the newest
    published checkpoint if its shards no longer match their digests.
    Returns True (verified), False (corrupt → quarantined), or None
    (nothing to verify / a concurrent publish raced the read — retry
    next tick)."""
    report = verify_checkpoint(directory, tag)
    if report is None:
        return None
    if report["ok"]:
        _C_VPASS.inc()
        return True
    # a publish may have swapped the directory mid-read; only a
    # failure that REPRODUCES against an unchanged manifest is
    # corruption
    try:
        commit = _ckpt._read_manifest(report["path"]).get("commit")
    except MXNetError:
        commit = None
    if commit != report["commit"]:
        return None
    _C_VFAIL.inc()
    try:
        dst = _quarantine(report["path"])
    except OSError as e:
        _logger().error(
            "checkpoint %s failed digest verification (%s) but could "
            "not be quarantined: %s", report["path"],
            report["bad"] or report["error"], e)
        return False
    _logger().error(
        "checkpoint %s failed digest verification (bad shards: %s%s); "
        "quarantined to %s — loads will fall back to the previous "
        "good checkpoint", report["path"],
        ", ".join(report["bad"]) or "-",
        f"; {report['error']}" if report["error"] else "", dst)
    return False


# -- background verifier ----------------------------------------------------

_VLOCK = threading.Lock()
_DIRS: Dict[str, str] = {}              # directory -> tag
_thread: Optional[threading.Thread] = None
_stop = threading.Event()


def note_save(directory: str, tag: str) -> None:
    """Register a save target for the background sweep (called by the
    writer thread after every publish) and start the verifier if
    ``MXNET_CKPT_VERIFY_SEC`` asks for one."""
    with _VLOCK:
        _DIRS[os.path.abspath(str(directory))] = str(tag)
    if verify_sec() > 0:
        start()


def _sweep() -> None:
    """One verification pass over every registered directory (exposed
    for deterministic tests; the daemon just loops this)."""
    with _VLOCK:
        targets = list(_DIRS.items())
    for directory, tag in targets:
        try:
            verify_and_heal(directory, tag)
        except Exception:               # noqa: BLE001 — sweep survives
            _logger().exception("background verify of %s failed",
                                directory)


def _verifier_loop() -> None:
    while True:
        period = verify_sec()
        if _stop.wait(period if period > 0 else 1.0):
            return
        if period > 0:
            _sweep()


def start() -> None:
    """Start the background verifier daemon (idempotent)."""
    global _thread
    with _VLOCK:
        if _thread is not None and _thread.is_alive():
            return
        _stop.clear()
        _thread = threading.Thread(target=_verifier_loop,
                                   name="ckpt-verifier", daemon=True)
        _thread.start()


def stop(timeout: float = 2.0) -> None:
    """Stop the background verifier (tests; production lets the daemon
    die with the process)."""
    global _thread
    with _VLOCK:
        t = _thread
        _thread = None
    if t is None:
        return
    _stop.set()
    t.join(timeout)
