"""Persistent kernel-autotune cache (counterpart of
``mxnet_tpu/kernels/cache.py``, same on-disk format).

One versioned JSON document per shared directory
(``$MXNET_KERNEL_CACHE_DIR/kernel_cache.json``) maps full tuning keys
(see ``registry.cache_key``) to winning configs, so a new process or
replica looks a config up instead of measuring again.  Both packages
can share one file: the backend field of the key keeps their entries
apart.

Writes go tmp → flush → fsync → ``os.replace`` → directory fsync, so a
crashed tuner never publishes a torn file.  Loads treat any defect
(missing file, bad JSON, wrong format tag or version, non-dict entries)
as an empty cache: the failure mode is tuning again, never crashing.
With ``MXNET_KERNEL_CACHE_DIR`` unset the cache is memory-only.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

FORMAT = "mxnet-tpu-kernel-cache"
VERSION = 1
FILENAME = "kernel_cache.json"

_LOCK = threading.Lock()


def cache_dir() -> Optional[str]:
    """The shared cache directory, or None for memory-only."""
    return os.environ.get("MXNET_KERNEL_CACHE_DIR") or None


def cache_path() -> Optional[str]:
    d = cache_dir()
    return os.path.join(d, FILENAME) if d else None


def load() -> Dict[str, dict]:
    """Entries from disk: ``{key: {"config": {...}, "ms": float}}``;
    empty on every defect."""
    path = cache_path()
    if path is None:
        return {}
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if not isinstance(doc, dict) or doc.get("format") != FORMAT \
            or doc.get("version") != VERSION:
        return {}
    entries = doc.get("entries")
    if not isinstance(entries, dict):
        return {}
    return {k: v for k, v in entries.items()
            if isinstance(v, dict) and isinstance(v.get("config"), dict)}


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def store(entries: Dict[str, dict]) -> bool:
    """Merge ``entries`` into the on-disk document atomically
    (read-merge-replace under a process lock).  Returns False
    (memory-only) when no cache dir is configured."""
    path = cache_path()
    if path is None:
        return False
    with _LOCK:
        merged = load()
        merged.update(entries)
        doc = {"format": FORMAT, "version": VERSION, "entries": merged}
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(os.path.dirname(path))
    return True
