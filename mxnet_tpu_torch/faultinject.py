"""Deterministic fault injection for robustness testing (counterpart
of ``mxnet_tpu/faultinject.py``, the same spec grammar and sites).

The checkpoint commit protocol (``checkpoint.py``) claims an
invariant — under ANY single failure a subsequent ``load`` returns a
complete digest-verified checkpoint or the previous published one,
never a partial restore.  Claims like that are only worth anything if
every failure branch actually runs, so the IO/commit hot spots call
:func:`fire` at **named sites** and this module decides, from a
declarative spec, whether that particular occurrence fails.

Spec grammar (``MXNET_FAULT_SPEC`` or :func:`configure`)::

    spec     := rule ("," rule)*
    rule     := site ["@" rank] ":" occurrence [":" action]
    site     := shard_write | fsync | marker_write | barrier_wait |
                commit | manifest_write | rename | gc_remove |
                verify_read | ...   (any name a fire() call uses)
    action   := raise (default) | kill | exit

``shard_write:2`` fails the 2nd shard-file write in the process;
``marker_write@1:1`` fails rank 1's first ready-marker write (rank
scoping is how a threads-as-ranks test kills ONE rank);
``rename:1:kill`` SIGKILLs the whole process at the first publish
rename — the subprocess soak's "host dies mid-publish".

Occurrence counting is per rule and 1-based: the rule fires on exactly
the Nth *matching* call, earlier and later occurrences pass through —
so a test can fail "the second save's marker" deterministically.
``raise`` raises :class:`FaultInjected` (an ``MXNetError``: the
checkpoint retry/degradation machinery treats it like any real IO
error); ``kill`` delivers ``SIGKILL`` to the process (nothing drains,
the honest crash); ``exit`` is ``os._exit(17)`` for environments where
a signal is awkward.

Disabled (no spec) the per-call cost is one module-attribute read and
an ``is None`` check — safe to leave in production paths.  Injected
fires count into the ``checkpoint.faults_injected`` telemetry counter
so a CI run can assert the harness actually exercised the site.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

from .base import MXNetError, getenv

__all__ = ["FaultInjected", "configure", "clear", "fire", "hits",
           "active_spec"]


class FaultInjected(MXNetError):
    """Raised by :func:`fire` when a spec rule matches.  Subclasses
    ``MXNetError`` so the production error paths (retry, graceful
    degradation, barrier abort) handle it exactly like a real fault."""

    def __init__(self, site: str, occurrence: int, rank: Optional[int]):
        self.site = site
        self.occurrence = occurrence
        self.rank = rank
        at = f" rank {rank}" if rank is not None else ""
        super().__init__(
            f"injected fault at site {site!r} (occurrence {occurrence}"
            f"{at}; MXNET_FAULT_SPEC / faultinject.configure)")


class _Rule:
    __slots__ = ("site", "rank", "occurrence", "action", "seen")

    def __init__(self, site: str, rank: Optional[int],
                 occurrence: int, action: str):
        self.site = site
        self.rank = rank
        self.occurrence = occurrence
        self.action = action
        self.seen = 0


_LOCK = threading.Lock()
_rules: Optional[List[_Rule]] = None    # None = disabled (fast path)
_spec_src: Optional[str] = None         # spec string _rules came from
_env_seen: Optional[str] = None         # last MXNET_FAULT_SPEC observed
_HITS: Dict[str, int] = {}


def _parse(spec: str) -> List[_Rule]:
    rules = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        fields = part.split(":")
        if len(fields) not in (2, 3):
            raise MXNetError(
                f"invalid MXNET_FAULT_SPEC rule {part!r}; expected "
                f"site[@rank]:occurrence[:action]")
        site, rank = fields[0], None
        if "@" in site:
            site, r = site.split("@", 1)
            try:
                rank = int(r)
            except ValueError:
                raise MXNetError(
                    f"invalid rank {r!r} in MXNET_FAULT_SPEC rule "
                    f"{part!r}")
        try:
            occurrence = int(fields[1])
        except ValueError:
            raise MXNetError(
                f"invalid occurrence {fields[1]!r} in MXNET_FAULT_SPEC "
                f"rule {part!r}; expected a 1-based integer")
        if occurrence < 1:
            raise MXNetError(
                f"occurrence must be >= 1 in MXNET_FAULT_SPEC rule "
                f"{part!r}")
        action = fields[2] if len(fields) == 3 else "raise"
        if action not in ("raise", "kill", "exit"):
            raise MXNetError(
                f"unknown action {action!r} in MXNET_FAULT_SPEC rule "
                f"{part!r}; expected raise|kill|exit")
        rules.append(_Rule(site.strip(), rank, occurrence, action))
    return rules


def configure(spec: Optional[str]) -> None:
    """Install ``spec`` (see module doc), replacing any active rules
    and resetting occurrence counters.  ``None``/empty disables."""
    global _rules, _spec_src
    with _LOCK:
        _rules = _parse(spec) if spec else None
        _spec_src = spec or None
        _HITS.clear()


def clear() -> None:
    """Disable injection and forget all hit counts."""
    configure(None)


def active_spec() -> Optional[str]:
    """The spec string currently installed (env or programmatic)."""
    _sync_env()
    return _spec_src


def hits(site: str) -> int:
    """How many times ``site`` has fired since the spec was installed
    (counted only while a spec is active — disabled means zero cost,
    zero bookkeeping)."""
    with _LOCK:
        return _HITS.get(site, 0)


def _sync_env() -> None:
    """Adopt ``MXNET_FAULT_SPEC`` when it changed since last look, so a
    subprocess harness can drive injection purely through env."""
    global _env_seen
    env = getenv("MXNET_FAULT_SPEC") or None
    if env != _env_seen:
        _env_seen = env
        configure(env)


def fire(site: str, rank: Optional[int] = None, **context) -> None:
    """Declare one occurrence of ``site``.  No-op unless an installed
    rule matches, in which case the rule's action happens (raise /
    kill / exit).  ``rank`` scopes matching for ``site@rank`` rules;
    ``context`` kwargs are logged with the injection."""
    if _rules is None and _env_seen == (getenv("MXNET_FAULT_SPEC") or None):
        return                          # disabled fast path
    _sync_env()
    with _LOCK:
        if not _rules:
            return
        _HITS[site] = _HITS.get(site, 0) + 1
        fired = None
        for r in _rules:
            if r.site != site:
                continue
            if r.rank is not None and r.rank != rank:
                continue
            r.seen += 1
            if r.seen == r.occurrence:
                fired = r
                break
        if fired is None:
            return
    from . import telemetry
    telemetry.counter("checkpoint.faults_injected").inc()
    from .log import get_logger
    get_logger("mxnet_tpu_torch.faultinject").warning(
        "injecting %s fault at site %r occurrence %d rank %s %s",
        fired.action, site, fired.occurrence, rank, context or "")
    if fired.action == "kill":
        import signal
        os.kill(os.getpid(), signal.SIGKILL)
    if fired.action == "exit":
        os._exit(17)
    raise FaultInjected(site, fired.occurrence, rank)
