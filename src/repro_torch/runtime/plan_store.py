"""Persistent per-host plan store: atomic, versioned, corruption-tolerant.

The durable half of tuning once per host (the reference's
``src/repro/runtime/plan_store.py``, the same JSON document): the
autotuner's winning launch geometry is kept as JSON keyed
``(host_fingerprint, plan key id)``, so the next process starts with zero
tuning runs. Records carry ``bm``, ``bn``, ``bk``, ``k_split``, ``kernel``
and the reference's detail fields (``candidates``, ``source``,
``wall_us``); a store written by either package loads in the other.

* **Atomic.** Every write lands through a temp file in the same directory
  and ``os.replace``: a reader sees the old document or the new one, never
  a torn half.
* **Versioned.** The document carries ``version``; another version is
  discarded whole on load.
* **Corruption-tolerant.** A missing, torn or foreign file is an empty
  store (:attr:`PlanStore.load_error` says why), and the plan layer falls
  back to the default tiles; a bad cache file never stops a serving
  process. A record the tuner finds illegal is a miss and is re-tuned
  (``core/autotune``).

Staleness is handled by keying: the fingerprint hashes the toolchain and
the device, so another card or torch reads an empty namespace.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Optional

__all__ = ["STORE_VERSION", "PlanStore"]

STORE_VERSION = 1


def _empty_doc() -> dict:
    return {"version": STORE_VERSION, "hosts": {}}


class PlanStore:
    """JSON-file store the autotuner reads and writes through; duck-typed
    against ``core/autotune.PlanAutotuner`` (``get``/``put``), which never
    imports this module."""

    def __init__(self, path: str) -> None:
        self.path = os.fspath(path)
        self.load_error: Optional[str] = None
        self._doc: Optional[dict] = None

    # -- load --------------------------------------------------------------
    def _load(self) -> dict:
        if self._doc is not None:
            return self._doc
        self.load_error = None
        try:
            with open(self.path) as fh:
                doc = json.load(fh)
        except FileNotFoundError:
            doc = _empty_doc()
        except (OSError, ValueError) as exc:
            # a truncated copy or hand-edited garbage: start empty
            self.load_error = f"unreadable ({exc.__class__.__name__}): {exc}"
            doc = _empty_doc()
        if not isinstance(doc, dict) or not isinstance(doc.get("hosts"), dict):
            self.load_error = self.load_error or "malformed document"
            doc = _empty_doc()
        elif doc.get("version") != STORE_VERSION:
            self.load_error = (
                f"version mismatch (store {doc.get('version')!r}, "
                f"code {STORE_VERSION}) — discarded"
            )
            doc = _empty_doc()
        self._doc = doc
        return doc

    # -- the tuner-facing API ---------------------------------------------
    def get(self, fingerprint: str, key_id: str) -> Optional[dict]:
        host = self._load()["hosts"].get(fingerprint)
        record = host.get(key_id) if isinstance(host, dict) else None
        return record if isinstance(record, dict) else None

    def put(self, fingerprint: str, key_id: str, record: dict) -> None:
        hosts = self._load()["hosts"]
        if not isinstance(hosts.get(fingerprint), dict):
            hosts[fingerprint] = {}
        hosts[fingerprint][key_id] = dict(record)
        self._flush(self._doc)

    # -- observability -----------------------------------------------------
    def entries(self, fingerprint: Optional[str] = None) -> int:
        hosts = self._load()["hosts"]
        if fingerprint is not None:
            host = hosts.get(fingerprint)
            return len(host) if isinstance(host, dict) else 0
        return sum(len(v) for v in hosts.values() if isinstance(v, dict))

    def stats(self) -> dict:
        out = {"path": self.path, "entries": self.entries(), "version": STORE_VERSION}
        if self.load_error:
            out["load_error"] = self.load_error
        return out

    # -- atomic write ------------------------------------------------------
    def _flush(self, doc: dict) -> None:
        parent = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(parent, exist_ok=True)
        fd, tmp = tempfile.mkstemp(
            prefix=os.path.basename(self.path) + ".", suffix=".tmp", dir=parent
        )
        try:
            with os.fdopen(fd, "w") as fh:
                json.dump(doc, fh, indent=1, sort_keys=True)
                fh.flush()
                os.fsync(fh.fileno())
            os.replace(tmp, self.path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
