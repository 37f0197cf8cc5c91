"""File-backed shared plan store: a directory of versioned artifacts.

A :class:`PlanStore` persists :class:`~repro_torch.fleet.registry.
PlanRegistry` entries as individual ``plan_registry_entry`` JSON
artifacts, one file per content key, named by the key's sha256.  Wired
into a registry (``PlanRegistry(store=...)``), it makes the cache
*shared*: a plan computed by one process (or one run) is a registry
hit for every other registry pointing at the same directory — the
fleet-wide "identical clusters never re-plan" promise survives process
boundaries with no coordination service.

Writes are crash-safe by construction: each entry is serialized to a
unique temp file in the same directory and published with
``os.replace`` (atomic on POSIX), so concurrent readers only ever see
absent-or-complete artifacts, and two writers racing on one key both
leave a valid file.  Reads tolerate and skip corrupt/foreign files —
a shared directory must never poison every consumer.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile
from pathlib import Path

ENTRY_KIND = "plan_registry_entry"


def _key_digest(key: tuple) -> str:
    return hashlib.sha256(
        json.dumps(list(key), sort_keys=True).encode()).hexdigest()[:32]


class PlanStore:
    """Directory of ``plan_registry_entry`` artifacts keyed by the
    registry's content key (see module docstring)."""

    def __init__(self, root: str | os.PathLike):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)

    def _path(self, key: tuple) -> Path:
        return self.root / f"{_key_digest(key)}.json"

    def __len__(self) -> int:
        return sum(1 for _ in self.root.glob("*.json"))

    def __contains__(self, key: tuple) -> bool:
        return self._path(key).exists()

    def get(self, key: tuple) -> dict | None:
        """The stored entry payload for ``key``, or None.  Corrupt or
        foreign files read as misses, never as errors."""
        from ..api import artifacts
        path = self._path(key)
        try:
            text = path.read_text()
        except OSError:
            return None
        try:
            doc = artifacts.loads_payload(ENTRY_KIND, text)
        except (ValueError, KeyError, json.JSONDecodeError):
            return None
        if doc.get("key") != list(key):
            return None                 # digest collision / stale rename
        return doc["entry"]

    def put(self, key: tuple, entry: dict) -> None:
        """Atomically publish ``entry`` under ``key`` (tempfile in the
        same directory + ``os.replace``; readers never see partials)."""
        from ..api import artifacts
        text = artifacts.dumps_payload(
            ENTRY_KIND, {"key": list(key), "entry": entry})
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(text)
            os.replace(tmp, self._path(key))
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def delete(self, key: tuple) -> bool:
        try:
            os.unlink(self._path(key))
            return True
        except OSError:
            return False

    def keys(self) -> list[tuple]:
        """All content keys currently published (scans the directory;
        unreadable files are skipped)."""
        from ..api import artifacts
        out = []
        for p in sorted(self.root.glob("*.json")):
            try:
                doc = artifacts.loads_payload(ENTRY_KIND, p.read_text())
                out.append(tuple(doc["key"]))
            except (OSError, ValueError, KeyError, json.JSONDecodeError):
                continue
        return out
