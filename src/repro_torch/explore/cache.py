"""Content-addressed on-disk cache for evaluation results.

Copied from :mod:`repro.explore.cache` (the JAX package).  The key of a
point is the same digest in both packages, and an entry is plain JSON,
so the two may share one cache directory.

The cache key is the SHA-256 of a canonical-JSON description of
everything that determines an evaluation's outcome: the workload
(model name + geometry), the full ``ChipConfig`` dict, the compile
strategy, the cost-model parameters, and the fidelity.  Identical
(model, chip, strategy, mode) re-runs — and overlapping sweeps from
*different* callers — therefore share entries and are free.

Entries are JSON files sharded by key prefix (``<root>/ab/<key>.json``)
and written atomically (tmp + rename) so concurrent pool workers and
concurrent sweeps never observe torn files.

Eviction: entries are never aged out automatically, but a cache
constructed with ``max_age_days`` / ``max_entries`` (or given them at
call time) can be compacted with :meth:`ResultCache.prune` — drop
entries older than the age limit (file mtime), then the oldest entries
beyond the count limit.  ``python -m repro_torch.explore cache prune`` wires
this to the command line; pruning is safe alongside running sweeps
(``put`` retries when its shard directory is concurrently removed,
readers tolerate vanished files).
"""

from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from ..core.arch import ChipConfig
from ..core.mapping import CostParams

__all__ = ["ResultCache", "default_cache_dir", "cache_key"]

_ENV_VAR = "REPRO_EXPLORE_CACHE"
_SCHEMA_VERSION = 1


def default_cache_dir() -> str:
    return os.environ.get(_ENV_VAR,
                          os.path.join("results", "explore_cache"))


def cache_key(model: str, chip: ChipConfig, strategy: str,
              fidelity: str, params: Optional[CostParams] = None,
              **extra: Any) -> str:
    """Deterministic content hash of one evaluation's full inputs."""
    desc: Dict[str, Any] = {
        "v": _SCHEMA_VERSION,
        "model": model,
        "chip": chip.to_dict(),
        "strategy": strategy,
        "fidelity": fidelity,
        "params": dataclasses.asdict(params) if params else None,
        **extra,
    }
    # chip names are cosmetic — two identically-dimensioned chips with
    # different labels must share cache entries
    desc["chip"].pop("name", None)
    blob = json.dumps(desc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


class ResultCache:
    """Sharded JSON file cache with hit/miss accounting and an
    optional eviction policy (applied by :meth:`prune`, not on every
    ``put`` — pruning scans the whole tree)."""

    def __init__(self, root: Optional[str] = None,
                 max_age_days: Optional[float] = None,
                 max_entries: Optional[int] = None) -> None:
        self.root = root or default_cache_dir()
        self.max_age_days = max_age_days
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".json")

    def _entries(self, want_mtimes: bool = True
                 ) -> List[Tuple[float, str]]:
        """All entry files as sorted ``(mtime, path)``, oldest first.

        ``want_mtimes=False`` skips the per-file stat and the sort
        (``__len__``/``clear`` only need the paths).
        """
        out: List[Tuple[float, str]] = []
        if not os.path.isdir(self.root):
            return out
        for shard in os.listdir(self.root):
            sdir = os.path.join(self.root, shard)
            try:
                names = os.listdir(sdir)
            except (NotADirectoryError, FileNotFoundError):
                continue              # stray file / concurrent rmdir
            for f in names:
                if not f.endswith(".json"):
                    continue
                path = os.path.join(sdir, f)
                if not want_mtimes:
                    out.append((0.0, path))
                    continue
                try:
                    out.append((os.path.getmtime(path), path))
                except OSError:
                    continue          # concurrently pruned
        if want_mtimes:
            out.sort()
        return out

    def prune(self, max_age_days: Optional[float] = None,
              max_entries: Optional[int] = None,
              now: Optional[float] = None) -> int:
        """Evict entries by age and count; returns how many were removed.

        Age first (mtime older than ``max_age_days``), then the oldest
        entries beyond ``max_entries``.  Limits default to the ones the
        cache was constructed with; ``None`` disables that criterion.
        ``now`` is injectable for tests.
        """
        max_age_days = (self.max_age_days if max_age_days is None
                        else max_age_days)
        max_entries = (self.max_entries if max_entries is None
                       else max_entries)
        entries = self._entries()
        now = time.time() if now is None else now
        doomed: List[str] = []
        if max_age_days is not None:
            cutoff = now - max_age_days * 86400.0
            i = bisect.bisect_left(entries, (cutoff,))
            doomed.extend(p for _, p in entries[:i])
            entries = entries[i:]
        if max_entries is not None and len(entries) > max_entries:
            extra = len(entries) - max_entries
            doomed.extend(p for _, p in entries[:extra])
            del entries[:extra]
        removed = 0
        for path in doomed:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass                  # concurrently pruned
        self._remove_empty_shards()
        return removed

    def _remove_empty_shards(self) -> None:
        if not os.path.isdir(self.root):
            return
        for shard in os.listdir(self.root):
            sdir = os.path.join(self.root, shard)
            if os.path.isdir(sdir) and not os.listdir(sdir):
                try:
                    os.rmdir(sdir)
                except OSError:
                    pass

    def get(self, key: str) -> Optional[Dict[str, Any]]:
        try:
            with open(self._path(key)) as f:
                out = json.load(f)
        except (OSError, json.JSONDecodeError):
            self.misses += 1
            return None
        self.hits += 1
        return out

    def put(self, key: str, value: Dict[str, Any]) -> None:
        path = self._path(key)
        sdir = os.path.dirname(path)
        for _ in range(8):
            os.makedirs(sdir, exist_ok=True)
            try:
                fd, tmp = tempfile.mkstemp(dir=sdir, suffix=".tmp")
                break
            except FileNotFoundError:
                continue    # concurrent prune rmdir'd the empty shard
        else:
            raise OSError(f"cache shard {sdir} keeps vanishing "
                          f"(concurrent prune?)")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(value, f, sort_keys=True)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def __len__(self) -> int:
        return len(self._entries(want_mtimes=False))

    def clear(self) -> int:
        """Delete all entries; returns how many were removed."""
        n = 0
        for _, path in self._entries(want_mtimes=False):
            try:
                os.unlink(path)
                n += 1
            except OSError:
                pass
        self._remove_empty_shards()
        return n

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses}
