"""On-disk pass-output cache for the :mod:`repro_torch.flow` pipeline.

Host code copied from :mod:`repro.flow.diskcache` (the JAX package),
with the port's entries kept apart from the reference's.

The in-process LRU gives cross-fidelity partition reuse, but pool
workers (``repro_torch.explore`` fans sweeps over a ``multiprocessing`` pool)
each start with a cold cache and re-partition their own misses.  This
cache persists pass outputs across processes using the same
content-addressing discipline as :mod:`repro_torch.explore.cache`: entries
are sharded by key prefix (``<root>/ab/<key>.repro_torch.pkl``) and written
atomically (tmp + rename), so concurrent workers never observe torn
files and overlapping sweeps share partitions for free.

Payloads are pickles (pass outputs are ``CondensedGraph`` /
``PartitionResult`` objects, not JSON-shaped); a corrupt or
version-skewed entry is treated as a miss and overwritten.  Point every
process at the same directory via ``Pipeline(disk_cache=...)`` or the
``REPRO_TORCH_FLOW_CACHE`` environment variable (which
:func:`repro_torch.flow.default_pipeline` honors — that is how pool workers
inherit it).

The port copies the JAX package's pass keys verbatim, so its entries
carry their own file suffix (:data:`SUFFIX`): a directory shared with
the JAX package never hands the port one of that package's pickles
(unpickling one would import the JAX package), and the port never
counts, prunes or clears them.
"""

from __future__ import annotations

import bisect
import os
import pickle
import tempfile
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["PassDiskCache", "ENV_VAR", "SUFFIX"]

ENV_VAR = "REPRO_TORCH_FLOW_CACHE"
# the file suffix of the port's entries; the JAX package writes
# "<key>.pkl", which this suffix never matches
SUFFIX = ".repro_torch.pkl"


class PassDiskCache:
    """Sharded pickle cache keyed by the pipeline chain digest.

    Carries the same eviction discipline as
    :class:`repro_torch.explore.cache.ResultCache`: nothing ages out
    automatically, but :meth:`prune` drops entries older than
    ``max_age_days`` (file mtime) and then the oldest beyond
    ``max_entries`` — safe to run alongside live sweeps (``put`` is
    atomic, readers treat vanished files as misses).
    """

    def __init__(self, root: str,
                 max_age_days: Optional[float] = None,
                 max_entries: Optional[int] = None) -> None:
        self.root = root
        self.max_age_days = max_age_days
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.corrupt = 0    # unreadable entries dropped by get()

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + SUFFIX)

    def get(self, key: str) -> Tuple[bool, Any]:
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                out = pickle.load(f)
        except FileNotFoundError:
            self.misses += 1                  # plain miss: stay quiet
            return False, None
        except (OSError, pickle.UnpicklingError, EOFError,
                AttributeError, ImportError, ValueError,
                IndexError) as e:
            # the file exists but cannot be loaded: truncated by a
            # crash mid-copy, bit-rotted, or pickled against an older
            # class layout.  Drop it so the recompute can repopulate
            # the slot (put() is atomic, so we never tear a good entry)
            # and say so once — a silently swallowed corruption that
            # recurs every run is a debugging tarpit.
            warnings.warn(
                f"flow disk cache: dropping unreadable entry {path} "
                f"({type(e).__name__}: {e}); it will be recomputed",
                RuntimeWarning, stacklevel=2)
            try:
                os.unlink(path)
            except OSError:
                pass
            self.corrupt += 1
            self.misses += 1
            return False, None
        self.hits += 1
        return True, out

    def put(self, key: str, value: Any) -> None:
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
            with os.fdopen(fd, "wb") as f:
                pickle.dump(value, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _entries(self) -> List[Tuple[float, str]]:
        """All entry files as sorted ``(mtime, path)``, oldest first."""
        out: List[Tuple[float, str]] = []
        if not os.path.isdir(self.root):
            return out
        for shard in os.listdir(self.root):
            sdir = os.path.join(self.root, shard)
            try:
                names = os.listdir(sdir)
            except (NotADirectoryError, FileNotFoundError):
                continue
            for f in names:
                if not f.endswith(SUFFIX):
                    continue
                path = os.path.join(sdir, f)
                try:
                    out.append((os.path.getmtime(path), path))
                except OSError:
                    continue          # concurrently pruned
        out.sort()
        return out

    def prune(self, max_age_days: Optional[float] = None,
              max_entries: Optional[int] = None,
              now: Optional[float] = None) -> int:
        """Evict by age then by count; returns how many were removed.

        Limits default to the construction-time ones; ``None`` disables
        that criterion.  ``now`` is injectable for tests.
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
        removed = 0
        for path in doomed:
            try:
                os.unlink(path)
                removed += 1
            except OSError:
                pass
        for shard in os.listdir(self.root) if os.path.isdir(self.root) \
                else ():
            sdir = os.path.join(self.root, shard)
            if os.path.isdir(sdir) and not os.listdir(sdir):
                try:
                    os.rmdir(sdir)
                except OSError:
                    pass
        return removed

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def __len__(self) -> int:
        n = 0
        if not os.path.isdir(self.root):
            return 0
        for shard in os.listdir(self.root):
            sdir = os.path.join(self.root, shard)
            try:
                n += sum(1 for f in os.listdir(sdir)
                         if f.endswith(SUFFIX))
            except (NotADirectoryError, FileNotFoundError):
                continue
        return n

    def clear(self) -> int:
        n = 0
        if not os.path.isdir(self.root):
            return 0
        for shard in os.listdir(self.root):
            sdir = os.path.join(self.root, shard)
            try:
                names = os.listdir(sdir)
            except (NotADirectoryError, FileNotFoundError):
                continue
            for f in names:
                if f.endswith(SUFFIX):
                    try:
                        os.unlink(os.path.join(sdir, f))
                        n += 1
                    except OSError:
                        pass
            try:
                os.rmdir(sdir)
            except OSError:
                pass
        return n

    @property
    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "corrupt": self.corrupt}
