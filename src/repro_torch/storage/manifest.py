"""Store manifest: the single source of truth for one store generation.

Port of ``repro/storage/manifest.py``; the format is the reference's.

A spilled snapshot directory holds

  pages.bin        append-only packed pages (f64 rows, little-endian)
  meta-<gen>.npz   every non-row snapshot array (index metadata)
  manifest.json    THIS file: geometry + per-cluster extents + hashes

``manifest.json`` is the atomicity point.  Writers prepare everything
else first (append new page extents, write the new meta file, fsync),
then publish with a single ``os.replace`` of the manifest — a reader
either sees the previous complete generation or the new complete
generation, never a torn state.  Because a pages file is append-only,
page ids are immutable once written: a page cache keyed on
(file, page id) never needs invalidation across generations, and a
crashed writer leaves at worst unreferenced garbage pages.  Compaction
(``PagedStore.compact``) reclaims that garbage by switching
``pages_file`` to a freshly rewritten ``pages-<gen>.bin`` in the same
atomic swap; generation-bound views keep the retired file's name (and
mmap) so their page ids stay meaningful.

``cluster_sha1`` lets an incremental writer skip clusters whose row
bytes are unchanged (their extents carry over; only dirty clusters cost
IO on a refresh/retrain writeback).
"""
from __future__ import annotations

import json
import os
from dataclasses import asdict, dataclass, field

from .layout import PageLayout

MANIFEST_NAME = "manifest.json"
PAGES_NAME = "pages.bin"
FORMAT_VERSION = 1


def write_atomic(path: str, data: bytes) -> None:
    """temp file in the same directory + fsync + rename: the standard
    crash-safe publish (an interrupted writer can't truncate ``path``)."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


@dataclass
class Manifest:
    version: int
    generation: int
    page_bytes: int
    rows_per_page: int
    d: int
    n_max: int
    K: int
    total_pages: int
    extents: list = field(default_factory=list)        # (K,) start pages
    cluster_sha1: list = field(default_factory=list)   # (K,) row-byte hashes
    pages_file: str = PAGES_NAME
    meta_file: str = ""

    def layout(self) -> PageLayout:
        return PageLayout(page_bytes=self.page_bytes,
                          rows_per_page=self.rows_per_page,
                          d=self.d, n_max=self.n_max,
                          extents=tuple(self.extents))

    # ------------------------------------------------------------------- io
    @staticmethod
    def path_in(root: str) -> str:
        return os.path.join(root, MANIFEST_NAME)

    @classmethod
    def exists(cls, root: str) -> bool:
        return os.path.exists(cls.path_in(root))

    @classmethod
    def load(cls, root: str) -> "Manifest":
        with open(cls.path_in(root), "rb") as f:
            raw = json.loads(f.read().decode())
        if raw.get("version") != FORMAT_VERSION:
            raise ValueError(
                f"unsupported store format version {raw.get('version')!r}")
        return cls(**raw)

    def save(self, root: str) -> None:
        """Publish this generation: one atomic rename (see module doc)."""
        data = json.dumps(asdict(self), indent=1, sort_keys=True).encode()
        write_atomic(self.path_in(root), data)


__all__ = ["Manifest", "write_atomic", "MANIFEST_NAME", "PAGES_NAME",
           "FORMAT_VERSION"]
