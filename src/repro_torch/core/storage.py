"""Storage plane: persistence + data-lake media cost model.

Two concerns:

1. **Persistence** -- serialize :class:`~repro_torch.core.table.Table` objects to
   disk and back.  The physical container is one ``.gar`` file per table: a
   binary blob of column-chunk buffers with a JSON footer (mirroring the
   Parquet file/column/page metadata hierarchy of the paper's Fig. 2).

2. **Media cost model** -- the paper evaluates tmpfs / ESSD / OSS (Table 2).
   This container has a single local disk, so remote/cold media are modeled:
   an :class:`IOMeter` accumulates (bytes, requests) from every page-granular
   read, and a :class:`MediaModel` converts that into seconds with the
   bandwidth/latency of the paper's platforms.  Since data-lake reads are
   I/O-bound, "bytes touched" is exactly what the encodings optimize, and
   the modeled speedups track the paper's measured ones.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import struct
from typing import Dict, List, Optional

import numpy as np

from repro_torch.ft import faults as ft_faults

from .encoding import DeltaColumn, DeltaPage, RleColumn
from .table import (BoolPlainColumn, BoolRleColumn, Column, DeltaIntColumn,
                    PlainColumn, StringColumn, Table, TokensColumn)

MAGIC = b"GAR1"


# --------------------------------------------------------------------------
# media cost model
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MediaModel:
    """Seconds = requests * latency + bytes / bandwidth."""

    name: str
    bandwidth: float  # bytes / s
    latency: float    # s / request

    def seconds(self, nbytes: int, nrequests: int) -> float:
        return nrequests * self.latency + nbytes / self.bandwidth


#: Paper §6.1/§6.4 platforms: PL0 ESSD peaks at 180 MB/s; tmpfs is RAM;
#: OSS is S3-like object storage (high latency, moderate bandwidth).
TMPFS = MediaModel("tmpfs", bandwidth=8e9, latency=2e-7)
ESSD = MediaModel("essd", bandwidth=180e6, latency=1e-4)
OSS = MediaModel("oss", bandwidth=40e6, latency=8e-3)
MEDIA = {m.name: m for m in (TMPFS, ESSD, OSS)}


class IOMeter:
    """Accumulates the (bytes, requests) footprint of page-granular reads."""

    def __init__(self) -> None:
        self.nbytes = 0
        self.nrequests = 0

    def record(self, nbytes: int, nrequests: int = 1) -> None:
        self.nbytes += int(nbytes)
        self.nrequests += int(nrequests)

    def reset(self) -> None:
        self.nbytes = 0
        self.nrequests = 0

    def seconds(self, media: MediaModel) -> float:
        return media.seconds(self.nbytes, self.nrequests)

    def __repr__(self) -> str:
        return f"IOMeter(bytes={self.nbytes}, requests={self.nrequests})"


# --------------------------------------------------------------------------
# persistence: .gar single-file container (buffers + JSON footer)
# --------------------------------------------------------------------------

def _np_buf(arr: np.ndarray) -> bytes:
    return np.ascontiguousarray(arr).tobytes()


class _Writer:
    def __init__(self) -> None:
        self.bufs: List[bytes] = []
        self.offset = 0

    def put(self, data: bytes) -> Dict[str, int]:
        ref = {"offset": self.offset, "length": len(data)}
        self.bufs.append(data)
        self.offset += len(data)
        return ref


def _col_meta_and_bufs(col: Column, w: _Writer) -> dict:
    if isinstance(col, DeltaIntColumn):
        enc = col.encoded
        pages_meta = []
        for p in enc.pages:
            pages_meta.append({
                "count": p.count, "first": p.first_value,
                # per-page value statistics (partition plane pruning);
                # readers of files without them fall back to the
                # unknown-hull sentinel, which disables pruning only
                "vmin": p.vmin, "vmax": p.vmax,
                "min_deltas": w.put(_np_buf(p.min_deltas)),
                "bit_widths": w.put(_np_buf(p.bit_widths)),
                "word_offsets": w.put(_np_buf(p.word_offsets)),
                "packed": w.put(_np_buf(p.packed)),
            })
        return {"kind": "delta", "count": enc.count,
                "page_size": enc.page_size, "pages": pages_meta}
    if isinstance(col, BoolRleColumn):
        enc = col.encoded
        return {"kind": "rle", "count": enc.count,
                "first": bool(enc.first_value),
                "positions": w.put(_np_buf(enc.positions))}
    if isinstance(col, BoolPlainColumn):
        return {"kind": "bool_plain", "count": col.count,
                "data": w.put(_np_buf(col.values))}
    if isinstance(col, StringColumn):
        return {"kind": "string", "count": col.count,
                "offsets": w.put(_np_buf(col.offsets)),
                "payload": w.put(col.payload)}
    if isinstance(col, TokensColumn):
        return {"kind": "tokens", "count": col.count,
                "offsets": w.put(_np_buf(col.offsets)),
                "values": w.put(_np_buf(col.values))}
    if isinstance(col, PlainColumn):
        return {"kind": "plain", "count": col.count,
                "dtype": str(col.values.dtype),
                "data": w.put(_np_buf(col.values))}
    raise TypeError(f"unsupported column type {type(col)}")


def _atomic_write_bytes(path: str, blob: bytes, faults=None) -> int:
    """Durable write: temp file + ``os.replace`` (atomic on POSIX).

    Readers never observe a torn file at ``path`` -- they see either the
    old contents or the new ones.  A crash mid-write (exercised via the
    ``store.write`` fault boundary, injected between the two halves of
    the payload) leaves only a ``.tmp-*`` file that garbage collection
    removes; ``path`` itself is untouched.
    """
    tmp = f"{path}.tmp-{os.getpid()}"
    half = len(blob) // 2
    with open(tmp, "wb") as f:
        f.write(blob[:half])
        ft_faults.check(faults, "store.write")
        f.write(blob[half:])
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(blob)


def table_blob(table: Table) -> bytes:
    """The full ``.gar`` container bytes of ``table`` (in memory)."""
    w = _Writer()
    cols_meta = {}
    for name, col in table.columns.items():
        m = _col_meta_and_bufs(col, w)
        m["page_size"] = col.page_size
        cols_meta[name] = m
    footer = json.dumps({
        "name": table.name, "num_rows": table.num_rows,
        "page_size": table.page_size, "columns": cols_meta,
    }).encode("utf-8")
    return b"".join([MAGIC, *w.bufs, footer,
                     struct.pack("<I", len(footer)), MAGIC])


def write_table(table: Table, path: str, faults=None) -> int:
    """Serialize ``table`` to ``path`` (.gar), atomically.

    Returns file size in bytes.  The container is staged as a sibling
    temp file and renamed into place, so a crash mid-write never
    corrupts an existing table.
    """
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    return _atomic_write_bytes(path, table_blob(table), faults)


def _read_ref(data: bytes, ref: dict, dtype=None) -> np.ndarray:
    raw = data[ref["offset"]:ref["offset"] + ref["length"]]
    if dtype is None:
        return raw
    return np.frombuffer(raw, dtype=dtype).copy()


def read_table(path: str) -> Table:
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:4] != MAGIC or blob[-4:] != MAGIC:
        raise ValueError(f"{path}: not a GraphAr container")
    (footer_len,) = struct.unpack("<I", blob[-8:-4])
    footer = json.loads(blob[-8 - footer_len:-8].decode("utf-8"))
    body = blob[4:]
    table = Table(footer["name"], footer["num_rows"], footer["page_size"])
    for name, m in footer["columns"].items():
        ps = m.get("page_size", table.page_size)
        kind = m["kind"]
        if kind == "delta":
            pages = []
            for pm in m["pages"]:
                pages.append(DeltaPage(
                    count=pm["count"], first_value=pm["first"],
                    min_deltas=_read_ref(body, pm["min_deltas"], np.int64),
                    bit_widths=_read_ref(body, pm["bit_widths"], np.uint8),
                    word_offsets=_read_ref(body, pm["word_offsets"], np.int32),
                    packed=_read_ref(body, pm["packed"], np.uint32),
                    vmin=pm.get("vmin", 0), vmax=pm.get("vmax", -1)))
            col = DeltaIntColumn.__new__(DeltaIntColumn)
            col.name, col.count, col.page_size = name, m["count"], ps
            col.encoded = DeltaColumn(m["count"], m["page_size"], pages)
        elif kind == "rle":
            col = BoolRleColumn.__new__(BoolRleColumn)
            col.name, col.count, col.page_size = name, m["count"], ps
            col.encoded = RleColumn(m["count"], m["first"],
                                    _read_ref(body, m["positions"], np.int64))
        elif kind == "bool_plain":
            col = BoolPlainColumn(name, _read_ref(body, m["data"], np.bool_),
                                  ps)
        elif kind == "string":
            col = StringColumn.from_parts(
                name, _read_ref(body, m["offsets"], np.int64),
                bytes(_read_ref(body, m["payload"])), ps)
        elif kind == "tokens":
            col = TokensColumn.from_parts(
                name, _read_ref(body, m["offsets"], np.int64),
                _read_ref(body, m["values"], np.int32), ps)
        elif kind == "plain":
            col = PlainColumn(name, _read_ref(body, m["data"],
                                              np.dtype(m["dtype"])), ps)
        else:
            raise ValueError(f"unknown column kind {kind}")
        table.add(col)
    return table


# --------------------------------------------------------------------------
# dataset-level store: a directory of .gar files + graph.yaml
# --------------------------------------------------------------------------

MANIFEST = "manifest.json"
_GEN_RE = re.compile(r"\.g\d+\.gar$")


class GraphStore:
    """Directory layout: ``<root>/graph.yaml`` + ``<root>/<table>.gar``.

    Crash consistency (mutable plane): every file lands via temp +
    ``os.replace``, and multi-file updates (compaction writing a new
    generation of edge tables) commit through **one** atomic manifest
    flip -- ``manifest.json`` maps each logical table name to the
    physical generation file (``<name>.g<gen>.gar``) that serves it.
    Readers follow the manifest when present and read the write-once
    ``<name>.gar`` layout otherwise.  Files orphaned by a crash (staged
    generations never committed, ``.tmp-*`` files) are removed by
    :func:`repro_torch.core.compaction.gc.collect_garbage`.  The layout
    is the JAX package's, so a store written by either package reads in
    the other.
    """

    def __init__(self, root: str, faults=None):
        self.root = root
        #: optional :class:`repro_torch.ft.faults.FaultPlan` threaded
        #: into every write this store issues
        self.faults = faults

    def table_path(self, name: str) -> str:
        return os.path.join(self.root, f"{name}.gar")

    # -- manifest (the atomic commit point) ----------------------------------
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def manifest(self) -> Optional[dict]:
        """The committed manifest, or None for a legacy/fresh store."""
        try:
            with open(self.manifest_path(), "r", encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def current_generation(self) -> int:
        m = self.manifest()
        return 0 if m is None else int(m.get("generation", 0))

    def commit_manifest(self, tables: Dict[str, str],
                        generation: int) -> None:
        """Atomically flip the manifest pointer -- the single commit
        point of a multi-file update.  ``tables`` maps logical table
        names to physical filenames inside the store root."""
        blob = json.dumps({"generation": int(generation),
                           "tables": dict(tables)},
                          sort_keys=True).encode("utf-8")
        os.makedirs(self.root, exist_ok=True)
        _atomic_write_bytes(self.manifest_path(), blob, self.faults)

    def write(self, table: Table) -> int:
        return write_table(table, self.table_path(table.name),
                           self.faults)

    def write_generation(self, table: Table, generation: int) -> str:
        """Stage one generation file (``<name>.g<gen>.gar``); invisible
        to readers until :meth:`commit_manifest` references it."""
        fname = f"{table.name}.g{int(generation)}.gar"
        write_table(table, os.path.join(self.root, fname), self.faults)
        return fname

    def read(self, name: str) -> Table:
        m = self.manifest()
        if m is not None and name in m.get("tables", {}):
            return read_table(os.path.join(self.root,
                                           m["tables"][name]))
        return read_table(self.table_path(name))

    def write_schema_yaml(self, schema) -> None:
        schema.save(os.path.join(self.root, "graph.yaml"))

    def read_schema_yaml(self):
        from .schema import GraphSchema
        return GraphSchema.load(os.path.join(self.root, "graph.yaml"))

    def list_tables(self) -> List[str]:
        if not os.path.isdir(self.root):
            return []
        m = self.manifest()
        names = set() if m is None else set(m.get("tables", {}))
        for f in os.listdir(self.root):
            # legacy write-once files; generation files only count via
            # the manifest (an uncommitted one is invisible garbage)
            if f.endswith(".gar") and not _GEN_RE.search(f):
                names.add(f[:-4])
        return sorted(names)
