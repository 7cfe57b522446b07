"""Memory-mapped compressed binary document store (counterpart of
``osr_tpu/storage/doc_store.py``, the same file format: a store written by
either package opens in the other).

Capability parity with the reference's two storage implementations
(rag_system/core/memory_index.py and tests/memory_mapping.py: per-doc
binary records, zlib compression above a size threshold, an offset index,
an LRU cache, batch fetch through a thread pool, sequential scans, and an
``optimize`` re-compaction pass) — unified into one store.

Format (single ``.osrd`` file):

    [magic 'OSRD'][u32 version][u64 footer_offset]
    [blob section: per-doc payloads, 16-byte aligned]
    [footer: JSON {doc_id: [offset, stored_len, raw_len, flags]} zlib]

The footer keeps the offset table human-debuggable while the hot path —
random access into the blob section — goes through ``mmap`` so the OS page
cache, not Python, decides residency (the corpus never has to fit in RAM).
Payloads over ``compress_threshold`` bytes are zlib-compressed only when
that actually shrinks them (the reference compressed unconditionally and
measured a 0.993x "compression" ratio on incompressible data; see
BASELINE.md). v2 payloads are length-prefixed binary fields (FLAG_BINARY);
v1 JSON-object payloads still decode, so old stores keep reading.

Unlike the reference's ``add_documents`` (which rewrites the whole file on
every call, reference memory_index.py:300-335), appends here are
incremental: new blobs append to the blob section and the footer is
rewritten in place at the end.
"""

from __future__ import annotations

import json
import logging
import mmap
import struct
import threading
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Union

from osr_tpu_torch.storage.documents import Document

logger = logging.getLogger(__name__)

MAGIC = b"OSRD"
VERSION = 2  # v2 adds FLAG_BINARY payloads; v1 files (JSON-only) still read
VERSION_DICT = 3  # v3 footer = {"docs": ..., "zdict": base64|None,
# "codec": ...}. Written whenever the store is zstd-flavored — a trained
# dictionary exists, the configured codec is zstd, or ANY record carries
# FLAG_ZSTD — so a pre-zstd v2 reader fails loudly on its version gate
# instead of silently struct-unpacking zstd frames as raw records.
# Plain-zlib stores keep writing v2 flat footers, byte-compatible.
HEADER_FMT = "<4sIQ"  # magic, version, footer offset
HEADER_SIZE = struct.calcsize(HEADER_FMT)
ALIGN = 16

FLAG_COMPRESSED = 1  # zlib
FLAG_BINARY = 2  # length-prefixed fields instead of a JSON object
FLAG_ZSTD = 4  # zstd-compressed payload (flag-extensible format: the
# codec travels per record, so zlib and zstd records coexist in one
# store and any store reads regardless of the store's configured codec)

_BIN_HDR = "<III"  # text_len, title_len, metadata_json_len
_BIN_HDR_SIZE = struct.calcsize(_BIN_HDR)

try:  # optional: faster + denser codec where the wheel exists
    import zstandard as _zstd
except ImportError:  # pragma: no cover - environment dependent
    _zstd = None

# ZstdDecompressor instances are reusable but not thread-safe; reads can
# fan out through get_documents' thread pool, so keep one per thread —
# keyed by the store's dictionary, because dict-compressed frames
# reference the dictionary id and cannot decode without it.
_zstd_local = threading.local()


def _zstd_decompress(payload: bytes, raw_len: int, zdict=None) -> bytes:
    if _zstd is None:
        raise ValueError(
            "store record is zstd-compressed but the zstandard module "
            "is not available"
        )
    cache = getattr(_zstd_local, "dctx", None)
    if cache is None:
        cache = _zstd_local.dctx = {}
    dctx = cache.get(id(zdict))
    if dctx is None:
        dctx = cache[id(zdict)] = (
            _zstd.ZstdDecompressor(dict_data=zdict)
            if zdict is not None
            else _zstd.ZstdDecompressor()
        )
    # Frames written by ZstdCompressor.compress() embed the content size;
    # max_output_size covers externally produced frames that omit it.
    return dctx.decompress(payload, max_output_size=raw_len)


class LRUCache:
    """Thread-safe LRU bounded by entry count and total payload bytes
    (reference memory_index.py:37-104 semantics)."""

    def __init__(self, max_items: int = 1000, max_bytes: int = 100 * 2**20):
        self.max_items = max_items
        self.max_bytes = max_bytes
        self._data: OrderedDict[str, Document] = OrderedDict()
        self._sizes: Dict[str, int] = {}
        self._bytes = 0
        self._lock = threading.RLock()
        self.hits = 0
        self.misses = 0

    def get(self, key: str) -> Optional[Document]:
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self.hits += 1
                return self._data[key]
            self.misses += 1
            return None

    def put(self, key: str, doc: Document) -> None:
        size = len(doc.text) + len(doc.title) + 64
        with self._lock:
            if key in self._data:
                self._bytes -= self._sizes[key]
                del self._data[key]
            self._data[key] = doc
            self._sizes[key] = size
            self._bytes += size
            while self._data and (
                len(self._data) > self.max_items or self._bytes > self.max_bytes
            ):
                old_key, _ = self._data.popitem(last=False)
                self._bytes -= self._sizes.pop(old_key)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()
            self._sizes.clear()
            self._bytes = 0

    def discard(self, key: str) -> None:
        with self._lock:
            if key in self._data:
                del self._data[key]
                self._bytes -= self._sizes.pop(key)

    def stats(self) -> Dict[str, float]:
        with self._lock:
            total = self.hits + self.misses
            return {
                "items": len(self._data),
                "bytes": self._bytes,
                "hit_rate": self.hits / total if total else 0.0,
            }

    def __len__(self) -> int:
        return len(self._data)


def _raw_record(doc: Document) -> bytes:
    # v2 binary record: three length-prefixed fields (text, title,
    # metadata-as-JSON — empty metadata writes zero bytes). Decoding is a
    # struct.unpack + slices instead of a json.loads of the whole record,
    # which dominated the sequential-scan profile (~8 us/doc of the
    # ~15 us total at median FiQA doc size).
    text_b = doc.text.encode("utf-8")
    title_b = doc.title.encode("utf-8")
    meta_b = (
        json.dumps(doc.metadata, ensure_ascii=False).encode("utf-8")
        if doc.metadata
        else b""
    )
    return (
        struct.pack(_BIN_HDR, len(text_b), len(title_b), len(meta_b))
        + text_b
        + title_b
        + meta_b
    )


def _encode_payload(
    doc: Document,
    compress_threshold: int,
    compress_level: int = 1,
    compressor=None,  # ZstdCompressor -> zstd records; None -> zlib
) -> tuple:
    raw = _raw_record(doc)
    flags = FLAG_BINARY
    payload = raw
    if len(raw) > compress_threshold:
        if compressor is not None:
            compressed = compressor.compress(raw)
            codec_flag = FLAG_ZSTD
        else:
            compressed = zlib.compress(raw, compress_level)
            codec_flag = FLAG_COMPRESSED
        if len(compressed) < len(raw):
            payload = compressed
            flags |= codec_flag
    return payload, len(raw), flags


def _decode_payload(
    payload: bytes, raw_len: int, flags: int, doc_id: str, zdict=None
) -> Document:
    if flags & FLAG_ZSTD:
        payload = _zstd_decompress(payload, raw_len, zdict)
    elif flags & FLAG_COMPRESSED:
        # CPython's zlib is the same C library already; the ctypes-bound
        # native codec pays ~30 us of per-call marshalling
        # (create_string_buffer zero-fill + argument conversion) vs
        # ~1.6 us total for zlib.decompress at median doc size — the
        # native codec is for C++-internal batch paths, never per-doc.
        payload = zlib.decompress(payload)
    if flags & FLAG_BINARY:
        text_len, title_len, meta_len = struct.unpack_from(_BIN_HDR, payload)
        off = _BIN_HDR_SIZE
        text = payload[off : off + text_len].decode("utf-8")
        off += text_len
        title = payload[off : off + title_len].decode("utf-8")
        off += title_len
        meta = (
            json.loads(payload[off : off + meta_len].decode("utf-8"))
            if meta_len
            else {}
        )
        return Document(id=doc_id, text=text, title=title, metadata=meta)
    # v1 record: one JSON object
    record = json.loads(payload.decode("utf-8"))
    return Document(
        id=doc_id,
        text=record.get("text", ""),
        title=record.get("title", ""),
        metadata=record.get("metadata", {}),
    )


class DocumentStore:
    """Create/read a compressed binary corpus with mmap random access."""

    def __init__(
        self,
        path: Union[str, Path],
        create: bool = False,
        cache_items: int = 1000,
        cache_bytes: int = 100 * 2**20,
        compress_threshold: int = 128,
        compress_level: int = 1,
        num_workers: int = 4,
        codec: str = "zlib",
        zdict: Optional[bytes] = None,
    ):
        self.path = Path(path)
        self.compress_threshold = compress_threshold
        # Level 1 on the ingest path: ~3x cheaper than level 6 at a few
        # percent ratio cost (level 6 spent half of the measured build
        # time); optimize(compress_level=6) recompresses at rest.
        self.compress_level = compress_level
        # codec='zstd' writes new records as zstd frames (the flag travels
        # per record; reading is codec-agnostic). zlib stays the default:
        # it is stdlib-everywhere and the reference's choice.
        if codec not in ("zlib", "zstd"):
            raise ValueError(f"Unknown codec: {codec!r}")
        if codec == "zstd" and _zstd is None:  # pragma: no cover - env
            logger.warning("zstandard unavailable; falling back to zlib")
            codec = "zlib"
        self.codec = codec
        # A trained zstd dictionary (record payloads are ~1 KB, exactly
        # what dictionaries exist for: measured ratio 3.5 vs zlib-6's 1.9
        # on real prose at 4-5x the speed). Usually produced by
        # optimize(train_dict=True) and persisted in the v3 footer; a
        # pre-trained dict can be supplied here for a new store.
        self._zdict_bytes: Optional[bytes] = None
        self._zdict_obj = None
        if zdict is not None:
            if codec != "zstd":
                raise ValueError("zdict requires codec='zstd'")
            self._set_zdict(zdict)
        self._make_compressor()
        self.num_workers = num_workers
        self.cache = LRUCache(cache_items, cache_bytes)
        self._lock = threading.RLock()
        self._index: Dict[str, List[int]] = {}  # id -> [off, stored, raw, flags]
        self._mm: Optional[mmap.mmap] = None
        self._file = None
        if create or not self.path.exists():
            self._init_empty()
        self._open()

    # -- file lifecycle ---------------------------------------------------

    def _set_zdict(self, zdict_bytes: bytes) -> None:
        if _zstd is None:  # pragma: no cover - environment dependent
            raise ValueError(
                "store has a zstd dictionary but the zstandard module "
                "is not available"
            )
        self._zdict_bytes = zdict_bytes
        self._zdict_obj = _zstd.ZstdCompressionDict(zdict_bytes)

    def _make_compressor(self) -> None:
        if self.codec == "zstd":
            self._compressor = (
                _zstd.ZstdCompressor(
                    level=self.compress_level, dict_data=self._zdict_obj
                )
                if self._zdict_obj is not None
                else _zstd.ZstdCompressor(level=self.compress_level)
            )
        else:
            self._compressor = None

    def _init_empty(self) -> None:
        self.path.parent.mkdir(parents=True, exist_ok=True)
        with open(self.path, "wb") as f:
            footer = zlib.compress(json.dumps({}).encode())
            f.write(struct.pack(HEADER_FMT, MAGIC, VERSION, HEADER_SIZE))
            f.write(footer)

    def _open(self) -> None:
        self._file = open(self.path, "r+b")
        header = self._file.read(HEADER_SIZE)
        if len(header) < HEADER_SIZE:
            raise ValueError(f"Truncated store header: {self.path}")
        magic, version, footer_off = struct.unpack(HEADER_FMT, header)
        if magic != MAGIC:
            raise ValueError(f"Not an OSRD store: {self.path}")
        if version not in (1, VERSION, VERSION_DICT):  # v1 = JSON payloads
            raise ValueError(f"Unsupported store version {version}")
        self._file.seek(footer_off)
        footer = self._file.read()
        if footer:
            # decompressobj tolerates trailing bytes: after crash recovery
            # the header can point at an old footer that is followed by the
            # partial blobs of an interrupted append.
            data = zlib.decompressobj().decompress(footer)
            parsed = json.loads(data.decode())
            if version == VERSION_DICT:
                self._index = parsed["docs"]
                if parsed.get("zdict"):
                    import base64

                    # The file's persisted dictionary is authoritative:
                    # its frames reference this dict's id.
                    self._set_zdict(base64.b64decode(parsed["zdict"]))
                # The persisted codec wins on reopen (a reopened
                # dict-trained store must keep appending zstd frames, and
                # a no-arg optimize() must preserve them); convert with
                # optimize(codec=...). Degrade to zlib appends if the
                # zstandard module has gone missing.
                file_codec = parsed.get("codec")
                if file_codec in ("zlib", "zstd"):
                    if file_codec == "zstd" and _zstd is None:
                        logger.warning(  # pragma: no cover - env
                            "store %s is zstd-flavored but zstandard is "
                            "unavailable; appends fall back to zlib "
                            "(existing zstd records will fail to read)",
                            self.path,
                        )
                    else:
                        self.codec = file_codec
                self._make_compressor()
            else:
                self._index = parsed
        else:
            self._index = {}
        self._has_zstd_records = any(
            e[3] & FLAG_ZSTD for e in self._index.values()
        )
        self._footer_off = footer_off
        self._remap()

    def _remap(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        if self.path.stat().st_size > 0:
            self._mm = mmap.mmap(
                self._file.fileno(), 0, access=mmap.ACCESS_READ
            )

    # -- writes -----------------------------------------------------------

    def add_documents(self, docs: Iterable[Document]) -> int:
        """Incrementally append documents and write a new footer.

        Crash-safe in two senses. Against a raising ``docs`` iterable: the
        footer and header are finalized for every document successfully
        written before the exception, so the partial batch is committed.
        Against a process crash / power loss mid-append: new blobs are
        written AFTER the old footer (never over it), the new footer is
        written and fsynced, and only then does the 8-byte header pointer
        flip to it (fsynced again) — at every instant the header points at
        an intact footer, so previously committed documents survive. The
        dead bytes of superseded footers are reclaimed by :meth:`optimize`.
        """
        import os

        with self._lock:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            # Start after everything already on disk (old footer included).
            self._file.seek(0, 2)
            pos = self._file.tell()
            count = 0
            try:
                for doc in docs:
                    payload, raw_len, flags = _encode_payload(
                        doc,
                        self.compress_threshold,
                        self.compress_level,
                        self._compressor,
                    )
                    pad = (-pos) % ALIGN
                    if pad:
                        self._file.write(b"\0" * pad)
                        pos += pad
                    self._file.write(payload)
                    self._index[doc.id] = [pos, len(payload), raw_len, flags]
                    if flags & FLAG_ZSTD:
                        self._has_zstd_records = True
                    # A re-added id supersedes any cached copy.
                    self.cache.discard(doc.id)
                    pos += len(payload)
                    count += 1
            finally:
                if (
                    self._zdict_bytes is not None
                    or self.codec == "zstd"
                    or self._has_zstd_records
                ):
                    import base64

                    version = VERSION_DICT
                    footer_obj: object = {
                        "docs": self._index,
                        "zdict": (
                            base64.b64encode(self._zdict_bytes).decode(
                                "ascii"
                            )
                            if self._zdict_bytes is not None
                            else None
                        ),
                        "codec": self.codec,
                    }
                else:  # plain-zlib stores stay byte-compatible with v2
                    version = VERSION
                    footer_obj = self._index
                footer = zlib.compress(json.dumps(footer_obj).encode())
                self._file.seek(pos)
                self._file.write(footer)
                self._file.truncate(pos + len(footer))
                self._file.flush()
                os.fsync(self._file.fileno())  # footer durable first
                self._file.seek(0)
                self._file.write(struct.pack(HEADER_FMT, MAGIC, version, pos))
                self._file.flush()
                os.fsync(self._file.fileno())  # then the pointer flip
                self._footer_off = pos
                self._remap()
            return count

    def optimize(
        self,
        compress_level: Optional[int] = None,
        codec: Optional[str] = None,
        train_dict: bool = False,
        dict_size: int = 110 * 1024,
        dict_samples: int = 10_000,
    ) -> None:
        """Re-compact the blob section (drops holes left by re-adds;
        reference memory_index.py:501-525 capability).

        Streams through a temp file + atomic rename, so memory stays
        bounded and a crash mid-compaction leaves the original intact.
        ``compress_level`` recompresses records at a different level
        (e.g. 6 for archival after a level-1 fast ingest); ``codec``
        converts between 'zlib' and 'zstd' at rest. ``train_dict=True``
        (implies codec='zstd') trains a zstd dictionary on up to
        ``dict_samples`` record payloads and recompresses every record
        with it — on ~1 KB prose records the measured ratio is 3.5 vs
        zlib-6's 1.9 at 4-5x the speed; the dictionary persists in the
        store footer (v3), so reopening needs nothing extra."""
        import os

        zdict_bytes = self._zdict_bytes
        if train_dict:
            if _zstd is None:  # pragma: no cover - environment dependent
                raise ValueError(
                    "train_dict requires the zstandard module"
                )
            codec = "zstd"
            n = len(self._index)
            step = max(1, n // dict_samples)
            samples = [
                _raw_record(doc)
                for i, doc in enumerate(self.iter_documents())
                if i % step == 0
            ]
            try:
                zdict_bytes = _zstd.train_dictionary(
                    dict_size, samples
                ).as_bytes()
            except _zstd.ZstdError as e:
                # Too few / too-small samples (tiny or empty stores):
                # compact with plain zstd rather than failing the pass.
                logger.warning(
                    "zstd dictionary training skipped (%s); "
                    "compacting without a dictionary", e
                )
                zdict_bytes = None

        tmp_path = self.path.with_suffix(self.path.suffix + ".compact")
        with self._lock:
            tmp = DocumentStore(
                tmp_path,
                create=True,
                compress_threshold=self.compress_threshold,
                compress_level=(
                    self.compress_level
                    if compress_level is None
                    else compress_level
                ),
                codec=self.codec if codec is None else codec,
                zdict=(
                    zdict_bytes
                    if (codec or self.codec) == "zstd"
                    else None
                ),
            )
            try:
                tmp.add_documents(self.iter_documents())
            finally:
                tmp.close()
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            self._file.close()
            os.replace(tmp_path, self.path)
            self.cache.clear()
            self._index.clear()
            self._file = None
            # Future appends keep writing whatever the compaction wrote.
            self.codec = tmp.codec
            self._compressor = tmp._compressor
            self._zdict_bytes = tmp._zdict_bytes
            self._zdict_obj = tmp._zdict_obj
            if compress_level is not None:
                self.compress_level = compress_level
            self._open()

    # -- reads ------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._index)

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._index

    def doc_ids(self) -> List[str]:
        return list(self._index.keys())

    def get_document(self, doc_id: str) -> Optional[Document]:
        cached = self.cache.get(doc_id)
        if cached is not None:
            return cached
        doc = self._read_entry(doc_id)
        if doc is None:
            return None
        self.cache.put(doc_id, doc)
        return doc

    def _read_entry(
        self, doc_id: str, entry: Optional[List[int]] = None
    ) -> Optional[Document]:
        # Index lookup AND slice copy happen under the same lock, so a
        # concurrent optimize() can't swap the file between resolving the
        # offset and reading it (stale offsets against the compacted mmap
        # would return garbage); the (slower) decompress/decode runs
        # outside it. An explicit `entry` (iter_documents' on-disk-order
        # scan) is trusted as-is — that path holds no-writer invariants.
        with self._lock:
            if entry is None:
                entry = self._index.get(doc_id)
                if entry is None:
                    return None
            off, stored, raw_len, flags = entry
            if self._mm is None:
                raise ValueError(f"Store is closed: {self.path}")
            payload = bytes(self._mm[off : off + stored])
        return _decode_payload(payload, raw_len, flags, doc_id, self._zdict_obj)

    def get_documents(
        self, doc_ids: Sequence[str], num_workers: Optional[int] = None
    ) -> List[Optional[Document]]:
        """Batch fetch; misses resolved in parallel
        (reference memory_index.py:414-449 capability)."""
        workers = num_workers or self.num_workers
        if workers <= 1 or len(doc_ids) < 8:
            return [self.get_document(d) for d in doc_ids]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return list(pool.map(self.get_document, doc_ids))

    def iter_documents(self) -> Iterator[Document]:
        """Sequential scan in on-disk order."""
        for doc_id, entry in sorted(
            self._index.items(), key=lambda kv: kv[1][0]
        ):
            yield self._read_entry(doc_id, entry)

    def get_stats(self) -> Dict[str, object]:
        blob_bytes = self._footer_off - HEADER_SIZE
        raw_bytes = sum(e[2] for e in self._index.values())
        return {
            "num_documents": len(self._index),
            "file_bytes": self.path.stat().st_size,
            "blob_bytes": blob_bytes,
            "raw_bytes": raw_bytes,
            "compression_ratio": raw_bytes / blob_bytes if blob_bytes else 1.0,
            "codec": self.codec,
            "cache": self.cache.stats(),
        }

    def close(self) -> None:
        with self._lock:
            if self._mm is not None:
                self._mm.close()
                self._mm = None
            if self._file is not None:
                self._file.close()
                self._file = None
            self.cache.clear()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @classmethod
    def build_from_corpus(
        cls,
        corpus: Union[Dict[str, Dict], Iterable[Document]],
        path: Union[str, Path],
        **kwargs,
    ) -> "DocumentStore":
        """Build a store from a corpus mapping or Document iterable."""
        store = cls(path, create=True, **kwargs)

        def as_documents():
            if isinstance(corpus, dict):
                for doc_id, rec in corpus.items():
                    parsed = Document.from_record(
                        dict(rec) if isinstance(rec, dict) else {"text": rec},
                        fallback_id=str(doc_id),
                    )
                    # The mapping's key is authoritative for the id.
                    yield Document(
                        id=str(doc_id),
                        text=parsed.text,
                        title=parsed.title,
                        metadata=parsed.metadata,
                    )
            else:
                yield from corpus

        store.add_documents(as_documents())
        return store
