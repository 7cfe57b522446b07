"""The port's document storage (osr_tpu_torch/storage/documents.py and
doc_store.py), mirrored from the Document, CorpusProcessor, LRUCache and
DocumentStore tests of tests/test_storage.py (the dataset loaders wait for
the port's storage/loaders.py), plus stores read across packages: a store
written by either package opens in the other with every record, title
and metadata intact, for each codec.
"""

import json

import pytest

from osr_tpu_torch.storage import (
    CorpusProcessor,
    Document,
    DocumentStore,
    LRUCache,
)


def test_document_from_record():
    d = Document.from_record({"_id": "x", "content": "hello", "title": "T", "extra": 1})
    assert d.id == "x" and d.text == "hello" and d.title == "T"
    assert d.metadata == {"extra": 1}
    with pytest.raises(ValueError):
        Document(id="", text="x")
    d2 = Document.from_record({"text": "y"}, fallback_id="doc_9")
    assert d2.id == "doc_9"


def test_corpus_processor(tmp_path):
    path = tmp_path / "corpus.jsonl"
    lines = [
        json.dumps({"_id": f"d{i}", "text": f"document number {i}"})
        for i in range(50)
    ]
    lines.insert(10, "{broken json")
    lines.insert(20, "")
    path.write_text("\n".join(lines))
    proc = CorpusProcessor(num_workers=2, chunk_size=8)
    docs = proc.process(path)
    assert len(docs) == 50
    assert proc.stats["processed"] == 50
    assert proc.stats["json_errors"] == 1
    checksum = proc.compute_checksum(path)
    assert len(checksum) == 32 and checksum == proc.compute_checksum(path)


def test_lru_cache_eviction():
    cache = LRUCache(max_items=2, max_bytes=10**9)
    for i in range(3):
        cache.put(f"k{i}", Document(id=f"k{i}", text="t"))
    assert cache.get("k0") is None  # evicted
    assert cache.get("k2") is not None
    stats = cache.stats()
    assert stats["items"] == 2


def test_doc_store_roundtrip(tmp_path):
    path = tmp_path / "store.osrd"
    docs = [
        Document(id=f"d{i}", text=("lorem ipsum " * 50) + str(i), title=f"T{i}",
                 metadata={"n": i})
        for i in range(20)
    ]
    store = DocumentStore(path, create=True)
    assert store.add_documents(docs) == 20
    got = store.get_document("d7")
    assert got.text == docs[7].text and got.metadata == {"n": 7}
    # compression kicked in for repetitive text
    stats = store.get_stats()
    assert stats["compression_ratio"] > 2.0
    assert stats["num_documents"] == 20
    # batch fetch preserves order, returns None for misses
    batch = store.get_documents(["d3", "nope", "d1"])
    assert batch[0].id == "d3" and batch[1] is None and batch[2].id == "d1"
    store.close()

    # reopen from disk
    store2 = DocumentStore(path)
    assert len(store2) == 20
    assert store2.get_document("d19").title == "T19"
    assert [d.id for d in store2.iter_documents()][:3] == ["d0", "d1", "d2"]
    store2.close()


def test_doc_store_incremental_append_and_optimize(tmp_path):
    path = tmp_path / "s.osrd"
    store = DocumentStore(path, create=True)
    store.add_documents([Document(id="a", text="first " * 40)])
    store.add_documents([Document(id="b", text="second " * 40)])
    assert len(store) == 2
    # re-add 'a' with new text -> old blob becomes a hole
    store.add_documents([Document(id="a", text="updated " * 40)])
    size_before = path.stat().st_size
    store.optimize()
    assert path.stat().st_size <= size_before
    assert store.get_document("a").text.startswith("updated")
    assert store.get_document("b").text.startswith("second")
    store.close()


def test_doc_store_build_from_corpus(tmp_path):
    corpus = {"x1": {"text": "alpha beta"}, "x2": {"content": "gamma"}}
    store = DocumentStore.build_from_corpus(corpus, tmp_path / "c.osrd")
    assert store.get_document("x2").text == "gamma"
    store.close()


def test_add_documents_partial_failure_keeps_store_readable(tmp_path):
    store = DocumentStore(tmp_path / "p.osrd", create=True)

    def bad_docs():
        yield Document(id="good1", text="alpha " * 40)
        yield Document(id="good2", text="beta " * 40)
        raise RuntimeError("upstream iterator died")

    with pytest.raises(RuntimeError):
        store.add_documents(bad_docs())
    # The successfully-written prefix is committed and readable.
    assert store.get_document("good1").text.startswith("alpha")
    store.close()
    reopened = DocumentStore(tmp_path / "p.osrd")
    assert len(reopened) == 2
    assert reopened.get_document("good2").text.startswith("beta")
    reopened.close()


def test_doc_store_crash_mid_append_keeps_committed_docs(tmp_path):
    """A crash after new blobs are written but BEFORE the header pointer
    flips must leave every previously committed document readable (the
    header still points at the old, intact footer)."""
    path = tmp_path / "crash.osrd"
    store = DocumentStore(path, create=True)
    store.add_documents([Document(id="a", text="alpha " * 50)])
    store.close()
    pre_crash = path.read_bytes()

    store = DocumentStore(path)
    store.add_documents([Document(id="b", text="beta " * 50)])
    store.close()
    post = bytearray(path.read_bytes())

    # Simulate the crash: batch-2 bytes are on disk, but the 16-byte header
    # still holds its pre-append contents (pointer at the OLD footer).
    post[:16] = pre_crash[:16]
    # And simulate a torn tail: truncate the last few bytes of the new
    # footer as a power loss mid-write would.
    crashed = bytes(post[:-7])
    path.write_bytes(crashed)

    recovered = DocumentStore(path)
    assert recovered.get_document("a").text.startswith("alpha")
    assert recovered.get_document("b") is None  # uncommitted batch lost
    # The store remains appendable after recovery.
    recovered.add_documents([Document(id="c", text="gamma " * 50)])
    assert recovered.get_document("c").text.startswith("gamma")
    assert recovered.get_document("a").text.startswith("alpha")
    recovered.close()


def test_v1_json_payload_still_decodes(tmp_path):
    """v2 readers must decode v1 records (JSON object, no FLAG_BINARY) and
    v1-version files."""
    import json
    import struct
    import zlib

    from osr_tpu_torch.storage import doc_store as ds

    rec = {"text": "hello world", "title": "t", "metadata": {"a": 1}}
    raw = json.dumps(rec).encode()
    doc = ds._decode_payload(raw, len(raw), 0, "d1")
    assert (doc.text, doc.title, doc.metadata) == ("hello world", "t", {"a": 1})
    comp = zlib.compress(raw)
    doc = ds._decode_payload(comp, len(raw), ds.FLAG_COMPRESSED, "d1")
    assert doc.text == "hello world"

    # A whole v1 file: header says version=1, one JSON record.
    p = tmp_path / "v1.osrd"
    payload = raw
    off = ds.HEADER_SIZE
    index = {"d1": [off, len(payload), len(raw), 0]}
    footer = zlib.compress(json.dumps(index).encode())
    with open(p, "wb") as f:
        f.write(struct.pack(ds.HEADER_FMT, ds.MAGIC, 1, off + len(payload)))
        f.write(payload)
        f.write(footer)
    store = ds.DocumentStore(p)
    got = store.get_document("d1")
    assert got is not None and got.text == "hello world"
    store.close()


def test_binary_payload_roundtrip_fields():
    from osr_tpu_torch.storage import doc_store as ds
    from osr_tpu_torch.storage.documents import Document

    doc = Document(id="x", text="ünïcode ✓ text", title="tïtle",
                   metadata={"k": [1, 2]})
    payload, raw_len, flags = ds._encode_payload(doc, compress_threshold=10**9)
    assert flags & ds.FLAG_BINARY and not (flags & ds.FLAG_COMPRESSED)
    back = ds._decode_payload(payload, raw_len, flags, "x")
    assert (back.text, back.title, back.metadata) == (
        doc.text, doc.title, doc.metadata
    )
    # empty metadata writes zero meta bytes and decodes to {}
    doc2 = Document(id="y", text="a", title="", metadata={})
    payload2, raw_len2, flags2 = ds._encode_payload(doc2, 10**9)
    assert ds._decode_payload(payload2, raw_len2, flags2, "y").metadata == {}


def _prose_docs(n=300):
    import random

    rng = random.Random(42)
    words = (
        "retrieval sparse index query document ranking latency throughput "
        "memory compression benchmark pipeline evaluation corpus token "
        "vector quantization storage footer payload".split()
    )
    return [
        Document(
            id=f"p{i}",
            text=" ".join(rng.choice(words) for _ in range(120)),
            title=f"T{i}",
            metadata={"i": i},
        )
        for i in range(n)
    ]


def test_doc_store_zstd_codec_roundtrip(tmp_path):
    pytest.importorskip("zstandard")
    path = tmp_path / "z.osrd"
    docs = _prose_docs(50)
    store = DocumentStore(path, create=True, codec="zstd")
    store.add_documents(docs)
    stats = store.get_stats()
    assert stats["codec"] == "zstd"
    assert stats["compression_ratio"] > 1.5
    assert store.get_document("p7").text == docs[7].text
    store.close()
    # reopening with the DEFAULT codec still reads zstd records (the
    # codec flag travels per record)
    store2 = DocumentStore(path)
    assert store2.get_document("p49").metadata == {"i": 49}
    # mixed-codec store: zlib appends coexist with zstd records
    store2.add_documents([Document(id="extra", text="mixed " * 60)])
    assert store2.get_document("extra").text.startswith("mixed")
    assert store2.get_document("p3").text == docs[3].text
    store2.close()


def test_doc_store_zstd_dict_optimize(tmp_path):
    pytest.importorskip("zstandard")
    path = tmp_path / "d.osrd"
    docs = _prose_docs(400)
    store = DocumentStore(path, create=True)  # plain zlib ingest
    store.add_documents(docs)
    ratio_zlib = store.get_stats()["compression_ratio"]
    store.optimize(train_dict=True)
    stats = store.get_stats()
    assert stats["codec"] == "zstd"
    # dictionary compression must beat the zlib baseline on these
    # small same-domain records
    assert stats["compression_ratio"] > ratio_zlib
    assert store.get_document("p123").text == docs[123].text
    # appends after optimize use the dictionary and stay readable
    store.add_documents([Document(id="after", text=docs[0].text)])
    assert store.get_document("after").text == docs[0].text
    store.close()

    # the dictionary persists in the footer: a fresh open reads frames
    store2 = DocumentStore(path)
    assert store2.get_document("p321").text == docs[321].text
    assert store2.get_document("after").text == docs[0].text
    # threaded batch fetch exercises the per-thread decompressors
    got = store2.get_documents([f"p{i}" for i in range(0, 400, 7)])
    assert all(g is not None for g in got)
    # converting back to zlib at rest drops the dict cleanly
    store2.optimize(codec="zlib")
    assert store2.get_stats()["codec"] == "zlib"
    assert store2.get_document("p321").text == docs[321].text
    store2.close()


def test_doc_store_zstd_codec_and_dict_survive_reopen(tmp_path):
    """Code-review regression: the persisted codec must win on reopen —
    appends keep writing zstd, and a no-arg optimize() must NOT silently
    recompress everything back to zlib / drop the trained dictionary."""
    pytest.importorskip("zstandard")
    path = tmp_path / "r.osrd"
    docs = _prose_docs(300)
    store = DocumentStore(path, create=True)
    store.add_documents(docs)
    store.optimize(train_dict=True)
    ratio_dict = store.get_stats()["compression_ratio"]
    store.close()

    again = DocumentStore(path)  # default codec arg
    assert again.codec == "zstd"
    assert again._zdict_bytes is not None
    again.add_documents([Document(id="late", text=docs[0].text)])
    assert again._index["late"][3] & 4  # FLAG_ZSTD: dict compressor used
    again.optimize()  # no-arg compaction keeps the zstd dictionary
    stats = again.get_stats()
    assert stats["codec"] == "zstd"
    assert stats["compression_ratio"] >= ratio_dict * 0.95
    assert again.get_document("p123").text == docs[123].text
    again.close()


def test_doc_store_plain_zstd_store_is_version_gated(tmp_path):
    """A dict-less zstd store must carry the v3 header so pre-zstd v2
    readers fail loudly instead of misparsing zstd frames."""
    pytest.importorskip("zstandard")
    import struct

    path = tmp_path / "g.osrd"
    store = DocumentStore(path, create=True, codec="zstd")
    store.add_documents(_prose_docs(20))
    store.close()
    with open(path, "rb") as f:
        magic, version, _ = struct.unpack("<4sIQ", f.read(16))
    assert magic == b"OSRD" and version == 3
    # and it reopens with the zstd codec adopted from the footer
    again = DocumentStore(path)
    assert again.codec == "zstd"
    assert len(again) == 20
    again.close()


# ----------------------------------------------------------------------
# Across packages
# ----------------------------------------------------------------------


@pytest.mark.parametrize("codec", ["zlib", "zstd", "zstd_dict"])
@pytest.mark.parametrize("writer", ["osr_tpu", "port"])
def test_store_reads_across_packages(tmp_path, writer, codec):
    pytest.importorskip("jax")
    if codec != "zlib":
        pytest.importorskip("zstandard")
    from osr_tpu.storage.doc_store import DocumentStore as JaxStore
    from osr_tpu.storage.documents import Document as JaxDocument

    docs = _prose_docs(120)
    docs.append(Document(id="uni", text="ünïcode ✓ text", title="tïtle",
                         metadata={"k": [1, 2]}))
    stores = {"osr_tpu": (JaxStore, JaxDocument),
              "port": (DocumentStore, Document)}
    w_store, w_doc = stores[writer]
    r_store, r_doc = stores["port" if writer == "osr_tpu" else "osr_tpu"]
    path = tmp_path / "x.osrd"
    store = w_store(path, create=True,
                    codec="zlib" if codec == "zlib" else "zstd")
    store.add_documents(
        [w_doc(id=d.id, text=d.text, title=d.title, metadata=d.metadata)
         for d in docs]
    )
    if codec == "zstd_dict":
        store.optimize(train_dict=True)
    store.close()

    other = r_store(path)
    assert len(other) == len(docs)
    got = other.get_documents([d.id for d in docs])
    for want, g in zip(docs, got):
        assert (g.id, g.text, g.title, g.metadata) == (
            want.id, want.text, want.title, want.metadata
        )
    assert [d.id for d in other.iter_documents()] == [d.id for d in docs]
    other.add_documents([r_doc(id="late", text="appended " * 30)])
    other.close()
    again = w_store(path)
    assert again.get_document("late").text.startswith("appended")
    assert again.get_document("p7").metadata == {"i": 7}
    again.close()
