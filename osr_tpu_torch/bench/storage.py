"""The document store on the host: its suite, its codecs and the same-host
anchor (counterpart of ``tools/bench_storage.py``).

Rows, under the script's keys:

- ``synthetic``: ``StorageSuite(text_source="synthetic")`` over ``--docs``
  documents (build, random access, sequential scan, cold start), each row
  ``passed`` and its metrics rounded to 4 places.
- ``real``: the same suite over paragraphs of ``--prose-files``.
- ``codec_comparison``: zlib against zstd and dict-trained zstd (level 3,
  then ``optimize(train_dict=True)``) on identical documents: the
  resampled rows (``zlib_l1_default``, ``zstd_l1``, ``zstd_l3``,
  ``zstd_dict_l3``) draw 1-4 paragraphs of ``--prose-files`` a document;
  the ``*_unique_text`` rows take each 120-word window (stride 120, at
  least 300 characters) of the .md and .rst files under ``--roots``
  (default: this interpreter's stdlib and site-packages,
  ``common.prose_roots()``) at most once.
- ``same_host_anchor``: the port's ``DocumentStore`` over ``--ref-docs``
  seed-42 Zipf documents: build, sequential scan and 5,000 random reads.

Null rows are named in ``dropped`` with the reason: ``real`` and the
resampled codec rows without prose files (the script read the reference
project's markdown, outside the repository, and crashed without it); every
zstd row where the ``zstandard`` module is absent; the anchor's ``ref_*``
keys and ``osr_vs_ref_sequential``, whose reader is the reference
project's code and is not ported. The unique-text rows run whatever
prose files are given (the script skipped them without the reference's
prose), and a missing root is skipped (the script stopped its harvest at
one). Host work only: no kernel runs (``kernel_launches`` is empty) and
no card is needed; ``device`` names the card and its power limit where
there is one. Prints the whole result as one JSON line; ``--out PATH``
also writes it there.

Usage: python -m osr_tpu_torch.bench storage [--docs 2000]
       [--ref-docs 20000] [--prose-files PATH ...] [--roots DIR ...]
       [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import random
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from osr_tpu_torch.bench.common import (
    device_name,
    launched,
    log,
    prose_roots,
    reset_all_launches,
)

METRIC = "doc_store_rates"
KEYS = ("metric", "synthetic", "real", "codec_comparison",
        "same_host_anchor", "note", "dropped", "kernel_launches", "device")
# row -> (DocumentStore keyword arguments, train a zstd dictionary)
CODECS = {
    "zlib_l1_default": ({}, False),
    "zstd_l1": ({"codec": "zstd"}, False),
    "zstd_l3": ({"codec": "zstd", "compress_level": 3}, False),
    "zstd_dict_l3": ({"codec": "zstd", "compress_level": 3}, True),
}
UNIQUE_ROWS = {"zlib_l1_unique_text": "zlib_l1_default",
               "zstd_dict_l3_unique_text": "zstd_dict_l3"}
SUITE_ROWS = ("build", "random_access", "sequential_scan", "cold_start")
OSR_KEYS = ("osr_build_docs_per_s", "osr_sequential_docs_per_s",
            "osr_random_reads_per_s")
REF_KEYS = ("ref_build_docs_per_s", "ref_sequential_docs_per_s",
            "osr_vs_ref_sequential")
READS = 5000  # random reads a codec row and the anchor
WINDOW = 120  # the unique-text harvest's words a window, and its stride
MIN_CHARS = 300
NO_PROSE = ("no --prose-files paragraphs (the script read the reference "
            "project's markdown, outside the repository)")
NO_ZSTD = "the zstandard module is absent"
NO_REF = ("the reference's MemoryMappedCorpus is code from outside the "
          "repository; not ported")
CODEC_NOTE = (
    "identical real-prose documents; zstd_dict rows ingest at level 3 "
    "then optimize(train_dict=True) — the dictionary persists in the v3 "
    "footer. The resampled corpus reuses paragraphs across documents, "
    "which the dictionary captures (realistic for boilerplate-heavy "
    "corpora but flattering); the *_unique_text rows use every paragraph "
    "at most once and are the honest lower bound."
)
NOTE = (
    "same_host_anchor keeps the port's DocumentStore over the script's "
    "seed-42 Zipf corpus; the reference reader's half is not ported, so "
    "its ref_* keys are null."
)


def run_suite(text_source: str, num_docs: int,
              prose_files: Sequence[str] = ()) -> Dict[str, Dict]:
    """The StorageSuite's rows: name -> passed and metrics (4 places)."""
    from osr_tpu_torch.benchmarks.suites import StorageSuite

    suite = StorageSuite(num_docs=num_docs, text_source=text_source,
                         prose_files=prose_files)
    suite.setup()
    try:
        return {
            r.name: {"passed": bool(r.passed),
                     **{k: round(float(v), 4) for k, v in r.metrics.items()}}
            for r in suite.run()
        }
    finally:
        suite.cleanup()


def resampled_docs(paras: Sequence[str], num_docs: int) -> List:
    """The script's resampled documents: 1-4 seeded paragraphs each."""
    from osr_tpu_torch.storage.documents import Document

    rng = np.random.RandomState(42)
    return [
        Document(
            id=f"d{i}",
            text="\n\n".join(
                paras[j]
                for j in rng.randint(0, len(paras), int(rng.randint(1, 5)))
            ),
            title=f"Title {i}",
        )
        for i in range(num_docs)
    ]


def unique_chunks(roots: Sequence[str], num_docs: int) -> List[str]:
    """The script's unique-text harvest: the .md files then the .rst files
    of each root in sorted order, 120-word windows at stride 120 (the last
    may be shorter) of at least 300 characters, each text once, up to
    ``num_docs``; a missing root or an unreadable file is skipped."""
    seen, chunks = set(), []
    for root in map(Path, roots):
        if len(chunks) >= num_docs:
            break
        if not root.exists():
            continue
        files = [p for p in root.rglob("*") if p.suffix in (".md", ".rst")]
        for p in (sorted(p for p in files if p.suffix == ".md")
                  + sorted(p for p in files if p.suffix == ".rst")):
            try:
                words = p.read_text(encoding="utf-8").split()
            except (UnicodeDecodeError, OSError):
                continue
            for s in range(0, max(len(words) - 60, 0) + 1, WINDOW):
                w = " ".join(words[s:s + WINDOW])
                if len(w) < MIN_CHARS or w in seen:
                    continue
                seen.add(w)
                chunks.append(w)
                if len(chunks) >= num_docs:
                    break
            if len(chunks) >= num_docs:
                break
    return chunks


def read_ids(prefix: str, num_docs: int) -> List[str]:
    """READS seeded ids (``random.seed(1)``, as the script draws them)."""
    rng = random.Random(1)
    return [f"{prefix}{rng.randrange(num_docs)}" for _ in range(READS)]


def measure(docs: Sequence, ids: Sequence[str], store_kwargs: Dict,
            train_dict: bool = False) -> Dict[str, float]:
    """One codec row: build, (dictionary training,) sequential scan and
    uncached random reads of ``docs`` in a fresh store."""
    from osr_tpu_torch.storage.doc_store import DocumentStore

    with tempfile.TemporaryDirectory() as td:
        t0 = time.perf_counter()
        store = DocumentStore(Path(td) / "c.osrd", create=True,
                              **store_kwargs)
        store.add_documents(docs)
        build_s = time.perf_counter() - t0
        if train_dict:
            t0 = time.perf_counter()
            store.optimize(train_dict=True)
            opt_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cnt = sum(1 for _ in store.iter_documents())
        scan_s = time.perf_counter() - t0
        store.cache.clear()
        store.cache.max_items = 0
        t0 = time.perf_counter()
        for i in ids:
            store.get_document(i)
        rnd_s = time.perf_counter() - t0
        stats = store.get_stats()
        out = {
            "build_docs_per_s": round(len(docs) / build_s, 1),
            "sequential_docs_per_s": round(cnt / scan_s, 1),
            "random_reads_per_s": round(len(ids) / rnd_s, 1),
            "compression_ratio": round(stats["compression_ratio"], 3),
            "file_mb": round(stats["file_bytes"] / 2**20, 2),
        }
        if train_dict:
            out["optimize_s"] = round(opt_s, 2)
        store.close()
        return out


def codec_comparison(num_docs: int, paras: Sequence[str],
                     roots: Sequence[str],
                     dropped: Dict[str, str]) -> Dict[str, object]:
    """The codec rows; null rows are named in ``dropped``."""
    from osr_tpu_torch.storage import doc_store

    has_zstd = doc_store._zstd is not None

    def row(name, docs, ids, codec):
        kwargs, train = CODECS[codec]
        if not docs:
            dropped[f"codec_comparison.{name}"] = NO_PROSE
            return None
        if kwargs.get("codec") == "zstd" and not has_zstd:
            dropped[f"codec_comparison.{name}"] = NO_ZSTD
            return None
        log(f"codec {name}: {len(docs)} docs")
        return measure(docs, ids, kwargs, train)

    docs = resampled_docs(paras, num_docs) if paras else []
    ids = read_ids("d", num_docs)
    out: Dict[str, object] = {"num_docs": num_docs}
    for name in CODECS:
        out[name] = row(name, docs, ids, name)
    out["note"] = CODEC_NOTE

    from osr_tpu_torch.storage.documents import Document

    t0 = time.perf_counter()
    chunks = unique_chunks(roots, num_docs)
    log(f"unique-text harvest: {len(chunks)} windows from {list(roots)} in "
        f"{time.perf_counter() - t0:.1f}s")
    uniq = [Document(id=f"u{i}", text=t, title="")
            for i, t in enumerate(chunks)]
    ids = read_ids("u", len(uniq)) if uniq else []
    out["num_docs_unique_text"] = len(uniq)
    for name, codec in UNIQUE_ROWS.items():
        if uniq:
            out[name] = row(name, uniq, ids, codec)
        else:
            out[name] = None
            dropped[f"codec_comparison.{name}"] = (
                f"no .md/.rst window of {MIN_CHARS}+ characters under "
                f"{list(roots)}")
    return out


def anchor_corpus(num_docs: int) -> Dict[str, Dict]:
    """The script's anchor corpus: seed-42 Zipf documents over 50,000
    terms."""
    from osr_tpu_torch.testing import SyntheticDataGenerator

    return SyntheticDataGenerator(seed=42).zipf_corpus(
        num_docs, 50_000, avg_len=130, word_prefix="t", min_len=5
    )


def osr_anchor(corpus: Dict[str, Dict], path) -> Dict[str, float]:
    """The anchor's store half: ``DocumentStore.build_from_corpus`` at
    ``path`` (left there, closed), a sequential scan and READS seeded
    random reads through ``get_documents``, each as a rate."""
    from osr_tpu_torch.storage.doc_store import DocumentStore

    out = {}
    t0 = time.perf_counter()
    store = DocumentStore.build_from_corpus(corpus, path)
    out["osr_build_docs_per_s"] = round(
        len(corpus) / (time.perf_counter() - t0), 1)
    t0 = time.perf_counter()
    cnt = sum(1 for _ in store.iter_documents())
    out["osr_sequential_docs_per_s"] = round(
        cnt / (time.perf_counter() - t0), 1)
    keys = list(corpus)
    rng = random.Random(1)
    ids = [keys[rng.randrange(len(keys))] for _ in range(READS)]
    store.cache.clear()
    t0 = time.perf_counter()
    got = store.get_documents(ids, num_workers=1)
    out["osr_random_reads_per_s"] = round(
        len(ids) / (time.perf_counter() - t0), 1)
    store.close()
    if cnt != len(corpus) or any(d is None for d in got):
        raise RuntimeError(f"the anchor's store read back {cnt} of "
                           f"{len(corpus)} documents")
    return out


def same_host_anchor(num_docs: int,
                     dropped: Dict[str, str]) -> Dict[str, object]:
    corpus = anchor_corpus(num_docs)
    with tempfile.TemporaryDirectory() as td:
        osr = osr_anchor(corpus, Path(td) / "corpus.osrd")
    for key in REF_KEYS:
        dropped[f"same_host_anchor.{key}"] = NO_REF
    return {"num_docs": num_docs, "ref_build_docs_per_s": None,
            "ref_sequential_docs_per_s": None, **osr,
            "osr_vs_ref_sequential": None}


def run(
    *,
    docs: int = 2000,
    ref_docs: int = 20_000,
    prose_files: Sequence[str] = (),
    roots: Optional[Sequence[str]] = None,
    device="cpu",
    out: Optional[str] = None,
) -> Dict[str, object]:
    """The result, printed as one JSON line and returned (and written to
    ``out`` when given). ``device`` only names the machine's card in the
    result: every row runs on the host."""
    from osr_tpu_torch.benchmarks.suites import real_prose_paragraphs

    reset_all_launches()
    roots = prose_roots() if roots is None else tuple(roots)
    dropped: Dict[str, str] = {}
    t0 = time.perf_counter()
    synthetic = run_suite("synthetic", docs)
    log(f"synthetic suite: {time.perf_counter() - t0:.1f}s")
    paras = real_prose_paragraphs(prose_files)
    if paras:
        real = run_suite("real", docs, prose_files)
    else:
        real = None
        dropped["real"] = NO_PROSE
    t0 = time.perf_counter()
    codecs = codec_comparison(docs, paras, roots, dropped)
    log(f"codec comparison: {time.perf_counter() - t0:.1f}s")
    t0 = time.perf_counter()
    anchor = same_host_anchor(ref_docs, dropped)
    log(f"anchor ({ref_docs} docs): {time.perf_counter() - t0:.1f}s")
    result = {
        "metric": METRIC,
        "synthetic": synthetic,
        "real": real,
        "codec_comparison": codecs,
        "same_host_anchor": anchor,
        "note": NOTE,
        "dropped": dropped,
        "kernel_launches": launched(),
        "device": device_name(torch.device(device)),
    }
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result), flush=True)
    return result


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m osr_tpu_torch.bench storage",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--docs", type=int, default=2000)
    ap.add_argument("--ref-docs", type=int, default=20_000)
    ap.add_argument("--prose-files", nargs="+", default=(),
                    help="prose files for the real-text suite and the "
                    "resampled codec rows (default: none)")
    ap.add_argument("--roots", nargs="+", default=None,
                    help="directories of the unique-text harvest (default: "
                    "this interpreter's stdlib and site-packages)")
    ap.add_argument("--out", default=None,
                    help="also write the result to this file")
    args = ap.parse_args(argv)
    run(docs=args.docs, ref_docs=args.ref_docs,
        prose_files=args.prose_files, roots=args.roots,
        device="cuda" if torch.cuda.is_available() else "cpu",
        out=args.out)
    return 0
