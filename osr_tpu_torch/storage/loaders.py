"""BEIR-format dataset loading, validation and statistics (counterpart of
``osr_tpu/storage/loaders.py``).

Capability parity with the reference's safe loaders (reference
evaluate_rag_pipeline.py:572-678: streaming corpus/queries JSONL with
flexible id/text fields and per-line error recovery; qrels TSV with header
detection) and with data_loader.py (JSONL validation :31-119, dataset stats
:121-166, full-dataset validation :168-225, preparation from HuggingFace
:227-266 — the download path is gated on the ``datasets`` package and
network availability).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple, Union

logger = logging.getLogger(__name__)

ID_FIELDS = ("id", "_id", "doc_id", "docid")
QUERY_ID_FIELDS = ("id", "_id", "query_id", "qid")
TEXT_FIELDS = ("text", "content", "body", "passage", "document")
QUERY_TEXT_FIELDS = ("text", "query", "title", "question", "body")


def extract_record_id(rec: Any, fields: Tuple[str, ...], fallback: str) -> str:
    """First present id field of a record, else the fallback."""
    return next(
        (str(rec[field]) for field in fields if rec.get(field) is not None),
        fallback,
    )


def load_corpus(
    ds_path: Union[str, Path], max_errors_logged: int = 10
) -> Dict[str, Dict]:
    """Stream ``corpus.jsonl`` into {doc_id: record}; text normalized into
    the 'text' field; malformed lines skipped with capped error logging."""
    ds_path = Path(ds_path)
    corpus_file = ds_path / "corpus.jsonl"
    corpus: Dict[str, Dict] = {}
    if not corpus_file.exists():
        logger.warning("Corpus file not found: %s", corpus_file)
        return corpus
    errors = 0
    with open(corpus_file, "r", encoding="utf-8", buffering=1 << 20) as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                doc = json.loads(line)
                if not isinstance(doc, dict):
                    raise json.JSONDecodeError("not an object", "", 0)
                doc_id = extract_record_id(doc, ID_FIELDS, f"doc_{line_no}")
                if "text" not in doc:
                    for field in TEXT_FIELDS[1:]:
                        if field in doc:
                            doc["text"] = doc[field]
                            break
                corpus[doc_id] = doc
            except (json.JSONDecodeError, KeyError) as e:
                errors += 1
                if errors <= max_errors_logged:
                    logger.warning("Corpus line %d error: %s", line_no, e)
    logger.info("Corpus loaded: %d documents (%d errors)", len(corpus), errors)
    return corpus


def load_queries(ds_path: Union[str, Path]) -> Dict[str, Dict]:
    """Stream ``queries.jsonl`` into {query_id: record}."""
    ds_path = Path(ds_path)
    queries_file = ds_path / "queries.jsonl"
    queries: Dict[str, Dict] = {}
    if not queries_file.exists():
        logger.warning("Queries file not found: %s", queries_file)
        return queries
    with open(queries_file, "r", encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict):
                    raise json.JSONDecodeError("not an object", "", 0)
                qid = extract_record_id(
                    rec, QUERY_ID_FIELDS, f"query_{line_no}"
                )
                queries[qid] = rec
            except json.JSONDecodeError:
                logger.debug("Query line %d unparseable", line_no)
    logger.info("Queries loaded: %d", len(queries))
    return queries


def extract_query_text(qobj: Any) -> str:
    """Pull query text from a loaded record (reference
    evaluate_rag_pipeline.py:750-764 field priority)."""
    if isinstance(qobj, str):
        return qobj.strip()
    if isinstance(qobj, dict):
        for field in QUERY_TEXT_FIELDS:
            v = qobj.get(field)
            if v:
                return str(v).strip()
        return str(qobj.get("id", "")).strip()
    return str(qobj).strip() if qobj else ""


def load_qrels(
    ds_path: Union[str, Path], split: str = "test"
) -> Dict[str, Dict[str, int]]:
    """Load ``qrels/<split>.tsv`` (qid \\t docid \\t relevance), skipping a
    header row when present."""
    ds_path = Path(ds_path)
    qrels_path = ds_path / "qrels" / f"{split}.tsv"
    qrels: Dict[str, Dict[str, int]] = {}
    if not qrels_path.exists():
        return qrels
    with open(qrels_path, "r", encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            # No header special-case: a header row's non-numeric relevance
            # column fails the int() parse below and is skipped, while a
            # real first row whose qid merely contains 'query' is kept.
            parts = line.split("\t") if "\t" in line else line.split()
            if len(parts) < 3:
                continue
            qid, docid, rel = parts[0], parts[1], parts[2]
            try:
                qrels.setdefault(qid, {})[docid] = int(float(rel))
            except ValueError:
                continue
    logger.info("Qrels loaded: %d queries", len(qrels))
    return qrels


# ---------------------------------------------------------------------------
# Validation / statistics (reference data_loader.py capability)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DatasetStats:
    num_docs: int = 0
    num_queries: int = 0
    num_qrels: int = 0
    avg_doc_length: float = 0.0
    avg_query_length: float = 0.0
    avg_rels_per_query: float = 0.0


def _validate_jsonl(
    path: Path, id_fields: Tuple[str, ...], text_fields: Tuple[str, ...]
) -> Dict[str, Any]:
    result = {"path": str(path), "valid": 0, "invalid": 0, "errors": []}
    if not path.exists():
        result["errors"].append("file missing")
        return result
    with open(path, "r", encoding="utf-8") as f:
        for line_no, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
                if not isinstance(rec, dict):
                    raise json.JSONDecodeError("not an object", "", 0)
                has_id = any(rec.get(f) is not None for f in id_fields)
                has_text = any(rec.get(f) for f in text_fields)
                if has_id and has_text:
                    result["valid"] += 1
                else:
                    result["invalid"] += 1
                    if len(result["errors"]) < 10:
                        result["errors"].append(
                            f"line {line_no}: missing id or text"
                        )
            except json.JSONDecodeError:
                result["invalid"] += 1
                if len(result["errors"]) < 10:
                    result["errors"].append(f"line {line_no}: bad json")
    return result


def validate_dataset(ds_path: Union[str, Path]) -> Dict[str, Any]:
    """Validate a BEIR-format dataset directory."""
    ds_path = Path(ds_path)
    corpus = _validate_jsonl(ds_path / "corpus.jsonl", ID_FIELDS, TEXT_FIELDS)
    queries = _validate_jsonl(
        ds_path / "queries.jsonl", QUERY_ID_FIELDS, QUERY_TEXT_FIELDS
    )
    qrels_ok = (ds_path / "qrels" / "test.tsv").exists()
    ok = (
        corpus["valid"] > 0
        and corpus["invalid"] == 0
        and queries["valid"] > 0
        and queries["invalid"] == 0
    )
    return {
        "dataset": str(ds_path),
        "ok": bool(ok),
        "corpus": corpus,
        "queries": queries,
        "qrels_present": qrels_ok,
    }


def compute_dataset_stats(ds_path: Union[str, Path]) -> DatasetStats:
    corpus = load_corpus(ds_path)
    queries = load_queries(ds_path)
    qrels = load_qrels(ds_path)
    doc_lengths = [
        len(str(d.get("text", "")).split()) for d in corpus.values()
    ]
    query_lengths = [
        len(extract_query_text(q).split()) for q in queries.values()
    ]
    rels = [len(v) for v in qrels.values()]
    mean = lambda xs: sum(xs) / len(xs) if xs else 0.0
    return DatasetStats(
        num_docs=len(corpus),
        num_queries=len(queries),
        num_qrels=sum(rels),
        avg_doc_length=mean(doc_lengths),
        avg_query_length=mean(query_lengths),
        avg_rels_per_query=mean(rels),
    )


def prepare_dataset(
    name: str,
    out_dir: Union[str, Path],
    split: str = "test",
) -> Optional[Path]:
    """Materialize a HuggingFace BEIR dataset into the local BEIR layout
    (reference data_loader.py:227-266 capability). Requires the optional
    ``datasets`` package and network access; returns None when unavailable."""
    try:
        from datasets import load_dataset  # type: ignore
    except ImportError:
        logger.warning("`datasets` package not available; cannot prepare %s", name)
        return None
    out = Path(out_dir) / name.split("/")[-1]
    out.mkdir(parents=True, exist_ok=True)
    try:
        corpus = load_dataset(f"BeIR/{name}", "corpus", split="corpus")
        queries = load_dataset(f"BeIR/{name}", "queries", split="queries")
        qrels = load_dataset(f"BeIR/{name}-qrels", split=split)
    except Exception as e:  # pragma: no cover - network dependent
        logger.warning("Dataset download failed: %s", e)
        return None
    with open(out / "corpus.jsonl", "w", encoding="utf-8") as f:
        for rec in corpus:
            f.write(json.dumps(dict(rec), ensure_ascii=False) + "\n")
    with open(out / "queries.jsonl", "w", encoding="utf-8") as f:
        for rec in queries:
            f.write(json.dumps(dict(rec), ensure_ascii=False) + "\n")
    (out / "qrels").mkdir(exist_ok=True)
    with open(out / "qrels" / f"{split}.tsv", "w", encoding="utf-8") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        for rec in qrels:
            f.write(
                f"{rec['query-id']}\t{rec['corpus-id']}\t{rec['score']}\n"
            )
    return out


class LazyJSONLReader:
    """Random-access JSONL reader via a line-offset index.

    Capability parity with the reference's ``LazyJSONLReader`` (reference
    tests/memory_mapping.py:356-400): one initial scan records line byte
    offsets; subsequent reads seek directly. Useful as the uncompressed
    baseline against :class:`osr_tpu_torch.storage.doc_store.DocumentStore`.
    """

    def __init__(self, path: Union[str, Path]):
        import threading

        self.path = Path(path)
        self._offsets: List[int] = []
        self._ids: Dict[str, int] = {}
        with open(self.path, "rb") as f:
            pos = 0
            for line_no, line in enumerate(f):
                stripped = line.strip()
                if stripped:
                    try:
                        rec = json.loads(stripped)
                        if not isinstance(rec, dict):
                            raise json.JSONDecodeError("not an object", "", 0)
                        self._offsets.append(pos)
                        doc_id = extract_record_id(
                            rec, ID_FIELDS, f"doc_{line_no + 1}"
                        )
                        self._ids[doc_id] = len(self._offsets) - 1
                    except json.JSONDecodeError:
                        pass  # skip malformed / non-object lines
                pos += len(line)
        self._file = open(self.path, "rb")
        self._lock = threading.Lock()  # seek+readline must be atomic

    def __len__(self) -> int:
        return len(self._offsets)

    def __getitem__(self, idx: int) -> Dict:
        with self._lock:
            self._file.seek(self._offsets[idx])
            line = self._file.readline()
        return json.loads(line)

    def get(self, doc_id: str) -> Optional[Dict]:
        idx = self._ids.get(doc_id)
        return self[idx] if idx is not None else None

    def close(self) -> None:
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
