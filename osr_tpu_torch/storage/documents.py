"""Document model and corpus processing (counterpart of
``osr_tpu/storage/documents.py``).

Capability parity with reference rag_system/core/data_processor.py: a
``Document`` record (:14-46), and a ``CorpusProcessor`` (:48-212) that
streams a JSONL corpus, validates and normalizes records, tracks
per-category error counts, computes a corpus checksum, and parallelizes
parsing across a thread pool.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import logging
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Union

logger = logging.getLogger(__name__)

ID_FIELDS = ("id", "_id", "doc_id", "docid")
TEXT_FIELDS = ("text", "content", "body", "passage", "document")


@dataclasses.dataclass
class Document:
    """One corpus document."""

    id: str
    text: str
    title: str = ""
    metadata: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.id:
            raise ValueError("Document id must be non-empty")
        if not isinstance(self.text, str):
            raise ValueError("Document text must be a string")

    def to_dict(self) -> Dict[str, Any]:
        return {
            "id": self.id,
            "text": self.text,
            "title": self.title,
            "metadata": self.metadata,
        }

    @classmethod
    def from_record(
        cls, record: Dict[str, Any], fallback_id: Optional[str] = None
    ) -> "Document":
        """Build from a raw JSONL record with flexible field names
        (reference evaluate_rag_pipeline.py:595-603 behavior)."""
        doc_id = next(
            (str(record[f]) for f in ID_FIELDS if record.get(f) is not None),
            fallback_id,
        )
        if doc_id is None:
            raise ValueError("Record has no id field and no fallback")
        text = next(
            (record[f] for f in TEXT_FIELDS if record.get(f)),
            "",
        )
        known = set(ID_FIELDS) | set(TEXT_FIELDS) | {"title"}
        metadata = {k: v for k, v in record.items() if k not in known}
        return cls(
            id=doc_id,
            text=text if isinstance(text, str) else str(text),
            title=str(record.get("title", "") or ""),
            metadata=metadata,
        )


class CorpusProcessor:
    """Streams and validates a JSONL corpus into :class:`Document` objects."""

    def __init__(
        self,
        num_workers: int = 4,
        chunk_size: int = 2048,
        max_docs: Optional[int] = None,
    ):
        self.num_workers = num_workers
        self.chunk_size = chunk_size
        self.max_docs = max_docs
        self._lock = threading.Lock()
        self.stats: Dict[str, int] = {
            "processed": 0,
            "validation_errors": 0,
            "json_errors": 0,
            "other_errors": 0,
        }

    def compute_checksum(self, path: Union[str, Path]) -> str:
        """Streaming MD5 of the corpus file (reference
        data_processor.py:150 capability)."""
        h = hashlib.md5()
        with open(path, "rb") as f:
            for block in iter(lambda: f.read(1 << 20), b""):
                h.update(block)
        return h.hexdigest()

    def _parse_chunk(self, lines: List[tuple]) -> List[Document]:
        docs: List[Document] = []
        local = {"processed": 0, "validation_errors": 0, "json_errors": 0, "other_errors": 0}
        for line_no, line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
                docs.append(
                    Document.from_record(record, fallback_id=f"doc_{line_no}")
                )
                local["processed"] += 1
            except json.JSONDecodeError:
                local["json_errors"] += 1
            except ValueError:
                local["validation_errors"] += 1
            except Exception:
                local["other_errors"] += 1
        with self._lock:
            for k, v in local.items():
                self.stats[k] += v
        return docs

    def reset_stats(self) -> None:
        with self._lock:
            for k in self.stats:
                self.stats[k] = 0

    def process(self, path: Union[str, Path]) -> List[Document]:
        """Parse a JSONL corpus file with threaded chunk parsing.

        Stats reset per call — counts and error buckets describe THIS
        file, not everything the processor ever parsed."""
        path = Path(path)
        if not path.exists():
            raise FileNotFoundError(f"Corpus file not found: {path}")
        self.reset_stats()
        chunks: List[List[tuple]] = []
        current: List[tuple] = []
        with open(path, "r", encoding="utf-8", buffering=1 << 20) as f:
            for line_no, line in enumerate(f, 1):
                current.append((line_no, line))
                if self.max_docs and line_no >= self.max_docs:
                    break
                if len(current) >= self.chunk_size:
                    chunks.append(current)
                    current = []
        if current:
            chunks.append(current)

        if len(chunks) <= 1 or self.num_workers <= 1:
            parsed = [self._parse_chunk(c) for c in chunks]
        else:
            with ThreadPoolExecutor(max_workers=self.num_workers) as pool:
                parsed = list(pool.map(self._parse_chunk, chunks))
        docs = [d for chunk in parsed for d in chunk]
        logger.info(
            "Processed %d docs (%d json errors, %d validation errors)",
            self.stats["processed"],
            self.stats["json_errors"],
            self.stats["validation_errors"],
        )
        return docs

    def iter_documents(self, path: Union[str, Path]) -> Iterator[Document]:
        """Streaming single-threaded variant for very large corpora."""
        with open(path, "r", encoding="utf-8", buffering=1 << 20) as f:
            for line_no, line in enumerate(f, 1):
                if self.max_docs and line_no > self.max_docs:
                    return
                line = line.strip()
                if not line:
                    continue
                try:
                    yield Document.from_record(
                        json.loads(line), fallback_id=f"doc_{line_no}"
                    )
                    self.stats["processed"] += 1
                except json.JSONDecodeError:
                    self.stats["json_errors"] += 1
                except ValueError:
                    self.stats["validation_errors"] += 1
