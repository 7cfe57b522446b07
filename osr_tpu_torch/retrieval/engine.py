"""The sparse search engine on a CUDA device (counterpart of
``osr_tpu/retrieval/engine.py:SparseSearchEngine``).

Host/device split per batch:

- host: tokenization and batching (``retrieval/encoding.py``), the tail
  postings walk and the candidates' head dots (``index/postings.py``),
  the exact merge, result dicts and the query cache;
- device: the query scatter, the head scores (the hand-written kernels
  of ``ops/head.py`` for an int8/int4 head on CUDA) and the exact
  block-pruned top-k, launched asynchronously by
  :meth:`SparseSearchEngine.search_encoded_device`.

The device step's (top, rows) result is copied into pinned host buffers
with ``non_blocking`` copies and a recorded CUDA event;
:meth:`SparseSearchEngine.finish_batch` waits on that event. So the host's
candidate head dots overlap the device step, and ``run_pipelined`` keeps
several batches in flight.

Not yet ported (refused with NotImplementedError rather than rerouted):
``topk_mode='approx'``, per-block narrowing (``narrow_m > 0``,
``narrow_backend='extract'``) and row-chunked scoring.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from osr_tpu_torch import native
from osr_tpu_torch.index.builder import SparseIndex
from osr_tpu_torch.index.layout import repack_int4, round_up
from osr_tpu_torch.index.postings import (
    FlatCandidates,
    cand_head_scores_host,
    dense_tail_scores,
    filter_candidates_by_tau,
    merge_host,
    merge_tau_slack,
    prepare_host_merge,
    tail_candidates_flat,
)
from osr_tpu_torch.index.tokenizer import Tokenizer
from osr_tpu_torch.ops import head as head_ops
from osr_tpu_torch.ops.bm25 import dense_head_scores, fused_search
from osr_tpu_torch.retrieval.encoding import (
    EncodedBatch,
    QueryEncoder,
    encode_query_batch,
    encode_weighted_batch,
    pick_batch_size,
)
from osr_tpu_torch.retrieval.pipeline_util import run_pipelined
from osr_tpu_torch.retrieval.results import (
    as_object_names,
    assemble_result_dicts,
)

DEFAULT_BATCH_SIZES = (8, 32, 128, 256, 512)

# Share of the device memory free at construction that the head plus one
# (B_max, R) f32 score slab may take. The rest covers the selection's
# transients (a stable sort holds values, int64 indices and scratch several
# times the slab) and the batches kept in flight.
SEARCH_MEMORY_FRACTION = 0.25

_NOT_PORTED = (
    "is not ported yet (ROADMAP.md Queue 1 item 4: chunked scoring, "
    "approx and narrow selection)"
)


class _DeviceIndex:
    """Device-resident head of a :class:`HybridLayout` (the postings stay
    on the host). Head rows pad once at upload to the kernels' row tile
    (invalid, so -inf), and head widths to the kernels' column alignment
    (zero columns, or an int4 re-pack to a wider packed width)."""

    def __init__(self, layout, device: torch.device):
        head, valid = layout.head, layout.valid
        if layout.head_dtype == "int4" and head.shape[1] % head_ops.COL_ALIGN:
            head = repack_int4(
                head, layout.head_terms,
                round_up(head.shape[1], head_ops.COL_ALIGN),
            )
        elif layout.head_dtype != "int4" and head.shape[1] % head_ops.COL_ALIGN:
            head = np.pad(
                head, ((0, 0), (0, (-head.shape[1]) % head_ops.COL_ALIGN))
            )
        pad_r = (-head.shape[0]) % head_ops.ROW_TILE
        if pad_r:
            head = np.pad(head, ((0, pad_r), (0, 0)))
            valid = np.pad(valid, (0, pad_r))
        host = torch.from_numpy(np.ascontiguousarray(head))
        if layout.head_dtype == "bf16":
            host = host.view(torch.int16).view(torch.bfloat16)
        self.head = host.to(device)
        self.valid = torch.from_numpy(np.ascontiguousarray(valid)).to(device)
        self.head_scales = (
            torch.from_numpy(layout.head_scales).to(device)
            if layout.head_scales is not None
            else None
        )
        self.num_rows = self.head.shape[0]
        self.empty_i32 = torch.zeros(0, dtype=torch.int32, device=device)


class _PendingResult:
    """Device tensors on their way to the host: on CUDA, ``non_blocking``
    copies into pinned buffers followed by a recorded event; on the CPU,
    the tensors themselves."""

    def __init__(self, tensors: Sequence[torch.Tensor], device: torch.device):
        self._event = None
        if device.type == "cuda":
            self._host = []
            for t in tensors:
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                self._host.append(h)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(device))
        else:
            self._host = list(tensors)

    def wait(self) -> List[np.ndarray]:
        if self._event is not None:
            self._event.synchronize()
        return [h.numpy() for h in self._host]


class SparseSearchEngine:
    """Batched BM25/TF-IDF search over a :class:`SparseIndex`.

    ``device`` defaults to ``cuda``; pass ``"cpu"`` for the plain PyTorch
    path. ``head_backend``: 'auto' takes the CUDA kernels for an int8/int4
    head on a CUDA device and the plain version otherwise; 'cuda' insists
    on the kernels; 'torch' runs the plain version on any device."""

    def __init__(
        self,
        index: SparseIndex,
        device=None,
        batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
        cache_queries: bool = True,
        query_cache_limit: int = 1000,
        topk_mode: str = "exact",
        merge_backend: str = "auto",  # 'host' | 'device' | 'auto'
        head_backend: str = "auto",  # 'cuda' | 'torch' | 'auto'
        score_chunk_rows: Optional[int] = None,  # None = auto; 0 = off
        narrow_m: int = 0,
        narrow_backend: str = "torch",
        cand_filter_per_query: int = 2048,  # defer+filter gate; 0 = off
    ):
        self.index = index
        self.device = torch.device(device if device is not None else "cuda")
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device; pass device='cpu'")
        self.batch_sizes = tuple(sorted(batch_sizes))
        if topk_mode == "approx":
            raise NotImplementedError(f"topk_mode='approx' {_NOT_PORTED}")
        if topk_mode != "exact":
            raise ValueError(f"Unknown topk_mode: {topk_mode}")
        self.topk_mode = topk_mode
        if narrow_m or narrow_backend == "extract":
            raise NotImplementedError(
                f"narrow_m / narrow_backend='extract' {_NOT_PORTED}"
            )
        if narrow_backend != "torch":
            raise ValueError(f"Unknown narrow_backend: {narrow_backend}")
        self.cand_filter_per_query = int(cand_filter_per_query)
        layout = index.layout
        quantized = layout.head_dtype in ("int8", "int4")
        if head_backend == "auto":
            head_backend = (
                "cuda" if quantized and self.device.type == "cuda" else "torch"
            )
        if head_backend == "cuda" and not (
            quantized and self.device.type == "cuda"
        ):
            raise ValueError(
                "head_backend='cuda' needs an int8 or int4 head on a CUDA "
                f"device (head {layout.head_dtype}, device {self.device})"
            )
        if head_backend not in ("cuda", "torch"):
            raise ValueError(f"Unknown head_backend: {head_backend}")
        self.head_backend = head_backend
        if merge_backend == "auto":
            merge_backend = "host" if native.available() else "device"
        if merge_backend not in ("host", "device"):
            raise ValueError(f"Unknown merge_backend: {merge_backend}")
        self.merge_backend = merge_backend
        self._check_memory(score_chunk_rows)
        self.tokenizer = Tokenizer(index.vocabulary)
        self.encoder = QueryEncoder(self.tokenizer)
        self._dev = _DeviceIndex(layout, self.device)
        (
            self._host_head,
            self._host_head_dtype,
            self._head_t,
            self._slack_per_term,
        ) = prepare_host_merge(layout, want_head_t=merge_backend == "host")
        self._query_cache: Optional[
            Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]]
        ] = ({} if cache_queries else None)
        self._cache_limit = query_cache_limit
        self._cache_lock = threading.RLock()
        self._doc_names = as_object_names(index.doc_ids)

    def _check_memory(self, score_chunk_rows: Optional[int]) -> None:
        """Refuse plans that need row chunking: an explicit chunk size, or
        (auto) a head plus (B_max, R) f32 slab over the budget taken from
        the device's free memory."""
        if score_chunk_rows:
            raise NotImplementedError(f"score_chunk_rows {_NOT_PORTED}")
        if score_chunk_rows is not None or self.device.type != "cuda":
            return
        layout = self.index.layout
        rows = round_up(layout.num_rows, head_ops.ROW_TILE)
        need = layout.head.nbytes + 4 * self.batch_sizes[-1] * rows
        free, _ = torch.cuda.mem_get_info(self.device)
        budget = int(SEARCH_MEMORY_FRACTION * free)
        if need > budget:
            raise NotImplementedError(
                f"head + (B={self.batch_sizes[-1]}, R={rows}) scores need "
                f"{need / 2**30:.1f} GiB over the {budget / 2**30:.1f} GiB "
                f"budget; row-chunked scoring {_NOT_PORTED}"
            )

    # ------------------------------------------------------------------
    # Device path
    # ------------------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> search device, through a pinned buffer on CUDA so
        the copy does not stall the host."""
        src = torch.from_numpy(np.ascontiguousarray(arr))
        if self.device.type != "cuda":
            return src
        pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        pinned.copy_(src)
        return pinned.to(self.device, non_blocking=True)

    def _tail_candidates(self, enc: EncodedBatch, batch_size: int):
        layout = self.index.layout
        return tail_candidates_flat(
            layout.post_ptr,
            layout.post_rows,
            layout.post_weights,
            enc.tail_ids,
            enc.tail_counts,
            enc.tail_ptr,
            batch_size,
            num_rows=self._dev.num_rows,
        )

    def _cand_head_host(self, cand: FlatCandidates, enc: EncodedBatch):
        return cand_head_scores_host(
            self._host_head,
            self._host_head_dtype,
            self.index.layout.head_scales,
            cand,
            enc.head_flat_ids,
            enc.head_flat_counts,
            enc.head_ptr,
            head_t=self._head_t,
        )

    def search_encoded_device(self, enc: EncodedBatch, top_k: int):
        """Launch the device step and start its result copy, then run the
        host stages that do not need it (tail candidates were walked
        first; the candidates' head dots run while the device works).

        Returns an opaque in-flight handle for :meth:`finish_batch`."""
        d = self._dev
        cand = self._tail_candidates(enc, enc.head_ids.shape[0])
        if self.merge_backend == "device":
            flat_rows = self._upload(cand.rows)
            flat_cols = self._upload(cand.cols)
        else:
            flat_rows = flat_cols = d.empty_i32
        top, rows, cand_head_dev = fused_search(
            self._upload(enc.head_ids),
            self._upload(enc.head_weights),
            flat_rows,
            flat_cols,
            d.head,
            d.head_scales,
            d.valid,
            head_terms=self.index.layout.head_terms,
            k=top_k,
            head_backend=self.head_backend,
        )
        if self.merge_backend == "device":
            result = _PendingResult((top, rows, cand_head_dev), self.device)
            # The device's candidate head scores come from the same score
            # matrix as its top-k: no discrepancy, no slack.
            return cand, result, None, np.zeros(
                enc.head_ids.shape[0], dtype=np.float32
            )
        result = _PendingResult((top, rows), self.device)
        tau_slack = merge_tau_slack(
            self._slack_per_term,
            enc.head_flat_ids,
            enc.head_flat_counts,
            enc.head_ptr,
        )
        nq_real = max(1, len(enc.head_ptr) - 1)
        if (
            self.cand_filter_per_query
            and cand.total >= self.cand_filter_per_query * nq_real
        ):
            # Large candidate loads: defer the head dot until the device
            # top-k allows the exact tau filter
            # (postings.py:filter_candidates_by_tau).
            cand_head = ("tau_filter", enc)
        else:
            cand_head = self._cand_head_host(cand, enc)
        return cand, result, cand_head, tau_slack

    def finish_batch(
        self, in_flight, top_k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for the device result and run the exact host merge."""
        cand, result, cand_head, tau_slack = in_flight
        arrays = result.wait()
        head_s, head_r = arrays[0], arrays[1]
        if cand_head is None:
            cand_head = arrays[2]
        elif isinstance(cand_head, tuple):
            enc = cand_head[1]
            cand = filter_candidates_by_tau(
                cand, head_s, head_r, top_k, tau_slack, self._dev.num_rows
            )
            cand_head = self._cand_head_host(cand, enc)
        return merge_host(
            head_s,
            head_r,
            cand,
            cand_head,
            self._dev.num_rows,
            top_k,
            tau_slack=tau_slack,
        )

    def score_all(self, texts: Sequence[str]) -> np.ndarray:
        """Dense (len(texts), num_docs) score matrix: the oracle API. Head
        scores come from the device (plain version, in the head's dtype);
        tail scores are added on the host exactly."""
        d = self._dev
        layout = self.index.layout
        n = self.index.num_docs
        out = np.zeros((len(texts), n), dtype=np.float32)
        max_b = self.batch_sizes[-1]
        for i in range(0, len(texts), max_b):
            chunk = texts[i : i + max_b]
            enc = self.encode_queries(chunk)
            hs = dense_head_scores(
                self._upload(enc.head_ids),
                self._upload(enc.head_weights),
                d.head,
                d.head_scales,
                head_terms=layout.head_terms,
            )
            scores = hs.cpu().numpy()[: len(chunk), :n]
            tail = dense_tail_scores(
                layout.post_ptr,
                layout.post_rows,
                layout.post_weights,
                enc.tail_ids,
                enc.tail_counts,
                enc.tail_ptr,
                layout.num_rows,
            )[:, :n]
            out[i : i + len(chunk)] = scores + tail
        return out

    # ------------------------------------------------------------------
    # Host path
    # ------------------------------------------------------------------

    def encode_queries(self, texts: Sequence[str]) -> EncodedBatch:
        """Tokenize + pad query strings (at most the largest batch size)."""
        return encode_query_batch(
            self.encoder,
            texts,
            pick_batch_size(self.batch_sizes, len(texts)),
            self.index.layout.head_terms,
        )

    def _result_dicts(self, scores, ids) -> List[Dict[str, float]]:
        n = len(self.index.doc_ids)
        mask = (scores > 0) & (ids >= 0) & (ids < n)
        return assemble_result_dicts(self._doc_names, ids, scores, mask)

    def search(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        """Reference-compatible search: {qid: {doc_id: score}}, scores > 0
        only, sorted descending; empty and all-OOV queries give {}."""
        results: Dict[str, Dict[str, float]] = {}
        pending: List[Tuple[str, str]] = []
        for qid, text in queries.items():
            text = (text or "").strip()
            if not text:
                results[qid] = {}
                continue
            if self._query_cache is not None:
                with self._cache_lock:
                    hit = self._query_cache.get((text, top_k))
                if hit is not None:
                    results[qid] = self._result_dicts(
                        hit[1][None, :], hit[0][None, :]
                    )[0]
                    continue
            pending.append((qid, text))

        done = []
        run_pipelined(
            pending,
            self.batch_sizes[-1],
            lambda chunk: self.search_encoded_device(
                self.encode_queries([t for _, t in chunk]), top_k
            ),
            lambda chunk, handle: done.append(
                (chunk, *self.finish_batch(handle, top_k))
            ),
        )
        for chunk, scores, ids in done:
            dicts = self._result_dicts(scores, ids)
            for row, (qid, text) in enumerate(chunk):
                if self._query_cache is not None:
                    with self._cache_lock:
                        if len(self._query_cache) < self._cache_limit:
                            self._query_cache[(text, top_k)] = (
                                ids[row],
                                scores[row],
                            )
                results[qid] = dicts[row]
        return results

    def search_weighted(
        self,
        queries: Mapping[str, Mapping[str, float]],
        top_k: int = 10,
    ) -> Dict[str, Dict[str, float]]:
        """Learned-sparse search: queries are {term: weight} mappings used
        verbatim. Same result contract as :meth:`search`."""
        results: Dict[str, Dict[str, float]] = {}
        qids = [q for q, vec in queries.items() if vec]
        for q, vec in queries.items():
            if not vec:
                results[q] = {}
        max_b = self.batch_sizes[-1]
        for i in range(0, len(qids), max_b):
            chunk = qids[i : i + max_b]
            enc = encode_weighted_batch(
                self.index.vocabulary,
                [queries[q] for q in chunk],
                pick_batch_size(self.batch_sizes, len(chunk)),
                self.index.layout.head_terms,
            )
            scores, ids = self.finish_batch(
                self.search_encoded_device(enc, top_k), top_k
            )
            results.update(zip(chunk, self._result_dicts(scores, ids)))
        return results

    def clear_cache(self) -> None:
        if self._query_cache is not None:
            with self._cache_lock:
                self._query_cache.clear()

    def stats(self) -> Dict[str, object]:
        s = self.index.stats()
        s["device"] = str(self.device)
        s["topk_mode"] = self.topk_mode
        s["head_backend"] = self.head_backend
        s["merge_backend"] = self.merge_backend
        if self._query_cache is not None:
            s["query_cache_size"] = len(self._query_cache)
        return s
