"""The search engines on a CUDA device (counterparts of
``osr_tpu/retrieval/engine.py:SparseSearchEngine`` and
``DenseSearchEngine``).

Sparse (BM25/TF-IDF).

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

Every plan of ``osr_tpu``'s engine runs: ``topk_mode='approx'`` and
per-block narrowing (``narrow_m``), both served exactly by the standard
block-pruned selection; the extraction kernel K4
(``narrow_backend='extract'``: the (B, R) scores are never written); and
row-chunked scoring, whose chunk size comes from the device's free memory
(:func:`plan_score_chunks`).

Dense (quantized embeddings). :class:`DenseSearchEngine` keeps the
quantized corpus on the device. One batch is one device step: quantize
the queries (K7), score them against the corpus (K5 for int8, K6 for
int4), exact top-k; its result comes back through the same pinned
buffers and event as the sparse engine's.

Spans and counters. Each stage of a batch or a request is an
``osr.sparse.*`` / ``osr.dense.*`` span (``utils/timing.py:span``): a
``torch.profiler`` range while a profiler runs, nothing otherwise. The
sparse engine also counts its queries, batches, tail candidates,
re-dispatches and row-chunk sweeps (``stats()["counters"]``).
"""

from __future__ import annotations

import logging
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
from osr_tpu_torch.ops import matmul as matmul_ops
from osr_tpu_torch.ops import quantize as qz
from osr_tpu_torch.ops.bm25 import (
    BLOCK_PRUNE_MIN_ROWS,
    block_prune_applies,
    dense_head_scores,
    fused_search,
    fused_search_extract,
    merge_chunks,
)
from osr_tpu_torch.ops.topk import block_topk_from_max
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
from osr_tpu_torch.utils.timing import span

logger = logging.getLogger(__name__)

DEFAULT_BATCH_SIZES = (8, 32, 128, 256, 512)

# Share of the device memory the head leaves free (free at construction,
# less the head) that one sweep's transients (the (B_max, rows) f32 score
# slab, and the plain path's f32 head copy) may take. The rest covers the
# selection's transients (a stable sort holds values, int64 indices and
# scratch several times its input) and the batches kept in flight. On the
# H100 at MS MARCO passage's head (18.1 GB, B = 3,496, top_k 1,000) a batch
# took 606 / 424 / 381 ms in sweeps of 1.1M / 2.2M / 2.9M rows (each sweep
# sorts its k pruned blocks, so fewer sweeps are faster), at peaks of 50 /
# 64 / 74 GiB of 79 GiB: half leaves 4 sweeps of 2.2M rows there and room
# for the selection (PERF.md, Where the time goes).
SEARCH_MEMORY_FRACTION = 0.5


def plan_score_chunks(
    *,
    num_rows: int,
    head_bytes: int,
    max_batch: int,
    head_width: int,  # logical head columns (twice the int4 packed width)
    free_bytes: Optional[int],  # device memory free; None = no budget
    plain_f32_copy: bool,  # the plain head step decodes an f32 head copy
    requested: Optional[int] = None,  # None = auto; 0 = off; else rows
) -> Tuple[int, int, Optional[int]]:
    """The row-chunk plan of a sparse engine: (chunk_rows, need, budget).

    A sweep over ``rows`` head rows holds ``rows * row_bytes`` of
    transients: the (B_max, rows) f32 score slab, 4 B_max bytes a row, plus
    4 W bytes a row when the plain head step decodes the head to f32.
    ``budget`` is ``SEARCH_MEMORY_FRACTION`` of the memory the head leaves,
    ``free_bytes - head_bytes``: a head that fills a quarter of the card
    still leaves its sweeps room, so they keep enough 128-row blocks for
    the block-pruned selection. Auto (``requested=None``) keeps one sweep
    while R rows' transients fit the budget, and otherwise chunks at
    max(budget / row_bytes, 4,096) rows, rounded down to the kernels' row
    tile. An explicit ``requested`` is honoured. ``chunk_rows`` is 0 for
    one sweep; ``need`` is one sweep's transients of the plan chosen, which
    the caller compares with ``budget`` (None without a device figure)."""
    row_bytes = 4 * max_batch + (4 * head_width if plain_f32_copy else 0)
    rows = round_up(num_rows, head_ops.ROW_TILE)
    budget = (
        int(SEARCH_MEMORY_FRACTION * max(free_bytes - head_bytes, 0))
        if free_bytes is not None
        else None
    )
    if requested is None:
        if budget is None or rows * row_bytes <= budget:
            chunk = 0
        else:
            fit = budget // row_bytes
            fit -= fit % head_ops.ROW_TILE
            chunk = max(fit, BLOCK_PRUNE_MIN_ROWS)
    else:
        chunk = int(requested)
    if chunk >= num_rows:
        chunk = 0
    sweep = round_up(chunk, head_ops.ROW_TILE) if chunk else rows
    return chunk, sweep * row_bytes, budget


def _head_to(arr: np.ndarray, head_dtype: str, device) -> torch.Tensor:
    host = torch.from_numpy(np.ascontiguousarray(arr))
    if head_dtype == "bf16":
        host = host.view(torch.int16).view(torch.bfloat16)
    return host.to(device)


class _DeviceIndex:
    """Device-resident head of a :class:`HybridLayout` (the postings stay
    on the host). Head widths pad once at upload to the kernels' column
    alignment (zero columns, or an int4 re-pack to a wider packed width),
    and head rows to the kernels' row tile (invalid, so -inf).

    ``chunk_rows`` splits the head into row chunks of one equal size,
    rounded up to the row tile (``osr_tpu`` equalizes them the same way, so
    no short last chunk wastes memory); the engine scores and selects per
    chunk and merges the chunks' top-k (``ops/bm25.py:merge_chunks``).
    Chunk bases are int64 and rows int32, so no f32 row cap applies."""

    def __init__(self, layout, device: torch.device, chunk_rows=None):
        head, valid = layout.head, layout.valid
        tile = head_ops.ROW_TILE
        if layout.head_dtype == "int4" and head.shape[1] % head_ops.COL_ALIGN:
            head = repack_int4(
                head, layout.head_terms,
                round_up(head.shape[1], head_ops.COL_ALIGN),
            )
        elif layout.head_dtype != "int4" and head.shape[1] % head_ops.COL_ALIGN:
            head = np.pad(
                head, ((0, 0), (0, (-head.shape[1]) % head_ops.COL_ALIGN))
            )
        r = head.shape[0]
        if chunk_rows and r > chunk_rows:
            n_chunks = -(-r // round_up(int(chunk_rows), tile))
            cr = round_up(-(-r // n_chunks), tile)
        else:
            n_chunks, cr = 1, round_up(r, tile)
        parts = []
        for lo in range(0, n_chunks * cr, cr):
            h, v = head[lo : lo + cr], valid[lo : lo + cr]
            pad = cr - h.shape[0]
            if pad:
                h = np.pad(h, ((0, pad), (0, 0)))
                v = np.pad(v, (0, pad))
            parts.append(
                (
                    _head_to(h, layout.head_dtype, device),
                    torch.from_numpy(np.ascontiguousarray(v)).to(device),
                )
            )
        self.head_scales = (
            torch.from_numpy(layout.head_scales).to(device)
            if layout.head_scales is not None
            else None
        )
        self.chunk_rows = cr  # rows of one sweep: a chunk, or the head
        self.num_rows = n_chunks * cr
        if n_chunks > 1:
            self.chunks = parts
            self.chunk_bases = torch.arange(
                0, self.num_rows, cr, dtype=torch.int64, device=device
            )
            self.head = self.valid = None
        else:
            self.chunks = self.chunk_bases = None
            self.head, self.valid = parts[0]
        self.empty_i32 = torch.zeros(0, dtype=torch.int32, device=device)


def resolve_device(device) -> torch.device:
    """The engines' device: ``cuda`` unless the caller names another; a
    CUDA device that is not there raises."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu'")
    return dev


def host_runtime(device: torch.device) -> bool:
    """Whether the sparse engines' host stages take the C++ runtime
    (``native.py``). On a CUDA device they always do: a runtime that cannot
    be built or loaded raises, with the compiler's output, and no NumPy
    body stands in for it there. On the CPU they do when it loads, and take
    the NumPy bodies otherwise, as ``osr_tpu`` does."""
    if device.type != "cuda":
        return native.available()
    try:
        native.library()
    except ImportError as e:
        raise RuntimeError(
            f"the sparse engines on {device} need the host runtime: {e}"
        ) from e
    return True


def _head_backend(head_backend: str, head_dtype: str, device) -> str:
    """The sparse engines' head backend: 'auto' takes the CUDA kernels for
    an int8/int4 head on a CUDA device and the plain version otherwise;
    'cuda' insists on the kernels; 'torch' is the plain version."""
    quantized = head_dtype in ("int8", "int4")
    if head_backend == "auto":
        head_backend = (
            "cuda" if quantized and device.type == "cuda" else "torch"
        )
    if head_backend == "cuda" and not (quantized and device.type == "cuda"):
        raise ValueError(
            "head_backend='cuda' needs an int8 or int4 head on a CUDA "
            f"device (head {head_dtype}, device {device})"
        )
    if head_backend not in ("cuda", "torch"):
        raise ValueError(f"Unknown head_backend: {head_backend}")
    return head_backend


def _upload(arr, device: torch.device) -> torch.Tensor:
    """Host array (or tensor) -> ``device``. A host array goes through a
    pinned buffer on CUDA, so the copy does not stall the host."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device)
    src = torch.from_numpy(np.ascontiguousarray(arr))
    if device.type != "cuda":
        return src
    pinned = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
    pinned.copy_(src)
    return pinned.to(device, non_blocking=True)


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
    on the kernels; 'torch' runs the plain version on any device.

    ``topk_mode='approx'`` takes the exact block-pruned selection
    (``lax.approx_max_k`` has no CUDA counterpart; its recall here is
    1.0), and so does ``narrow_m > 0`` with ``narrow_backend='torch'``
    (``osr_tpu``'s narrowed selection is bit-identical to it). m is K4's:
    ``narrow_backend='extract'`` with ``narrow_m > 0``, an int8/int4 head
    and the host merge runs K4 (its plain twin with
    ``head_backend='torch'``) wherever a sweep has the block-pruned
    selection's rows; a batch whose tie-safety flag is set re-runs the
    standard program. ``score_chunk_rows``: None sizes row
    chunks from the device's free memory (:func:`plan_score_chunks`), 0
    turns chunking off, a number asks for that many rows a chunk."""

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
        narrow_backend: str = "torch",  # 'torch' | 'extract' (K4)
        cand_filter_per_query: int = 2048,  # defer+filter gate; 0 = off
    ):
        self.index = index
        self.device = resolve_device(device)
        self.batch_sizes = tuple(sorted(batch_sizes))
        if topk_mode not in ("exact", "approx"):
            raise ValueError(f"Unknown topk_mode: {topk_mode}")
        self.topk_mode = topk_mode
        if narrow_backend not in ("torch", "extract"):
            raise ValueError(f"Unknown narrow_backend: {narrow_backend}")
        self.narrow_m = int(narrow_m)
        self.narrow_backend = narrow_backend
        self.cand_filter_per_query = int(cand_filter_per_query)
        layout = index.layout
        self.head_backend = head_backend = _head_backend(
            head_backend, layout.head_dtype, self.device
        )
        if (
            narrow_backend == "extract"
            and head_backend == "cuda"
            and self.narrow_m > head_ops.BLOCKTOPM_MAX_M
        ):
            raise ValueError(
                f"narrow_m={self.narrow_m}: the block top-m kernel takes "
                f"m <= {head_ops.BLOCKTOPM_MAX_M}"
            )
        with_runtime = host_runtime(self.device)
        if merge_backend == "auto":
            merge_backend = "host" if with_runtime else "device"
        if merge_backend not in ("host", "device"):
            raise ValueError(f"Unknown merge_backend: {merge_backend}")
        self.merge_backend = merge_backend
        self.tokenizer = Tokenizer(index.vocabulary)
        self.encoder = QueryEncoder(self.tokenizer)
        self._dev = _DeviceIndex(
            layout, self.device,
            chunk_rows=self._chunk_rows(score_chunk_rows) or None,
        )
        # Real queries and batches dispatched, tail candidates walked,
        # extraction batches re-run by the standard program, row-chunk
        # sweeps dispatched (re-runs included).
        self._counts = dict.fromkeys(
            ("queries", "batches", "tail_candidates", "redispatches",
             "chunk_sweeps"),
            0,
        )
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

    def _chunk_rows(self, requested: Optional[int]) -> int:
        """Rows a score chunk (0: one sweep) from :func:`plan_score_chunks`,
        with ``osr_tpu``'s two warnings: chunking needs the host merge, and
        an explicit chunk over the budget may run out of memory."""
        layout = self.index.layout
        free = (
            torch.cuda.mem_get_info(self.device)[0]
            if self.device.type == "cuda"
            else None
        )
        width = layout.head.shape[1] * (2 if layout.head_dtype == "int4" else 1)
        rows, need, budget = plan_score_chunks(
            num_rows=layout.num_rows,
            head_bytes=layout.head.nbytes,
            max_batch=self.batch_sizes[-1],
            head_width=width,
            free_bytes=free,
            plain_f32_copy=(
                self.head_backend == "torch" and layout.head_dtype != "f32"
            ),
            requested=requested,
        )
        if rows and self.merge_backend != "host":
            logger.warning(
                "score chunking (%d rows a chunk) is off: merge_backend=%r "
                "has no chunked path, so one (B=%d, R=%d) sweep runs and "
                "may exceed the %.1f GiB search budget",
                rows, self.merge_backend, self.batch_sizes[-1],
                layout.num_rows, (budget or 0) / 2**30,
            )
            return 0
        if requested and rows and budget is not None and need > budget:
            logger.warning(
                "score_chunk_rows=%d needs %.1f GiB a sweep, over the %.1f "
                "GiB search budget: expect the device to run out of memory",
                rows, need / 2**30, budget / 2**30,
            )
        return rows

    # ------------------------------------------------------------------
    # Device path
    # ------------------------------------------------------------------

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        return _upload(arr, self.device)

    def _tail_candidates(self, enc: EncodedBatch, batch_size: int):
        layout = self.index.layout
        with span("osr.sparse.tail_walk"):
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
        with span("osr.sparse.cand_dots"):
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

    def _extract_applies(self, rows: int, top_k: int) -> bool:
        """The extraction kernel runs where a sweep of ``rows`` rows would
        take the block-pruned exact selection, on the host merge (there is
        no device candidate gather to serve) and an int8/int4 head."""
        return (
            self.narrow_backend == "extract"
            and self.narrow_m > 0
            and self.merge_backend == "host"
            and self.index.layout.head_dtype in ("int8", "int4")
            and block_prune_applies(rows, top_k)
        )

    def _use_extract(self, top_k: int) -> bool:
        """The unchunked engine takes the extraction path."""
        d = self._dev
        return d.chunks is None and self._extract_applies(d.num_rows, top_k)

    def _use_extract_chunked(self, top_k: int) -> bool:
        """The chunked engine takes the extraction path in every chunk
        (the chunks share one size, so one floor check covers them)."""
        d = self._dev
        return d.chunks is not None and self._extract_applies(
            d.chunk_rows, top_k
        )

    def _sweep(self, ids, w, head, valid, top_k, extract, flat=None):
        """One sweep of the device step over ``head`` rows: (top, rows,
        unsafe flag or None, candidates' head scores or None)."""
        d = self._dev
        terms = self.index.layout.head_terms
        if extract:
            top, rows, unsafe = fused_search_extract(
                ids, w, head, d.head_scales, valid, head_terms=terms,
                k=top_k, narrow_m=self.narrow_m,
                head_backend=self.head_backend,
            )
            return top, rows, unsafe, None
        flat_rows, flat_cols = flat or (d.empty_i32, d.empty_i32)
        top, rows, cand_head = fused_search(
            ids, w, flat_rows, flat_cols, head, d.head_scales, valid,
            head_terms=terms, k=top_k, head_backend=self.head_backend,
        )
        return top, rows, None, cand_head

    def _dispatch_chunked(self, ids, w, top_k: int, extract: bool):
        """One sweep per row chunk, then the chunks' top-k merged on the
        device: (top, rows, unsafe flag or None). A chunk's (B, Rc) scores
        are released when its sweep returns, so the next chunk reuses that
        memory: one chunk's slab is live at a time. The flag is the max
        over chunks."""
        d = self._dev
        vals, rows, flags = [], [], []
        for head_c, valid_c in d.chunks:
            with span("osr.sparse.chunk"):
                top, r, unsafe, _ = self._sweep(
                    ids, w, head_c, valid_c, top_k, extract
                )
            vals.append(top)
            rows.append(r)
            flags.append(unsafe)
        self._counts["chunk_sweeps"] += len(d.chunks)
        with span("osr.sparse.chunk_merge"):
            top, r = merge_chunks(torch.stack(vals), torch.stack(rows),
                                  d.chunk_bases)
        return top, r, (torch.stack(flags).any() if extract else None)

    def _standard_step(self, ids, w, top_k: int):
        """The standard program (no extraction), chunked or not: (top,
        rows) on the device."""
        d = self._dev
        if d.chunks is not None:
            top, rows, _ = self._dispatch_chunked(ids, w, top_k, False)
            return top, rows
        top, rows, _, _ = self._sweep(ids, w, d.head, d.valid, top_k, False)
        return top, rows

    def device_step(self, ids, w, top_k: int):
        """The device step of one batch on its uploaded head ids and
        weights (scatter, head kernel, selection; chunked, and extraction,
        where the engine takes them): (top, rows, tie flag or None) on the
        device, not waited for. :meth:`search_encoded_device` runs it
        wherever the merge is on the host."""
        d = self._dev
        if d.chunks is not None:
            return self._dispatch_chunked(
                ids, w, top_k, self._use_extract_chunked(top_k)
            )
        top, rows, unsafe, _ = self._sweep(
            ids, w, d.head, d.valid, top_k, self._use_extract(top_k)
        )
        return top, rows, unsafe

    @property
    def swept_head(self) -> Tuple[int, int, int]:
        """(rows, columns, bytes) of the head as one device step sweeps it:
        rows padded to the row tile, over every chunk; columns the query
        width the head kernel multiplies (padded to its alignment)."""
        d = self._dev
        parts = d.chunks if d.chunks is not None else [(d.head, d.valid)]
        head = parts[0][0]
        cols = head.shape[1] * (2 if self.index.layout.head_dtype == "int4"
                                else 1)
        return d.num_rows, cols, sum(
            h.numel() * h.element_size() for h, _ in parts
        )

    def search_encoded_device(self, enc: EncodedBatch, top_k: int):
        """Launch the device step and start its result copy, then run the
        host stages that do not need it (tail candidates were walked
        first; the candidates' head dots run while the device works).

        Returns an opaque in-flight handle for :meth:`finish_batch`."""
        with span("osr.sparse.dispatch"):
            d = self._dev
            cand = self._tail_candidates(enc, enc.head_ids.shape[0])
            counts = self._counts
            counts["queries"] += enc.num_queries
            counts["batches"] += 1
            counts["tail_candidates"] += cand.total
            ids = self._upload(enc.head_ids)
            w = self._upload(enc.head_weights)
            if self.merge_backend == "device":
                # Chunking and extraction need the host merge, so this is
                # the one unchunked standard sweep; its candidates' head
                # scores come from the same score matrix as its top-k: no
                # slack.
                flat = (self._upload(cand.rows), self._upload(cand.cols))
                top, rows, _, cand_head_dev = self._sweep(
                    ids, w, d.head, d.valid, top_k, False, flat
                )
                result = _PendingResult(
                    (top, rows, cand_head_dev), self.device
                )
                return cand, result, None, np.zeros(
                    enc.head_ids.shape[0], dtype=np.float32
                ), None
            top, rows, unsafe = self.device_step(ids, w, top_k)
            if unsafe is None:
                result, redo = _PendingResult((top, rows), self.device), None
            else:
                # Keep the query tensors: a batch whose flag is set re-runs
                # the standard program from them.
                result = _PendingResult((top, rows, unsafe), self.device)
                redo = (ids, w)
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
                # Large candidate loads: defer the head dot until the
                # device top-k allows the exact tau filter
                # (postings.py:filter_candidates_by_tau).
                cand_head = ("tau_filter", enc)
            else:
                cand_head = self._cand_head_host(cand, enc)
            return cand, result, cand_head, tau_slack, redo

    def finish_batch(
        self, in_flight, top_k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for the device result and run the exact host merge. An
        extraction batch whose tie-safety flag is set re-runs the standard
        program first (the narrowed candidates could miss a top-k
        member)."""
        cand, result, cand_head, tau_slack, redo = in_flight
        with span("osr.sparse.wait"):
            arrays = result.wait()
        head_s, head_r = arrays[0], arrays[1]
        if cand_head is None:
            cand_head = arrays[2]
        if redo is not None and bool(arrays[2]):
            self._counts["redispatches"] += 1
            with span("osr.sparse.redispatch"):
                top, rows = self._standard_step(*redo, top_k)
                head_s, head_r = _PendingResult((top, rows), self.device).wait()
        if isinstance(cand_head, tuple):
            enc = cand_head[1]
            with span("osr.sparse.tau_filter"):
                cand = filter_candidates_by_tau(
                    cand, head_s, head_r, top_k, tau_slack,
                    self._dev.num_rows,
                )
            cand_head = self._cand_head_host(cand, enc)
        with span("osr.sparse.merge"):
            return merge_host(
                head_s,
                head_r,
                cand,
                cand_head,
                self._dev.num_rows,
                top_k,
                tau_slack=tau_slack,
            )

    def search_token_batch(
        self, texts: Sequence[str], top_k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Encode + search one batch of query strings synchronously: (B, k)
        scores and int32 doc rows, B the batch padded to its bucket."""
        enc = self.encode_queries(texts)
        return self.finish_batch(self.search_encoded_device(enc, top_k), top_k)

    def score_all(self, texts: Sequence[str]) -> np.ndarray:
        """Dense (len(texts), num_docs) score matrix: the oracle API. Head
        scores come from the device (plain version, in the head's dtype,
        chunk by chunk on a chunked engine); tail scores are added on the
        host exactly."""
        d = self._dev
        layout = self.index.layout
        n = self.index.num_docs
        out = np.zeros((len(texts), n), dtype=np.float32)
        max_b = self.batch_sizes[-1]
        heads = [c for c, _ in d.chunks] if d.chunks is not None else [d.head]
        for i in range(0, len(texts), max_b):
            chunk = texts[i : i + max_b]
            enc = self.encode_queries(chunk)
            ids = self._upload(enc.head_ids)
            w = self._upload(enc.head_weights)
            scores = np.concatenate(
                [
                    dense_head_scores(
                        ids, w, h, d.head_scales,
                        head_terms=layout.head_terms,
                    ).cpu().numpy()
                    for h in heads
                ],
                axis=1,
            )[: len(chunk), :n]
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
        with span("osr.sparse.encode"):
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
        with span("osr.sparse.search"):
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
                with span("osr.sparse.dicts"):
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
        with span("osr.sparse.search"):
            results: Dict[str, Dict[str, float]] = {}
            qids = [q for q, vec in queries.items() if vec]
            for q, vec in queries.items():
                if not vec:
                    results[q] = {}
            max_b = self.batch_sizes[-1]
            for i in range(0, len(qids), max_b):
                chunk = qids[i : i + max_b]
                with span("osr.sparse.encode"):
                    enc = encode_weighted_batch(
                        self.index.vocabulary,
                        [queries[q] for q in chunk],
                        pick_batch_size(self.batch_sizes, len(chunk)),
                        self.index.layout.head_terms,
                    )
                scores, ids = self.finish_batch(
                    self.search_encoded_device(enc, top_k), top_k
                )
                with span("osr.sparse.dicts"):
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
        if self._dev.chunks is not None:
            s["score_chunks"] = len(self._dev.chunks)
        if self.narrow_backend == "extract":
            s["extract_redispatches"] = self._counts["redispatches"]
        s["counters"] = dict(self._counts)
        if self._query_cache is not None:
            s["query_cache_size"] = len(self._query_cache)
        return s


# ----------------------------------------------------------------------
# Dense retrieval
# ----------------------------------------------------------------------

DENSE_QUANTIZATIONS = (
    "symmetric", "asymmetric", "int4", "int4_grouped", "none"
)
KERNEL_QUANTIZATIONS = ("symmetric", "int4")  # the modes K5/K6 score
# The batch size from which K5/K6's block maxima beat the block_max pass
# over their scores (H100, N = 2.68M: the fused step is slower at B = 1, even
# at 2, faster from 4 on; PERF.md, Findings): below it the fused reduction's
# latency in each tile's epilogue costs more than it saves.
FUSED_MAXIMA_MIN_ROWS = 4


def dense_kernel_scores(
    q: torch.Tensor,  # (B, D) f32 queries
    docs: torch.Tensor,  # (N, D) int8, or (N, D/2) uint8 int4-packed
    scales: torch.Tensor,  # (N,) f32
    blockmax: bool = False,
):
    """The (B, N) f32 scores of :func:`dense_kernel_step`: K7 on the
    queries, then K5 (int8 corpus) or K6 (int4). With ``blockmax``, the
    scores and their (B, ceil(N / 128)) block maxima from the same
    launch."""
    q8, qs = qz.quantize_symmetric(q)
    int4 = docs.dtype == torch.uint8
    if blockmax:
        similarity = (matmul_ops.int4_similarity_blockmax if int4
                      else matmul_ops.int8_similarity_blockmax)
    else:
        similarity = (matmul_ops.int4_similarity if int4
                      else matmul_ops.int8_similarity)
    return similarity(q8, docs, qs, scales)


def dense_kernel_step(
    q: torch.Tensor,  # (B, D) f32 queries
    docs: torch.Tensor,  # (N, D) int8, or (N, D/2) uint8 int4-packed
    scales: torch.Tensor,  # (N,) f32
    k: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One dense batch through the kernels (counterpart of ``osr_tpu``'s
    ``_pallas_dense_step``): K7 quantizes the queries, K5 (int8 corpus) or
    K6 (int4, chosen by the corpus dtype) scores them, and the exact
    selection takes the top k. Returns ((B, k') f32 scores, (B, k') int32
    rows), k' = min(k, N).

    At ``BLOCK_SELECT_MIN_COLS`` (2,048) documents and more, the crossover
    of ``ops/quantize.py:_select_topk``, and ``FUSED_MAXIMA_MIN_ROWS``
    queries and more, K5/K6 also write the maximum of each 128-document
    block from their epilogue (``int8_similarity_blockmax``), and the
    block-pruned selection takes them (``block_topk_from_max``): the result
    is ``block_topk``'s, ties included, without its re-read of the (B, N)
    scores. Otherwise the scores-only kernel and ``_select_topk``.

    The kernels mask ragged B and N, so nothing is padded: the (B, N)
    similarity covers exactly the real rows (a zero-scale padding row
    would score 0 and could displace a document scoring below 0)."""
    n = docs.shape[0]
    if n < qz.BLOCK_SELECT_MIN_COLS or q.shape[0] < FUSED_MAXIMA_MIN_ROWS:
        return qz._select_topk(dense_kernel_scores(q, docs, scales), k)
    scores, maxima = dense_kernel_scores(q, docs, scales, blockmax=True)
    # The kernel's maxima are a (G, B) array's transposed view; one copy
    # here, where the sort would make its own two.
    return block_topk_from_max(scores, maxima.contiguous(), k=min(k, n))


def _dense_backend(backend: str, quantization: str, device) -> str:
    if backend == "auto":
        backend = (
            "cuda"
            if quantization in KERNEL_QUANTIZATIONS and device.type == "cuda"
            else "torch"
        )
    if backend == "cuda" and not (
        quantization in KERNEL_QUANTIZATIONS and device.type == "cuda"
    ):
        raise ValueError(
            "backend='cuda' needs symmetric or int4 quantization on a CUDA "
            f"device (quantization {quantization}, device {device})"
        )
    if backend not in ("cuda", "torch"):
        raise ValueError(f"Unknown backend: {backend}")
    return backend


def _rows(t: Optional[torch.Tensor], start: int, stop: int, device):
    return None if t is None else t[start:stop].to(device).contiguous()


class DenseSearchEngine:
    """Quantized (or f32) dense retrieval on the device.

    ``quantization``: 'symmetric' (int8), 'int4' (signed nibbles, half the
    bytes), 'int4_grouped' (int4 with per-128-column scales),
    'asymmetric' (uint8 with a zero offset) or 'none' (f32).

    ``device`` defaults to ``cuda``; pass ``"cpu"`` for the plain path.
    ``backend``: 'auto' takes the CUDA kernels (K7 + K5/K6,
    :func:`dense_kernel_step`) for symmetric/int4 on a CUDA device and the
    plain PyTorch ops otherwise; 'cuda' insists on the kernels; 'torch'
    runs ``ops/quantize.py``'s search functions on any device (plain
    products; their query quantizer is still K7 on a CUDA tensor). The
    kernels take every width (every even width for int4). Results are
    exact top-k with ties to the lower document row, as ``osr_tpu``'s.

    Doc rows are int32 on the device, so, unlike ``osr_tpu``, neither the
    corpus nor a score chunk is capped at 2^24 rows."""

    def __init__(
        self,
        doc_ids: Sequence[str],
        embeddings,  # (N, dim) float32: NumPy array or tensor
        quantization: str = "symmetric",
        device=None,
        backend: str = "auto",
    ):
        if quantization not in DENSE_QUANTIZATIONS:
            raise ValueError(f"Unknown quantization: {quantization}")
        self.doc_ids = list(doc_ids)
        self.quantization = quantization
        self.device = resolve_device(device)
        self.backend = _dense_backend(backend, quantization, self.device)
        if embeddings.shape[0] != len(self.doc_ids):
            raise ValueError(
                f"{embeddings.shape[0]} embeddings for {len(self.doc_ids)} "
                "doc ids"
            )
        self.dim = int(embeddings.shape[1])
        self._chunks = None
        self._mins = None
        self._doc_names = None
        # Quantize on the device itself; the staged f32 rows are dropped
        # when the constructor returns (unless they were the caller's).
        if not isinstance(embeddings, torch.Tensor):
            embeddings = np.asarray(embeddings, dtype=np.float32)
        emb = _upload(embeddings, self.device).float()
        if quantization == "symmetric":
            self._docs, self._scales = qz.quantize_symmetric(emb)
        elif quantization == "int4":
            self._docs, self._scales = qz.quantize_symmetric_int4(emb)
        elif quantization == "int4_grouped":
            self._docs, self._scales = qz.quantize_symmetric_int4_grouped(emb)
        elif quantization == "asymmetric":
            self._docs, self._scales, self._mins = qz.quantize_asymmetric(emb)
        else:
            self._docs, self._scales = emb.contiguous(), None

    @classmethod
    def from_quantized(
        cls,
        doc_ids: Sequence[str],
        docs_q,  # int8 (N, D) | uint8 (N, D/2) int4-packed
        scales,  # (N,) f32 per row, or (N, G) for int4_grouped
        quantization: str = "symmetric",
        device=None,
        backend: str = "auto",
        score_chunk_rows: Optional[int] = None,
    ) -> "DenseSearchEngine":
        """Build from host-pre-quantized rows (``ops/quantize.py``'s NumPy
        twins): only the packed bytes travel to the device.

        ``score_chunk_rows`` splits the corpus into row chunks, each scored
        and selected on its own, whose top-k lists merge on the host by
        descending score, ties to the lower doc id: the (B, N) f32
        similarity of the whole corpus never exists at once."""
        docs_q = torch.as_tensor(docs_q)
        scales = torch.as_tensor(scales, dtype=torch.float32)
        if quantization == "symmetric":
            if docs_q.dtype != torch.int8:
                raise ValueError(f"symmetric rows must be int8: {docs_q.dtype}")
            dim = docs_q.shape[1]
        elif quantization in ("int4", "int4_grouped"):
            if docs_q.dtype != torch.uint8:
                raise ValueError(f"int4 rows must be uint8: {docs_q.dtype}")
            dim = 2 * docs_q.shape[1]
            if quantization == "int4_grouped":
                if scales.dim() != 2:
                    raise ValueError(
                        "int4_grouped needs (N, G) per-group scales "
                        f"(got shape {tuple(scales.shape)})"
                    )
                if dim % scales.shape[1]:
                    raise ValueError(
                        f"dim {dim} not divisible by {scales.shape[1]} groups"
                    )
        else:
            raise ValueError(
                "from_quantized supports symmetric/int4/int4_grouped, "
                f"got {quantization}"
            )
        if len(doc_ids) != docs_q.shape[0] or len(doc_ids) != scales.shape[0]:
            raise ValueError("doc_ids/rows/scales length mismatch")
        return cls._from_state(
            doc_ids, docs_q, scales, None, quantization, dim,
            device=device, backend=backend,
            score_chunk_rows=score_chunk_rows,
        )

    @classmethod
    def _from_state(
        cls,
        doc_ids: Sequence[str],
        docs: torch.Tensor,
        scales: Optional[torch.Tensor],
        mins: Optional[torch.Tensor],
        quantization: str,
        dim: int,
        *,
        device=None,
        backend: str = "auto",
        score_chunk_rows: Optional[int] = None,
    ) -> "DenseSearchEngine":
        """An engine over already quantized rows (any quantization),
        row-chunked when ``score_chunk_rows`` is below the corpus size."""
        self = cls.__new__(cls)
        self.doc_ids = list(doc_ids)
        self.quantization = quantization
        self.device = resolve_device(device)
        self.backend = _dense_backend(backend, quantization, self.device)
        self.dim = int(dim)
        self._doc_names = None
        n = len(self.doc_ids)
        if score_chunk_rows and n > score_chunk_rows:
            rows = int(score_chunk_rows)
            self._chunks = [
                (
                    _rows(docs, base, base + rows, self.device),
                    _rows(scales, base, base + rows, self.device),
                    _rows(mins, base, base + rows, self.device),
                    base,
                )
                for base in range(0, n, rows)
            ]
            self._docs = self._scales = self._mins = None
        else:
            self._chunks = None
            self._docs = _rows(docs, 0, n, self.device)
            self._scales = _rows(scales, 0, n, self.device)
            self._mins = _rows(mins, 0, n, self.device)
        return self

    def _scores(self, q, docs, scales, mins) -> torch.Tensor:
        """One batch against one set of rows: (B, N) f32 scores on the
        device."""
        if self.backend == "cuda":
            return dense_kernel_scores(q, docs, scales)
        if self.quantization == "symmetric":
            return qz.int8_scores_symmetric(q, docs, scales)
        if self.quantization == "int4":
            return qz.int4_scores_symmetric(q, docs, scales)
        if self.quantization == "int4_grouped":
            return qz.int4_scores_symmetric_grouped(
                q, docs, scales, group_size=self.dim // scales.shape[1]
            )
        if self.quantization == "asymmetric":
            return qz.int8_scores_asymmetric(q, docs, scales, mins)
        return qz.fp_scores(q, docs)

    def _step(self, q, docs, scales, mins, k: int):
        """One batch against one set of rows: ((B, k') f32, (B, k')
        int32) on the device."""
        if self.backend == "cuda":
            return dense_kernel_step(q, docs, scales, k)
        return qz._select_topk(self._scores(q, docs, scales, mins), k)

    def dispatch_vectors(self, query_vectors, top_k: int):
        """Enqueue the device step for (B, dim) f32 query vectors (array or
        tensor) and start its result copy; returns an in-flight handle for
        :meth:`collect_vectors` without waiting for the device."""
        with span("osr.dense.dispatch"):
            if not isinstance(query_vectors, torch.Tensor):
                query_vectors = np.asarray(query_vectors, dtype=np.float32)
            with span("osr.dense.upload"):
                q = _upload(query_vectors, self.device).float()
            if q.dim() != 2 or q.shape[1] != self.dim:
                raise ValueError(
                    f"queries must be (B, {self.dim}), got {tuple(q.shape)}"
                )
            if self._chunks is None:
                out = self._step(q, self._docs, self._scales, self._mins,
                                 top_k)
                return (_PendingResult(out, self.device), None, top_k)
            tensors, bases = [], []
            for docs, scales, mins, base in self._chunks:
                tensors += self._step(q, docs, scales, mins, top_k)
                bases.append(base)
            return (_PendingResult(tensors, self.device), bases, top_k)

    def collect_vectors(self, in_flight) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for a :meth:`dispatch_vectors` handle: (scores (B, k) f32,
        doc rows (B, k) int32). Row chunks merge by descending score,
        ties to the lower doc row, as one selection over the corpus would
        order them."""
        pending, bases, top_k = in_flight
        with span("osr.dense.wait"):
            arrays = pending.wait()
        if bases is None:
            return arrays[0], arrays[1]
        vals = np.concatenate(arrays[0::2], axis=1)
        ids = np.concatenate(
            [a.astype(np.int64) + b for a, b in zip(arrays[1::2], bases)],
            axis=1,
        )
        order = np.lexsort((ids, -vals), axis=1)[:, : min(top_k, vals.shape[1])]
        return (
            np.take_along_axis(vals, order, axis=1),
            np.take_along_axis(ids, order, axis=1).astype(np.int32),
        )

    def search_vectors(
        self, query_vectors, top_k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B, k), doc rows (B, k)) for (B, dim) f32 query vectors,
        one device step for the whole batch."""
        return self.collect_vectors(self.dispatch_vectors(query_vectors, top_k))

    def search(
        self,
        query_vectors: Mapping[str, np.ndarray],
        top_k: int = 10,
        min_score: float = 0.0,
    ) -> Dict[str, Dict[str, float]]:
        """{qid: {doc_id: score}} with scores above ``min_score``, sorted
        descending."""
        qids = list(query_vectors.keys())
        if not qids:
            return {}
        with span("osr.dense.search"):
            batch = np.stack(
                [np.asarray(query_vectors[q], dtype=np.float32) for q in qids]
            )
            scores, ids = self.search_vectors(batch, top_k=top_k)
            with span("osr.dense.dicts"):
                if self._doc_names is None:
                    self._doc_names = as_object_names(self.doc_ids)
                n = len(self.doc_ids)
                mask = (scores > min_score) & (ids >= 0) & (ids < n)
                return dict(zip(
                    qids,
                    assemble_result_dicts(self._doc_names, ids, scores, mask),
                ))
