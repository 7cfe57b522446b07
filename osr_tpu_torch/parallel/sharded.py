"""Document-sharded, query-parallel search over a ``torch.distributed``
world (counterpart of ``osr_tpu/parallel/sharded.py``).

``osr_tpu`` runs one program over a (q, d) mesh of chips with
``shard_map``; here every rank of the world runs the same program on its
own shard (SPMD), and the collectives of ``torch.distributed`` take the
place of ``lax.all_gather``, ``psum`` and ``pmax``. Rank (qi, di) of the
mesh (``mesh.py``) holds row shard di of the index and scores query slice
qi of every batch.

One sparse batch (:func:`sharded_search`):

1. every rank walks the tail postings of the whole batch on the host (the
   index is host-resident on every rank, as it is on ``osr_tpu``'s one
   host), so every rank holds the same flat candidate list;
2. the rank scores its query slice against its head shard with the flat
   engine's own head step (``ops/bm25.py:head_step_scores``: K2 where the
   flat engine's block-pruned selection applies, K1 below that floor, K3
   for an int4 head, the plain product with ``head_backend='torch'``),
   selects as the flat engine would, and turns its local top-k rows into
   global rows;
3. an ``all_gather`` over ``d`` collects the shards' (B/n_q, k) lists in
   ``d`` order, and one stable descending selection merges them. Ties go
   to the lower global row, as ``lax.top_k`` over the gathered axis does,
   except where the flat engine prunes by blocks: there ties order by
   descending block maximum first, as its selection orders them, so a tie
   at the k-th place keeps the document the flat engine keeps (shards
   start on 128-row blocks, so their blocks are the flat engine's);
4. each rank writes the head scores of the candidates in its (rows,
   queries) block into a zero (M,) vector, and an ``all_reduce`` SUM over
   the world reassembles it (each candidate is owned by one rank, so the
   sum is exact);
5. an ``all_gather`` over ``q`` gives every rank the whole batch, and the
   exact host merge (``index/postings.py:merge_host``) runs on every rank.

Every rank calls the engines with the same queries and returns the same
results. Collectives run on the device of the group's backend: the card's
tensors under NCCL, CPU tensors under gloo, which takes no CUDA tensor
for ``all_gather``. Only the small (B, k) lists, the (M,) candidate
vector and the flag travel; the scoring kernels run on the engine's
device either way. Rows stay int32 and shard bases int64.

Exactness: each true top-k document lives on some shard, where it ranks
within the shard's top-k, and the kernels' per-row sums do not depend on
how many rows a shard holds, so the merged lists equal the flat engine's.
The standard step's candidate scores come from the device scores (zero
merge slack), as with the flat engine's ``merge_backend='device'``; the
extraction plan's from the host (``merge_tau_slack``), as with its host
merge. The dense engine merges in its flat selection's order too.
"""

from __future__ import annotations

import threading
import types
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from osr_tpu_torch.index.builder import SparseIndex
from osr_tpu_torch.index.layout import round_up
from osr_tpu_torch.index.postings import (
    FlatCandidates,
    cand_head_scores_host,
    merge_host,
    merge_tau_slack,
    prepare_host_merge,
    tail_candidates_flat,
)
from osr_tpu_torch.index.tokenizer import Tokenizer
from osr_tpu_torch.ops import head as head_ops
from osr_tpu_torch.ops.bm25 import (
    block_prune_applies,
    head_step_blocktopm,
    head_step_scores,
)
from osr_tpu_torch.ops import quantize as qz
from osr_tpu_torch.ops.topk import (
    block_max,
    block_topk_from_max,
    blocktopm_topk,
    topk,
)
from osr_tpu_torch.parallel.mesh import DOC_AXIS, QUERY_AXIS
from osr_tpu_torch.retrieval.encoding import (
    EncodedBatch,
    QueryEncoder,
    encode_query_batch,
    encode_weighted_batch,
    pick_batch_size,
)
from osr_tpu_torch.retrieval.engine import (
    DEFAULT_BATCH_SIZES,
    DenseSearchEngine,
    _DeviceIndex,
    _PendingResult,
    _dense_backend,
    _head_backend,
    _upload,
    host_runtime,
    resolve_device,
)
from osr_tpu_torch.retrieval.pipeline_util import run_pipelined
from osr_tpu_torch.retrieval.results import (
    as_object_names,
    assemble_result_dicts,
)

SHARDED_QUANTIZATIONS = ("symmetric", "asymmetric", "int4", "none")


class MeshComm:
    """This rank's place in a (q, d) ``DeviceMesh`` and the collectives
    the sharded steps use.

    ``device`` is the engine's device. The transport is the card under an
    NCCL group and the CPU under any other backend (gloo): tensors move
    there before a collective and the results stay there."""

    def __init__(self, mesh, device: torch.device):
        self.n_q, self.n_d = (int(s) for s in mesh.shape)
        self.q, self.d = (int(c) for c in mesh.get_coordinate())
        self.q_group = mesh.get_group(QUERY_AXIS)
        self.d_group = mesh.get_group(DOC_AXIS)
        backend = str(dist.get_backend(self.d_group))
        self.device = (
            device
            if "nccl" in backend and device.type == "cuda"
            else torch.device("cpu")
        )
        # all_gather lists a group's tensors in group-rank order; the merge's
        # tie order needs that order to be the mesh coordinate.
        me = dist.get_rank()
        if (
            dist.get_group_rank(self.d_group, me) != self.d
            or dist.get_group_rank(self.q_group, me) != self.q
        ):
            raise RuntimeError(
                "mesh groups do not list their ranks in mesh order"
            )

    def _all_gather(self, t: torch.Tensor, group, n: int, dim: int):
        t = t.to(self.device).contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t, group=group)
        return torch.cat(parts, dim=dim)

    def gather_d(self, t: torch.Tensor) -> torch.Tensor:
        """(B_local, k) per shard -> (B_local, n_d k), shards in d order."""
        return self._all_gather(t, self.d_group, self.n_d, 1)

    def gather_q(self, t: torch.Tensor) -> torch.Tensor:
        """(B_local, k) per query slice -> (B, k), slices in q order."""
        return self._all_gather(t, self.q_group, self.n_q, 0)

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``op`` over every rank of the world; returns a new tensor."""
        t = t.to(self.device, copy=True).contiguous()
        dist.all_reduce(t, op=op)
        return t


def merge_shards(
    comm: MeshComm,
    top: torch.Tensor,  # (B_local, k') this shard's top scores
    rows: torch.Tensor,  # (B_local, k') int32 shard-local rows
    base: int,  # the shard's first global row
    k: int,
    block_max: Optional[torch.Tensor] = None,  # (B_local, k') or None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The shards' top-k lists merged over ``d``: ((B_local, k'') scores,
    (B_local, k'') int32 global rows) on the transport device, k'' =
    min(k, n_d k').

    Lists arrive in d order and the selection is stable, so ties go to the
    lower global row. With ``block_max`` (each entry's 128-row block
    maximum), ties order by descending block maximum first: the order of
    the flat engine's block-pruned selection (``ops/topk.py:
    block_topk_from_max``), so a tie at the k-th place keeps the document
    the flat engine keeps."""
    ids = (rows.long() + base).int()
    s_all = comm.gather_d(top)
    i_all = comm.gather_d(ids)
    if block_max is not None:
        _, by_block = torch.sort(
            comm.gather_d(block_max), dim=1, descending=True, stable=True
        )
        s_all = torch.gather(s_all, 1, by_block)
        i_all = torch.gather(i_all, 1, by_block)
    merged, pos = topk(s_all, k=min(k, s_all.shape[1]))
    return merged, torch.gather(i_all, 1, pos.long())


def _rows_block_max(block_max: torch.Tensor, rows: torch.Tensor):
    """(B, k) block maxima of the 128-row blocks holding ``rows``."""
    return torch.gather(block_max, 1, rows.long() // head_ops.ROW_TILE)


def sharded_search(
    q_head_ids: torch.Tensor,  # (B_local, Q) int32: this rank's query slice
    q_head_weights: torch.Tensor,  # (B_local, Q) f32
    cand_flat_rows: torch.Tensor,  # (M,) int32 GLOBAL rows, whole batch
    cand_flat_cols: torch.Tensor,  # (M,) int32 GLOBAL query index
    head: torch.Tensor,  # (R_local, F) this rank's head shard
    head_scales: Optional[torch.Tensor],  # (F,) f32 or None
    valid: torch.Tensor,  # (R_local,) bool
    *,
    comm: MeshComm,
    head_terms: int,
    k: int,
    head_backend: str,  # 'cuda' | 'torch'
    block_prune: bool,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The sharded device step of one batch: the shard's head step
    (``ops/bm25.py:head_step_scores``, as in ``fused_search``), the merge
    over ``d``, the candidate vector reassembled over the world and the
    batch gathered over ``q``. Returns (top (B, k'') f32, rows (B, k'')
    int32 global, cand_head (M,) f32), all on the transport device; every
    rank gets the same three.

    ``block_prune`` is the flat engine's choice for the whole index
    (``block_prune_applies(R, k)``): with it, the shard launches K2/K3 and
    selects block-pruned, and the merge orders ties as the flat engine
    does (:func:`merge_shards`); without it, K1 (K3 for int4) and one
    exact sort. Shards start on 128-row blocks, so their blocks are the
    flat engine's."""
    rows_local = head.shape[0]
    b_local = q_head_ids.shape[0]
    row_lo = comm.d * rows_local
    col_lo = comm.q * b_local
    hs, bmax = head_step_scores(
        q_head_ids, q_head_weights, head, head_scales, valid,
        head_terms=head_terms, head_backend=head_backend,
        with_block_max=block_prune,
    )
    kk = min(k, rows_local)
    if block_prune:
        top, rows = block_topk_from_max(hs, bmax, k=kk)
        key = _rows_block_max(bmax, rows)
    else:
        top, rows = topk(hs, k=kk)
        key = None
    top, ids = merge_shards(comm, top, rows, row_lo, k, key)
    lrow = cand_flat_rows.long() - row_lo
    lcol = cand_flat_cols.long() - col_lo
    mine = (lrow >= 0) & (lrow < rows_local) & (lcol >= 0) & (lcol < b_local)
    vals = hs[lcol.clamp(0, b_local - 1), lrow.clamp(0, rows_local - 1)]
    cand = torch.where(mine, vals, torch.zeros_like(vals))
    if cand.numel():  # M is the same on every rank: all skip, or none
        cand = comm.all_reduce(cand, dist.ReduceOp.SUM)
    else:
        cand = cand.to(comm.device)
    return comm.gather_q(top), comm.gather_q(ids), cand


def sharded_search_extract(
    q_head_ids: torch.Tensor,  # (B_local, Q) int32: this rank's query slice
    q_head_weights: torch.Tensor,  # (B_local, Q) f32
    head: torch.Tensor,  # (R_local, F) int8 | (R_local, F/2) uint8 int4
    head_scales: torch.Tensor,  # (F,) f32
    valid: torch.Tensor,  # (R_local,) bool
    *,
    comm: MeshComm,
    head_terms: int,
    k: int,
    narrow_m: int = 8,
    head_backend: str,  # 'cuda' (K4) | 'torch' (its plain twin)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The extraction form of the sharded step, for the host-merge path:
    the shard's block top-m (``ops/bm25.py:head_step_blocktopm``: K4 on the
    card, so the (B, R) scores are never written) and ``blocktopm_topk``,
    as in ``fused_search_extract``; the merge over ``d`` in the flat
    engine's tie order; the batch gathered over ``q``; and the tie-safety
    flag as a (1,) int32 MAX over the world, so every rank takes the same
    branch. Candidate head scores come from the host
    (``postings.cand_head_scores_host``). When the flag is set the caller
    runs :func:`sharded_search` for the batch."""
    rows_local = head.shape[0]
    vals, rows = head_step_blocktopm(
        q_head_ids, q_head_weights, head, head_scales, valid,
        head_terms=head_terms, narrow_m=narrow_m, head_backend=head_backend,
    )
    top, top_rows, unsafe = blocktopm_topk(vals, rows, k=k)
    key = _rows_block_max(vals[:, :, 0], top_rows)
    top, ids = merge_shards(
        comm, top, top_rows, comm.d * rows_local, k, key
    )
    flag = comm.all_reduce(
        unsafe.to(torch.int32).reshape(1), dist.ReduceOp.MAX
    )
    return comm.gather_q(top), comm.gather_q(ids), flag


def _shard_layout(layout, lo: int, rows: int):
    """The head rows [lo, lo + rows) of ``layout`` as the layout-like
    record ``_DeviceIndex`` uploads; rows past the index are zero and
    invalid."""
    head = layout.head[lo : lo + rows]
    valid = layout.valid[lo : lo + rows]
    pad = rows - head.shape[0]
    if pad:
        head = np.pad(head, ((0, pad), (0, 0)))
        valid = np.pad(valid, (0, pad))
    return types.SimpleNamespace(
        head=head,
        valid=valid,
        head_dtype=layout.head_dtype,
        head_terms=layout.head_terms,
        head_scales=layout.head_scales,
    )


class ShardedSparseSearchEngine:
    """Document-sharded, query-parallel BM25/TF-IDF search.

    The host API and options of :class:`osr_tpu_torch.retrieval.engine.
    SparseSearchEngine`: ``topk_mode`` ('approx' is served exactly, as in
    the flat engine), ``head_backend`` ('auto' | 'cuda' | 'torch'), the
    query cache, ``search_weighted``, the pipelined ``search``, and the
    extraction plan (``narrow_m > 0`` with ``narrow_backend='extract'``:
    K4 on each shard, or its plain twin with ``head_backend='torch'``).
    ``batch_sizes`` round up to multiples of the mesh's ``q`` size.

    Every rank builds the engine from the same full :class:`SparseIndex`
    on the host (the postings, the tail walk and the merge stay there) and
    uploads only its own ``d`` shard of the head: ``round_up(ceil(R /
    n_d), 128)`` rows, rows past the index invalid. Every rank calls
    :meth:`search` with the same queries and gets the same results.
    ``device`` defaults to ``cuda`` (the card ``make_mesh`` selected)."""

    def __init__(
        self,
        index: SparseIndex,
        mesh,
        batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
        topk_mode: str = "exact",
        head_backend: str = "auto",  # 'cuda' | 'torch' | 'auto'
        cache_queries: bool = True,
        query_cache_limit: int = 1000,
        narrow_m: int = 0,
        narrow_backend: str = "torch",  # 'torch' | 'extract' (K4)
        device=None,
    ):
        self.index = index
        self.device = resolve_device(device)
        host_runtime(self.device)
        self.comm = MeshComm(mesh, self.device)
        self.n_q = self.comm.n_q
        self.batch_sizes = tuple(
            round_up(b, self.n_q) for b in sorted(batch_sizes)
        )
        if topk_mode not in ("exact", "approx"):
            raise ValueError(f"Unknown topk_mode: {topk_mode}")
        self.topk_mode = topk_mode
        if narrow_backend not in ("torch", "extract"):
            raise ValueError(f"Unknown narrow_backend: {narrow_backend}")
        self.narrow_m = int(narrow_m)
        self.narrow_backend = narrow_backend
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
        n_d = self.comm.n_d
        self.rows_local = round_up(
            -(-layout.num_rows // n_d), head_ops.ROW_TILE
        )
        self.num_rows = n_d * self.rows_local
        # The flat engine's head rows: its block-pruning rule, on them,
        # sets the selection and tie order of every shard.
        self.flat_rows = round_up(layout.num_rows, head_ops.ROW_TILE)
        self._dev = _DeviceIndex(
            _shard_layout(
                layout, self.comm.d * self.rows_local, self.rows_local
            ),
            self.device,
        )
        self.tokenizer = Tokenizer(index.vocabulary)
        self.encoder = QueryEncoder(self.tokenizer)
        self._redispatches = 0
        # The extraction plan takes the candidates' head scores from the
        # host (there is no score matrix to gather from).
        self._host_merge = (
            prepare_host_merge(layout, want_head_t=True)
            if narrow_backend == "extract"
            and self.narrow_m > 0
            and layout.head_dtype in ("int8", "int4")
            else None
        )
        self._query_cache: Optional[
            Dict[Tuple[str, int], Tuple[np.ndarray, np.ndarray]]
        ] = ({} if cache_queries else None)
        self._cache_limit = query_cache_limit
        self._cache_lock = threading.RLock()
        self._doc_names = as_object_names(index.doc_ids)

    def _block_prune(self, top_k: int) -> bool:
        return block_prune_applies(self.flat_rows, top_k)

    def _use_extract(self, top_k: int) -> bool:
        """The flat engine's rule for the extraction plan, which must hold
        for the whole index and for a shard."""
        return (
            self._host_merge is not None
            and self._block_prune(top_k)
            and block_prune_applies(self.rows_local, top_k)
        )

    def encode_queries(self, texts: Sequence[str]) -> EncodedBatch:
        """Tokenize + pad query strings (at most the largest batch size)."""
        return encode_query_batch(
            self.encoder,
            texts,
            pick_batch_size(self.batch_sizes, len(texts)),
            self.index.layout.head_terms,
        )

    # ------------------------------------------------------------------
    # Device path
    # ------------------------------------------------------------------

    def _query_slice(self, enc: EncodedBatch):
        """This rank's rows of the batch's head arrays, on the device."""
        b_local = enc.head_ids.shape[0] // self.n_q
        rows = slice(self.comm.q * b_local, (self.comm.q + 1) * b_local)
        return (
            _upload(enc.head_ids[rows], self.device),
            _upload(enc.head_weights[rows], self.device),
        )

    def _standard(self, ids, w, cand: FlatCandidates, top_k: int):
        d = self._dev
        return sharded_search(
            ids,
            w,
            _upload(cand.rows, self.device),
            _upload(cand.cols, self.device),
            d.head,
            d.head_scales,
            d.valid,
            comm=self.comm,
            head_terms=self.index.layout.head_terms,
            k=top_k,
            head_backend=self.head_backend,
            block_prune=self._block_prune(top_k),
        )

    def search_encoded_device(self, enc: EncodedBatch, top_k: int):
        """Run the sharded device step of one batch and start its result
        copy; returns an in-flight handle for :meth:`finish_batch`. Every
        rank must call it with the same batch (its collectives pair up
        across the ranks)."""
        layout = self.index.layout
        cand = tail_candidates_flat(
            layout.post_ptr,
            layout.post_rows,
            layout.post_weights,
            enc.tail_ids,
            enc.tail_counts,
            enc.tail_ptr,
            enc.head_ids.shape[0],
            num_rows=self.num_rows,
        )
        ids, w = self._query_slice(enc)
        if self._use_extract(top_k):
            d = self._dev
            out = sharded_search_extract(
                ids,
                w,
                d.head,
                d.head_scales,
                d.valid,
                comm=self.comm,
                head_terms=layout.head_terms,
                k=top_k,
                narrow_m=self.narrow_m,
                head_backend=self.head_backend,
            )
            result = _PendingResult(out, self.comm.device)
            host_head, host_dtype, head_t, slack = self._host_merge
            cand_head = cand_head_scores_host(
                host_head,
                host_dtype,
                layout.head_scales,
                cand,
                enc.head_flat_ids,
                enc.head_flat_counts,
                enc.head_ptr,
                head_t=head_t,
            )
            tau_slack = merge_tau_slack(
                slack, enc.head_flat_ids, enc.head_flat_counts, enc.head_ptr
            )
            # The query tensors stay in the handle: a batch whose flag is
            # set re-runs the standard step from them.
            return cand, result, cand_head, tau_slack, (ids, w)
        result = _PendingResult(
            self._standard(ids, w, cand, top_k), self.comm.device
        )
        return cand, result, None, None, None

    def finish_batch(
        self, in_flight, top_k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Wait for the device result and run the exact host merge. An
        extraction batch whose flag is set (the same on every rank) runs
        the standard step first."""
        cand, result, cand_head, tau_slack, redo = in_flight
        arrays = result.wait()
        if redo is not None and arrays[2][0] != 0:
            self._redispatches += 1
            arrays = _PendingResult(
                self._standard(*redo, cand, top_k), self.comm.device
            ).wait()
            cand_head = None
        head_s, head_r = arrays[0], arrays[1]
        if cand_head is None:
            # Gathered from the same scores as head_s: zero slack is sound.
            cand_head = arrays[2]
            tau_slack = np.zeros(head_s.shape[0], dtype=np.float32)
        return merge_host(
            head_s,
            head_r,
            cand,
            cand_head,
            self.num_rows,
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

    # ------------------------------------------------------------------
    # Host path
    # ------------------------------------------------------------------

    def _result_dicts(self, scores, ids) -> List[Dict[str, float]]:
        n = len(self.index.doc_ids)
        mask = (scores > 0) & (ids >= 0) & (ids < n)
        return assemble_result_dicts(self._doc_names, ids, scores, mask)

    def search(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        """Reference-compatible search: {qid: {doc_id: score}}, scores > 0
        only, sorted descending; empty and all-OOV queries give {}. Same
        pipelining and query cache as the flat engine; every rank's cache
        sees the same queries, so every rank dispatches the same batches."""
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
        """Learned-sparse search over the sharded index: queries are
        {term: weight} mappings used verbatim. Same result contract as
        :meth:`search`."""
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


class ShardedDenseSearchEngine:
    """Document-sharded quantized (or f32) dense retrieval: each rank
    scores its row shard; the shards' top-k lists merge over ``d``.

    ``quantization``: 'symmetric' (int8), 'asymmetric', 'int4' or 'none',
    ``osr_tpu``'s four. ``backend``: 'auto' | 'cuda' | 'torch', as the flat
    :class:`DenseSearchEngine` takes it: per shard, ``retrieval/engine.py:
    dense_kernel_step`` (K7 on the queries, then K5 or K6, then the exact
    selection) on the card, the plain search functions with 'torch'.

    Rows pad to ``n_d`` shards of ``round_up(ceil(N / n_d), 128)`` rows
    (``osr_tpu`` pads to a multiple of ``n_d``, of ``128 n_d`` for its
    Pallas backend): shards start on 128-row blocks, so the merge can
    order exact ties as the flat selection does. Each rank uploads only
    its real rows of the f32 corpus and quantizes them on its device (K7
    on the card), so no rank holds the whole f32 matrix on its device.
    The padding rows score -inf: a zero-scale row would score 0 and could
    displace a document that scores below 0."""

    def __init__(
        self,
        doc_ids: Sequence[str],
        embeddings,  # (N, dim) float32: NumPy array or tensor
        mesh,
        quantization: str = "symmetric",
        backend: str = "auto",
        device=None,
    ):
        if quantization not in SHARDED_QUANTIZATIONS:
            raise ValueError(f"Unknown quantization: {quantization}")
        self.doc_ids = list(doc_ids)
        if embeddings.shape[0] != len(self.doc_ids):
            raise ValueError(
                f"{embeddings.shape[0]} embeddings for {len(self.doc_ids)} "
                "doc ids"
            )
        self.device = resolve_device(device)
        self.comm = MeshComm(mesh, self.device)
        self.quantization = quantization
        self.backend = _dense_backend(backend, quantization, self.device)
        n = len(self.doc_ids)
        # Shards start on 128-row blocks, so their blocks are the flat
        # selection's (its tie order reads them).
        self.rows_local = round_up(-(-n // self.comm.n_d), head_ops.ROW_TILE)
        self.n_rows = self.comm.n_d * self.rows_local
        self.block_select = n >= qz.BLOCK_SELECT_MIN_COLS
        lo = self.comm.d * self.rows_local
        hi = min(lo + self.rows_local, n)
        self.row_lo = lo
        self.n_real = max(0, hi - lo)
        # The shard's rows as a flat engine on this rank's device: it
        # uploads and quantizes only them and owns the per-shard step.
        self._local = (
            DenseSearchEngine(
                self.doc_ids[lo:hi],
                embeddings[lo:hi],
                quantization=quantization,
                device=self.device,
                backend=self.backend,
            )
            if self.n_real
            else None
        )
        self.dim = int(embeddings.shape[1])

    def _shard_topk(self, q: torch.Tensor, k: int):
        """(B_local, min(k, rows_local)) scores, int32 shard rows and each
        entry's block maximum (None without block selection): the real
        rows' exact top-k in the flat engine's order (block-pruned where
        the flat selection is, ``ops/quantize.py:_select_topk``), then the
        padding rows at -inf."""
        kk = min(k, self.rows_local)
        b = q.shape[0]
        loc = self._local
        if loc is not None:
            sims = loc._scores(q, loc._docs, loc._scales, loc._mins)
            if self.block_select:
                bmax = block_max(sims)
                s, r = block_topk_from_max(sims, bmax, k=kk)
                key = _rows_block_max(bmax, r)
            else:
                s, r = topk(sims, k=kk)
                key = None
        else:
            s = torch.empty((b, 0), dtype=torch.float32, device=q.device)
            r = torch.empty((b, 0), dtype=torch.int32, device=q.device)
            key = s if self.block_select else None
        pad = kk - s.shape[1]
        if pad:
            neg = torch.full((b, pad), float("-inf"), device=q.device)
            s = torch.cat([s, neg], 1)
            fill = torch.arange(
                self.n_real, self.n_real + pad, dtype=torch.int32,
                device=q.device,
            )
            r = torch.cat([r, fill.expand(b, pad)], 1)
            if key is not None:
                key = torch.cat([key, neg], 1)
        return s, r, key

    def search_vectors(
        self, query_vectors, top_k: int = 10
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (B, k), doc rows (B, k)) for (B, dim) f32 query vectors;
        every rank passes the same vectors and gets the same arrays. The
        batch pads to a multiple of the mesh's ``q`` size (the zero rows'
        results are dropped), and k is clamped to the real document
        count."""
        if not isinstance(query_vectors, torch.Tensor):
            query_vectors = np.asarray(query_vectors, dtype=np.float32)
        nq = query_vectors.shape[0]
        n_q = self.comm.n_q
        b_local = -(-nq // n_q)
        lo = self.comm.q * b_local
        q = _upload(query_vectors[lo : lo + b_local], self.device).float()
        if q.shape[0] < b_local:
            q = torch.nn.functional.pad(q, (0, 0, 0, b_local - q.shape[0]))
        if q.dim() != 2 or q.shape[1] != self.dim:
            raise ValueError(
                f"queries must be (B, {self.dim}), got {tuple(q.shape)}"
            )
        k = min(top_k, len(self.doc_ids))
        s, r, key = self._shard_topk(q, k)
        s, ids = merge_shards(self.comm, s, r, self.row_lo, k, key)
        out = _PendingResult(
            (self.comm.gather_q(s), self.comm.gather_q(ids)), self.comm.device
        ).wait()
        return out[0][:nq], out[1][:nq]


class ShardedHybridEngine:
    """Sharded late fusion, the multi-rank form of the flat
    ``HybridRetriever``: both sharded engines score the same document
    sharding; the sparse batch is dispatched first, then the dense step
    runs, and fusion (``retrieval/fusion.py``) runs on their (scores, ids)
    arrays on the host. The default query embedding is
    ``index/dense.py:synthetic_query_embeddings``."""

    def __init__(
        self,
        index: SparseIndex,
        embeddings,
        mesh,
        sparse_weight: float = 0.3,
        dense_weight: float = 0.7,
        fusion_depth: int = 100,
        fusion: str = "weighted",
        rrf_k: float = 60.0,
        query_embedding_fn=None,
        batch_sizes: Sequence[int] = DEFAULT_BATCH_SIZES,
        quantization: str = "symmetric",
        head_backend: str = "auto",
        dense_backend: str = "auto",
        device=None,
    ):
        if fusion not in ("weighted", "rrf"):
            raise ValueError(f"unknown fusion mode: {fusion!r}")
        self.sparse_weight = sparse_weight
        self.dense_weight = dense_weight
        self.fusion_depth = fusion_depth
        self.fusion = fusion
        self.rrf_k = rrf_k
        self.sparse = ShardedSparseSearchEngine(
            index,
            mesh,
            batch_sizes=batch_sizes,
            head_backend=head_backend,
            cache_queries=False,
            device=device,
        )
        self.dense = ShardedDenseSearchEngine(
            index.doc_ids,
            embeddings,
            mesh,
            quantization=quantization,
            backend=dense_backend,
            device=device,
        )
        dim = embeddings.shape[1]
        if query_embedding_fn is not None:
            self._embed_batch = lambda texts: np.stack(
                [
                    np.asarray(query_embedding_fn(t), dtype=np.float32)
                    for t in texts
                ]
            )
        else:
            from osr_tpu_torch.index.dense import synthetic_query_embeddings

            self._embed_batch = lambda texts: synthetic_query_embeddings(
                texts, dim
            )

    def search(
        self, queries: Mapping[str, str], top_k: int = 10
    ) -> Dict[str, Dict[str, float]]:
        from osr_tpu_torch.retrieval.fusion import (
            fuse_topk_arrays,
            fused_rows_to_results,
        )

        sp = self.sparse
        results: Dict[str, Dict[str, float]] = {}
        pending: List[Tuple[str, str]] = []
        for qid, text in queries.items():
            text = (text or "").strip()
            if text:
                pending.append((qid, text))
            else:
                results[qid] = {}
        depth = self.fusion_depth
        max_b = sp.batch_sizes[-1]
        for i in range(0, len(pending), max_b):
            chunk = pending[i : i + max_b]
            texts = [t for _, t in chunk]
            enc = sp.encode_queries(texts)
            s_handle = sp.search_encoded_device(enc, depth)
            d_scores, d_ids = self.dense.search_vectors(
                self._embed_batch(texts), top_k=depth
            )
            s_scores, s_ids = sp.finish_batch(s_handle, depth)
            n = len(chunk)  # sparse rows are padded to the batch bucket
            f_sc, f_ids = fuse_topk_arrays(
                s_scores[:n],
                s_ids[:n],
                d_scores,
                d_ids,
                self.sparse_weight,
                self.dense_weight,
                top_k,
                mode=self.fusion,
                rrf_k=self.rrf_k,
            )
            results.update(
                fused_rows_to_results(
                    [q for q, _ in chunk], f_sc, f_ids, sp._doc_names
                )
            )
        return results
