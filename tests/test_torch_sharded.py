"""The port's sharded engines (osr_tpu_torch/parallel/) on torch.distributed
worlds, against osr_tpu's sharded engines and the port's flat engines.

Every case of tests/test_sharded.py is mirrored with its parameters. The
port's engines run in spawned worlds of 4 and 2 processes on the CPU
(gloo), on meshes (1, 4), (2, 2) and (1, 2); each world lives for the
module, runs one case at a time, and is respawned after a case fails.
Every process group has a 60 s timeout, and the parent waits for a case
at most 180 s, then kills the world and raises, so no case can hang the
suite; a rank's traceback is re-raised in the parent.

Each case holds the port's sharded engine against two references, both
computed in the parent process:

- osr_tpu's sharded engine on the same mesh shape (``make_mesh(n,
  query_parallel=...)`` over the first n of the 8 virtual CPU devices of
  tests/conftest.py), with the index carried across by
  ``convert.index_from_arrays``. Tolerance as in tests/test_torch_engine.py:
  the same ids in the same order, except at positions whose score is
  within 1e-5 relative of a neighbour's, and scores within rtol 1e-5;
- the port's flat engine on the same index: sparse results equal dict for
  dict; dense ids equal and scores within rtol 1e-5. The sharded standard
  step takes its candidates' head scores from the device scores, as the
  flat engine's ``merge_backend='device'`` does, so that is the flat
  engine it is held to; the extraction plan takes them from the host, as
  the flat engine's default host merge does.

``head_backend='torch'`` (the plain head product and K4's plain twin)
stands in for both of osr_tpu's head backends on the CPU. The cases
marked ``cuda`` run on a card: a world of one under NCCL against the flat
engines, and two ranks on one card under gloo, each launching K2 on its
shard.

JAX, osr_tpu and tests.reference_impl are imported inside the tests and
fixtures only: the spawned ranks import this module and must load none of
them.
"""

import multiprocessing as mp
import pickle
import queue
import traceback
from datetime import timedelta

import numpy as np
import pytest
import torch

GROUP_TIMEOUT_S = 60  # every process group's collective timeout
CASE_TIMEOUT_S = 180  # the parent's wait for one case on every rank
RTOL = 1e-5


# ----------------------------------------------------------------------
# The spawned worlds
# ----------------------------------------------------------------------


def _rank_main(rank, size, init_file, tasks, results):
    """One rank of a world: join the gloo group, then run the cases the
    parent sends until it sends None."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo",
        init_method=f"file://{init_file}",
        rank=rank,
        world_size=size,
        timeout=timedelta(seconds=GROUP_TIMEOUT_S),
    )
    try:
        while True:
            task = tasks.get()
            if task is None:
                break
            fn, kwargs = task
            try:
                results.put((rank, True, fn(**kwargs)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class World:
    """``size`` spawned ranks in one gloo process group."""

    def __init__(self, size, directory, name):
        ctx = mp.get_context("spawn")
        self.size = size
        self.tasks = [ctx.Queue() for _ in range(size)]
        self.results = ctx.Queue()
        init_file = directory / f"{name}.pg"
        self.procs = [
            ctx.Process(
                target=_rank_main,
                args=(r, size, str(init_file), self.tasks[r], self.results),
                daemon=True,
            )
            for r in range(size)
        ]
        for p in self.procs:
            p.start()
        self.alive = True

    def run(self, fn, **kwargs):
        """Run ``fn(**kwargs)`` on every rank; returns the ranks' results
        in rank order. A rank's exception or the timeout kills the world
        and raises here."""
        for q in self.tasks:
            q.put((fn, kwargs))
        got = {}
        while len(got) < self.size:
            try:
                rank, ok, payload = self.results.get(timeout=CASE_TIMEOUT_S)
            except queue.Empty:
                self.close(kill=True)
                missing = sorted(set(range(self.size)) - set(got))
                raise TimeoutError(
                    f"{fn.__name__}: ranks {missing} did not answer in "
                    f"{CASE_TIMEOUT_S} s"
                ) from None
            if not ok:
                self.close(kill=True)
                raise AssertionError(
                    f"{fn.__name__} failed on rank {rank}:\n{payload}"
                )
            got[rank] = payload
        return [got[r] for r in range(self.size)]

    def close(self, kill=False):
        if not kill:
            for q in self.tasks:
                q.put(None)
            for p in self.procs:
                p.join(timeout=30)
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        self.alive = False


class Worlds:
    """The module's worlds by size, respawned after a failed case."""

    def __init__(self, directory):
        self.directory = directory
        self.worlds = {}
        self.spawned = 0

    def run(self, size, fn, **kwargs):
        w = self.worlds.get(size)
        if w is None or not w.alive:
            self.spawned += 1
            w = self.worlds[size] = World(
                size, self.directory, f"world{size}_{self.spawned}"
            )
        return w.run(fn, **kwargs)

    def close(self):
        for w in self.worlds.values():
            if w.alive:
                w.close()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    w = Worlds(tmp_path_factory.mktemp("worlds"))
    yield w
    w.close()


def _same_on_every_rank(outs):
    for other in outs[1:]:
        assert _equal(other, outs[0])
    return outs[0]


def _equal(a, b):
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and np.array_equal(a, b)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


# ----------------------------------------------------------------------
# Indexes across processes
# ----------------------------------------------------------------------


def _index_kwargs(index):
    lay = index.layout
    return dict(
        head=lay.head, head_scales=lay.head_scales, post_ptr=lay.post_ptr,
        post_rows=lay.post_rows, post_weights=lay.post_weights,
        valid=lay.valid, num_docs=lay.num_docs, vocab_size=lay.vocab_size,
        head_terms=lay.head_terms, head_dtype=lay.head_dtype,
        vocabulary=dict(index.vocabulary), doc_ids=list(index.doc_ids),
        method=index.method, idf=index.idf, doc_lengths=index.doc_lengths,
        avgdl=index.avgdl, k1=index.k1, b=index.b,
    )


def _port_index(path):
    from osr_tpu_torch.convert import index_from_arrays

    with open(path, "rb") as f:
        return index_from_arrays(**pickle.load(f))


class Carried:
    """An osr_tpu index, the port's copy of it, and a file the ranks load
    the copy from."""

    def __init__(self, jax_index, directory, name):
        self.jax = jax_index
        self.path = str(directory / f"{name}.pkl")
        with open(self.path, "wb") as f:
            pickle.dump(_index_kwargs(jax_index), f)
        self.port = _port_index(self.path)


# ----------------------------------------------------------------------
# What the ranks run
# ----------------------------------------------------------------------


def _mesh(query_parallel, device_type="cpu"):
    import torch.distributed as dist

    from osr_tpu_torch.parallel import make_mesh

    return make_mesh(
        dist.get_world_size(), query_parallel=query_parallel,
        device_type=device_type,
    )


def rank_layout(query_parallel):
    import torch.distributed as dist

    mesh = _mesh(query_parallel)
    coord = tuple(int(c) for c in mesh.get_coordinate())
    return (
        dist.get_rank(), dist.get_world_size(), tuple(mesh.shape), coord,
        dist.get_backend(),
        dist.get_process_group_ranks(mesh.get_group("d")),
        dist.get_process_group_ranks(mesh.get_group("q")),
    )


def rank_sparse(index_path, queries, top_k, query_parallel, engine=None,
                call="search", twice=False):
    from osr_tpu_torch.parallel import ShardedSparseSearchEngine

    eng = ShardedSparseSearchEngine(
        _port_index(index_path), _mesh(query_parallel), device="cpu",
        **(engine or {}),
    )
    first = getattr(eng, call)(queries, top_k=top_k)
    if not twice:
        return first
    cached = len(eng._query_cache)
    return first, cached, eng.search(queries, top_k=top_k)


def rank_extract(index_path, queries, top_k, query_parallel, unsafe):
    """The extraction plan beside the standard one; ``unsafe`` patches the
    extraction step to raise its tie-safety flag on every batch."""
    import osr_tpu_torch.parallel.sharded as sh

    calls = {"n": 0}
    real = sh.sharded_search_extract

    def always_unsafe(*args, **kwargs):
        calls["n"] += 1
        tops, tids, flag = real(*args, **kwargs)
        return tops, tids, torch.ones_like(flag)

    index = _port_index(index_path)
    mesh = _mesh(query_parallel)
    common = dict(batch_sizes=(len(queries),), cache_queries=False,
                  device="cpu")
    ex = sh.ShardedSparseSearchEngine(
        index, mesh, head_backend="torch", narrow_m=8,
        narrow_backend="extract", **common,
    )
    std = sh.ShardedSparseSearchEngine(index, mesh, **common)
    if unsafe:
        sh.sharded_search_extract = always_unsafe
    try:
        r_ex = ex.search(queries, top_k=top_k)
    finally:
        sh.sharded_search_extract = real
    return (
        ex._use_extract(top_k), ex.rows_local, r_ex,
        std.search(queries, top_k=top_k), calls["n"], ex._redispatches,
    )


def rank_dense(emb, queries, top_k, query_parallel, quantization):
    from osr_tpu_torch.parallel import ShardedDenseSearchEngine

    eng = ShardedDenseSearchEngine(
        [f"d{i}" for i in range(len(emb))], emb, _mesh(query_parallel),
        quantization=quantization, backend="torch", device="cpu",
    )
    return eng.search_vectors(queries, top_k=top_k)


def rank_hybrid(index_path, emb, queries, top_k, query_parallel, fusion):
    from osr_tpu_torch.parallel import ShardedHybridEngine

    eng = ShardedHybridEngine(
        _port_index(index_path), emb, _mesh(query_parallel),
        sparse_weight=0.3, dense_weight=0.7, fusion_depth=25, fusion=fusion,
        device="cpu",
    )
    return eng.search(queries, top_k=top_k)


def rank_make_mesh_refuses(n_devices):
    from osr_tpu_torch.parallel import make_mesh

    try:
        make_mesh(n_devices, device_type="cpu")
    except ValueError as e:
        return str(e)
    return None


# ----------------------------------------------------------------------
# References and tolerances
# ----------------------------------------------------------------------


def _jax_mesh(n, query_parallel=None):
    from osr_tpu.parallel.mesh import make_mesh

    return make_mesh(n, query_parallel=query_parallel)


def assert_close_results(got, want):
    """Same doc ids in the same order, except at near-ties (1e-5
    relative of a neighbour), and scores within rtol 1e-5."""
    assert got.keys() == want.keys()
    for qid, w in want.items():
        g = got[qid]
        assert len(g) == len(w), qid
        g_ids, g_s = list(g), np.array(list(g.values()))
        w_ids, w_s = list(w), np.array(list(w.values()))
        np.testing.assert_allclose(g_s, w_s, rtol=RTOL)
        _assert_order(g_ids, w_ids, w_s, qid)


def _assert_order(g_ids, w_ids, w_s, where):
    for i, (a, b) in enumerate(zip(g_ids, w_ids)):
        if a == b:
            continue
        near = [j for j in (i - 1, i + 1) if 0 <= j < len(w_s)]
        tied = any(
            abs(w_s[i] - w_s[j]) <= RTOL * abs(w_s[i]) for j in near
        ) or i == len(w_s) - 1
        assert tied, (where, i, a, b, w_s[max(0, i - 1) : i + 2])


def assert_close_arrays(got, want):
    """Dense (scores, ids): ids row by row as assert_close_results holds
    them, scores within rtol 1e-5."""
    (gs, gi), (ws, wi) = got, want
    assert gs.shape == ws.shape and gi.shape == wi.shape
    np.testing.assert_allclose(gs, ws, rtol=RTOL, atol=1e-6)
    for row in range(wi.shape[0]):
        _assert_order(gi[row].tolist(), wi[row].tolist(), ws[row], row)


def _flat(index, device="cpu", **kw):
    """The flat engine whose merge reads the same candidate scores as the
    sharded standard step (the device's)."""
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    return SparseSearchEngine(index, device=device, merge_backend="device",
                              **kw)


def _jax_sharded(index, n, query_parallel=None, **kw):
    from osr_tpu.parallel.sharded import ShardedSparseSearchEngine

    return ShardedSparseSearchEngine(
        index, _jax_mesh(n, query_parallel), **kw
    )


# ----------------------------------------------------------------------
# Fixtures (osr_tpu's test_sharded.py shapes)
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    from tests.reference_impl import zipf_corpus

    return zipf_corpus(num_docs=250, vocab_size=600, avg_len=50)


@pytest.fixture(scope="module")
def queries():
    from tests.reference_impl import zipf_queries

    return zipf_queries(num_queries=12, vocab_size=600, terms_per_query=5)


@pytest.fixture(scope="module")
def carry(tmp_path_factory):
    directory = tmp_path_factory.mktemp("indexes")
    made = {}

    def get(name, build):
        if name not in made:
            made[name] = Carried(build(), directory, name)
        return made[name]

    return get


@pytest.fixture(scope="module")
def small(corpus, carry):
    from osr_tpu.index.builder import SparseIndexBuilder

    return carry("small", lambda: SparseIndexBuilder(method="bm25").build(corpus))


@pytest.fixture(scope="module")
def big_corpus():
    from tests.reference_impl import zipf_corpus

    return zipf_corpus(num_docs=12_000, vocab_size=6_000, avg_len=40)


@pytest.fixture(scope="module")
def big(big_corpus, carry):
    from osr_tpu.index.builder import SparseIndexBuilder

    return carry("big", lambda: SparseIndexBuilder(method="bm25").build(big_corpus))


@pytest.fixture(scope="module")
def big_queries():
    from tests.reference_impl import zipf_queries

    return zipf_queries(num_queries=32, vocab_size=6_000, terms_per_query=7)


@pytest.fixture(scope="module")
def wide(carry):
    """The extraction cases' 20,000-document index."""
    from osr_tpu.index.builder import SparseIndexBuilder
    from tests.reference_impl import zipf_corpus

    return carry(
        "wide",
        lambda: SparseIndexBuilder(method="bm25").build(
            zipf_corpus(num_docs=20_000, vocab_size=20_000, avg_len=60)
        ),
    )


# ----------------------------------------------------------------------
# Mirrors of tests/test_sharded.py
# ----------------------------------------------------------------------


def test_four_ranks_lay_out_the_mesh_row_major(worlds):
    """The counterpart of the eight virtual devices: a world of 4 gloo
    ranks, rank r at (r // n_d, r % n_d), groups listing ranks in mesh
    order."""
    for qp, shape in ((None, (1, 4)), (2, (2, 2))):
        outs = worlds.run(4, rank_layout, query_parallel=qp)
        for r, out in enumerate(outs):
            rank, size, mshape, coord, backend, d_ranks, q_ranks = out
            n_d = shape[1]
            assert (rank, size, mshape, backend) == (r, 4, shape, "gloo")
            assert coord == (r // n_d, r % n_d)
            assert d_ranks == [coord[0] * n_d + j for j in range(n_d)]
            assert q_ranks == [i * n_d + coord[1] for i in range(shape[0])]


@pytest.mark.parametrize("query_parallel", [1, 2])
def test_sharded_sparse_matches_single_device(
    worlds, small, queries, query_parallel
):
    got = _same_on_every_rank(
        worlds.run(4, rank_sparse, index_path=small.path, queries=queries,
                   top_k=10, query_parallel=query_parallel)
    )
    assert got == _flat(small.port).search(queries, top_k=10)
    want = _jax_sharded(small.jax, 4, query_parallel).search(queries, top_k=10)
    assert_close_results(got, want)


def test_sharded_dense_matches_single_device(worlds, corpus):
    from osr_tpu.index.dense import synthetic_corpus_embeddings
    from osr_tpu.parallel.sharded import ShardedDenseSearchEngine as JaxDense
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine

    doc_ids = list(corpus.keys())
    emb = synthetic_corpus_embeddings(len(doc_ids), dim=64, seed=5)
    qv = synthetic_corpus_embeddings(16, dim=64, seed=9)
    got = _same_on_every_rank(
        worlds.run(4, rank_dense, emb=emb, queries=qv, top_k=10,
                   query_parallel=None, quantization="symmetric")
    )
    flat = DenseSearchEngine(doc_ids, emb, quantization="symmetric",
                             device="cpu")
    s1, i1 = flat.search_vectors(qv, top_k=10)
    np.testing.assert_array_equal(got[1], i1)
    np.testing.assert_allclose(got[0], s1, rtol=RTOL)
    assert_close_arrays(
        got, JaxDense(doc_ids, emb, _jax_mesh(4)).search_vectors(qv, top_k=10)
    )


def test_sharded_handles_row_padding(worlds, queries, carry):
    """131 docs over 4 shards of 128 rows: padding rows never surface."""
    from osr_tpu.index.builder import SparseIndexBuilder
    from tests.reference_impl import zipf_corpus

    c = carry(
        "padded",
        lambda: SparseIndexBuilder(method="tfidf").build(
            zipf_corpus(num_docs=131, vocab_size=400, avg_len=30)
        ),
    )
    got = _same_on_every_rank(
        worlds.run(4, rank_sparse, index_path=c.path, queries=queries,
                   top_k=7, query_parallel=None)
    )
    assert got == _flat(c.port).search(queries, top_k=7)
    assert_close_results(got, _jax_sharded(c.jax, 4).search(queries, top_k=7))


@pytest.mark.parametrize(
    "head_backend,query_parallel",
    [("xla", 1), ("xla", 2), ("pallas", 2)],
)
def test_sharded_options_match_single_device_at_scale(
    worlds, big, big_queries, head_backend, query_parallel
):
    """12k docs, int8 head: the port's plain head step per shard
    (head_backend='torch') against osr_tpu's sharded engine on each of its
    backends (Pallas interpreted) and the port's flat engine."""
    got = _same_on_every_rank(
        worlds.run(4, rank_sparse, index_path=big.path, queries=big_queries,
                   top_k=20, query_parallel=query_parallel,
                   engine=dict(head_backend="torch", cache_queries=False))
    )
    flat = _flat(big.port, head_backend="torch", cache_queries=False)
    assert got == flat.search(big_queries, top_k=20)
    want = _jax_sharded(
        big.jax, 4, query_parallel, head_backend=head_backend,
        cache_queries=False, pallas_interpret=head_backend == "pallas",
    ).search(big_queries, top_k=20)
    assert_close_results(got, want)


def test_sharded_approx_mode_recall(worlds, big, big_queries):
    """topk_mode='approx' is served exactly: recall@20 >= 0.9 against the
    exact sharded results (it is 1.0), equal to the flat approx engine."""
    exact, approx = (
        _same_on_every_rank(
            worlds.run(4, rank_sparse, index_path=big.path,
                       queries=big_queries, top_k=20, query_parallel=None,
                       engine=dict(topk_mode=mode, cache_queries=False))
        )
        for mode in ("exact", "approx")
    )
    overlaps = [
        len(set(exact[q]) & set(approx[q])) / len(exact[q])
        for q in exact if exact[q]
    ]
    assert np.mean(overlaps) >= 0.9, np.mean(overlaps)
    flat = _flat(big.port, topk_mode="approx", cache_queries=False)
    assert approx == flat.search(big_queries, top_k=20)
    want = _jax_sharded(
        big.jax, 4, topk_mode="approx", cache_queries=False
    ).search(big_queries, top_k=20)
    assert_close_results(approx, want)


def test_sharded_search_weighted_matches_single(worlds, big):
    terms = list(big.jax.vocabulary)[:2000]
    rng = np.random.RandomState(7)
    weighted = {}
    for qi in range(12):
        picks = rng.choice(len(terms), size=6, replace=False)
        weighted[f"w{qi}"] = {
            terms[p]: float(rng.rand() * 2 + 0.1) for p in picks
        }
    weighted["empty"] = {}
    got = _same_on_every_rank(
        worlds.run(4, rank_sparse, index_path=big.path, queries=weighted,
                   top_k=15, query_parallel=None,
                   engine=dict(cache_queries=False), call="search_weighted")
    )
    assert got["empty"] == {}
    flat = _flat(big.port, cache_queries=False)
    assert got == flat.search_weighted(weighted, top_k=15)
    want = _jax_sharded(big.jax, 4, cache_queries=False).search_weighted(
        weighted, top_k=15
    )
    assert_close_results(got, want)


def test_sharded_query_cache(worlds, big, big_queries):
    first, cached, again = _same_on_every_rank(
        worlds.run(4, rank_sparse, index_path=big.path, queries=big_queries,
                   top_k=10, query_parallel=None,
                   engine=dict(cache_queries=True), twice=True)
    )
    assert cached > 0
    assert first == again
    assert first == _flat(big.port).search(big_queries, top_k=10)
    assert_close_results(
        first, _jax_sharded(big.jax, 4).search(big_queries, top_k=10)
    )


@pytest.mark.parametrize(
    "quantization,backend",
    [("symmetric", "xla"), ("symmetric", "pallas"), ("asymmetric", "xla"),
     ("int4", "xla"), ("int4", "pallas"), ("none", "xla")],
)
def test_sharded_dense_options_match_single_device(
    worlds, quantization, backend
):
    """517 docs (not a multiple of the shards). The port runs its plain
    search per shard ('torch'); osr_tpu's xla cases run on mesh (1, 4)
    against the port's world of 4, its Pallas cases (interpreted) on mesh
    (1, 2) against the port's world of 2."""
    from osr_tpu.index.dense import synthetic_corpus_embeddings
    from osr_tpu.parallel.sharded import ShardedDenseSearchEngine as JaxDense
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine

    n = 4 if backend == "xla" else 2
    doc_ids = [f"d{i}" for i in range(517)]
    dim = 256 if (quantization, backend) == ("int4", "pallas") else 64
    emb = synthetic_corpus_embeddings(len(doc_ids), dim=dim, seed=5)
    qv = synthetic_corpus_embeddings(16, dim=dim, seed=9)
    got = _same_on_every_rank(
        worlds.run(n, rank_dense, emb=emb, queries=qv, top_k=10,
                   query_parallel=None, quantization=quantization)
    )
    flat = DenseSearchEngine(doc_ids, emb, quantization=quantization,
                             device="cpu", backend="torch")
    s1, i1 = flat.search_vectors(qv, top_k=10)
    np.testing.assert_array_equal(got[1], i1)
    np.testing.assert_allclose(got[0], s1, rtol=RTOL, atol=1e-6)
    want = JaxDense(
        doc_ids, emb, _jax_mesh(n), quantization=quantization,
        backend=backend, pallas_interpret=backend == "pallas",
    ).search_vectors(qv, top_k=10)
    assert_close_arrays(got, want)


def test_sharded_int4_matches_single_device(worlds, big_corpus, big_queries,
                                            carry):
    from osr_tpu.index.builder import SparseIndexBuilder

    c = carry(
        "big_int4",
        lambda: SparseIndexBuilder(method="bm25", head_dtype="int4").build(
            big_corpus
        ),
    )
    got = _same_on_every_rank(
        worlds.run(4, rank_sparse, index_path=c.path, queries=big_queries,
                   top_k=15, query_parallel=2,
                   engine=dict(head_backend="torch", cache_queries=False))
    )
    flat = _flat(c.port, head_backend="torch", cache_queries=False)
    assert got == flat.search(big_queries, top_k=15)
    want = _jax_sharded(
        c.jax, 4, 2, head_backend="pallas", cache_queries=False,
        pallas_interpret=True,
    ).search(big_queries, top_k=15)
    assert_close_results(got, want)


@pytest.mark.parametrize("fusion", ["weighted", "rrf"])
def test_sharded_hybrid_matches_flat_hybrid(worlds, corpus, queries, fusion,
                                            tmp_path):
    """The port's sharded hybrid over the port's flat hybrid's own index
    and embeddings equals that hybrid dict for dict; against osr_tpu's
    sharded hybrid over osr_tpu's flat hybrid, the tolerance holds."""
    from osr_tpu.index.dense import synthetic_corpus_embeddings
    from osr_tpu.parallel.sharded import ShardedHybridEngine as JaxHybrid
    from osr_tpu.retrieval.registry import RetrieverRegistry as JaxRegistry
    from osr_tpu_torch.retrieval.registry import RetrieverRegistry

    params = {
        "sparse_weight": 0.3, "dense_weight": 0.7, "embedding_dim": 64,
        "fusion_depth": 25, "fusion": fusion, "cache_dir": None,
    }
    flat = RetrieverRegistry.create(
        {"type": "hybrid", "params": {**params, "device": "cpu"}}
    )
    flat.build_index_from_corpus(corpus)
    path = tmp_path / "hybrid.pkl"
    with open(path, "wb") as f:
        pickle.dump(_index_kwargs(flat.sparse.engine.index), f)
    emb = synthetic_corpus_embeddings(len(corpus), dim=64)
    got = _same_on_every_rank(
        worlds.run(4, rank_hybrid, index_path=str(path), emb=emb,
                   queries=queries, top_k=50, query_parallel=2, fusion=fusion)
    )
    assert got == flat.search(queries, top_k=50)
    jflat = JaxRegistry.create({"type": "hybrid", "params": params})
    jflat.build_index_from_corpus(corpus)
    want = JaxHybrid(
        jflat.sparse.engine.index, emb, _jax_mesh(4, 2), sparse_weight=0.3,
        dense_weight=0.7, fusion_depth=25, fusion=fusion,
    ).search(queries, top_k=50)
    assert_close_results(got, want)


def test_sharded_extract_matches_standard_and_flat(worlds, wide):
    """Extraction per shard (K4's plain twin) over 20,000 docs on mesh
    (2, 2): 2 shards of 10,112 rows, past the block-pruning floor. Equal
    to the standard sharded engine and the flat engine dict for dict."""
    from tests.reference_impl import zipf_queries

    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    queries = zipf_queries(num_queries=8, vocab_size=20_000, terms_per_query=6)
    uses, rows, r_ex, r_std, calls, redo = _same_on_every_rank(
        worlds.run(4, rank_extract, index_path=wide.path, queries=queries,
                   top_k=10, query_parallel=2, unsafe=False)
    )
    assert uses and rows >= 4096 and calls == 0 and redo == 0
    assert r_ex == r_std
    flat = _flat(wide.port, batch_sizes=(8,), cache_queries=False)
    assert r_std == flat.search(queries, top_k=10)
    flat_ex = SparseSearchEngine(
        wide.port, device="cpu", batch_sizes=(8,), cache_queries=False,
        narrow_m=8, narrow_backend="extract",
    )
    assert r_ex == flat_ex.search(queries, top_k=10)
    want = _jax_sharded(
        wide.jax, 4, 2, batch_sizes=(8,), cache_queries=False
    ).search(queries, top_k=10)
    assert_close_results(r_ex, want)


def test_sharded_extract_unsafe_flag_falls_back(worlds, wide):
    """A raised tie-safety flag (patched in every rank) runs the standard
    sharded step: results equal the standard engine's."""
    from tests.reference_impl import zipf_queries

    queries = zipf_queries(num_queries=4, vocab_size=20_000, terms_per_query=6)
    uses, _, r_ex, r_std, calls, redo = _same_on_every_rank(
        worlds.run(4, rank_extract, index_path=wide.path, queries=queries,
                   top_k=10, query_parallel=2, unsafe=True)
    )
    assert uses and calls > 0, "the extraction step never ran"
    assert redo == calls
    assert r_ex == r_std
    flat = _flat(wide.port, batch_sizes=(4,), cache_queries=False)
    assert r_ex == flat.search(queries, top_k=10)
    want = _jax_sharded(
        wide.jax, 4, 2, batch_sizes=(4,), cache_queries=False
    ).search(queries, top_k=10)
    assert_close_results(r_ex, want)


# ----------------------------------------------------------------------
# The mesh and the hint
# ----------------------------------------------------------------------


@pytest.mark.parametrize(
    "n,query_parallel",
    [(1, None), (4, None), (8, None), (4, 1), (4, 2), (8, 4), (6, 3),
     (4, 3), (8, 3)],
)
def test_pick_mesh_shape_matches_osr_tpu(n, query_parallel):
    from osr_tpu.parallel.mesh import pick_mesh_shape as jax_pick
    from osr_tpu_torch.parallel import pick_mesh_shape

    try:
        want = jax_pick(n, query_parallel)
    except ValueError as e:
        with pytest.raises(ValueError, match="must divide"):
            pick_mesh_shape(n, query_parallel)
        assert "must divide" in str(e)
    else:
        assert pick_mesh_shape(n, query_parallel) == want


def test_make_mesh_refuses_a_world_size_mismatch(worlds):
    outs = worlds.run(2, rank_make_mesh_refuses, n_devices=4)
    assert all("2 ranks" in o for o in outs), outs


def test_make_mesh_needs_a_process_group():
    import torch.distributed as dist

    from osr_tpu_torch.parallel import make_mesh

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="init_process_group"):
        make_mesh(1, device_type="cpu")


@pytest.mark.parametrize("cards", [1, 2, 8])
def test_recommendations_name_the_sharded_engine(cards):
    """Several CUDA cards: the hints name the sharded engine, as osr_tpu's
    name its own for several TPU chips."""
    from osr_tpu_torch.utils.hardware import get_optimization_recommendations

    recs = get_optimization_recommendations(
        {"platform": "gpu", "num_devices": cards, "device_kind": "H100",
         "memory_gb": 64}
    )
    if cards > 1:
        assert "osr_tpu_torch.parallel.ShardedSparseSearchEngine" in (
            recs["sharding"]
        )
        assert f"{cards} CUDA cards" in recs["sharding"]
    else:
        assert "sharding" not in recs


# ----------------------------------------------------------------------
# On the card
# ----------------------------------------------------------------------


def _card_index(num_docs, head_dtype="int8"):
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.testing import SyntheticDataGenerator

    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        num_docs, 20_000, avg_len=60, word_prefix="t", min_len=5
    )
    return SparseIndexBuilder(head_dtype=head_dtype).build(corpus)


def _card_queries(n=96):
    from osr_tpu_torch.testing import SyntheticDataGenerator

    return SyntheticDataGenerator(seed=6).queries(
        n, 20_000, avg_terms=9, word_prefix="t", min_terms=2
    )


@pytest.fixture
def nccl_world_of_one(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from osr_tpu_torch.parallel import make_mesh

    dist.init_process_group(
        "nccl", init_method=f"file://{tmp_path}/pg", rank=0, world_size=1,
        timeout=timedelta(seconds=GROUP_TIMEOUT_S),
    )
    try:
        yield make_mesh(1)
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_world_of_one_on_the_card_matches_the_flat_engines(nccl_world_of_one):
    """Mesh (1, 1) under NCCL: K2 (top_k 10), K1 (top_k 200, below the
    block-pruning floor), K3 (int4), K4-i8 and K4-i4 (extraction), K7 +
    K5 and K7 + K6 (dense), each equal to the flat engine on the card (the
    standard plans to its device merge, extraction to its host merge)."""
    from osr_tpu_torch.index.dense import synthetic_corpus_embeddings
    from osr_tpu_torch.ops import head, matmul
    from osr_tpu_torch.parallel import (
        ShardedDenseSearchEngine,
        ShardedSparseSearchEngine,
    )
    from osr_tpu_torch.retrieval.engine import (
        DenseSearchEngine,
        SparseSearchEngine,
    )

    mesh = nccl_world_of_one
    queries = _card_queries()
    cases = [
        ("int8", 10, {}, "head_blockmax_i8"),
        ("int8", 200, {}, "head_scores_i8"),
        ("int4", 10, {}, "head_blockmax_i4"),
        ("int8", 10, dict(narrow_m=8, narrow_backend="extract"),
         "head_blocktopm_i8"),
        ("int4", 10, dict(narrow_m=8, narrow_backend="extract"),
         "head_blocktopm_i4"),
    ]
    indexes = {d: _card_index(20_000, d) for d in ("int8", "int4")}
    for dtype, k, opts, kernel in cases:
        common = dict(batch_sizes=(96,), cache_queries=False, **opts)
        sh = ShardedSparseSearchEngine(indexes[dtype], mesh, **common)
        assert sh.comm.device.type == "cuda"
        head.reset_launches()
        got = sh.search(queries, top_k=k)
        assert head.LAUNCHES[kernel] > 0, (dtype, k, opts)
        flat = SparseSearchEngine(
            indexes[dtype], device="cuda",
            merge_backend="host" if opts else "device", **common,
        )
        assert got == flat.search(queries, top_k=k), (dtype, k, opts)
    emb = synthetic_corpus_embeddings(5_000, dim=256, seed=3)
    ids = [str(i) for i in range(5_000)]
    for quantization, kernel in (("symmetric", "int8_similarity"),
                                 ("int4", "int4_similarity")):
        sd = ShardedDenseSearchEngine(ids, emb, mesh, quantization=quantization)
        matmul.reset_launches()
        s2, i2 = sd.search_vectors(emb[:300], top_k=50)
        assert matmul.LAUNCHES[kernel] > 0
        s1, i1 = DenseSearchEngine(
            ids, emb, quantization=quantization, device="cuda"
        ).search_vectors(emb[:300], top_k=50)
        np.testing.assert_array_equal(i2, i1)
        np.testing.assert_array_equal(s2, s1)


def rank_card_shard(index_path, queries, top_k):
    """A rank of two on one card: its K2 launches and results."""
    from osr_tpu_torch.ops import head
    from osr_tpu_torch.parallel import ShardedSparseSearchEngine

    mesh = _mesh(None, device_type="cuda")
    eng = ShardedSparseSearchEngine(
        _port_index(index_path), mesh, batch_sizes=(96,), cache_queries=False
    )
    head.reset_launches()
    results = eng.search(queries, top_k=top_k)
    torch.cuda.synchronize()
    return (
        head.LAUNCHES["head_blockmax_i8"], eng.rows_local,
        str(eng.comm.device), results,
    )


@pytest.mark.cuda
def test_two_ranks_on_one_card_launch_k2_per_shard(tmp_path):
    """Mesh (1, 2) under gloo with both ranks on the one card: each rank
    launches K2 on its 10,112-row shard once a batch, and both return the
    flat engine's results."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    index = _card_index(20_000)
    path = tmp_path / "index.pkl"
    with open(path, "wb") as f:
        pickle.dump(_index_kwargs(index), f)
    queries = _card_queries(192)
    w = Worlds(tmp_path)
    try:
        outs = w.run(2, rank_card_shard, index_path=str(path),
                     queries=queries, top_k=10)
    finally:
        w.close()
    flat = SparseSearchEngine(index, device="cuda", batch_sizes=(96,),
                              cache_queries=False, merge_backend="device")
    want = flat.search(queries, top_k=10)
    for launches, rows, transport, results in outs:
        assert launches == 2 and rows == 10_112 and transport == "cpu"
        assert results == want
