"""The five measurement tools ported as modes of ``python -m
osr_tpu_torch.bench`` (batch-curve, int4-quality, quality-at-scale,
fusion-sweep, dense-encoder) against the JAX scripts they port and
osr_tpu's engines, all on the CPU at small sizes from seeds.

Where a script writes under ``bench_results/`` it runs from a copy in the
test's temporary directory, so it writes there. Tolerances: sparse scores
within rtol 1e-5 and the same doc ids in the same order (the rule of
tests/test_torch_bench.py); the int4-quality MAEs within 1e-5 (the rows
round to 5 decimals); IR metrics of the sparse, hashing-dense and hybrid
legs equal; the dense-encoder's pooled f32 embeddings within 1e-5 (the
rule of tests/test_torch_hf_encoder.py) and its legs' quality numbers,
rounded to 4 decimals as the script rounds them, equal.
"""

import ast
import contextlib
import importlib.util
import io
import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from osr_tpu_torch.bench import (
    batch_curve,
    dense_encoder,
    fusion_sweep,
    int4_quality,
    quality_at_scale,
)

REPO = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _quiet(fn, *args, **kwargs):
    """Call ``fn`` with standard output captured; (its value, the JSON
    lines it printed)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args, **kwargs)
    return value, [json.loads(ln) for ln in buf.getvalue().splitlines()
                   if ln.startswith("{")]


def _script_copy(tmp_path, monkeypatch, *names, prose_roots=None):
    """Copy ``tools/<name>`` for each name into ``tmp_path/tools`` (with an
    empty ``tmp_path/bench_results`` for what they write) and load the
    first. ``prose_roots`` replaces the copied quality script's
    PROSE_ROOTS, the machine's prose directories, with the test's tree."""
    tools = tmp_path / "tools"
    tools.mkdir()
    (tmp_path / "bench_results").mkdir()
    for name in names:
        shutil.copy(REPO / "tools" / name, tools / name)
    if prose_roots is not None:
        path = tools / "bench_quality_at_scale.py"
        roots = tuple(map(str, prose_roots))
        path.write_text(path.read_text() + f"\nPROSE_ROOTS = {roots!r}\n")
    monkeypatch.setattr(sys, "path", list(sys.path))  # the script inserts
    spec = importlib.util.spec_from_file_location(
        f"_copy_{Path(names[0]).stem}", tools / names[0]
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _same_ranking(got, want):
    assert got.keys() == want.keys()
    for qid, w in want.items():
        assert list(got[qid]) == list(w), qid
        np.testing.assert_allclose(
            list(got[qid].values()), list(w.values()), rtol=RTOL
        )


# ----------------------------------------------------------------------
# batch-curve
# ----------------------------------------------------------------------

CURVE = dict(docs=3_000, vocab=12_000, batches=(64, 256))


@pytest.fixture(scope="module")
def curve():
    (rows, results), printed = _quiet(
        batch_curve.run, passes=1, device="cpu", **CURVE
    )
    assert printed == rows
    return rows, results


def test_batch_curve_workload_is_the_scripts():
    """Corpus and queries from one seed-42 generator, as
    tools/bench_batch_curve.py:52-59 draws them."""
    from osr_tpu.testing import SyntheticDataGenerator

    gen = SyntheticDataGenerator(seed=42)
    corpus, queries = batch_curve.workload(1_500, 6_000, 300)
    assert corpus == gen.zipf_corpus(
        1_500, 6_000, avg_len=130, word_prefix="t", min_len=5
    )
    assert queries == gen.queries(
        300, 6_000, avg_terms=11, word_prefix="t", min_terms=2
    )


@pytest.mark.parametrize("batch", CURVE["batches"])
def test_batch_curve_results_equal_osr_tpu(curve, batch):
    """Each batch's engine (batch_sizes=(b,), exact top-k) returns
    osr_tpu's SparseSearchEngine's results at that batch, and the row
    counts the queries searched."""
    from osr_tpu.index.builder import SparseIndexBuilder
    from osr_tpu.retrieval.engine import SparseSearchEngine as JaxEngine

    rows, results = curve
    corpus, queries = batch_curve.workload(CURVE["docs"], CURVE["vocab"])
    sub = dict(list(queries.items())[:batch_curve.timed_count(batch, 6_648)])
    want = JaxEngine(
        SparseIndexBuilder(method="bm25").build(corpus),
        batch_sizes=(batch,), cache_queries=False, topk_mode="exact",
    ).search(sub, top_k=50)
    row = next(r for r in rows if r["batch"] == batch)
    assert row["queries_timed"] == len(results[batch]) == len(sub)
    assert len(sub) == (2_000 // batch) * batch
    assert row["qps_median"] > 0 and row["num_docs"] == CURVE["docs"]
    _same_ranking(results[batch], want)


def test_batch_curve_counts_the_queries_searched():
    """queries_timed is what was searched: at B=6,656 the 6,648 queries
    there are (the script's max((2000 // b) * b, b) said 6,656)."""
    assert [batch_curve.timed_count(b, 6_648)
            for b in batch_curve.BATCHES] == [2_000, 1_920, 1_536, 2_048,
                                              6_648]


# ----------------------------------------------------------------------
# int4-quality
# ----------------------------------------------------------------------

INT4_SIZES = dict(NUM_DOCS=3_000, VOCAB=12_000, NUM_QUERIES=128,
                  HEAD_TERMS=512)


def _int4_device_merge(engine_class):
    """osr_tpu's engine, with its device merge for an int4 head: its host
    merge scales the merge slack by the signed int4 scales and can drop
    real candidates, which the port keeps (ROADMAP.md, deliberate
    divergences); its device merge has no slack prefilter."""

    def engine(index, **kwargs):
        if index.layout.head_dtype == "int4":
            kwargs["merge_backend"] = "device"
        return engine_class(index, **kwargs)

    return engine


@pytest.fixture(scope="module")
def int4_run():
    (rows, results), printed = _quiet(
        int4_quality.run, num_docs=3_000, vocab=12_000, num_queries=128,
        head_terms=512, device="cpu",
    )
    assert printed == rows
    return rows, results


def test_int4_quality_rows_equal_the_scripts(int4_run, tmp_path,
                                             monkeypatch):
    """tools/bench_int4_quality.py itself (a copy, its constants cut to a
    small corpus; the int4 engine on osr_tpu's device merge) and the
    port's three legs on the same corpus through the same metric code:
    every key equal, the overlaps exactly and the MAEs within 1e-5."""
    import jax

    import osr_tpu.retrieval.engine as jax_engine

    script = _script_copy(tmp_path, monkeypatch, "bench_int4_quality.py")
    for name, value in INT4_SIZES.items():
        monkeypatch.setattr(script, name, value)
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(jax_engine, "SparseSearchEngine",
                        _int4_device_merge(jax_engine.SparseSearchEngine))
    with contextlib.redirect_stdout(io.StringIO()):
        script.main()
    want = [json.loads(ln) for ln in
            (tmp_path / "bench_results" / "int4_quality.jsonl")
            .read_text().splitlines()]
    got, _ = int4_run
    assert [r["head_dtype"] for r in got] == ["int8", "int4"]
    for g, w in zip(got, want):
        assert set(w) <= set(g)
        for key, value in w.items():
            if key == "device":
                assert g[key] == "cpu"
            elif key.startswith("score_mae"):
                assert abs(g[key] - value) <= 1e-5 + 1e-12, key
            else:
                assert g[key] == value, key
        assert g["kernel_launches"] == {}
        assert g["merge_checked_candidates"] is None  # the card's check


def test_int4_leg_keeps_what_osr_tpus_host_merge_drops(int4_run):
    """The script's own engine (osr_tpu's host merge) on the int4 head
    returns the port's results less documents that osr_tpu's score_all
    scores positive inside the top-k: the signed-scale slack fault the
    port mends. Its other documents are the port's, with the port's
    scores (at exact int4 ties the two merges order documents apart)."""
    from osr_tpu.index.builder import SparseIndexBuilder
    from osr_tpu.retrieval.engine import SparseSearchEngine as JaxEngine

    got = int4_run[1]["int4"]
    corpus, queries = batch_curve.workload(3_000, 12_000, 128)
    index = SparseIndexBuilder(method="bm25", head_terms=512,
                               head_dtype="int4").build(corpus)
    engine = JaxEngine(index, batch_sizes=(128,), cache_queries=False,
                       topk_mode="exact")
    want = engine.search(queries, top_k=50)
    dropped = 0
    for qid, w in want.items():
        g = dict(got[qid])
        missing = [d for d in g if d not in w]
        assert set(w) <= set(g), qid
        np.testing.assert_allclose([g[d] for d in w], list(w.values()),
                                   rtol=RTOL)
        if missing:
            exact = engine.score_all([queries[qid]])[0]
            for d in missing:
                s = exact[index.doc_ids.index(d)]
                assert s > 0 and np.isclose(g[d], s, rtol=RTOL), (qid, d)
                assert (exact > s).sum() < 50
            dropped += len(missing)
    assert dropped > 0  # the fault shows on this corpus


@pytest.mark.parametrize("head_dtype", ["int8", "int4"])
def test_merge_check_passes_and_fails(head_dtype):
    """common.merge_check, which int4-quality runs on the card, on the
    CPU's plain head: two engines on one build pass with every candidate
    inside the slack; an engine on another build fails."""
    from osr_tpu_torch.bench import common
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    corpus, queries = batch_curve.workload(3_000, 12_000, 300)

    def engine(corpus, **kw):
        index = SparseIndexBuilder(head_terms=512, head_dtype=head_dtype,
                                   **kw).build(corpus)
        return SparseSearchEngine(index, device="cpu", batch_sizes=(256,),
                                  cache_queries=False)

    eng = engine(corpus)
    assert common.merge_check(eng, engine(corpus), queries) > 1_000
    with pytest.raises(RuntimeError, match="disagree"):
        common.merge_check(eng, engine(corpus, k1=2.0), queries)


def test_same_results_allows_only_near_tie_swaps():
    from osr_tpu_torch.bench.common import same_results

    want = {"q": {"a": 3.0, "b": 2.0, "c": 2.0 + 1e-6, "d": 1.0}}
    assert same_results({"q": {"a": 3.0, "c": 2.0, "b": 2.0, "d": 1.0}},
                        want)
    assert not same_results({"q": {"b": 3.0, "a": 3.0, "c": 2.0,
                                   "d": 1.0}}, want)
    assert not same_results({"q": {"a": 3.0, "b": 2.0, "c": 2.0}}, want)


def test_int4_ranking_quality_is_the_scripts_metric():
    """ranking_quality on hand-made rankings: the empty f32 result is
    skipped, overlap@10 looks at the first 10 of each, the MAE at the f32
    documents both hold."""
    truth = {"a": [(f"d{i}", 10.0 - i) for i in range(12)], "b": []}
    got = {"a": [(f"d{i}", 10.0 - i + 0.5) for i in (0, 1, 2, 20)]}
    q = int4_quality.ranking_quality(truth, got)
    assert q == {"num_queries": 1, "overlap_at_10": 0.3,
                 "overlap_at_50": 0.25, "score_mae_on_f32_top50": 0.5,
                 "score_mae_rel_top1": 0.05}


# ----------------------------------------------------------------------
# quality-at-scale and fusion-sweep
# ----------------------------------------------------------------------


def _prose_tree(root, files=30, words=720, seed=5):
    """Seeded prose files: Zipf-drawn words of 3-9 letters, some
    capitalised or ending in a comma; .md, .rst and .txt files in two
    directories, one under 2 KiB and one not prose."""
    rng = np.random.RandomState(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = sorted({"".join(rng.choice(letters, rng.randint(3, 10)))
                    for _ in range(3_000)})
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    (root / "sub").mkdir(parents=True)
    for i in range(files):
        ws = [vocab[j] for j in rng.choice(len(vocab), words, p=p)]
        ws = [w.capitalize() if rng.rand() < 0.1 else
              w + "," if rng.rand() < 0.05 else w for w in ws]
        ext = (".md", ".rst", ".txt")[i % 3]
        where = root / "sub" if i % 4 == 0 else root
        (where / f"doc{i}{ext}").write_text(" ".join(ws))
    (root / "short.md").write_text("too short " * 20)
    (root / "code.py").write_text("x = 1\n" * 500)
    return root


@pytest.fixture(scope="module")
def prose(tmp_path_factory):
    root = _prose_tree(tmp_path_factory.mktemp("prose") / "tree")
    chunks = quality_at_scale.harvest(None, [str(root)])
    assert 500 < len(chunks) < quality_at_scale.MIN_CHUNKS
    return root, chunks


def test_harvest_is_the_scripts(prose, tmp_path, monkeypatch):
    """The harvest over --roots gives tools/bench_quality_at_scale.py's
    chunks with its PROSE_ROOTS pointed at the same tree, whole and cut
    by max_chunks."""
    from tools import bench_quality_at_scale as tool

    root, chunks = prose
    monkeypatch.setattr(tool, "PROSE_ROOTS", (str(root), str(tmp_path)))
    assert chunks == tool.harvest_chunks(None)
    assert quality_at_scale.harvest(300, [str(root)]) == \
        tool.harvest_chunks(300)


def test_prose_roots_are_this_interpreters_library_trees():
    import sysconfig

    roots = quality_at_scale.prose_roots()
    paths = sysconfig.get_paths()
    assert set(roots) == {paths[k] for k in ("stdlib", "purelib", "platlib")}
    assert len(roots) == len(set(roots))
    installs = {Path(sys.prefix), Path(sys.base_prefix)}
    assert all(any(Path(r).is_relative_to(p) for p in installs)
               for r in roots)


def _call_kwargs(path, func):
    """The literal keyword arguments of every call of ``func`` in a
    script, in source order."""
    calls = []
    for node in ast.walk(ast.parse(path.read_text())):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == func):
            kw = {}
            for k in node.keywords:
                try:
                    kw[k.arg] = ast.literal_eval(k.value)
                except ValueError:
                    pass
            calls.append((node.lineno, kw))
    return [kw for _, kw in sorted(calls, key=lambda c: c[0])]


def test_quality_sections_run_the_scripts_methods():
    """bm25_custom, the five hashing legs and the f32 control: the
    script's methods, top_k and method_params, dict for dict."""
    calls = _call_kwargs(REPO / "tools" / "bench_quality_at_scale.py",
                         "run_quality_benchmark")
    assert calls == [
        {"methods": ("bm25_custom",), "top_k": quality_at_scale.TOP_K},
        {"methods": quality_at_scale.DENSE_METHODS,
         "top_k": quality_at_scale.TOP_K,
         "method_params": quality_at_scale.DENSE_PARAMS},
        {"methods": ("bm25_custom",), "top_k": quality_at_scale.TOP_K,
         "method_params": quality_at_scale.F32_PARAMS},
    ]


@pytest.fixture(scope="module")
def at_scale(prose):
    _, chunks = prose
    out, printed = _quiet(
        quality_at_scale.run, chunks, num_queries=64, query_mode="noisy",
        dense_hashing=True, f32_control=True, device="cpu",
    )
    assert printed == [out]
    return out


@pytest.mark.parametrize("section", [
    "osr_tpu", "osr_tpu_dense_hashing", "osr_tpu_f32head",
])
def test_quality_at_scale_ir_metrics_equal_osr_tpu(prose, at_scale, tmp_path,
                                                   section):
    """Each section's IR metrics equal osr_tpu's run_quality_benchmark
    with the same methods and params over the script's own dataset
    files for the same chunks."""
    from osr_tpu.benchmarks.quality import run_quality_benchmark
    from tools import bench_quality_at_scale as tool

    _, chunks = prose
    made, grade1 = tool.build_dataset(tmp_path / "ds", chunks, 64,
                                      mode="noisy")
    assert (at_scale["num_queries"], at_scale["grade1_qrels"]) == (made,
                                                                   grade1)
    methods, params = {
        "osr_tpu": (("bm25_custom",), None),
        "osr_tpu_dense_hashing": (quality_at_scale.DENSE_METHODS,
                                  quality_at_scale.DENSE_PARAMS),
        "osr_tpu_f32head": (("bm25_custom",), quality_at_scale.F32_PARAMS),
    }[section]
    want = run_quality_benchmark(
        tmp_path / "ds", methods=methods, out_dir=tmp_path / "reports",
        top_k=quality_at_scale.TOP_K, method_params=params,
    )
    got = at_scale[section]
    assert list(got) == list(methods)
    for m in methods:
        ir = {k: v for k, v in want[m].items() if "@" in k}
        assert ir and {k: got[m][k] for k in ir} == ir, m
        assert got[m]["method"] == m and got[m]["qps"] > 0


def test_quality_at_scale_object(at_scale, prose):
    _, chunks = prose
    assert at_scale["num_docs"] == len(chunks)
    assert at_scale["query_mode"] == "noisy" and at_scale["reference"] is None
    assert at_scale["kernel_launches"] == {} and at_scale["device"] == "cpu"
    assert not any(k.startswith("ndcg10_delta") for k in at_scale)


@pytest.mark.parametrize("module", [quality_at_scale, fusion_sweep])
def test_main_refuses_below_the_floor(prose, module, capsys):
    """Below 20,000 chunks main prints the line with no value and the
    reason and exits 1, as the script raises (:254); the floor is the
    module's constant."""
    root, chunks = prose
    assert quality_at_scale.MIN_CHUNKS == 20_000
    rc = module.main(["--cpu", "--roots", str(root)])
    line = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 1
    assert line == {
        "metric": module.METRIC, "value": None, "num_docs": len(chunks),
        "error": f"only {len(chunks)} chunks harvested; need >=20000 for "
                 "the at-scale claim",
    }


def test_main_runs_at_the_floor(prose, monkeypatch, capsys):
    """At the floor main runs the harvest over --roots and --max-chunks
    and prints the at-scale object."""
    root, _ = prose
    monkeypatch.setattr(quality_at_scale, "MIN_CHUNKS", 400)
    rc = quality_at_scale.main(["--cpu", "--roots", str(root),
                                "--max-chunks", "400", "--num-queries", "16",
                                "--skip-reference"])
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert rc == 0 and out["num_docs"] == 400 and out["num_queries"] == 16
    assert str(root) in out["dataset"] and list(out["osr_tpu"]) == [
        "bm25_custom"]


def test_fusion_sweep_equals_the_script(prose, tmp_path, monkeypatch):
    """tools/bench_fusion_sweep.py itself (a copy, with its sibling's
    PROSE_ROOTS pointed at the test's tree) and the port's sweep over the
    same harvest: the 13 configs in the script's order, each row's IR
    metrics equal; the run object's keys the script's."""
    root, chunks = prose
    script = _script_copy(tmp_path, monkeypatch, "bench_fusion_sweep.py",
                          "bench_quality_at_scale.py", prose_roots=[root])
    monkeypatch.setattr(sys, "argv", ["bench_fusion_sweep.py",
                                      "--num-queries", "48"])
    with contextlib.redirect_stdout(io.StringIO()):
        script.main()
    want = json.loads((tmp_path / "bench_results" / "fusion_sweep.json")
                      .read_text())["hashing_idf"]
    got, printed = _quiet(fusion_sweep.run, chunks, num_queries=48,
                          device="cpu")
    assert printed == [got]
    assert set(want) <= set(got) and got["kernel_launches"] == {}
    for key in ("encoder", "query_mode", "num_docs", "num_queries", "top_k"):
        assert got[key] == want[key], key
    assert len(got["sweep"]) == len(want["sweep"]) == 13
    for g, w in zip(got["sweep"], want["sweep"]):
        assert set(g) == set(w)
        assert {k: v for k, v in g.items() if k != "qps_warm"} == {
            k: v for k, v in w.items() if k != "qps_warm"}


# ----------------------------------------------------------------------
# dense-encoder
# ----------------------------------------------------------------------

ENC = dict(docs=300, vocab=600, queries=32, topk=10)


@pytest.fixture(scope="module")
def encoder_runs(tmp_path_factory):
    """tools/bench_dense_encoder.py at hidden 128, 2 layers, f32 (its
    stand-in builder wrapped to those widths; osr_tpu's int4_grouped leg
    needs a width divisible by its 128-column groups), and the port's mode over
    the same FlaxBertModel's parameters (convert.bert_from_flax_params)
    and a WordPiece tokenizer on the same vocabulary."""
    import jax

    from osr_tpu_torch.bert import SPECIAL_TOKENS, WordPieceTokenizer
    from osr_tpu_torch.convert import bert_from_flax_params
    from osr_tpu_torch.encoders import HFEncoder

    tmp = tmp_path_factory.mktemp("dense_encoder")
    mp = pytest.MonkeyPatch()
    try:
        script = _script_copy(tmp, mp, "bench_dense_encoder.py")
        built = []

        def standin(terms, **kw):
            built.append(script_build(terms, hidden=128, layers=2,
                                      dtype=kw["dtype"]))
            return built[-1]

        script_build = script.build_standin_encoder
        mp.setattr(script, "build_standin_encoder", standin)
        mp.setenv("OSR_TPU_COMPILE_CACHE", "off")
        mp.setattr(sys, "argv", [
            "bench_dense_encoder.py", "--docs", str(ENC["docs"]), "--vocab",
            str(ENC["vocab"]), "--queries", str(ENC["queries"]), "--topk",
            str(ENC["topk"]), "--dtype", "float32", "--out",
            str(tmp / "out.json"),
        ])
        with contextlib.redirect_stdout(io.StringIO()):
            script.main()
    finally:
        mp.undo()
    want = json.loads((tmp / "out.json").read_text())
    jax_encoder = built[0]
    _, texts, _, _ = dense_encoder.workload(ENC["docs"], ENC["vocab"],
                                            ENC["queries"])
    terms = sorted({w for t in texts for w in t.split()})
    flax = jax_encoder.model
    model = bert_from_flax_params(flax.config.to_dict(),
                                  jax.device_get(flax.params))
    port_encoder = HFEncoder(
        "flax-params", model=model,
        tokenizer=WordPieceTokenizer(list(SPECIAL_TOKENS) + terms),
        max_length=128, batch_size=128, pad_to_max=True, dtype="float32",
        device="cpu",
    )
    got, printed = _quiet(
        dense_encoder.run, docs=ENC["docs"], vocab=ENC["vocab"],
        num_queries=ENC["queries"], top_k=ENC["topk"], dtype="float32",
        device="cpu", encoder=port_encoder,
    )
    assert printed == [got]
    return want, got, jax_encoder, port_encoder, texts


def test_dense_encoder_tokens_and_embeddings_equal_osr_tpus(encoder_runs):
    """The WordPiece ids equal BertTokenizerFast's over the script's
    vocab.txt; the pooled f32 embeddings osr_tpu's HFEncoder's within
    1e-5."""
    _, _, jax_encoder, port_encoder, texts = encoder_runs
    sample = texts[:40] + ["t1 unknownword t3", ""]
    kw = dict(padding="max_length", truncation=True, max_length=128)
    want = jax_encoder.tokenizer(sample, return_tensors="np", **kw)
    got = port_encoder.tokenizer(sample, return_tensors="np", **kw)
    assert np.array_equal(np.asarray(got["input_ids"]), want["input_ids"])
    np.testing.assert_allclose(port_encoder.encode(sample),
                               jax_encoder.encode(sample), rtol=0, atol=1e-5)


def test_dense_encoder_legs_equal_osr_tpus(encoder_runs):
    """Every key of the script's object; each leg's quality dict, the
    int8-vs-f32 overlap and Spearman, the counts and widths equal to
    osr_tpu's; the port names each leg's route."""
    want, got, _, _, _ = encoder_runs
    assert set(want) <= set(got)
    for key in ("fp32", "int8_symmetric", "uint8_asymmetric",
                "int4_symmetric", "int4_grouped128",
                "int8_vs_fp32_p_at_k_overlap", "int8_vs_fp32_spearman",
                "num_docs", "num_queries", "dim", "compute_dtype", "top_k"):
        assert got[key] == want[key], key
    assert got["dense_backends"] == dict.fromkeys(
        ("fp32", "int8_symmetric", "uint8_asymmetric", "int4_symmetric",
         "int4_grouped128"), "torch")
    assert got["kernel_route_equals_plain"] is None  # the card's check
    assert got["kernel_launches"] == {} and got["device"] == "cpu"


def test_dense_encoder_standin_is_the_ports_draw():
    """The stand-in's name says it is the port's own seeded draw, and the
    same seed draws the same weights."""
    from osr_tpu_torch.testing import build_standin_encoder

    a, b = (build_standin_encoder(["t1", "t2"], hidden=32, layers=1,
                                  device="cpu") for _ in range(2))
    assert a.model_name == "torch-standin-bert-1l-32h-seed0-bfloat16"
    for (na, pa), (nb, pb) in zip(a.model.named_parameters(),
                                  b.model.named_parameters()):
        assert na == nb and bool((pa == pb).all()), na
