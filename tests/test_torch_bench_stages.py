"""The stage and device-step profilers ported as modes of ``python -m
osr_tpu_torch.bench`` (profile-stages-1m, profile-host-scale,
profile-hybrid, profile-device, profile-fused, profile-narrow,
profile-blocksel, profile-topk2, profile-topk-fix) against the JAX
scripts they port and osr_tpu's selections, on the CPU at small sizes
from seeds.

The two index-dump modes read a dump the port's ``scaling.save_index``
writes (``tools/bench_scaling.py``'s layout), which the JAX scripts load
too; the scripts run from copies under the test's temporary directory.
Tolerances: host-scale's counts and estimates equal the script's on an
int8 dump, floats within 1e-6 relative (both round them alike); on an
int4 dump the port's merge slack is at least osr_tpu's (|scale| against
the signed scale). The selections over seeded matrices with distinct
values equal osr_tpu's ``block_topk_from_max`` / ``block_topk_narrow``
and ``lax.top_k`` run through JAX on the CPU: the same values and rows.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from osr_tpu_torch.bench import (
    common,
    profile_blocksel,
    profile_device,
    profile_fused,
    profile_host_scale,
    profile_hybrid,
    profile_narrow,
    profile_stages_1m,
    profile_topk2,
    profile_topk_fix,
    scaling,
)
from tests.test_torch_bench_tools import _script_copy

REPO = Path(__file__).resolve().parents[1]
DOCS = 3_000
VOCAB = 12_000
TOP_K = 10
# profile-host-scale's count and estimate keys that equal the script's on
# an int8 dump (postings_per_q_mean does not: see its module docstring).
ESTIMATES = (
    "num_docs", "head_terms", "head_dtype", "max_tail_df", "num_queries",
    "candidates_per_q_mean", "theta_median", "theta_p10",
    "theta_finite_frac", "skip_fraction_of_postings",
    "cand_tail_ge_theta_frac", "postings_per_q_after_skip",
)


def _run_script(mod, monkeypatch, argv):
    """The copied script's ``main()`` under ``argv``, JAX's persistent
    compile cache left off (the scripts point it at a fixed directory);
    its standard output."""
    import jax

    update = jax.config.update
    monkeypatch.setattr(
        jax.config, "update",
        lambda k, v: None if k.startswith("jax_persistent_cache")
        or k == "jax_compilation_cache_dir" else update(k, v),
    )
    monkeypatch.setattr(sys, "argv", ["script", *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        mod.main()
    return buf.getvalue()


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """{head dtype: dump directory} of one seed-42 corpus, int8 and int4."""
    out = {}
    for dtype in ("int8", "int4"):
        index, build_s = scaling.build_index(DOCS, VOCAB, dtype)
        path = tmp_path_factory.mktemp(f"dump_{dtype}")
        scaling.save_index(index, build_s, path)
        out[dtype] = path
    return out


# ----------------------------------------------------------------------
# profile-host-scale
# ----------------------------------------------------------------------


def _host_scale_pair(dumps, dtype, tmp_path, monkeypatch):
    mod = _script_copy(tmp_path, monkeypatch, "profile_host_scale.py")
    want = json.loads(_run_script(mod, monkeypatch, [
        "--load-index", str(dumps[dtype]), "--queries", "64",
        "--topk", str(TOP_K),
    ]))
    got = profile_host_scale.run(str(dumps[dtype]), queries=64, topk=TOP_K)
    return got, want, mod


def test_host_scale_equals_the_script_on_int8(dumps, tmp_path, monkeypatch):
    got, want, _ = _host_scale_pair(dumps, "int8", tmp_path, monkeypatch)
    assert set(got) == set(profile_host_scale.KEYS)
    assert set(want) <= set(got)
    assert got["host_runtime"] == "native"
    assert want["candidates_per_q_mean"] > 0
    assert 0 < want["theta_finite_frac"] <= 1
    for key in ESTIMATES:
        if isinstance(want[key], float):
            assert got[key] == pytest.approx(want[key], rel=1e-6), key
        else:
            assert got[key] == want[key], key


def test_host_scale_postings_per_query_counts_empty_tails_as_zero(
        dumps, tmp_path, monkeypatch):
    """postings_per_q_mean is the mean of each query's tail postings (a
    plain sum a query here); the script's np.add.reduceat gave a query
    without tail terms the next query's first term, and its value is
    that formula's."""
    from osr_tpu_torch.index.tokenizer import Tokenizer
    from osr_tpu_torch.retrieval.encoding import (
        QueryEncoder,
        encode_query_batch,
    )
    from osr_tpu_torch.testing import SyntheticDataGenerator

    got, want, _ = _host_scale_pair(dumps, "int8", tmp_path, monkeypatch)
    index, _ = scaling.load_index(dumps["int8"])
    lay = index.layout
    texts = list(SyntheticDataGenerator(seed=42).queries(
        64, lay.vocab_size, avg_terms=11, word_prefix="t", min_terms=2,
    ).values())
    enc = encode_query_batch(QueryEncoder(Tokenizer(index.vocabulary)),
                             texts, 64, lay.head_terms)
    df = np.diff(lay.post_ptr)
    ptr = enc.tail_ptr
    per_q = [sum(int(df[t]) for t in enc.tail_ids[ptr[q]:ptr[q + 1]])
             for q in range(64)]
    assert (np.diff(ptr) == 0).any()  # queries with no tail term
    assert got["postings_per_q_mean"] == round(float(np.mean(per_q)), 1)
    scripts = np.add.reduceat(df[enc.tail_ids].astype(np.float64),
                              ptr[:-1].astype(np.int64))
    assert want["postings_per_q_mean"] == round(float(scripts.mean()), 1)
    assert want["postings_per_q_mean"] > got["postings_per_q_mean"]


def test_host_scale_int4_slack_is_at_least_osr_tpus(dumps, tmp_path,
                                                    monkeypatch):
    """The port's merge slack multiplies by |scale|, osr_tpu's by the
    signed int4 scale: the port's per-term slack is the absolute value of
    osr_tpu's, so its theta is at most osr_tpu's, it skips at most as
    many postings and keeps at least as many candidates; the counts are
    equal."""
    from osr_tpu.index.postings import prepare_host_merge as jax_prepare
    from osr_tpu_torch.index.postings import prepare_host_merge

    got, want, mod = _host_scale_pair(dumps, "int4", tmp_path, monkeypatch)
    index, _ = scaling.load_index(dumps["int4"])
    mine = prepare_host_merge(index.layout, want_head_t=False)[3]
    theirs = jax_prepare(mod.load_dump(dumps["int4"]).layout,
                         want_head_t=False)[3]
    assert (index.layout.head_scales < 0).any()
    np.testing.assert_array_equal(mine, np.abs(theirs))
    assert (mine > theirs).any()
    for key in ("num_docs", "head_terms", "head_dtype", "max_tail_df",
                "num_queries", "candidates_per_q_mean"):
        assert got[key] == want[key], key
    assert got["theta_median"] <= want["theta_median"]
    assert got["theta_p10"] <= want["theta_p10"]
    assert got["skip_fraction_of_postings"] <= want[
        "skip_fraction_of_postings"]
    assert got["postings_per_q_after_skip"] >= want[
        "postings_per_q_after_skip"]
    assert got["cand_tail_ge_theta_frac"] >= want["cand_tail_ge_theta_frac"]


def test_host_scale_cli_runs_on_the_host(dumps, capsys):
    """Without a card the mode touches no device and prints its row."""
    assert profile_host_scale.main(
        ["--load-index", str(dumps["int8"]), "--queries", "16", "--cpu"]
    ) == 0
    row = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert row["num_queries"] == 16 and row["device"] == "cpu"
    assert row["kernel_launches"] == {}


# ----------------------------------------------------------------------
# profile-stages-1m
# ----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_stages_candidates_equal_the_script(dumps, dtype, tmp_path,
                                            monkeypatch):
    """cand_total and cand_per_query equal the script's on the same dump
    and queries; the port's row has every key of the script's dict."""
    mod = _script_copy(tmp_path, monkeypatch, "profile_stages_1m.py")
    out = _run_script(mod, monkeypatch, [
        "--load-index", str(dumps[dtype]), "--batch", "256",
        "--queries", "256", "--topk", str(TOP_K), "--vocab", str(VOCAB),
    ])
    want = ast.literal_eval(out.strip().splitlines()[-1])
    got = profile_stages_1m.run(str(dumps[dtype]), batch=256, queries=256,
                                topk=TOP_K, vocab=VOCAB, device="cpu")
    assert set(got) == set(profile_stages_1m.KEYS)
    assert set(want) <= set(got)
    assert got["cand_total"] == want["cand_total"] > 0
    assert got["cand_per_query"] == want["cand_per_query"]
    assert got["head_dtype"] == dtype and got["qps"] > 0


# ----------------------------------------------------------------------
# profile-hybrid
# ----------------------------------------------------------------------


def _hybrid_stage_names():
    """The names tools/profile_hybrid.py passes to ``tick``, in order."""
    tree = ast.parse((REPO / "tools/profile_hybrid.py").read_text())
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and isinstance(n.func, ast.Name) and n.func.id == "tick"]
    return list(dict.fromkeys(
        c.args[0].value for c in sorted(calls, key=lambda c: c.lineno)
    ))


HYBRID = dict(num_docs=DOCS, vocab=VOCAB, batch=64, reps=2)


@pytest.fixture(scope="module")
def hybrid_run():
    return profile_hybrid.run("rrf", device="cpu", **HYBRID)


def test_hybrid_stage_keys_are_the_scripts(hybrid_run):
    row, _ = hybrid_run
    want = _hybrid_stage_names()
    assert len(want) == 11
    assert list(row["ms_per_batch"]) == want
    assert set(row) == set(profile_hybrid.KEYS)
    assert row["host_serial_ms"] <= row["serial_wall_ms"]
    assert row["device_step_event_ms"] == {"sparse_dev": None,
                                           "dense_dev": None}


def test_hybrid_composed_stages_equal_search(hybrid_run):
    """The stages, composed, give the hybrid retriever's own results."""
    from osr_tpu_torch.retrieval.registry import RetrieverRegistry

    _, got = hybrid_run
    corpus = common.make_corpus(DOCS, VOCAB)
    queries = dict(list(common.make_queries(128, VOCAB).items())[:64])
    retr = RetrieverRegistry.create({"type": "hybrid", "params": {
        "sparse_weight": 0.3, "dense_weight": 0.7, "fusion_depth": 100,
        "fusion": "rrf", "cache_dir": None, "device": "cpu",
    }})
    retr.build_index_from_corpus(corpus)
    assert got == retr.search(queries, top_k=50)


# ----------------------------------------------------------------------
# The selections against osr_tpu and lax.top_k
# ----------------------------------------------------------------------


def _jax_top_k(scores, k):
    import jax.numpy as jnp
    from jax import lax

    s, r = lax.top_k(jnp.asarray(scores), k)
    return np.asarray(s), np.asarray(r)


def _assert_same(got_s, got_r, want_s, want_r):
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_r, want_r)


def _distinct(scores, k=TOP_K):
    """No tie among each row's k + 1 largest scores: where the
    selections' order and membership are defined by the values alone."""
    top = -np.sort(-scores, axis=1)[:, : k + 1]
    assert (np.diff(top, axis=1) < 0).all()


@pytest.fixture(scope="module")
def blocksel_run():
    return profile_blocksel.run(batch=32, rows=3_000, topk=TOP_K, w=16,
                                device="cpu")


def test_blocksel_equals_osr_tpu_and_top_k(blocksel_run):
    import jax.numpy as jnp
    from osr_tpu.ops.topk import block_topk_from_max

    row, outs = blocksel_run
    scores = outs["scores"]
    _distinct(scores)
    assert row["scores_equal"] and row["rows_equal"]
    want = _jax_top_k(scores, TOP_K)
    _assert_same(outs["block_top"], outs["block_rows"], *want)
    _assert_same(outs["plain_top"], outs["plain_rows"], *want)
    bmax = scores.reshape(32, -1, 128).max(axis=2)
    s, r = block_topk_from_max(jnp.asarray(scores[:, :3_000]),
                               jnp.asarray(bmax), k=TOP_K)
    _assert_same(outs["block_top"], outs["block_rows"], np.asarray(s),
                 np.asarray(r))


@pytest.fixture(scope="module")
def topk2_run():
    return profile_topk2.run(batch=32, rows=3_000, topk=TOP_K, device="cpu")


def test_int_bitcast_trick_equals_top_k(topk2_run):
    row, outs = topk2_run
    _distinct(outs["scores"])
    assert row["int_trick_exact"]
    want = _jax_top_k(outs["scores"], TOP_K)
    _assert_same(outs["int_top"], outs["int_rows"], *want)
    _assert_same(outs["f32_top"], outs["f32_rows"], *want)


def test_int_bitcast_order_is_float_order():
    """Ordered int32 bits sort as the floats do, signs and zeros
    included."""
    import torch

    x = torch.tensor([[-3.5, -0.25, 0.0, 1e-30, 2.0, -1e30, 7.25, 0.5]])
    s, r = profile_topk2.int_bitcast_topk(x, 8)
    assert s[0].tolist() == sorted(x[0].tolist(), reverse=True)
    assert r.tolist() == [[6, 4, 7, 3, 2, 1, 0, 5]]


@pytest.fixture(scope="module")
def topk_fix_run():
    return profile_topk_fix.run(batch=32, rows=20_000, f=256, topk=TOP_K,
                                with_scores=True, device="cpu")


def test_chunked_scan_equals_top_k(topk_fix_run):
    """The scan over 8,192-row chunks (3 chunks, the last padded) equals
    lax.top_k of the one-program (B, R) scores, values and rows, and the
    one-program top-k equals it too."""
    row, outs = topk_fix_run
    _distinct(outs["scores"])
    assert row["scan_equals_baseline"] and row["scan_equals_baseline_scores"]
    want = _jax_top_k(outs["scores"], TOP_K)
    _assert_same(outs["scan_top"], outs["scan_rows"], *want)
    _assert_same(outs["base_top"], outs["base_rows"], *want)


def test_topk_fix_scores_are_the_scripts_product(topk_fix_run):
    """The one-program scores are the script's mm (bf16 scaled queries
    times the codes, f32 sums) within f32 summation order."""
    import jax.numpy as jnp
    from jax import lax

    _, outs = topk_fix_run
    rng = np.random.default_rng(0)
    head = rng.integers(-127, 128, (20_000, 256)).astype(np.int8)
    q = (rng.random((32, 256)) * 0.01).astype(np.float32)
    scales = (rng.random(256).astype(np.float32) + 0.5) / 127.0
    qb = (jnp.asarray(q) * jnp.asarray(scales)[None, :]).astype(jnp.bfloat16)
    want = np.asarray(lax.dot_general(
        qb, jnp.asarray(head).astype(jnp.bfloat16),
        dimension_numbers=(((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    ))
    np.testing.assert_allclose(outs["scores"], want, rtol=1e-5, atol=1e-6)


NARROW = dict(docs=5_000, vocab=20_000, batch=32, topk=TOP_K)


@pytest.fixture(scope="module")
def narrow_run():
    return profile_narrow.run(device="cpu", **NARROW)


@pytest.mark.parametrize("m", profile_narrow.MS)
def test_narrowed_selection_equals_osr_tpu(narrow_run, m):
    import jax.numpy as jnp
    from osr_tpu.ops.topk import block_topk_from_max, block_topk_narrow

    _, outs = narrow_run
    scores = outs["scores"]
    _distinct(scores)
    padded = np.pad(scores, ((0, 0), (0, (-scores.shape[1]) % 128)),
                    constant_values=-np.inf)
    bmax = jnp.asarray(padded.reshape(scores.shape[0], -1, 128).max(axis=2))
    got = outs[f"narrow_top_m{m}"], outs[f"narrow_rows_m{m}"]
    s, r = block_topk_narrow(jnp.asarray(scores), bmax, k=TOP_K, block_m=m)
    _assert_same(*got, np.asarray(s), np.asarray(r))
    s, r = block_topk_from_max(jnp.asarray(scores), bmax, k=TOP_K)
    _assert_same(*got, np.asarray(s), np.asarray(r))
    _assert_same(*got, *_jax_top_k(scores, TOP_K))


def test_narrow_outputs_equal_across_m(narrow_run):
    row, _ = narrow_run
    assert row["outputs_equal_across_m"]
    for m in (0,) + profile_narrow.MS:
        assert row[f"fused_exact_step_narrow_m{m}_bit_identical"]
    for m in profile_narrow.MS:
        assert row[f"selection_narrow_m{m}_bit_identical"]
        assert row[f"fused_extract_step_m{m}_positive_set_identical"]


def test_narrowed_selection_falls_back_where_unsafe():
    """A block holding more than m of the top k sets the flag: the
    full-width selection answers, and equals it."""
    import torch
    from osr_tpu_torch.ops.topk import block_topk_from_max

    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 1024)).astype(np.float32)
    x[:, 128:138] += 100.0  # ten of the top ten in block 1
    hs = torch.from_numpy(x)
    bmax = torch.from_numpy(x.reshape(4, 8, 128).max(axis=2))
    s, r, fell = profile_narrow.narrowed(hs, bmax, 10, 4)
    want = block_topk_from_max(hs, bmax, k=10)
    assert fell
    _assert_same(s.numpy(), r.numpy(), want[0].numpy(), want[1].numpy())


# ----------------------------------------------------------------------
# profile-fused and profile-device against the engine's device step
# ----------------------------------------------------------------------


def _engine_over(head, f):
    """A SparseSearchEngine on the CPU over a bare int8 head with unit
    scales and no tail."""
    from osr_tpu_torch.convert import index_from_arrays
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    r = head.shape[0]
    index = index_from_arrays(
        head=head, head_scales=np.ones(f, np.float32),
        post_ptr=np.zeros(1, np.int64), post_rows=np.zeros(0, np.int32),
        post_weights=np.zeros(0, np.float32), valid=np.ones(r, bool),
        num_docs=r, vocab_size=f, head_terms=f, head_dtype="int8",
        vocabulary={f"t{i}": i for i in range(f)},
        doc_ids=[str(i) for i in range(r)],
    )
    return SparseSearchEngine(index, device="cpu", cache_queries=False)


def test_fused_stages_equal_the_engine_device_step():
    """Stage D is the engine's device step bit for bit, stage E equals it
    up to the order of tied scores; both at a block-pruned shape (40
    blocks > 2 x top_k)."""
    import torch

    row, outs = profile_fused.run(docs=5_000, batch=64, topk=TOP_K, f=256,
                                  device="cpu")
    assert set(row) == set(profile_fused.KEYS)
    assert row["stage_d_equals_device_step"]
    assert row["stage_e_equals_device_step"]
    engine = _engine_over(outs["head"], 256)
    top, rows, _ = engine.device_step(torch.from_numpy(outs["ids"]),
                                      torch.from_numpy(outs["weights"]),
                                      TOP_K)
    _assert_same(outs["d_top"], outs["d_rows"], top.numpy(), rows.numpy())
    _assert_same(outs["step_top"], outs["step_rows"], top.numpy(),
                 rows.numpy())
    assert common.equal_up_to_ties(outs["e_top"], outs["e_rows"],
                                   top.numpy(), rows.numpy())


def test_device_fused_total_equals_the_engine_device_step():
    import torch
    from osr_tpu_torch.index.builder import SparseIndexBuilder
    from osr_tpu_torch.retrieval.engine import SparseSearchEngine

    row, outs = profile_device.run(docs=5_000, vocab=20_000, batch=64,
                                   topk=TOP_K, device="cpu")
    assert set(row) == set(profile_device.KEYS)
    assert row["fused_equals_engine_step"]
    assert row["approx_max_k_ms"] is None
    assert set(row["dropped"]) == {"approx_max_k_ms"}
    index = SparseIndexBuilder(method="bm25").build(
        common.make_corpus(5_000, 20_000))
    engine = SparseSearchEngine(index, device="cpu", batch_sizes=(64,),
                                cache_queries=False)
    top, rows, _ = engine.device_step(torch.from_numpy(outs["ids"]),
                                      torch.from_numpy(outs["weights"]),
                                      TOP_K)
    _assert_same(outs["top"], outs["rows"], top.numpy(), rows.numpy())


def test_equal_up_to_ties():
    s = np.array([[5.0, 4.0, 4.0, 3.0, 3.0]])
    r = np.array([[1, 2, 3, 4, 5]])
    assert common.equal_up_to_ties(s, r, s, np.array([[1, 3, 2, 4, 5]]))
    assert common.equal_up_to_ties(s, r, s, np.array([[1, 2, 3, 5, 9]]))
    assert not common.equal_up_to_ties(s, r, s, np.array([[1, 2, 7, 4, 5]]))
    assert not common.equal_up_to_ties(s, r, s + 1e-3, r)


# ----------------------------------------------------------------------
# Keys, the CLIs and the refusals
# ----------------------------------------------------------------------


@pytest.mark.parametrize("name", ["blocksel", "topk2", "topk_fix", "narrow"])
def test_selection_rows_have_their_keys(name, blocksel_run, topk2_run,
                                        topk_fix_run, narrow_run):
    row, module = {
        "blocksel": (blocksel_run[0], profile_blocksel),
        "topk2": (topk2_run[0], profile_topk2),
        "topk_fix": (topk_fix_run[0], profile_topk_fix),
        "narrow": (narrow_run[0], profile_narrow),
    }[name]
    assert set(row) == set(module.KEYS)
    assert row["device"] == "cpu" and row["kernel_launches"] == {}
    for key, reason in getattr(module, "DROPPED", {}).items():
        assert row[key] is None and row["dropped"][key] == reason


DEVICE_MODES = {
    "profile-stages-1m": profile_stages_1m, "profile-hybrid": profile_hybrid,
    "profile-device": profile_device, "profile-fused": profile_fused,
    "profile-narrow": profile_narrow, "profile-blocksel": profile_blocksel,
    "profile-topk2": profile_topk2, "profile-topk-fix": profile_topk_fix,
}


@pytest.mark.parametrize("mode", sorted(DEVICE_MODES))
def test_device_mode_without_a_card_prints_no_value(mode):
    """Each device mode prints its JSON line with no value and the reason
    and exits 1 without a CUDA device (bench.py:139-153)."""
    extra = ["--load-index", "unused"] if mode == "profile-stages-1m" else []
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "osr_tpu_torch.bench", mode, *extra],
        cwd=REPO, capture_output=True, text=True, timeout=120, env=env,
    )
    assert res.returncode == 1, res.stderr
    line = json.loads(res.stdout.splitlines()[-1])
    assert line["value"] is None and line["error"] == common.NO_CARD
    assert line["metric"] == DEVICE_MODES[mode].METRIC


def test_modes_are_registered():
    from osr_tpu_torch.bench.__main__ import MODES

    assert len(MODES) == 26
    assert set(DEVICE_MODES) | {"profile-host-scale"} <= set(MODES)
