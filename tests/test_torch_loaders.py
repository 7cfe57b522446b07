"""The port's BEIR loaders (osr_tpu_torch/storage/loaders.py), mirrored
from the loader tests of tests/test_storage.py, and held against
osr_tpu's loaders on the same files: equal corpora, queries, qrels,
validation reports and statistics."""

import json
import threading

import pytest

from osr_tpu_torch.storage.loaders import (
    LazyJSONLReader,
    compute_dataset_stats,
    extract_query_text,
    load_corpus,
    load_qrels,
    load_queries,
    validate_dataset,
)


@pytest.fixture
def beir_dataset(tmp_path):
    ds = tmp_path / "fiqa_mini"
    ds.mkdir()
    with open(ds / "corpus.jsonl", "w") as f:
        for i in range(10):
            f.write(json.dumps({"_id": f"d{i}", "text": f"doc text {i}", "title": ""}) + "\n")
    with open(ds / "queries.jsonl", "w") as f:
        for i in range(4):
            f.write(json.dumps({"_id": f"q{i}", "text": f"query {i}"}) + "\n")
    (ds / "qrels").mkdir()
    with open(ds / "qrels" / "test.tsv", "w") as f:
        f.write("query-id\tcorpus-id\tscore\n")
        f.write("q0\td0\t1\nq1\td1\t2\nq1\td2\t1\n")
    return ds


def test_loaders(beir_dataset):
    corpus = load_corpus(beir_dataset)
    assert len(corpus) == 10 and corpus["d3"]["text"] == "doc text 3"
    queries = load_queries(beir_dataset)
    assert extract_query_text(queries["q2"]) == "query 2"
    qrels = load_qrels(beir_dataset)
    assert qrels == {"q0": {"d0": 1}, "q1": {"d1": 2, "d2": 1}}
    v = validate_dataset(beir_dataset)
    assert v["ok"] and v["qrels_present"]
    stats = compute_dataset_stats(beir_dataset)
    assert stats.num_docs == 10 and stats.num_queries == 4
    assert stats.num_qrels == 3
    assert stats.avg_doc_length == pytest.approx(3.0)


def test_extract_query_text_variants():
    assert extract_query_text("plain") == "plain"
    assert extract_query_text({"query": "a", "text": "b"}) == "b"
    assert extract_query_text({"question": "why"}) == "why"
    assert extract_query_text(None) == ""


def test_lazy_jsonl_reader(tmp_path):
    path = tmp_path / "c.jsonl"
    with open(path, "w") as f:
        for i in range(30):
            f.write(json.dumps({"_id": f"d{i}", "text": f"body {i}"}) + "\n")
        f.write("\n{bad json\n")
    with LazyJSONLReader(path) as reader:
        assert len(reader) == 30
        assert reader[7]["text"] == "body 7"
        assert reader.get("d29")["_id"] == "d29"
        assert reader.get("nope") is None


def test_lazy_jsonl_reader_non_dict_lines(tmp_path):
    path = tmp_path / "odd.jsonl"
    path.write_text('42\n{"_id": "a", "text": "x"}\n[1,2]\n"str"\n')
    with LazyJSONLReader(path) as reader:
        assert len(reader) == 1
        assert reader.get("a")["text"] == "x"


def test_lazy_jsonl_reader_concurrent(tmp_path):
    path = tmp_path / "c.jsonl"
    with open(path, "w") as f:
        for i in range(50):
            f.write(json.dumps({"_id": f"d{i}", "text": f"body {i}"}) + "\n")
    reader = LazyJSONLReader(path)
    errors = []

    def worker(tid):
        try:
            for i in range(100):
                idx = (tid * 17 + i) % 50
                assert reader[idx]["text"] == f"body {idx}"
        except Exception as e:
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    reader.close()
    assert not errors, errors


def test_loaders_skip_non_dict_json(tmp_path):
    ds = tmp_path / "weird"
    ds.mkdir()
    (ds / "corpus.jsonl").write_text(
        '[1,2]\n{"_id": "d1", "text": "ok"}\n"plain"\n42\n'
    )
    (ds / "queries.jsonl").write_text('17\n{"_id": "q1", "text": "hello"}\n')
    assert list(load_corpus(ds)) == ["d1"]
    assert list(load_queries(ds)) == ["q1"]
    v = validate_dataset(ds)
    assert v["corpus"]["valid"] == 1 and v["corpus"]["invalid"] == 3


def test_qrels_first_row_with_query_substring_kept(tmp_path):
    ds = tmp_path / "q"
    (ds / "qrels").mkdir(parents=True)
    (ds / "qrels" / "test.tsv").write_text("query_1\tdoc3\t1\nq2\tdoc4\t2\n")
    assert load_qrels(ds) == {"query_1": {"doc3": 1}, "q2": {"doc4": 2}}
    (ds / "qrels" / "test.tsv").write_text(
        "query-id\tcorpus-id\tscore\nq1\td1\t1\n"
    )
    assert load_qrels(ds) == {"q1": {"d1": 1}}


def test_loaders_equal_osr_tpu(tmp_path):
    """Odd field names, malformed lines, missing files, a qrels file
    without a header: both packages read the same records."""
    from osr_tpu.storage import loaders as want
    from osr_tpu_torch.storage import loaders as got

    ds = tmp_path / "mixed"
    (ds / "qrels").mkdir(parents=True)
    (ds / "corpus.jsonl").write_text("\n".join([
        json.dumps({"_id": "a", "text": "alpha text"}),
        json.dumps({"doc_id": 7, "content": "seven"}),
        json.dumps({"docid": "b", "body": "bee body", "title": "B"}),
        json.dumps({"passage": "no id here"}),
        "{bad",
        json.dumps({"id": "c", "document": "see"}),
        "",
    ]))
    (ds / "queries.jsonl").write_text("\n".join([
        json.dumps({"qid": "q1", "query": "first?"}),
        json.dumps({"_id": "q2", "question": "second"}),
        json.dumps({"query_id": 3, "title": "third"}),
        json.dumps({"text": "anonymous"}),
        "[]",
    ]))
    (ds / "qrels" / "test.tsv").write_text("q1 a 1\nq2\tb\t2.0\nq3 c x\nshort\n")
    for name in ("load_corpus", "load_queries", "load_qrels",
                 "validate_dataset"):
        assert getattr(got, name)(ds) == getattr(want, name)(ds), name
    assert compute_dataset_stats(ds).__dict__ == want.compute_dataset_stats(ds).__dict__
    for q in load_queries(ds).values():
        assert extract_query_text(q) == want.extract_query_text(q)
    empty = tmp_path / "empty"
    empty.mkdir()
    assert load_corpus(empty) == want.load_corpus(empty) == {}
    assert validate_dataset(empty) == {
        **want.validate_dataset(empty), "dataset": str(empty)}
    with LazyJSONLReader(ds / "corpus.jsonl") as got_r, want.LazyJSONLReader(
        ds / "corpus.jsonl"
    ) as want_r:
        assert len(got_r) == len(want_r) == 5
        assert [got_r[i] for i in range(5)] == [want_r[i] for i in range(5)]
        assert got_r.get("7") == want_r.get("7")
