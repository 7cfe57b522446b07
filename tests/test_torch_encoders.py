"""The port's HashingEncoder (osr_tpu_torch/encoders.py), mirrored from the
HashingEncoder tests of tests/test_encoders.py and held against osr_tpu's.

- Vectors are bit-equal to osr_tpu's, for idf on and off and the native
  backend on and off, and so are the native blake2b hashes.
- A state saved by either package's ``save`` loads in the other and gives
  the same query vectors.
- The ``hashing``/``hashing_idf`` registry routes hand both packages'
  engines bit-equal document vectors. Unquantized (``use_quantization:
  False``) the routes' results equal osr_tpu's: ids equal except at
  near-ties, scores within the f32 atol 3e-5 of tests/test_torch_dense.py.
  Quantized, the codes, the scales and the results (ids, order and
  scores) equal osr_tpu's exactly. A hashed vector often holds a value
  at exactly half of its row maximum, a rounding half step, where a
  scale one ulp away would round that code the other way: the port's K7
  computes the scale as osr_tpu's XLA does, absmax times f32(1/127).
"""

import hashlib
import logging

import numpy as np
import pytest
import torch

from osr_tpu_torch import native
from osr_tpu_torch.encoders import HashingEncoder, encode_corpus_to_npy
from osr_tpu_torch.retrieval.registry import RetrieverRegistry
from osr_tpu_torch.testing import SyntheticDataGenerator

F32_ATOL = 3e-5


def _backends():
    return ["force", "off"] if native.available() else ["off"]


def test_hashing_encoder_deterministic_and_normalized():
    enc = HashingEncoder(dim=256)
    a = enc.encode_one("an exchange traded fund holds securities")
    b = enc.encode_one("an exchange traded fund holds securities")
    np.testing.assert_array_equal(a, b)
    assert abs(float(np.linalg.norm(a)) - 1.0) < 1e-5
    c = enc.encode_one("an exchange traded fund holds bonds")
    d = enc.encode_one("completely unrelated words entirely different")
    assert float(a @ c) > float(a @ d)
    batch = enc.encode(["an exchange traded fund holds securities"])
    np.testing.assert_array_equal(batch[0], a)


def test_registry_hashing_encoder_dense_quality():
    """Self-retrieval by a quote from the document finds the document."""
    gen = SyntheticDataGenerator(seed=42)
    corpus = gen.zipf_corpus(800, 5_000, avg_len=60, word_prefix="t")
    ids = list(corpus)
    r = RetrieverRegistry.create(
        {"type": "dpr", "params": {"encoder": "hashing", "device": "cpu"}}
    )
    r.build_index_from_corpus(corpus)
    queries = {
        f"q{i}": " ".join(corpus[ids[i]]["text"].split()[:12])
        for i in range(20)
    }
    res = r.search(queries, top_k=5)
    hits = sum(1 for i in range(20) if ids[i] in res[f"q{i}"])
    assert hits >= 16, hits

    with pytest.raises(ValueError):
        RetrieverRegistry.create(
            {"type": "dpr", "params": {"encoder": "nonsense"}}
        )


def test_hashing_encoder_idf_fit_once_and_weighting():
    corpus_texts = [f"the document number {i}" for i in range(50)] + [
        "the zebra document"
    ]
    enc = HashingEncoder(dim=256, idf=True)
    emb = enc.encode(corpus_texts)  # first call fits
    assert emb.shape == (51, 256)
    assert enc._n_docs == 51

    h_the = enc._hash("the")
    h_zebra = enc._hash("zebra")
    assert enc._idf(h_zebra) > enc._idf(h_the) > 0

    q1 = enc.encode_one("the zebra")
    enc.encode(["some unrelated probe text"])
    assert enc._n_docs == 51
    np.testing.assert_array_equal(enc.encode_one("the zebra"), q1)

    plain = HashingEncoder(dim=256, idf=False)
    pe = plain.encode(corpus_texts)
    q_i = enc.encode_one("zebra facts")
    q_p = plain.encode_one("zebra facts")
    sims_i = emb @ q_i
    sims_p = pe @ q_p
    assert np.argmax(sims_i) == 50 == np.argmax(sims_p)
    margin_i = sims_i[50] - np.max(sims_i[:50])
    margin_p = sims_p[50] - np.max(sims_p[:50])
    assert margin_i > margin_p


def test_registry_hashing_idf_end_to_end():
    corpus = {
        f"d{i}": {"text": f"the common filler words {('rareterm' if i == 7 else 'plain')} item {i}"}
        for i in range(30)
    }
    r = RetrieverRegistry.create(
        {
            "type": "dpr",
            "params": {"encoder": "hashing_idf", "embedding_dim": 128,
                       "cache_matrices": False, "device": "cpu"},
        }
    )
    r.build_index_from_corpus(corpus)
    res = r.search({"q": "rareterm item"}, top_k=3)
    assert list(res["q"])[0] == "d7"


def test_hashing_encoder_save_load_roundtrip(tmp_path):
    corpus = [f"the common doc {i} {'rare' if i == 3 else 'usual'}"
              for i in range(20)]
    queries = ["rare doc", "the usual", "unseen thing"]
    backends = _backends()
    for src in backends:
        enc = HashingEncoder(dim=128, idf=True, native=src)
        emb = enc.encode(corpus)
        p = tmp_path / f"enc_{src}.npz"
        enc.save(p)
        for dst in backends:
            enc2 = HashingEncoder.load(p, native=dst)
            assert enc2._fitted and enc2._n_docs == 20
            for q in queries:
                np.testing.assert_array_equal(
                    enc.encode_one(q), enc2.encode_one(q)
                )
            np.testing.assert_array_equal(enc2.encode(corpus[:5]), emb[:5])
            assert enc2._n_docs == 20


def test_hashing_encoder_unfitted_idf_warns(caplog):
    enc = HashingEncoder(dim=64, idf=True)
    with caplog.at_level(logging.WARNING, logger="osr_tpu_torch.encoders"):
        enc.encode_one("some query")
    assert any("before fit" in r.message for r in caplog.records)


def test_native_option_is_checked():
    with pytest.raises(ValueError):
        HashingEncoder(dim=8, native="sometimes")
    with pytest.raises(ValueError):
        HashingEncoder(dim=0)
    assert HashingEncoder(dim=8, native="off")._nb is None


def test_encode_corpus_to_npy(tmp_path):
    corpus = {f"d{i}": {"text": f"doc {i} words"} for i in range(6)}
    enc = HashingEncoder(dim=32)
    path = encode_corpus_to_npy(corpus, enc, tmp_path / "sub" / "emb.npy")
    emb = np.load(path)
    np.testing.assert_array_equal(
        emb, enc.encode([c["text"] for c in corpus.values()])
    )
    r = RetrieverRegistry.create(
        {"type": "dpr", "params": {"embeddings_path": str(path),
                                   "embedding_dim": 32, "device": "cpu"}}
    )
    r.build_index_from_corpus(corpus)
    assert r.engine.dim == 32


# ----------------------------------------------------------------------
# Against osr_tpu
# ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_encoders():
    pytest.importorskip("jax")
    from osr_tpu import encoders

    return encoders


TEXTS = (
    [f"The quick brown fox {i} jumps over the lazy dog {i % 7}" for i in range(60)]
    + ["ünïcode wörds and naïve café text", "", "repeat repeat repeat word"]
)


@pytest.mark.parametrize("idf", [False, True])
@pytest.mark.parametrize("backend", ["force", "off"])
def test_vectors_bit_equal_to_osr_tpu(jax_encoders, idf, backend):
    if backend == "force" and not native.available():
        pytest.skip("the native runtime is not built")
    got_enc = HashingEncoder(dim=192, idf=idf, native=backend)
    want_enc = jax_encoders.HashingEncoder(dim=192, idf=idf, native="off")
    got, want = got_enc.encode(TEXTS), want_enc.encode(TEXTS)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    for q in ("the lazy fox", "café", "nothing known here"):
        np.testing.assert_array_equal(
            got_enc.encode_one(q), want_enc.encode_one(q)
        )


def test_native_hash_is_blake2b():
    if not native.available():
        pytest.skip("the native runtime is not built")
    for data in (b"", b"a", "ünï".encode(), b"x" * 300):
        want = int.from_bytes(
            hashlib.blake2b(data, digest_size=8).digest(), "little"
        )
        assert native.blake2b64(data) == want
        assert HashingEncoder._hash(data.decode("utf-8")) == want


@pytest.mark.parametrize("direction", ["osr_tpu_to_port", "port_to_osr_tpu"])
def test_saved_state_loads_across_packages(jax_encoders, tmp_path, direction):
    corpus = TEXTS[:40]
    port = HashingEncoder(dim=128, idf=True)
    ref = jax_encoders.HashingEncoder(dim=128, idf=True)
    port.encode(corpus)
    ref.encode(corpus)
    path = tmp_path / "enc.npz"
    if direction == "osr_tpu_to_port":
        ref.save(path)
        loaded = HashingEncoder.load(path)
        other = ref
    else:
        port.save(path)
        loaded = jax_encoders.HashingEncoder.load(path)
        other = port
    assert loaded._fitted and loaded._n_docs == 40
    for q in ("the quick fox", "lazy dog 3", "unseen"):
        np.testing.assert_array_equal(loaded.encode_one(q), other.encode_one(q))


@pytest.fixture(scope="module")
def route_corpus():
    corpus = SyntheticDataGenerator(seed=42).zipf_corpus(
        600, 3_000, avg_len=40, word_prefix="t", min_len=5
    )
    ids = list(corpus)
    queries = {
        f"q{i}": " ".join(corpus[ids[3 * i]]["text"].split()[:10])
        for i in range(30)
    }
    return corpus, queries


def _same_f32(got, want):
    assert got.keys() == want.keys()
    for qid, w in want.items():
        g = got[qid]
        assert len(g) == len(w), qid
        ws = np.array(list(w.values()))
        np.testing.assert_allclose(
            np.array(list(g.values())), ws, rtol=0, atol=F32_ATOL
        )
        for i, (a, b) in enumerate(zip(g, w)):
            if a != b:
                near = [j for j in (i - 1, i + 1) if 0 <= j < len(ws)]
                assert any(abs(ws[i] - ws[j]) <= 2 * F32_ATOL for j in near)


@pytest.mark.parametrize("encoder", ["hashing", "hashing_idf"])
def test_hashing_routes_match_osr_tpu(route_corpus, encoder):
    pytest.importorskip("jax")
    from osr_tpu.ops import quantize as jq
    from osr_tpu.retrieval.registry import RetrieverRegistry as JaxRegistry
    from osr_tpu_torch.ops import quantize as tq

    corpus, queries = route_corpus
    built = {}
    for quantize in (False, True):
        params = {"encoder": encoder, "embedding_dim": 192,
                  "use_quantization": quantize}
        want_r = JaxRegistry.create({"type": "dpr", "params": params})
        got_r = RetrieverRegistry.create(
            {"type": "dpr", "params": {**params, "device": "cpu"}}
        )
        want_r.build_index_from_corpus(corpus)
        got_r.build_index_from_corpus(corpus)
        built[quantize] = (got_r, want_r)
    got_r, want_r = built[False]
    # Unquantized: the routes' results are osr_tpu's.
    _same_f32(got_r.search(queries, top_k=10), want_r.search(queries, top_k=10))
    docs = got_r.engine._docs.numpy()
    np.testing.assert_array_equal(docs, np.asarray(want_r.engine._docs))

    # Quantized: codes and scales are osr_tpu's bit for bit, half steps
    # included, and so are the results.
    got_r, want_r = built[True]
    t_codes, t_scales = (
        t.numpy() for t in tq.quantize_symmetric(torch.from_numpy(docs))
    )
    np.testing.assert_array_equal(got_r.engine._docs.numpy(), t_codes)
    np.testing.assert_array_equal(t_codes, np.asarray(want_r.engine._docs))
    np.testing.assert_array_equal(
        t_scales, np.asarray(jq.quantize_symmetric(docs)[1])
    )
    half = np.abs(docs / t_scales[:, None])
    assert np.any(np.abs(half - np.floor(half) - 0.5) < 1e-4)
    got, want = (r.search(queries, top_k=10) for r in (got_r, want_r))
    assert {q: list(r.items()) for q, r in got.items()} == {
        q: list(r.items()) for q, r in want.items()
    }
    hits = {
        name: sum(
            1 for i in range(30)
            if list(corpus)[3 * i] in r.search(queries, top_k=5)[f"q{i}"]
        )
        for name, r in (("port", got_r), ("osr_tpu", want_r))
    }
    assert hits["port"] == hits["osr_tpu"] >= 24, hits
