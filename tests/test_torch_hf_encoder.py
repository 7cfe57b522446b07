"""The port's HFEncoder (osr_tpu_torch/encoders.py), mirrored from the HF
tests of tests/test_encoders.py on the CPU, and held against
``osr_tpu.encoders.HFEncoder`` over the same ``FlaxBertModel`` weights.

Tolerance: f32 embeddings within atol 1e-5 of osr_tpu's; bf16 (the
forward and the pooling in bf16, as osr_tpu's Flax backend computes)
within atol 1e-2 of osr_tpu's bf16 and of the port's own f32, a few times
the gap bf16 rounding leaves in unit vectors of these widths.
Embeddings are unit vectors."""

import sys
import zlib

import numpy as np
import pytest
import torch

from osr_tpu_torch.bert import SPECIAL_TOKENS, BertConfig, BertModel, WordPieceTokenizer
from osr_tpu_torch.convert import bert_from_flax_params, bert_from_torch_state_dict
from osr_tpu_torch.encoders import HFEncoder, encode_corpus_to_npy
from osr_tpu_torch.retrieval.registry import RetrieverRegistry

TINY = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)
BF16_ATOL = 1e-2


class _CharTokenizer:
    """tests/test_encoders.py's whitespace tokenizer with the HF call
    signature (crc32 word ids), copied so this file imports no JAX."""

    vocab_size = 100

    def __call__(self, texts, padding, truncation, max_length, return_tensors):
        ids = [
            [min(99, 2 + (zlib.crc32(w.encode()) % 90)) for w in t.split()][
                :max_length
            ]
            or [1]
            for t in texts
        ]
        width = max(len(x) for x in ids)
        if padding == "max_length":
            width = max(width, max_length)
        input_ids = np.zeros((len(ids), width), dtype=np.int64)
        mask = np.zeros((len(ids), width), dtype=np.int64)
        for i, x in enumerate(ids):
            input_ids[i, : len(x)] = x
            mask[i, : len(x)] = 1
        batch = {"input_ids": input_ids, "attention_mask": mask}
        if return_tensors == "pt":
            batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        return batch


@pytest.fixture(scope="module")
def transformers():
    return pytest.importorskip("transformers")


@pytest.fixture(scope="module")
def encoder(transformers):
    """tests/test_encoders.py's tiny random BERT (torch.manual_seed(42)),
    carried into the port's BertModel."""
    torch.manual_seed(42)
    hf = transformers.BertModel(transformers.BertConfig(**TINY)).eval()
    model = bert_from_torch_state_dict(hf.config.to_dict(), hf.state_dict())
    return HFEncoder(
        "tiny-random-bert", max_length=32, batch_size=4, model=model,
        tokenizer=_CharTokenizer(), device="cpu",
    )


def test_encode_shapes_and_norms(encoder):
    texts = ["hello world", "bonds pay interest", "etf"]
    emb = encoder.encode(texts)
    assert emb.shape == (3, 32) and emb.dtype == np.float32
    np.testing.assert_allclose(np.linalg.norm(emb, axis=1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(encoder.encode_one("hello world"), emb[0], rtol=1e-5)
    one_by_one = np.stack([encoder.encode_one(t) for t in texts])
    np.testing.assert_allclose(one_by_one, emb, rtol=1e-4, atol=1e-5)
    assert encoder.encode([]).shape == (0, 0)


def test_real_encoder_through_dense_retriever(encoder, tmp_path):
    corpus = {
        "d1": {"text": "exchange traded funds hold many securities"},
        "d2": {"text": "bonds pay interest to holders"},
        "d3": {"text": "savings accounts are insured"},
    }
    r = RetrieverRegistry.create({"type": "dpr", "params": {
        "embedding_fn": encoder.encode,
        "query_embedding_fn": encoder.encode_one, "device": "cpu"}})
    r.build_index_from_corpus(corpus)
    res = r.search({"q": "exchange traded funds hold many securities"}, top_k=2)
    assert list(res["q"])[0] == "d1"

    path = encode_corpus_to_npy(corpus, encoder, tmp_path / "emb.npy")
    r2 = RetrieverRegistry.create({"type": "contriever", "params": {
        "embeddings_path": str(path),
        "query_embedding_fn": encoder.encode_one, "device": "cpu"}})
    r2.build_index_from_corpus(corpus)
    res2 = r2.search({"q": "bonds pay interest to holders"}, top_k=1)
    assert list(res2["q"])[0] == "d2"


def test_pad_to_max_matches_dynamic_padding(encoder):
    texts = ["hello world", "bonds pay interest to holders", "etf"]
    kw = dict(max_length=32, batch_size=4, model=encoder.model,
              tokenizer=_CharTokenizer(), device="cpu")
    fixed = HFEncoder("tiny-random-bert", pad_to_max=True, **kw)
    dyn = HFEncoder("tiny-random-bert", **kw)
    np.testing.assert_allclose(
        fixed.encode(texts), dyn.encode(texts), rtol=1e-4, atol=1e-5
    )
    assert fixed.encode(texts).shape == (3, 32)


def test_any_module_with_last_hidden_state(encoder, transformers):
    """model= takes transformers' own torch BertModel too; it gives the
    port's BertModel's embeddings."""
    torch.manual_seed(42)
    hf = transformers.BertModel(transformers.BertConfig(**TINY)).eval()
    other = HFEncoder("tiny-random-bert", max_length=32, batch_size=4,
                      model=hf, tokenizer=_CharTokenizer(), device="cpu")
    texts = ["hello world", "bonds pay interest to holders", "etf"]
    np.testing.assert_allclose(other.encode(texts), encoder.encode(texts),
                               rtol=0, atol=1e-5)


def test_standin_artifact_pipeline():
    """tests/test_encoders.py's stand-in pipeline on the port's modules:
    seeded BERT + corpus vocabulary -> encode -> int8 -> search -> IR
    metrics shows real self-retrieval signal."""
    from osr_tpu_torch.metrics.ir import recall_at_k
    from osr_tpu_torch.retrieval.engine import DenseSearchEngine
    from osr_tpu_torch.testing import build_standin_encoder

    rng = np.random.RandomState(3)
    words = [f"t{i}" for i in range(300)]
    corpus, texts = {}, []
    for i in range(120):
        t = " ".join(words[w] for w in rng.randint(0, 300, 20))
        corpus[f"d{i}"] = t
        texts.append(t)
    enc = build_standin_encoder(sorted(set(words)), hidden=64, layers=2,
                                device="cpu")
    emb = enc.encode(texts)
    assert emb.shape == (120, 64)
    queries, qrels = {}, {}
    for qi in range(16):
        src = int(rng.randint(120))
        ws = texts[src].split()
        queries[f"q{qi}"] = " ".join(ws[p] for p in rng.choice(len(ws), 8, replace=False))
        qrels[f"q{qi}"] = {f"d{src}": 1}
    q_emb = enc.encode(list(queries.values()))
    eng = DenseSearchEngine(list(corpus), emb, quantization="symmetric",
                            device="cpu")
    res = eng.search({q: q_emb[i] for i, q in enumerate(queries)}, top_k=10,
                     min_score=-1e30)
    assert recall_at_k(res, qrels, 10) >= 0.4


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    words = [f"t{i}" for i in range(TINY["vocab_size"] - len(SPECIAL_TOKENS))]
    path.write_text("\n".join(list(SPECIAL_TOKENS) + words))
    return path, words


@pytest.mark.parametrize("pad_to_max", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_matches_osr_tpu_over_flax_weights(vocab_file, transformers, dtype,
                                            pad_to_max):
    """osr_tpu's HFEncoder over a FlaxBertModel (BertTokenizerFast) and the
    port's over the same parameters (WordPieceTokenizer on the same
    vocab.txt); texts with unknown words, empty texts and truncation."""
    import jax
    import jax.numpy as jnp

    from osr_tpu.encoders import HFEncoder as JaxEncoder

    path, words = vocab_file
    rng = np.random.RandomState(11)
    texts = [" ".join(rng.choice(words + ["zzz"], rng.randint(0, 45)))
             for _ in range(21)] + [""]
    flax_model = transformers.FlaxBertModel(
        transformers.BertConfig(**TINY), seed=5, dtype=jnp.dtype(dtype)
    )
    kw = dict(max_length=32, batch_size=8, pad_to_max=pad_to_max)
    want = JaxEncoder(
        "tiny", model=flax_model,
        tokenizer=transformers.BertTokenizerFast(vocab_file=str(path)), **kw,
    ).encode(texts)

    def port_model():
        return bert_from_flax_params(
            flax_model.config.to_dict(),
            jax.tree_util.tree_map(np.asarray, flax_model.params),
        )

    got = HFEncoder("tiny", model=port_model(),
                    tokenizer=WordPieceTokenizer.from_file(path), dtype=dtype,
                    device="cpu", **kw).encode(texts)
    assert got.shape == want.shape == (22, 32) and got.dtype == np.float32
    atol = 1e-5 if dtype == "float32" else BF16_ATOL
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
    if dtype == "bfloat16":
        f32 = HFEncoder("tiny", model=port_model(),
                        tokenizer=WordPieceTokenizer.from_file(path),
                        device="cpu", **kw).encode(texts)
        np.testing.assert_allclose(got, f32, rtol=0, atol=BF16_ATOL)
        assert np.abs(got - f32).max() > 0  # the forward did run in bf16


def test_cuda_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour without a card")
    model = BertModel(BertConfig(**TINY))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HFEncoder("tiny", model=model, tokenizer=_CharTokenizer())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HFEncoder("tiny", model=model, tokenizer=_CharTokenizer(), device="cuda")


def test_options_are_checked():
    model = BertModel(BertConfig(**TINY))
    with pytest.raises(ValueError, match="backend"):
        HFEncoder("tiny", model=model, tokenizer=_CharTokenizer(),
                  backend="flax", device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        HFEncoder("tiny", model=model, tokenizer=_CharTokenizer(),
                  dtype="float16", device="cpu")


def test_import_error_names_the_arguments(monkeypatch):
    """Without tokenizer= (or model=) and without transformers, the error
    says which arguments replace it."""
    monkeypatch.setitem(sys.modules, "transformers", None)
    model = BertModel(BertConfig(**TINY))
    with pytest.raises(ImportError, match="model=.*tokenizer="):
        HFEncoder("tiny", model=model, device="cpu")
    with pytest.raises(ImportError, match="transformers"):
        HFEncoder("tiny", tokenizer=_CharTokenizer(), device="cpu")
    # Both given: transformers is not needed.
    HFEncoder("tiny", model=model, tokenizer=_CharTokenizer(), device="cpu")


@pytest.mark.cuda
def test_hf_encoder_on_card_matches_cpu(vocab_file):
    """f32 on the card against f32 on the CPU (TF32 off, the default),
    atol 1e-5; bf16 on the card within BF16_ATOL of both."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card, see README)")
    path, words = vocab_file
    rng = np.random.RandomState(12)
    texts = [" ".join(rng.choice(words, rng.randint(0, 60))) for _ in range(40)]
    out = {}
    for dev, dtype in (("cpu", "float32"), ("cuda", "float32"),
                       ("cuda", "bfloat16")):
        model = BertModel(BertConfig(**TINY),
                          generator=torch.Generator().manual_seed(9))
        out[dev, dtype] = HFEncoder(
            "tiny", model=model, tokenizer=WordPieceTokenizer.from_file(path),
            max_length=64, batch_size=16, dtype=dtype, device=dev,
        ).encode(texts)
    np.testing.assert_allclose(out["cuda", "float32"], out["cpu", "float32"],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(out["cuda", "bfloat16"], out["cpu", "float32"],
                               rtol=0, atol=BF16_ATOL)
