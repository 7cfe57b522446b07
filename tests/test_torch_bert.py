"""The port's own BERT and WordPiece tokenizer (osr_tpu_torch/bert.py),
held against the ``transformers`` classes that osr_tpu's HFEncoder uses.

Tolerance: ``BertModel`` carried across from ``FlaxBertModel``'s
parameters (``convert.bert_from_flax_params``) or from ``transformers``'
torch ``BertModel`` state dict (``convert.bert_from_torch_state_dict``)
gives their ``last_hidden_state`` within atol 1e-5 in f32 (a tiny config:
vocab 100, hidden 32, 2 layers, 2 heads, intermediate 64).
``WordPieceTokenizer`` gives ``BertTokenizerFast``'s input ids, attention
mask and token type ids exactly, on the same ``vocab.txt``."""

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from osr_tpu_torch.bert import (
    SPECIAL_TOKENS,
    BertConfig,
    BertModel,
    WordPieceTokenizer,
)
from osr_tpu_torch.convert import (
    bert_from_flax_params,
    bert_from_torch_state_dict,
)

TINY = dict(vocab_size=100, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=64,
            max_position_embeddings=64)


def _batch(seed=0, b=5, t=23):
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, TINY["vocab_size"], (b, t)).astype(np.int64)
    mask = np.ones((b, t), np.int64)
    for i in range(1, b):
        mask[i, rng.randint(1, t):] = 0  # right padding of assorted length
    types = (rng.rand(b, t) < 0.3).astype(np.int64)
    return ids, mask, types


def _port(model, ids, mask, types=None):
    with torch.no_grad():
        out = model(
            torch.from_numpy(ids), attention_mask=torch.from_numpy(mask),
            token_type_ids=None if types is None else torch.from_numpy(types),
        )
    return out.last_hidden_state.numpy()


@pytest.mark.parametrize("with_types", [False, True])
def test_bert_matches_flax(with_types):
    import jax

    flax_model = transformers.FlaxBertModel(transformers.BertConfig(**TINY), seed=3)
    port = bert_from_flax_params(
        flax_model.config.to_dict(), jax.tree_util.tree_map(np.asarray, flax_model.params)
    )
    ids, mask, types = _batch()
    kwargs = {"token_type_ids": types} if with_types else {}
    want = np.asarray(
        flax_model(ids, attention_mask=mask, **kwargs).last_hidden_state
    )
    got = _port(port, ids, mask, types if with_types else None)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_bert_matches_transformers_torch():
    torch.manual_seed(4)
    hf = transformers.BertModel(transformers.BertConfig(**TINY)).eval()
    state = {f"bert.{k}": v for k, v in hf.state_dict().items()}  # prefixed
    port = bert_from_torch_state_dict(hf.config.to_dict(), state)
    ids, mask, types = _batch(seed=1)
    with torch.no_grad():
        want = hf(
            input_ids=torch.from_numpy(ids),
            attention_mask=torch.from_numpy(mask),
            token_type_ids=torch.from_numpy(types),
        ).last_hidden_state.numpy()
    got = _port(port, ids, mask, types)
    valid = mask.astype(bool)  # transformers' SDPA path leaves padded rows free
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)


def test_seeded_init_and_config():
    cfg = BertConfig(**TINY)
    a = BertModel(cfg, generator=torch.Generator().manual_seed(7))
    b = BertModel(cfg, generator=torch.Generator().manual_seed(7))
    c = BertModel(cfg, generator=torch.Generator().manual_seed(8))
    sa, sb, sc = a.state_dict(), b.state_dict(), c.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["encoder.layer.0.attention.self.query.weight"],
                           sc["encoder.layer.0.attention.self.query.weight"])
    for name, p in sa.items():
        if "LayerNorm.weight" in name:
            assert torch.all(p == 1)
        elif name.endswith("bias"):
            assert torch.all(p == 0)
    w = sa["embeddings.word_embeddings.weight"]
    assert abs(float(w.std()) - cfg.initializer_range) < 0.003
    # transformers' names and defaults; other config.json keys ignored.
    full = transformers.BertConfig().to_dict()
    assert BertConfig.from_dict(full) == BertConfig()
    with pytest.raises(ValueError):
        BertConfig(hidden_act="relu")
    # No mask and no token types: all attended, type 0.
    ids, _, _ = _batch(seed=2)
    np.testing.assert_array_equal(
        _port(a, ids, np.ones_like(ids), np.zeros_like(ids)),
        _port(a, ids, np.ones_like(ids)),
    )


VOCAB = list(SPECIAL_TOKENS) + [
    "hello", "world", "##s", "run", "##ning", "un", "##aff", "##able",
    "cafe", "naive", ",", "!", ".", "'", "$", "-", "a", "b", "中", "istanbul",
    "σ", "##a", "x", "##y", "3", "##5", "i", "the", "resume", "[", "]",
]
TEXTS = [
    "Hello, WORLD!!",  # case, punctuation
    "runnings unaffable",  # ## pieces
    "Café naïve résumé",  # accents stripped
    "中文 x\x0by",  # CJK padded, a control character dropped
    "İstanbul ΣΑΣ σας",  # lowercase per character
    "it's 3.5$ a-b\tc d e",  # punctuation, unicode whitespace
    "", "   ", "\t\n",  # empty texts: [CLS] [SEP]
    "zzz qqq hellos",  # unknown words
    "a" * 150,  # longer than 100 characters: [UNK]
    "hello " * 40,  # truncated
    "x\x00y�z​q",  # dropped characters
    "[CLS] hello [SEP] [cls]",  # special tokens written in the text
    "3535 x5 xy xyy",
    "ﬁ ligature ¼",
]


@pytest.fixture(scope="module")
def tokenizers(tmp_path_factory):
    path = tmp_path_factory.mktemp("vocab") / "vocab.txt"
    path.write_text("\n".join(VOCAB), encoding="utf-8")
    return (
        WordPieceTokenizer.from_file(path),
        transformers.BertTokenizerFast(vocab_file=str(path)),
    )


@pytest.mark.parametrize("padding", [True, "max_length"])
@pytest.mark.parametrize("max_length", [8, 32, 128])
def test_wordpiece_matches_bert_tokenizer_fast(tokenizers, padding, max_length):
    got_tok, want_tok = tokenizers
    for tensors in ("np", "pt"):
        got = got_tok(TEXTS, padding=padding, truncation=True,
                      max_length=max_length, return_tensors=tensors)
        want = want_tok(TEXTS, padding=padding, truncation=True,
                        max_length=max_length, return_tensors=tensors)
        assert list(got) == list(want)
        for key in want:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(np.asarray(got[key]),
                                          np.asarray(want[key]), err_msg=key)


def test_wordpiece_lists_and_errors(tokenizers):
    got_tok, want_tok = tokenizers
    texts = ["hello world", "runnings", ""]
    assert got_tok(texts) == {k: v for k, v in want_tok(texts).items()}
    assert got_tok.encode("hello, worlds") == want_tok(
        ["hello, worlds"], add_special_tokens=False)["input_ids"][0]
    with pytest.raises(ValueError):
        got_tok(texts, return_tensors="np")  # unequal lengths, no padding
    with pytest.raises(ValueError):
        got_tok(["hello " * 20], padding="max_length", max_length=8)
    with pytest.raises(ValueError):
        WordPieceTokenizer(["hello"])  # no special tokens
