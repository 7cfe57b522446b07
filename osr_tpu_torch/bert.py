"""A BERT encoder and its WordPiece tokenizer, owned by this package.

``osr_tpu``'s ``HFEncoder`` takes its transformer and tokenizer from
``transformers`` (``FlaxBertModel``, ``BertTokenizerFast``). This package
runs where ``transformers`` is not installed, so it carries both itself:

- :class:`BertConfig` has ``transformers``' field names and defaults, so a
  checkpoint's ``config.json`` loads through :meth:`BertConfig.from_dict`.
- :class:`BertModel` is BERT's encoder stack in plain PyTorch ops (no
  pooler, inference only): its parameter names are ``transformers``'
  ``BertModel``'s, so that model's state dict loads unchanged, and
  ``convert.py:bert_from_flax_params`` carries ``FlaxBertModel``'s
  parameters across. The attention is written out (scaled query, key
  mask added as ``finfo.min``, softmax) as Flax computes it, rather than
  through a fused attention call, so f32 results stay within 1e-5 of
  ``FlaxBertModel``'s.
- :class:`WordPieceTokenizer` reproduces ``BertTokenizerFast`` for an
  uncased vocabulary: the same ids, attention mask and token type ids.

``osr_tpu`` runs the forward through XLA outside any Pallas kernel, so no
hand-written kernel stands behind this module.
"""

from __future__ import annotations

import dataclasses
import math
import re
import unicodedata
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass
class BertConfig:
    """BERT's shape (``transformers.BertConfig``'s names and defaults:
    BERT-base, uncased vocabulary)."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0

    def __post_init__(self):
        if self.hidden_act != "gelu":
            raise ValueError(
                f"hidden_act {self.hidden_act!r} is not supported (gelu only)"
            )
        if self.hidden_size % self.num_attention_heads:
            raise ValueError("hidden_size must divide by num_attention_heads")

    @classmethod
    def from_dict(cls, cfg: Mapping) -> "BertConfig":
        """From a ``config.json``-style mapping; other keys are ignored."""
        names = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in cfg.items() if k in names})


@dataclasses.dataclass
class BertOutput:
    last_hidden_state: torch.Tensor  # (B, T, hidden)


class BertEmbeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(
            cfg.max_position_embeddings, cfg.hidden_size
        )
        self.token_type_embeddings = nn.Embedding(
            cfg.type_vocab_size, cfg.hidden_size
        )
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, input_ids, token_type_ids):
        positions = torch.arange(input_ids.shape[1], device=input_ids.device)
        x = (
            self.word_embeddings(input_ids)
            + self.position_embeddings(positions)[None]
            + self.token_type_embeddings(token_type_ids)
        )
        return self.LayerNorm(x)


class BertSelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.heads = cfg.num_attention_heads
        self.head_dim = cfg.hidden_size // cfg.num_attention_heads
        self.query = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.key = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.value = nn.Linear(cfg.hidden_size, cfg.hidden_size)

    def _split(self, x):  # (B, T, H) -> (B, heads, T, head_dim)
        b, t, _ = x.shape
        return x.view(b, t, self.heads, self.head_dim).transpose(1, 2)

    def forward(self, x, key_bias):
        # Flax scales the query before the product; so does this.
        q = self._split(self.query(x)) / math.sqrt(self.head_dim)
        k = self._split(self.key(x))
        v = self._split(self.value(x))
        probs = torch.softmax(q @ k.transpose(-1, -2) + key_bias, dim=-1)
        ctx = (probs @ v).transpose(1, 2)
        return ctx.reshape(x.shape)


class BertSelfOutput(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertAttention(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.self = BertSelfAttention(cfg)
        self.output = BertSelfOutput(cfg)

    def forward(self, x, key_bias):
        return self.output(self.self(x, key_bias), x)


class BertIntermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)

    def forward(self, x):
        return F.gelu(self.dense(x))  # exact (erf) GELU


class BertOutputLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.intermediate_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h, residual):
        return self.LayerNorm(self.dense(h) + residual)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.attention = BertAttention(cfg)
        self.intermediate = BertIntermediate(cfg)
        self.output = BertOutputLayer(cfg)

    def forward(self, x, key_bias):
        a = self.attention(x, key_bias)
        return self.output(self.intermediate(a), a)


class BertEncoder(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(cfg) for _ in range(cfg.num_hidden_layers)
        )

    def forward(self, x, key_bias):
        for layer in self.layer:
            x = layer(x, key_bias)
        return x


class BertModel(nn.Module):
    """BERT's encoder stack; ``forward`` returns ``last_hidden_state``.

    Parameters are created on the CPU and drawn from ``generator``
    (N(0, ``initializer_range``) weights and embeddings, zero biases,
    LayerNorm 1/0), so a seed gives the same model on every device; move
    it with ``.to(device)``."""

    def __init__(
        self, config: BertConfig, generator: Optional[torch.Generator] = None
    ):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config)
        self.encoder = BertEncoder(config)
        self.eval()
        with torch.no_grad():
            for name, p in self.named_parameters():
                if "LayerNorm" in name:
                    p.fill_(1.0 if name.endswith("weight") else 0.0)
                elif name.endswith("bias"):
                    p.zero_()
                else:
                    p.normal_(0.0, config.initializer_range, generator=generator)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
    ) -> BertOutput:
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = self.embeddings(input_ids, token_type_ids)
        # Additive key mask, (B, 1, 1, T): 0 where attended, the dtype's
        # most negative finite value where masked (Flax's bias).
        key_bias = torch.where(
            attention_mask[:, None, None, :] > 0,
            torch.zeros((), dtype=x.dtype, device=x.device),
            torch.full((), torch.finfo(x.dtype).min, dtype=x.dtype,
                       device=x.device),
        )
        return BertOutput(self.encoder(x, key_bias))


# ---------------------------------------------------------------------------
# WordPiece tokenization (BertTokenizerFast, uncased)
# ---------------------------------------------------------------------------

SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
MAX_CHARS_PER_WORD = 100  # longer words become [UNK], as in WordPiece
_SPLIT_CACHE_MAX = 1 << 18
# A special token written in the text is one token, matched before any
# normalization (the fast tokenizer's added tokens).
_SPECIAL_RE = re.compile("(" + "|".join(map(re.escape, SPECIAL_TOKENS)) + ")")

# Rust's char::is_whitespace (the Unicode White_Space property), which the
# fast tokenizer's normalizer maps to a space.
_WHITESPACE = frozenset(
    "\t\n\x0b\x0c\r \x85\xa0\u1680\u2028\u2029\u202f\u205f\u3000"
    + "".join(chr(c) for c in range(0x2000, 0x200B))
)
_ASCII_PUNCT = frozenset(chr(c) for c in range(33, 127)
                         if not chr(c).isalnum())
_ASCII_WORD_RE = re.compile(r"[^\s!-/:-@\[-`{-~]+|[!-/:-@\[-`{-~]")
# The normalizer on ASCII: tab, LF and CR become spaces, every other
# control character is dropped.
_ASCII_CLEAN = {c: None for c in (*range(32), 0x7F)}
_ASCII_CLEAN.update({9: 32, 10: 32, 13: 32})
_CJK_RANGES = (
    (0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
    (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
    (0xF900, 0xFAFF), (0x2F800, 0x2FA1F),
)


def _is_cjk(cp: int) -> bool:
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _is_punct(ch: str) -> bool:
    return ch in _ASCII_PUNCT or unicodedata.category(ch).startswith("P")


def _normalize(text: str) -> str:
    """BertNormalizer (clean text, pad CJK, strip accents, lowercase), in
    the fast tokenizer's order: accents are stripped before lowercasing,
    and lowercasing goes character by character."""
    out = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD:
            continue
        if ch not in "\t\n\r" and unicodedata.category(ch) in (
            "Cc", "Cf", "Cs", "Co", "Cn"
        ):
            continue
        if ch in _WHITESPACE:
            out.append(" ")
        elif _is_cjk(cp):
            out.append(f" {ch} ")
        else:
            out.append(ch)
    text = unicodedata.normalize("NFD", "".join(out))
    return "".join(
        ch.lower() for ch in text if unicodedata.category(ch) != "Mn"
    )


def _split_words(text: str) -> List[str]:
    """Whitespace split, then each punctuation character on its own
    (BertPreTokenizer)."""
    words: List[str] = []
    for chunk in text.split(" "):
        start = 0
        for i, ch in enumerate(chunk):
            if _is_punct(ch):
                if i > start:
                    words.append(chunk[start:i])
                words.append(ch)
                start = i + 1
        if start < len(chunk):
            words.append(chunk[start:])
    return words


def _pre_tokenize(text: str) -> List[str]:
    if text.isascii():
        # The same steps at C speed: no accents or CJK in ASCII, and the
        # punctuation is ASCII's.
        return _ASCII_WORD_RE.findall(text.translate(_ASCII_CLEAN).lower())
    return [w for w in _split_words(_normalize(text)) if w]


class WordPieceTokenizer:
    """``BertTokenizerFast`` over an uncased WordPiece vocabulary, with the
    call signature ``HFEncoder`` uses: ``tokenizer(texts, padding,
    truncation, max_length, return_tensors)``. Returns ``input_ids``,
    ``token_type_ids`` (zeros) and ``attention_mask``, each sequence as
    ``[CLS] pieces [SEP]``, right-padded with ``[PAD]``."""

    def __init__(self, vocab: Sequence[str]):
        """``vocab``: the tokens, each id its position."""
        self.vocab: Dict[str, int] = {tok: i for i, tok in enumerate(vocab)}
        missing = [t for t in SPECIAL_TOKENS if t not in self.vocab]
        if missing:
            raise ValueError(f"vocabulary lacks {missing}")
        self.pad_id = self.vocab["[PAD]"]
        self.unk_id = self.vocab["[UNK]"]
        self.cls_id = self.vocab["[CLS]"]
        self.sep_id = self.vocab["[SEP]"]
        # Pieces of words that are not whole vocabulary entries, bounded.
        self._split_cache: Dict[str, List[int]] = {}

    @classmethod
    def from_file(cls, path: Union[str, Path]) -> "WordPieceTokenizer":
        """From a ``vocab.txt``: one token per line, ids by line number."""
        lines = Path(path).read_text(encoding="utf-8").split("\n")
        if lines and lines[-1] == "":
            lines.pop()
        return cls(lines)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    def _word_ids(self, word: str) -> List[int]:
        """Greedy longest-match-first pieces; ``[UNK]`` for the whole word
        when some part has no piece."""
        hit = self.vocab.get(word)
        if hit is not None:
            return [hit]
        if len(word) > MAX_CHARS_PER_WORD:
            return [self.unk_id]
        ids, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                hit = self.vocab.get(piece)
                if hit is not None:
                    break
                end -= 1
            if hit is None:
                return [self.unk_id]
            ids.append(hit)
            start = end
        return ids

    def _piece_ids(self, words: List[str]) -> List[int]:
        get = self.vocab.get
        ids = [get(w, -1) for w in words]  # whole words: one lookup each
        misses = [j for j, i in enumerate(ids) if i < 0]
        for j in reversed(misses):  # from the end: earlier indices hold
            w = words[j]
            pieces = self._split_cache.get(w)
            if pieces is None:
                if len(self._split_cache) >= _SPLIT_CACHE_MAX:
                    self._split_cache.clear()
                pieces = self._split_cache[w] = self._word_ids(w)
            ids[j : j + 1] = pieces
        return ids

    def encode(self, text: str) -> List[int]:
        """The piece ids of one text, without [CLS] and [SEP]."""
        ids: List[int] = []
        for part in _SPECIAL_RE.split(text):
            if part in SPECIAL_TOKENS:
                ids.append(self.vocab[part])
            elif part:
                ids.extend(self._piece_ids(_pre_tokenize(part)))
        return ids

    def __call__(
        self,
        texts: Sequence[str],
        padding: Union[bool, str] = False,
        truncation: bool = False,
        max_length: Optional[int] = None,
        return_tensors: Optional[str] = None,
    ):
        rows = []
        for text in texts:
            ids = self.encode(text)
            if truncation and max_length is not None:
                ids = ids[: max(max_length - 2, 0)]
            rows.append([self.cls_id] + ids + [self.sep_id])
        longest = max((len(r) for r in rows), default=0)
        if padding == "max_length":
            if max_length is None or longest > max_length:
                raise ValueError(
                    "padding='max_length' needs max_length at least the "
                    "longest sequence (pass truncation=True)"
                )
            width = max_length
        elif padding:
            width = longest
        elif return_tensors is not None and any(
            len(r) != longest for r in rows
        ):
            raise ValueError("sequences of unequal length need padding")
        else:
            width = None
        if return_tensors is None:
            batch: Dict[str, list] = {
                "input_ids": [], "token_type_ids": [], "attention_mask": []
            }
            for r in rows:
                pad = (width or len(r)) - len(r)
                batch["input_ids"].append(r + [self.pad_id] * pad)
                batch["token_type_ids"].append([0] * (len(r) + pad))
                batch["attention_mask"].append([1] * len(r) + [0] * pad)
            return batch
        input_ids = np.full((len(rows), longest if width is None else width),
                            self.pad_id, np.int64)
        mask = np.zeros_like(input_ids)
        for i, r in enumerate(rows):
            input_ids[i, : len(r)] = r
            mask[i, : len(r)] = 1
        arrays = {
            "input_ids": input_ids,
            "token_type_ids": np.zeros_like(input_ids),
            "attention_mask": mask,
        }
        if return_tensors == "np":
            return arrays
        if return_tensors == "pt":
            return {k: torch.from_numpy(v) for k, v in arrays.items()}
        raise ValueError(f"return_tensors {return_tensors!r}: 'np' or 'pt'")
