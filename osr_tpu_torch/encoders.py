"""Text encoders for the dense retrieval path (counterpart of
``osr_tpu/encoders.py``).

:class:`HFEncoder` is the neural encoder: a BERT-style transformer
(``bert.py:BertModel``, or any module returning ``.last_hidden_state``)
on the card, mean-pooled over non-padding tokens and L2-normalized, the
standard sentence-embedding recipe (and Contriever's)::

    encoder = HFEncoder("contriever-standin", model=model, tokenizer=tok)
    retriever = RetrieverRegistry.create({
        "type": "contriever",
        "params": {
            "embedding_fn": encoder.encode,
            "query_embedding_fn": encoder.encode_one,
        },
    })

:class:`HashingEncoder` is a deterministic lexical encoder with no model
weights: signed feature hashing of word unigrams and bigrams, optionally
IDF-weighted, L2-normalized. Its vectors are bit-identical to
``osr_tpu``'s, with the shared C++ runtime and without it, and a state saved
by either package's :meth:`HashingEncoder.save` loads in the other. It is
the dense leg of the ``hashing_idf`` hybrid retriever.

:func:`encode_corpus_to_npy` materializes corpus embeddings to a ``.npy``
file consumable by ``QuantizedDenseRetriever(embeddings_path=...)``.

The HashingEncoder runs on the host (NumPy and the C++ runtime); its
vectors reach the card through ``DenseSearchEngine``.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class HFEncoder:
    """Mean-pooling sentence encoder over a BERT-style transformer.

    The constructor is ``osr_tpu``'s, plus ``device`` (``cuda`` unless the
    caller names another). ``model`` is this package's ``BertModel`` or any
    module whose output has ``.last_hidden_state``; it is moved to
    ``device`` and ``dtype`` in place. ``tokenizer`` is called as
    ``tokenizer(texts, padding, truncation, max_length, return_tensors)``
    (``bert.py:WordPieceTokenizer``, or a ``transformers`` tokenizer).
    Without them, both are loaded from ``model_name`` through
    ``transformers`` (the state dict into this package's ``BertModel``).

    ``dtype="bfloat16"`` runs the forward in bf16 and pools in it, as
    ``osr_tpu``'s Flax backend does; outputs are f32 either way. With
    ``pad_to_max`` every batch is (``batch_size``, ``max_length``): the
    tail batch gets empty filler texts, sliced off after pooling."""

    def __init__(
        self,
        model_name: str,
        max_length: int = 256,
        batch_size: int = 64,
        backend: str = "auto",  # 'auto' | 'torch': the only forward here
        model=None,
        tokenizer=None,
        pad_to_max: bool = False,
        dtype: str = "float32",
        device=None,
    ):
        from osr_tpu_torch.retrieval.engine import resolve_device

        if backend not in ("auto", "torch"):
            raise ValueError(
                f"backend {backend!r}: this package runs the torch forward "
                "only ('auto' or 'torch')"
            )
        if dtype not in _DTYPES:
            raise ValueError(f"dtype {dtype!r}: one of {sorted(_DTYPES)}")
        self.model_name = model_name
        self.max_length = max_length
        self.batch_size = batch_size
        self.pad_to_max = pad_to_max
        self.backend = "torch"
        self.dtype = _DTYPES[dtype]
        self.device = resolve_device(device)
        if tokenizer is None or model is None:
            try:
                import transformers
            except ImportError as e:
                raise ImportError(
                    "HFEncoder without model= and tokenizer= loads them "
                    "through `transformers`, which is not installed; pass "
                    "model= (e.g. osr_tpu_torch.bert.BertModel) and "
                    "tokenizer= (e.g. osr_tpu_torch.bert.WordPieceTokenizer)"
                ) from e
            if tokenizer is None:
                tokenizer = transformers.AutoTokenizer.from_pretrained(
                    model_name
                )
            if model is None:
                from osr_tpu_torch.convert import bert_from_torch_state_dict

                hf = transformers.AutoModel.from_pretrained(model_name)
                model = bert_from_torch_state_dict(
                    hf.config.to_dict(), hf.state_dict()
                )
        self.tokenizer = tokenizer
        self.model = model.to(device=self.device, dtype=self.dtype).eval()
        logger.info("HFEncoder %s on %s (%s)", model_name, self.device, dtype)

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        """(len(texts), hidden) float32, mean-pooled + L2-normalized."""
        chunks = [
            self._encode_batch(list(texts[i : i + self.batch_size]))
            for i in range(0, len(texts), self.batch_size)
        ]
        if not chunks:
            return np.zeros((0, 0), np.float32)
        return np.concatenate(chunks, axis=0)

    def encode_one(self, text: str) -> np.ndarray:
        return self.encode([text])[0]

    def _tokenize(self, texts: List[str]):
        if self.pad_to_max and len(texts) < self.batch_size:
            texts = list(texts) + [""] * (self.batch_size - len(texts))
        return self.tokenizer(
            texts,
            padding="max_length" if self.pad_to_max else True,
            truncation=True,
            max_length=self.max_length,
            return_tensors="pt",
        )

    @torch.inference_mode()
    def _encode_batch(self, texts: List[str]) -> np.ndarray:
        n = len(texts)  # pad_to_max may append filler rows; slice back
        batch = {
            k: torch.as_tensor(v).to(self.device)
            for k, v in self._tokenize(texts).items()
        }
        hidden = self.model(**batch).last_hidden_state  # (B, T, H)
        mask = batch["attention_mask"][..., None].to(hidden.dtype)
        pooled = (hidden * mask).sum(dim=1) / mask.sum(dim=1).clamp(min=1)
        pooled = pooled[:n].float()
        norm = torch.linalg.vector_norm(pooled, dim=-1, keepdim=True)
        return (pooled / norm.clamp(min=1e-8)).cpu().numpy()


class HashingEncoder:
    """Deterministic lexical encoder: signed feature hashing of word
    unigrams + bigrams into a dense D-dim vector, L2-normalized.

    This is a REAL (if classical) text encoder — cosine similarity over
    its vectors approximates lexical bag-of-ngrams cosine (a random
    signed projection preserves inner products in expectation), so dense
    retrieval built on it has *measurable* ranking quality against
    qrels. That is what the synthetic clustered embeddings (the
    reference's approach, retriever_registry.py:409-433) cannot provide:
    their geometry is independent of the text, so dense nDCG against
    real qrels is noise. Use it where no neural checkpoint is available
    (offline environments) or as a fast first-stage encoder.

    No model weights, no randomness: blake2b feature hashes make every
    vector a pure function of the text (plus, with ``idf=True``, of the
    fitted corpus).

    ``idf=True`` adds smooth-IDF feature weighting (sklearn convention:
    ``ln((1+N)/(1+df)) + 1``): :meth:`fit` counts document frequencies
    over the corpus, and both document and query vectors weight each
    feature by its IDF — without it, stopword-dominated cosine drags
    dense quality on real prose. :meth:`encode` auto-fits on its FIRST
    call (the registry's build path encodes the whole corpus first), and
    never refits, so later batch encodes (e.g. queries) stay consistent.
    """

    # Bounded caches (Zipf vocab: hot features dominate, so a cap keeps
    # memory flat on bigram-heavy corpora while capturing most hits).
    _FEAT_CACHE_MAX = 1 << 21

    def __init__(
        self,
        dim: int = 768,
        ngrams: int = 2,
        idf: bool = False,
        native: str = "auto",  # 'auto' | 'force' | 'off' — the C++ core
        #   (csrc/host_runtime.cc:henc_*) featurizes/hashes/accumulates
        #   with bit-identical vectors (re.findall tokenization stays in
        #   Python for exact unicode semantics); 'auto' falls back to pure
        #   Python when the runtime cannot be loaded.
    ):
        if dim <= 0:
            raise ValueError(f"dim must be positive (got {dim})")
        self.dim = int(dim)
        self.ngrams = int(ngrams)
        self.idf = bool(idf)
        self._df: Optional[dict] = None
        self._n_docs = 0
        self._fitted = False
        # feat -> (column, sign * idf): one blake2b + one log per unique
        # feature instead of per occurrence. Invalidated by fit() (idf
        # changes); identical numerics to the uncached path.
        self._feat_cache: dict = {}
        # tf -> 1 + np.log(tf): np.log for bit-identity with the
        # uncached scalar path (libm vs SIMD log can differ by 1 ulp).
        self._tf_cache: dict = {}
        self._nb = None
        if native in ("auto", "force"):
            try:
                from osr_tpu_torch.native import NativeHashingBackend

                self._nb = NativeHashingBackend(
                    self.dim, self.ngrams, self.idf
                )
            except ImportError:
                if native == "force":
                    raise
        elif native != "off":
            raise ValueError(f"native must be auto|force|off (got {native!r})")

    def _features(self, text: str):
        import re

        words = re.findall(r"\b\w+\b", text.lower())
        feats = list(words)
        for n in range(2, self.ngrams + 1):
            feats.extend(
                " ".join(words[i : i + n])
                for i in range(len(words) - n + 1)
            )
        return feats

    @staticmethod
    def _hash(feat: str) -> int:
        import hashlib

        return int.from_bytes(
            hashlib.blake2b(feat.encode("utf-8"), digest_size=8).digest(),
            "little",
        )

    def _token_bytes(self, text: str) -> bytes:
        """'\\0'-joined utf-8 tokens for the native backend — the same
        token stream _features consumes, so featurization is identical."""
        import re

        return "\x00".join(re.findall(r"\b\w+\b", text.lower())).encode(
            "utf-8"
        )

    def fit(self, texts: Sequence[str]) -> "HashingEncoder":
        """Count per-feature document frequencies for IDF weighting."""
        if self._nb is not None:
            self._nb.fit([self._token_bytes(t) for t in texts])
            self._df = None  # lives native-side; _idf() queries it there
        else:
            df: dict = {}
            for t in texts:
                for h in {self._hash(f) for f in self._features(t)}:
                    df[h] = df.get(h, 0) + 1
            self._df = df
        self._n_docs = len(texts)
        self._fitted = True
        self._feat_cache.clear()  # cached sign*idf entries are now stale
        return self

    def _idf(self, h: int) -> float:
        if not self.idf:
            return 1.0
        if self._nb is not None:
            return self._nb.idf(h)
        df = self._df.get(h, 0) if self._df else 0
        return float(np.log((1.0 + self._n_docs) / (1.0 + df)) + 1.0)

    def _entry(self, feat: str):
        """(column, sign * idf) for a feature, cached per unique feature."""
        e = self._feat_cache.get(feat)
        if e is None:
            h = self._hash(feat)
            e = (
                (h >> 1) % self.dim,
                (1.0 if h & 1 else -1.0) * self._idf(h),
            )
            if len(self._feat_cache) < self._FEAT_CACHE_MAX:
                self._feat_cache[feat] = e
        return e

    @staticmethod
    def _normalize_rows(emb: np.ndarray) -> np.ndarray:
        """Per-row L2 normalize in place, with the exact per-vector
        np.linalg.norm numerics of the original scalar path (a batched
        axis-norm sums in a different order and is NOT bit-identical)."""
        for i in range(emb.shape[0]):
            n = float(np.linalg.norm(emb[i]))
            if n > 0:
                emb[i] /= n
        return emb

    def save(self, path) -> None:
        """Persist the encoder config + fitted IDF state to ``.npz``.

        Required whenever doc embeddings are materialized in one process
        (``encode_corpus_to_npy`` + ``embeddings_path``) and queries are
        encoded in another: an unfitted idf encoder silently weights
        every feature 1.0, degrading to the plain hashing geometry while
        the cached doc vectors carry IDF."""
        from pathlib import Path as _P

        if self._nb is not None:
            keys, vals = self._nb.export_df()
        elif self._df:
            keys = np.fromiter(self._df.keys(), dtype=np.uint64,
                               count=len(self._df))
            vals = np.fromiter(self._df.values(), dtype=np.int32,
                               count=len(self._df))
            order = np.argsort(keys, kind="stable")
            keys, vals = keys[order], vals[order]
        else:
            keys = np.empty(0, np.uint64)
            vals = np.empty(0, np.int32)
        _P(path).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            path,
            dim=self.dim,
            ngrams=self.ngrams,
            idf=int(self.idf),
            fitted=int(self._fitted),
            n_docs=self._n_docs,
            df_keys=keys,
            df_vals=vals,
        )

    @classmethod
    def load(cls, path, native: str = "auto") -> "HashingEncoder":
        """Restore an encoder saved with :meth:`save` (any backend —
        vectors are bit-identical across the native and pure-Python
        backends)."""
        with np.load(path) as z:
            enc = cls(
                dim=int(z["dim"]),
                ngrams=int(z["ngrams"]),
                idf=bool(int(z["idf"])),
                native=native,
            )
            if int(z["fitted"]):
                keys = z["df_keys"]
                vals = z["df_vals"]
                n_docs = int(z["n_docs"])
                if enc._nb is not None:
                    enc._nb.import_df(keys, vals, n_docs)
                else:
                    enc._df = dict(
                        zip((int(k) for k in keys), (int(v) for v in vals))
                    )
                enc._n_docs = n_docs
                enc._fitted = True
        return enc

    def encode_one(self, text: str) -> np.ndarray:
        if self.idf and not self._fitted:
            logger.warning(
                "HashingEncoder(idf=True).encode_one before fit(): IDF "
                "weights degenerate to 1.0 — fit on the corpus first (or "
                "HashingEncoder.load a saved state) so query vectors "
                "match the document vectors"
            )
        if self._nb is not None:
            emb = self._nb.encode([self._token_bytes(text)])
            return self._normalize_rows(emb)[0]
        from collections import Counter

        counts = Counter(self._features(text))
        tf = self._tf_cache
        cols = np.empty(len(counts), dtype=np.int64)
        vals = np.empty(len(counts), dtype=np.float64)
        for i, (feat, cnt) in enumerate(counts.items()):
            col, signed_idf = self._entry(feat)
            # Sublinear TF (1 + log tf): raw counts let one repeated
            # token dominate the vector.
            t = tf.get(cnt)
            if t is None:
                t = tf[cnt] = 1.0 + float(np.log(cnt))
            cols[i] = col
            vals[i] = signed_idf * t
        v = np.zeros(self.dim, dtype=np.float32)
        # Unbuffered scatter-add in feature order — the same additions in
        # the same order as the scalar loop it replaces (bit-identical).
        np.add.at(v, cols, vals)
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    def encode(self, texts: Sequence[str]) -> np.ndarray:
        if self._nb is not None:
            toks = [self._token_bytes(t) for t in texts]
            if self.idf and not self._fitted:  # tokenize once, fit+encode
                self._nb.fit(toks)
                self._df = None
                self._n_docs = len(texts)
                self._fitted = True
                self._feat_cache.clear()
            emb = self._nb.encode(toks)
            return self._normalize_rows(emb)
        if self.idf and not self._fitted:
            self.fit(texts)
        return np.stack([self.encode_one(t) for t in texts])



def encode_corpus_to_npy(
    corpus,
    encoder,
    out_path: Union[str, Path],
) -> Path:
    """Encode every corpus document with ``encoder.encode`` and write (N, D)
    float32 to ``.npy``.

    Row order follows the corpus mapping's iteration order, the order
    ``QuantizedDenseRetriever.build_index_from_corpus`` assigns doc ids, so
    the file can be passed as its ``embeddings_path``.
    """
    from osr_tpu_torch.index.builder import extract_text

    texts = [extract_text(doc) for doc in corpus.values()]
    emb = encoder.encode(texts)
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.save(out_path, emb)
    logger.info("Wrote %s embeddings to %s", emb.shape, out_path)
    return out_path
