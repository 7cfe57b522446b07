"""Seeded synthetic corpora and queries (counterpart of
``osr_tpu/testing.py:SyntheticDataGenerator``): Zipf-distributed term
streams, identical to ``osr_tpu``'s for the same seed, used by the tests
and ``chip_smoke.py``; and ``osr_tpu/testing.py``'s validators
(:func:`spearman_correlation`, :class:`CorrectnessValidator`), which the
benchmark suites use, and :class:`PerformanceBenchmark`, a public helper
that nothing in the package calls (the suites time their rows with
``utils/timing.py``).

Also the repo's quality fixtures, on this package's modules:
:func:`harvest_chunks` and :func:`build_dataset` are
``tools/bench_quality_at_scale.py``'s prose harvest and BEIR writer (the
same windows, dedup and query recipes, on this package's tokenizer), and
:func:`build_standin_encoder` is ``tools/bench_dense_encoder.py``'s
seeded stand-in encoder on ``bert.py``.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from osr_tpu_torch.index.dense import synthetic_corpus_embeddings
from osr_tpu_torch.utils.timing import block_and_time


class SyntheticDataGenerator:
    """Zipf-distributed corpora/queries and clustered embeddings, seeded."""

    def __init__(self, seed: int = 42):
        self.seed = seed

    def zipf_corpus(
        self,
        num_docs: int,
        vocab_size: int = 10_000,
        avg_len: int = 100,
        word_prefix: str = "term",
        min_len: int = 3,
    ) -> Dict[str, Dict[str, str]]:
        rng = np.random.RandomState(self.seed)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        cum = np.cumsum(probs)
        lengths = np.maximum(
            min_len,
            rng.gamma(2.0, avg_len / 2.0, size=num_docs).astype(np.int64),
        )
        total = int(lengths.sum())
        token_ids = np.searchsorted(cum, rng.rand(total))
        offsets = np.concatenate([[0], np.cumsum(lengths)]).tolist()
        # Each word is formatted once, not once per token (searchsorted can
        # return vocab_size where the cumulative sum rounds below 1).
        words = [f"{word_prefix}{i}" for i in range(vocab_size + 1)]
        tokens = list(map(words.__getitem__, token_ids.tolist()))
        corpus = {}
        for d in range(num_docs):
            corpus[f"doc{d}"] = {
                "text": " ".join(tokens[offsets[d] : offsets[d + 1]]),
                "title": f"Document {d}",
            }
        return corpus

    def queries(
        self,
        num_queries: int,
        vocab_size: int = 10_000,
        avg_terms: int = 8,
        word_prefix: str = "term",
        min_terms: int = 1,
    ) -> Dict[str, str]:
        rng = np.random.RandomState(self.seed + 1)
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        probs = 1.0 / ranks
        probs /= probs.sum()
        cum = np.cumsum(probs)
        out = {}
        for i in range(num_queries):
            n = max(min_terms, int(rng.poisson(avg_terms)))
            ids = np.searchsorted(cum, rng.rand(n))
            out[f"q{i}"] = " ".join(f"{word_prefix}{j}" for j in ids)
        return out

    def embeddings(self, num_docs: int, dim: int = 768) -> np.ndarray:
        return synthetic_corpus_embeddings(num_docs, dim, seed=self.seed)


def spearman_correlation(a: Sequence[float], b: Sequence[float]) -> float:
    """Spearman rank correlation (scipy-free)."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.size < 2:
        return 1.0
    ra = np.argsort(np.argsort(a)).astype(np.float64)
    rb = np.argsort(np.argsort(b)).astype(np.float64)
    ra -= ra.mean()
    rb -= rb.mean()
    denom = np.sqrt((ra**2).sum() * (rb**2).sum())
    return float((ra * rb).sum() / denom) if denom else 0.0


class CorrectnessValidator:
    """Numeric validators with the reference suite's acceptance thresholds."""

    @staticmethod
    def validate_scores(
        got: np.ndarray,
        want: np.ndarray,
        atol: float = 1e-3,
        rtol: float = 1e-3,
    ) -> Dict[str, Any]:
        got = np.asarray(got, dtype=np.float64)
        want = np.asarray(want, dtype=np.float64)
        abs_err = np.abs(got - want)
        rel_err = abs_err / np.maximum(np.abs(want), 1e-9)
        ok = bool(np.all((abs_err <= atol) | (rel_err <= rtol)))
        return {
            "passed": ok,
            "max_abs_error": float(abs_err.max(initial=0.0)),
            "max_rel_error": float(rel_err.max(initial=0.0)),
        }

    @staticmethod
    def validate_topk_ranking(
        got_ids: Sequence[int],
        want_ids: Sequence[int],
        min_overlap: float = 0.9,
    ) -> Dict[str, Any]:
        """Set overlap plus the Spearman correlation of the rank positions
        of the common ids (correlating two already-sorted score lists
        would always report about 1.0)."""
        k = len(want_ids)
        overlap = len(set(got_ids) & set(want_ids)) / k if k else 1.0
        got_pos = {d: i for i, d in enumerate(got_ids)}
        want_pos = {d: i for i, d in enumerate(want_ids)}
        common = [d for d in want_ids if d in got_pos]
        if len(common) >= 2:
            corr = spearman_correlation(
                [got_pos[d] for d in common],
                [want_pos[d] for d in common],
            )
        else:
            corr = 1.0
        return {
            "passed": overlap >= min_overlap,
            "precision_at_k": overlap,
            "rank_spearman": corr,
        }

    @staticmethod
    def validate_quantization(
        original: np.ndarray,
        reconstructed: np.ndarray,
        min_cosine: float = 0.95,
    ) -> Dict[str, Any]:
        original = np.asarray(original, dtype=np.float64)
        reconstructed = np.asarray(reconstructed, dtype=np.float64)
        mse = float(((original - reconstructed) ** 2).mean())
        mae = float(np.abs(original - reconstructed).mean())
        num = (original * reconstructed).sum(axis=-1)
        den = np.linalg.norm(original, axis=-1) * np.linalg.norm(
            reconstructed, axis=-1
        )
        cos = float((num / np.maximum(den, 1e-12)).mean())
        return {
            "passed": cos >= min_cosine,
            "mse": mse,
            "mae": mae,
            "mean_cosine": cos,
        }


class PerformanceBenchmark:
    """Time competing implementations on identical inputs. Each run waits
    for the CUDA devices its result lives on (``utils/timing.py:
    block_and_time``)."""

    def __init__(self, warmup: int = 1, runs: int = 5):
        self.warmup = warmup
        self.runs = runs

    def compare_implementations(
        self,
        implementations: Dict[str, Callable[[], Any]],
        baseline: str,
    ) -> Dict[str, Dict[str, float]]:
        results: Dict[str, Dict[str, float]] = {}
        for name, fn in implementations.items():
            for _ in range(self.warmup):
                block_and_time(fn)
            times = [block_and_time(fn) for _ in range(self.runs)]
            results[name] = {"median_s": float(np.median(times))}
        base = results[baseline]["median_s"]
        for name in results:
            results[name]["speedup_vs_baseline"] = (
                base / results[name]["median_s"]
                if results[name]["median_s"]
                else float("inf")
            )
        return results


# The prose fixture (tools/bench_quality_at_scale.py).
PROSE_EXTS = (".md", ".rst", ".txt")
WINDOW, STRIDE, MIN_WORDS = 48, 24, 24
MAX_GRADE1 = 200  # quotes matching more chunks than this are boilerplate


def harvest_chunks(
    roots: Sequence[str], max_chunks: Optional[int] = None
) -> List[str]:
    """Deterministic 48-word/stride-24 chunks of every .md/.rst/.txt file
    of at least 2 KiB under ``roots`` (missing roots are skipped), exact
    duplicates removed by an md5 of the lowercased window."""
    files = []
    for root in roots:
        rp = Path(root)
        if not rp.exists():
            continue
        files.extend(
            p
            for p in rp.rglob("*")
            if p.suffix in PROSE_EXTS
            and p.is_file()
            and p.stat().st_size >= 2048
        )
    files.sort()
    chunks, seen = [], set()
    for f in files:
        try:
            words = f.read_text(encoding="utf-8").split()
        except (UnicodeDecodeError, OSError):
            continue
        for s in range(0, max(len(words) - MIN_WORDS, 0) + 1, STRIDE):
            w = words[s : s + WINDOW]
            if len(w) < MIN_WORDS:
                break
            key = hashlib.md5(
                " ".join(t.lower() for t in w).encode("utf-8")
            ).digest()
            if key in seen:
                continue
            seen.add(key)
            chunks.append(" ".join(w))
            if max_chunks and len(chunks) >= max_chunks:
                return chunks
    return chunks


def _make_query(
    rng: np.random.RandomState, chunks: Sequence[str], mode: str
) -> Optional[Tuple[int, str, Optional[List[str]]]]:
    """One query attempt: (source chunk, query text, the noisy mode's
    4-word quote), or None when the draw is rejected."""
    src = int(rng.randint(len(chunks)))
    words = chunks[src].split()
    if len(words) < WINDOW:
        return None
    if mode == "sample":
        content = sorted({w for w in (t.lower() for t in words) if len(w) >= 4})
        if len(content) < 6:
            return None
        picks = rng.choice(len(content), size=6, replace=False)
        return src, " ".join(content[p] for p in picks), None
    if mode == "noisy":
        start = int(rng.randint(0, len(words) - 4))
        quote4 = words[start : start + 4]
        other = int(rng.randint(len(chunks)))
        if other == src:
            return None
        noise_pool = sorted(
            {w for w in (t.lower() for t in chunks[other].split()) if len(w) >= 4}
        )
        if len(noise_pool) < 2:
            return None
        npick = rng.choice(len(noise_pool), size=2, replace=False)
        return src, " ".join(quote4 + [noise_pool[p] for p in npick]), quote4
    start = int(rng.randint(0, len(words) - 6))
    return src, " ".join(words[start : start + 6]), None


def build_dataset(
    root: Path, chunks: Sequence[str], num_queries: int, mode: str = "quote"
) -> Tuple[int, int]:
    """Write a BEIR-format dataset under ``root`` (``corpus.jsonl`` with
    ids ``p<i>``, ``queries.jsonl`` with ids ``q<i>``, graded
    ``qrels/test.tsv``); returns (queries made, grade-1 qrels).

    Queries are drawn with seed 42: ``quote`` = 6 verbatim words of a
    full-window chunk; ``sample`` = 6 distinct content words (>= 4 chars)
    of it; ``noisy`` = 4 consecutive source words + 2 content words of
    another chunk. Grade 2 is the source chunk; grade 1 every other chunk
    holding all the query's tokens; a query whose all-token set exceeds
    200 chunks is rejected (and, except in ``noisy``, one its source does
    not hold)."""
    from osr_tpu_torch.index.tokenizer import tokenize

    root = Path(root)
    root.mkdir(parents=True, exist_ok=True)
    with open(root / "corpus.jsonl", "w", encoding="utf-8") as f:
        for i, text in enumerate(chunks):
            f.write(json.dumps({"_id": f"p{i}", "text": text, "title": ""}) + "\n")

    inv: Dict[str, set] = {}
    chunk_toks = []
    for i, text in enumerate(chunks):
        toks = set(tokenize(text))
        chunk_toks.append(toks)
        for t in toks:
            inv.setdefault(t, set()).add(i)

    rng = np.random.RandomState(42)
    (root / "qrels").mkdir(exist_ok=True)
    made = grade1_total = attempts = 0
    with open(root / "queries.jsonl", "w", encoding="utf-8") as fq, open(
        root / "qrels" / "test.tsv", "w", encoding="utf-8"
    ) as ft:
        ft.write("query-id\tcorpus-id\tscore\n")
        while made < num_queries and attempts < num_queries * 50:
            attempts += 1
            drawn = _make_query(rng, chunks, mode)
            if drawn is None:
                continue
            src, quote, quote4 = drawn
            qtoks = set(tokenize(quote))
            if len(qtoks) < 4:
                continue
            cands = None
            for t in sorted(qtoks, key=lambda t: len(inv.get(t, ()))):
                s = inv.get(t, set())
                cands = s.copy() if cands is None else (cands & s)
                if not cands:
                    break
            if mode == "noisy":
                if not set(tokenize(" ".join(quote4))) <= chunk_toks[src]:
                    continue
                cands = cands or set()
                if len(cands) > MAX_GRADE1:
                    continue
            elif not cands or src not in cands or len(cands) > MAX_GRADE1:
                continue
            fq.write(json.dumps({"_id": f"q{made}", "text": quote}) + "\n")
            ft.write(f"q{made}\tp{src}\t2\n")
            grade1 = sorted(cands - {src})
            for c in grade1:
                ft.write(f"q{made}\tp{c}\t1\n")
            grade1_total += len(grade1)
            made += 1
    return made, grade1_total


def build_standin_encoder(
    vocab_terms: Sequence[str],
    hidden: int = 256,
    layers: int = 4,
    seed: int = 0,
    dtype: str = "bfloat16",
    device=None,
):
    """``tools/bench_dense_encoder.py``'s deterministic stand-in on this
    package's modules: a BERT (4 heads, intermediate 4 x hidden, 512
    positions) with weights drawn from a ``torch.Generator`` seeded with
    ``seed`` (not Flax's initialisation, so its name starts ``torch-``)
    over a WordPiece vocabulary of the five specials plus
    ``vocab_terms``; max_length 128, batches of 128, fixed shapes."""
    import torch

    from osr_tpu_torch.bert import (
        SPECIAL_TOKENS,
        BertConfig,
        BertModel,
        WordPieceTokenizer,
    )
    from osr_tpu_torch.encoders import HFEncoder

    tokenizer = WordPieceTokenizer(list(SPECIAL_TOKENS) + list(vocab_terms))
    cfg = BertConfig(
        vocab_size=tokenizer.vocab_size,
        hidden_size=hidden,
        num_hidden_layers=layers,
        num_attention_heads=4,
        intermediate_size=hidden * 4,
        max_position_embeddings=512,
    )
    model = BertModel(cfg, generator=torch.Generator().manual_seed(seed))
    return HFEncoder(
        f"torch-standin-bert-{layers}l-{hidden}h-seed{seed}-{dtype}",
        model=model,
        tokenizer=tokenizer,
        max_length=128,
        batch_size=128,
        pad_to_max=True,
        dtype=dtype,
        device=device,
    )
