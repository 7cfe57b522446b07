"""The RAG experiment runner (counterpart of
``osr_tpu/pipeline/experiment.py``). Each experiment's retriever runs on
the ``device`` of its config block (``cuda`` unless named).

Capability parity with reference
rag_system/pipeline/evaluate_rag_pipeline.py:700-874 (``run_rag_experiment``)
and rag_research_pipeline.py:41-103 (the per-experiment loop with failure
isolation and ``overall_results.json``), with two upgrades:

- retrieval runs in large device batches through the engines (the
  reference re-batches by host RAM and scores query-by-query), and
- the summary includes real retrieval-quality metrics (nDCG/MAP/recall/P@k
  against the qrels) — the reference's ``evaluate`` was a placeholder
  (reference evaluate_rag_pipeline.py:878-884).
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Union

from osr_tpu_torch.index.builder import extract_text
from osr_tpu_torch.metrics.ir import evaluate_retrieval
from osr_tpu_torch.readers.registry import ReaderRegistry
from osr_tpu_torch.retrieval.registry import RetrieverRegistry
from osr_tpu_torch.storage.loaders import (
    extract_query_text,
    load_corpus,
    load_qrels,
    load_queries,
)
from osr_tpu_torch.utils.hardware import detect_hardware_capabilities
from osr_tpu_torch.utils.monitoring import StatsMonitor

logger = logging.getLogger(__name__)

MAX_CONTEXTS = 10
CONTEXT_CHARS = 1000
STORED_CONTEXT_CHARS = 500


def run_rag_experiment(
    exp_cfg: Dict[str, Any],
    global_cfg: Dict[str, Any],
    out_dir: Union[str, Path],
) -> Dict[str, Any]:
    """Run one experiment: load data, build index, retrieve, read, evaluate."""
    out_dir = Path(out_dir)
    start_time = time.perf_counter()

    ds_name = exp_cfg["dataset"]
    ds_path = Path(global_cfg.get("datasets_root", "datasets")) / ds_name
    if not ds_path.exists():
        raise FileNotFoundError(f"Dataset not found: {ds_path}")

    logger.info("Experiment %s on %s", exp_cfg["name"], ds_name)
    corpus = load_corpus(ds_path)
    queries = load_queries(ds_path)
    qrels = load_qrels(ds_path)
    if not corpus or not queries:
        raise ValueError("Failed to load required data")
    load_time = time.perf_counter() - start_time

    hardware = detect_hardware_capabilities()
    retriever = RetrieverRegistry.create(exp_cfg["retriever"])
    reader = ReaderRegistry.create(exp_cfg.get("reader", "extractive"))

    build_start = time.perf_counter()
    retriever.build_index_from_corpus(corpus)
    build_time = time.perf_counter() - build_start

    # The retriever config may be a plain type string (RetrieverRegistry
    # supports it); only mappings carry params.
    retriever_cfg = exp_cfg.get("retriever", {})
    if isinstance(retriever_cfg, Mapping):
        # `params:` with no value parses to None in YAML — treat as empty.
        params = retriever_cfg.get("params") or {}
        top_k = params.get("top_k", 50)
    else:
        top_k = 50
    monitor = StatsMonitor(out_dir / "logs", log_interval=60)

    # Extract query texts; empty ones count as failures up front.
    query_texts: Dict[str, str] = {}
    failed_queries: List[str] = []
    for qid, qobj in queries.items():
        text = extract_query_text(qobj)
        if text:
            query_texts[qid] = text
        else:
            failed_queries.append(qid)

    # Warmup on a small prefix so the steady-state throughput isn't
    # charged for one-time costs (kernel builds, first CUDA allocations).
    # Cleared from the query cache afterwards.
    warm_start = time.perf_counter()
    warm = dict(list(query_texts.items())[:128])
    if warm:
        retriever.search(warm, top_k=top_k)
        if hasattr(retriever, "clear_cache"):
            retriever.clear_cache()
    warmup_time = time.perf_counter() - warm_start

    # Retrieval for ALL queries in engine-sized batches (the engine batches
    # and pipelines on device internally).
    retrieve_start = time.perf_counter()
    retrieved_all = retriever.search(query_texts, top_k=top_k)
    retrieve_time = time.perf_counter() - retrieve_start

    # Reader pass + prediction records.
    read_start = time.perf_counter()
    results: List[Dict[str, Any]] = []
    retrieval_results: Dict[str, Dict[str, float]] = {}
    for qid, query_text in query_texts.items():
        qstat = monitor.start_query(qid)
        try:
            retrieved = retrieved_all.get(qid, {})
            retrieval_results[qid] = retrieved
            contexts: List[str] = []
            valid_retrieved: Dict[str, float] = {}
            for doc_id, score in list(retrieved.items())[:MAX_CONTEXTS]:
                doc = corpus.get(doc_id)
                if doc is None:
                    continue
                text = extract_text(doc)
                if text:
                    contexts.append(text[:CONTEXT_CHARS])
                    valid_retrieved[doc_id] = score
            answer = reader.generate_answer(query_text, contexts)
            results.append(
                {
                    "qid": qid,
                    "query": query_text,
                    "answer": answer,
                    "contexts": [
                        {"docid": doc_id, "text": ctx[:STORED_CONTEXT_CHARS]}
                        for doc_id, ctx in zip(valid_retrieved, contexts)
                    ],
                    "retriever_scores": valid_retrieved,
                }
            )
            monitor.end_query(qstat, num_results=len(retrieved))
        except Exception as e:  # per-query isolation
            logger.warning("Query %s failed: %s", qid, e)
            failed_queries.append(qid)
            monitor.end_query(qstat, error=str(e))

    read_time = time.perf_counter() - read_start
    total_time = time.perf_counter() - start_time
    processing_time = total_time - build_time - warmup_time
    qps = len(results) / processing_time if processing_time > 0 else 0.0

    # Only evaluate at cutoffs the retrieval depth actually covers —
    # recall@100 over top_k=50 lists would be silently understated.
    evaluate_start = time.perf_counter()
    k_values = tuple(sorted({k for k in (10, 100) if k <= top_k} | {top_k}))
    quality = (
        evaluate_retrieval(retrieval_results, qrels, k_values=k_values)
        if qrels
        else {}
    )
    evaluate_time = time.perf_counter() - evaluate_start

    write_start = time.perf_counter()
    out_dir.mkdir(parents=True, exist_ok=True)
    preds_path = out_dir / f"{exp_cfg['name']}_preds.json"
    with open(preds_path, "w", encoding="utf-8") as f:
        json.dump(results, f, indent=2, ensure_ascii=False)
    write_time = time.perf_counter() - write_start

    summary = {
        "name": exp_cfg["name"],
        "dataset": ds_name,
        "num_queries": len(queries),
        "num_corpus": len(corpus),
        "queries_processed": len(results),
        "queries_failed": len(failed_queries),
        "build_time_s": build_time,
        "warmup_time_s": warmup_time,
        "retrieve_time_s": retrieve_time,
        "total_time_s": total_time,
        "processing_time_s": processing_time,
        "queries_per_second": qps,
        "retrieval_qps": (
            len(query_texts) / retrieve_time if retrieve_time > 0 else 0.0
        ),
        "quality": quality,
        # Wall seconds of each stage (this package's addition to the
        # summary): data loading, index build, warmup, retrieval of every
        # query, the reader loop, evaluation, the preds file.
        "stage_times_s": {
            "load": load_time,
            "build": build_time,
            "warmup": warmup_time,
            "retrieve": retrieve_time,
            "read": read_time,
            "evaluate": evaluate_time,
            "write_preds": write_time,
        },
        "hardware_info": hardware,
        "monitor": monitor.get_current_stats(),
        "top_k": top_k,
    }
    with open(out_dir / f"{exp_cfg['name']}_summary.json", "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=2, ensure_ascii=False)
    monitor.flush()

    logger.info(
        "Experiment %s: %d/%d queries, %.1f QPS, build %.2fs%s",
        exp_cfg["name"],
        len(results),
        len(queries),
        qps,
        build_time,
        f", nDCG@10={quality.get('ndcg@10', 0):.4f}" if quality else "",
    )
    return summary


def run_all_experiments(
    config: Dict[str, Any], out_root: Optional[Union[str, Path]] = None
) -> Dict[str, Any]:
    """Loop experiments with per-experiment failure isolation and write
    ``overall_results.json`` (reference rag_research_pipeline.py:41-103)."""
    out_root = Path(out_root or config.get("output_dir", "results"))
    overall: Dict[str, Any] = {}
    for exp in config["experiments"]:
        name = exp["name"]
        try:
            overall[name] = run_rag_experiment(exp, config, out_root)
            overall[name]["status"] = "ok"
        except Exception as e:
            logger.error("Experiment %s failed: %s", name, e)
            overall[name] = {"status": "failed", "error": str(e)}
    out_root.mkdir(parents=True, exist_ok=True)
    with open(out_root / "overall_results.json", "w", encoding="utf-8") as f:
        json.dump(overall, f, indent=2, ensure_ascii=False)
    return overall
