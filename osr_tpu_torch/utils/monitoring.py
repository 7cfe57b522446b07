"""Per-query statistics and performance monitoring (counterpart of
``osr_tpu/utils/monitoring.py``).

Capability parity with reference rag_system/core/monitoring.py: per-query
wall-clock tracking (start_query/end_query :95-116), a rolling latency
window, aggregate system stats, and periodic JSONL stat logs
(stats_YYYYMMDD.jsonl :118-140). Extended with latency percentiles and
CUDA device-memory introspection.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import time
from collections import deque
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional, Union

import numpy as np
import torch

logger = logging.getLogger(__name__)


from osr_tpu_torch.utils.timing import process_rss_mb as _process_rss_mb


def device_memory_stats() -> Dict[str, float]:
    """Per-card memory allocated by this process's tensors, MB (empty
    without a card)."""
    out: Dict[str, float] = {}
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            stats = torch.cuda.memory_stats(i)
            out[f"cuda:{i}"] = stats.get("allocated_bytes.all.current", 0) / 2**20
    return out


@dataclasses.dataclass
class QueryStats:
    """Timing record of one query (reference monitoring.py:16-24)."""

    query_id: str
    start_time: float
    end_time: float = 0.0
    num_results: int = 0
    latency_ms: float = 0.0
    error: Optional[str] = None


@dataclasses.dataclass
class SystemStats:
    """Aggregate counters with a rolling latency window
    (reference monitoring.py:26-76)."""

    total_queries: int = 0
    successful_queries: int = 0
    failed_queries: int = 0
    min_latency_ms: float = float("inf")
    max_latency_ms: float = 0.0
    total_results: int = 0
    memory_usage_mb: float = 0.0
    window_size: int = 100

    def __post_init__(self):
        self._latencies = deque(maxlen=self.window_size)

    def update(self, q: QueryStats) -> None:
        self.total_queries += 1
        if q.error:
            self.failed_queries += 1
        else:
            self.successful_queries += 1
            self.total_results += q.num_results
            self._latencies.append(q.latency_ms)
            self.min_latency_ms = min(self.min_latency_ms, q.latency_ms)
            self.max_latency_ms = max(self.max_latency_ms, q.latency_ms)
        self.memory_usage_mb = _process_rss_mb()

    def to_dict(self) -> Dict:
        lat = list(self._latencies)
        d = {
            "total_queries": self.total_queries,
            "successful_queries": self.successful_queries,
            "failed_queries": self.failed_queries,
            "avg_latency_ms": float(np.mean(lat)) if lat else 0.0,
            "p50_latency_ms": float(np.percentile(lat, 50)) if lat else 0.0,
            "p95_latency_ms": float(np.percentile(lat, 95)) if lat else 0.0,
            "min_latency_ms": (
                self.min_latency_ms
                if self.min_latency_ms != float("inf")
                else 0.0
            ),
            "max_latency_ms": self.max_latency_ms,
            "total_results": self.total_results,
            "memory_usage_mb": self.memory_usage_mb,
            "success_rate": (
                self.successful_queries / self.total_queries
                if self.total_queries
                else 0.0
            ),
            "avg_results_per_query": (
                self.total_results / self.successful_queries
                if self.successful_queries
                else 0.0
            ),
        }
        return d


class StatsMonitor:
    """Query-level tracing with periodic JSONL flushes."""

    def __init__(
        self,
        log_dir: Union[str, Path],
        log_interval: int = 60,
        window_size: int = 100,
        track_device_memory: bool = False,
    ):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.log_interval = log_interval
        self.track_device_memory = track_device_memory
        self.stats = SystemStats(window_size=window_size)
        self.last_log_time = time.time()

    def start_query(self, query_id: str) -> QueryStats:
        return QueryStats(query_id=query_id, start_time=time.time())

    def end_query(
        self,
        query_stats: QueryStats,
        num_results: int = 0,
        error: Optional[str] = None,
    ) -> None:
        query_stats.end_time = time.time()
        query_stats.num_results = num_results
        query_stats.error = error
        query_stats.latency_ms = (
            query_stats.end_time - query_stats.start_time
        ) * 1000
        self.stats.update(query_stats)
        if time.time() - self.last_log_time > self.log_interval:
            self.flush()

    def flush(self) -> None:
        record = self.stats.to_dict()
        record["timestamp"] = datetime.now().isoformat()
        if self.track_device_memory:
            record["device_memory_mb"] = device_memory_stats()
        log_file = self.log_dir / f"stats_{datetime.now():%Y%m%d}.jsonl"
        with open(log_file, "a") as f:
            f.write(json.dumps(record) + "\n")
        self.last_log_time = time.time()
        logger.info(
            "Stats: %d queries, avg %.2fms, success %.1f%%, rss %.1fMB",
            record["total_queries"],
            record["avg_latency_ms"],
            record["success_rate"] * 100,
            record["memory_usage_mb"],
        )

    def get_current_stats(self) -> Dict:
        return self.stats.to_dict()

    def reset_stats(self) -> None:
        self.stats = SystemStats(window_size=self.stats.window_size)
        self.last_log_time = time.time()
