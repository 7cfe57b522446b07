from osr_tpu_torch.pipeline.config import load_config, validate_config
from osr_tpu_torch.pipeline.experiment import run_rag_experiment, run_all_experiments
from osr_tpu_torch.pipeline.ablation import generate_ablation_configs, run_ablation, deep_update
from osr_tpu_torch.pipeline.errors import categorize_errors, analyze_retrieval_performance
from osr_tpu_torch.pipeline.efficiency import (
    measure_build_performance,
    benchmark_query_latency,
    benchmark_index_scaling,
    run_comprehensive_benchmark,
)

__all__ = [
    "load_config",
    "validate_config",
    "run_rag_experiment",
    "run_all_experiments",
    "generate_ablation_configs",
    "run_ablation",
    "deep_update",
    "categorize_errors",
    "analyze_retrieval_performance",
    "measure_build_performance",
    "benchmark_query_latency",
    "benchmark_index_scaling",
    "run_comprehensive_benchmark",
]
