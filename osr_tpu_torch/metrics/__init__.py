from osr_tpu_torch.metrics.ir import evaluate_retrieval, ndcg_at_k, map_at_k, recall_at_k, precision_at_k
from osr_tpu_torch.metrics.generation import (
    rouge_l,
    rouge_n,
    bleu,
    faithfulness,
    evaluate_generation,
)

__all__ = [
    "evaluate_retrieval",
    "ndcg_at_k",
    "map_at_k",
    "recall_at_k",
    "precision_at_k",
    "rouge_l",
    "rouge_n",
    "bleu",
    "faithfulness",
    "evaluate_generation",
]
