"""LLM reader (counterpart of ``osr_tpu/readers/llm.py``).

The reference ships a placeholder that formats a canned response (reference
rag_system/core/reader_registry.py:215-234). Here the same placeholder
behavior is the zero-dependency default, but a real completion callback can
be injected (``complete_fn``) so production deployments plug in an actual
model endpoint without changing pipeline code.
"""

from __future__ import annotations

from typing import Callable, List, Optional

PROMPT_TEMPLATE = (
    "Answer the question using only the provided context.\n\n"
    "Context:\n{context}\n\nQuestion: {query}\n\nAnswer:"
)


class LLMReader:
    def __init__(
        self,
        model: str = "placeholder-llm",
        max_context_chars: int = 2000,
        complete_fn: Optional[Callable[[str], str]] = None,
        **kwargs,
    ):
        self.model = model
        self.max_context_chars = max_context_chars
        self.complete_fn = complete_fn
        self.optimization_level = kwargs.get("optimization_level", "balanced")

    def build_prompt(self, query: str, contexts: List[str]) -> str:
        context = "\n---\n".join(c for c in contexts if c)[
            : self.max_context_chars
        ]
        return PROMPT_TEMPLATE.format(context=context, query=query)

    def generate_answer(self, query: str, contexts: List[str]) -> str:
        if not contexts:
            return "Insufficient context for LLM generation."
        if self.complete_fn is not None:
            return self.complete_fn(self.build_prompt(query, contexts))
        preview = (contexts[0] or "No context")[:200]
        return (
            f"[LLM {self.model}] Based on the context '{preview}...', "
            f"regarding '{query[:50]}...': configure complete_fn to call a "
            f"real model."
        )
