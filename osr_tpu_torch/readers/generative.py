"""Template-based generative answer reader (counterpart of
``osr_tpu/readers/generative.py``).

Capability-parity reimplementation of the reference's
``OptimizedGenerativeReader`` (reference rag_system/core/reader_registry.py:
88-171): deduplicate contexts by a sorted-word fingerprint of their first 20
words, join with ' | ' separators, truncate at a sentence boundary near the
max context length, then wrap in a question-type template.
"""

from __future__ import annotations

from typing import List

MAX_CONTEXTS = 4
FINGERPRINT_WORDS = 20


class GenerativeReader:
    def __init__(self, max_context_length: int = 800, **kwargs):
        self.max_context_length = max_context_length
        self.context_combination = kwargs.get("context_combination", "smart")

    def generate_answer(self, query: str, contexts: List[str]) -> str:
        if not contexts:
            return "I don't have enough information to answer this question."
        if not query:
            return "Please provide a clear question."
        combined = self._combine(contexts)
        return self._apply_template(query, combined)

    def _combine(self, contexts: List[str]) -> str:
        if self.context_combination != "smart":
            return " ".join(contexts[:2])[: self.max_context_length]
        unique: List[str] = []
        seen = set()
        for context in contexts[:MAX_CONTEXTS]:
            if not context:
                continue
            head_words = context.lower().split()[:FINGERPRINT_WORDS]
            fingerprint = " ".join(sorted(set(head_words)))
            if fingerprint not in seen:
                unique.append(context)
                seen.add(fingerprint)
        combined = " | ".join(unique)
        if len(combined) > self.max_context_length:
            combined = combined[: self.max_context_length]
            cut = combined.rfind(".")
            if cut > self.max_context_length * 0.8:
                combined = combined[: cut + 1]
        return combined

    @staticmethod
    def _apply_template(query: str, context: str) -> str:
        if not context.strip():
            return (
                "The available information doesn't contain relevant details "
                "to answer this question."
            )
        q = query.lower()
        if any(w in q for w in ("what", "which", "who")):
            if "definition" in q or "meaning" in q:
                return f"Based on the information provided: {context}"
            return f"According to the sources, {context}"
        if any(w in q for w in ("how", "why")):
            return f"The explanation is: {context}"
        if any(w in q for w in ("when", "where")):
            return f"The information indicates: {context}"
        if any(w in q for w in ("is", "are", "does", "do", "can", "will")):
            return f"Based on the available information: {context}"
        return f"Regarding your question: {context}"
