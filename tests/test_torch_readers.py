"""The port's readers (osr_tpu_torch/readers/), mirrored from the reader
half of tests/test_registries.py, and held against osr_tpu's readers:
every answer string-equal on the same queries and contexts."""

import numpy as np
import pytest

from osr_tpu_torch.readers.registry import ReaderRegistry


def test_readers():
    extractive = ReaderRegistry.create(
        {"type": "extractive", "params": {"max_answer_length": 100}}
    )
    contexts = [
        "Short.",
        "An exchange traded fund is a basket of securities that trades on an "
        "exchange. It tracks an index. Other sentences exist here too.",
    ]
    ans = extractive.generate_answer("what is an exchange traded fund", contexts)
    assert "exchange traded fund" in ans.lower()
    assert extractive.generate_answer("", []) == "No sufficient context available."

    generative = ReaderRegistry.create("generative")
    ans = generative.generate_answer("what is an etf", ["ETFs are funds."])
    assert ans.startswith("According to the sources,")
    ans2 = generative.generate_answer(
        "how does it work", ["same words here alpha", "same words here alpha"]
    )
    assert ans2.count("same words here") == 1

    llm = ReaderRegistry.create({"type": "llm", "params": {"model": "m"}})
    assert "m" in llm.generate_answer("q", ["ctx"])
    llm2 = ReaderRegistry.create(
        {"type": "llm", "params": {"complete_fn": lambda p: "ANSWER"}}
    )
    assert llm2.generate_answer("q", ["ctx"]) == "ANSWER"

    with pytest.raises(ValueError):
        ReaderRegistry.create({"type": "bogus"})


def test_registry_lists_and_registers_custom_readers():
    class Echo:
        def __init__(self, prefix=""):
            self.prefix = prefix

        def generate_answer(self, query, contexts):
            return self.prefix + query

    ReaderRegistry.register("echo_reader", Echo)
    try:
        r = ReaderRegistry.create({"name": "echo_reader", "params": {"prefix": ">"}})
        assert r.generate_answer("q", []) == ">q"
        assert "echo_reader" in ReaderRegistry.list_available()["registered_custom"]
    finally:
        ReaderRegistry._readers.pop("echo_reader")
    assert ReaderRegistry.list_available()["builtin"] == [
        "extractive", "generative", "llm"]
    with pytest.raises(ValueError):
        ReaderRegistry.create({"params": {}})


def _cases():
    """Seeded queries and context lists: question words of every template,
    sentences of assorted lengths, duplicate contexts, empty ones."""
    rng = np.random.RandomState(17)
    vocab = ("what which who how why when where is are does can fund bond "
             "etf rate tax pays index exchange traded meaning definition "
             "basket securities").split()
    cases = []
    for i in range(120):
        query = " ".join(rng.choice(vocab, rng.randint(0, 7)))
        contexts = []
        for _ in range(rng.randint(0, 7)):
            sentences = [
                " ".join(rng.choice(vocab, rng.randint(1, 40)))
                for _ in range(rng.randint(1, 6))
            ]
            contexts.append(". ".join(sentences) + rng.choice([".", "!", ""]))
        if contexts and i % 5 == 0:
            contexts.append(contexts[0])
        if contexts and i % 11 == 0:
            contexts[0] = ""
        cases.append((query, contexts))
    return cases


@pytest.mark.parametrize("config", [
    {"type": "extractive", "params": {"max_answer_length": 150}},
    {"type": "extractive", "params": {"max_answer_length": 40}},
    {"type": "extractive", "params": {"use_advanced_extraction": False}},
    {"type": "generative", "params": {"max_context_length": 500}},
    {"type": "generative", "params": {"context_combination": "concat"}},
    {"type": "llm", "params": {"max_context_chars": 300}},
])
def test_answers_equal_osr_tpu(config):
    from osr_tpu.readers.registry import ReaderRegistry as Want

    got, want = ReaderRegistry.create(config), Want.create(config)
    prompts = []
    for query, contexts in _cases():
        assert got.generate_answer(query, contexts) == want.generate_answer(
            query, contexts
        ), (query, contexts)
        if config["type"] == "llm" and contexts:
            prompts.append(got.build_prompt(query, contexts) == want.build_prompt(
                query, contexts))
    assert all(prompts)
