"""chunk_sweeps.msmarco: row-chunk sweeps a batch over the window, the
engine's ``chunk_sweeps`` counter over its ``batches`` (the window's
difference of ``stats()["counters"]``). None where the engine has no such
counter."""


def read(record):
    c = record["window"].get("counters") or {}
    if "chunk_sweeps" not in c or not c.get("batches"):
        return None
    return c["chunk_sweeps"] / c["batches"]
