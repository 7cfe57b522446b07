"""setup_s: seconds from the harness's first line to the window's start
(imports, the card's context, building or loading the kernels and the
host runtime, making the inputs, building the index, warming up)."""


def read(record):
    return record["setup_s"]
