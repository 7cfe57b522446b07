"""The port's measurement entry points (counterparts of ``bench.py`` and
``tools/bench_scaling.py``, ``tools/bench_hybrid.py``,
``tools/bench_dense_scale.py``), run as

    python -m osr_tpu_torch.bench {headline,scaling,hybrid,dense-scale}

``headline`` is the default. Each mode runs on the CUDA card; without one
it prints its JSON line with ``"value": null`` and an ``error`` and exits
1. Importing this package loads none of its modules.
"""
