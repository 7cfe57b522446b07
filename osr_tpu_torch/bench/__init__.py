"""The port's measurement entry points (counterparts of ``bench.py`` and
``tools/bench_scaling.py``, ``bench_hybrid.py``, ``bench_dense_scale.py``,
``bench_batch_curve.py``, ``bench_int4_quality.py``,
``bench_quality_at_scale.py``, ``bench_fusion_sweep.py``,
``bench_dense_encoder.py``, ``bench_sharded_cpu.py``,
``bench_sharded_tpu.py``, ``profile_trace.py``, ``profile_latency.py``
and ``profile_search.py``), run as

    python -m osr_tpu_torch.bench {headline,scaling,hybrid,dense-scale,
        batch-curve,int4-quality,quality-at-scale,fusion-sweep,dense-encoder,
        sharded-scale,sharded-overhead,profile-trace,profile-latency,
        profile-search}

``headline`` is the default. Each mode runs on the CUDA card; without one
it prints its JSON line with ``"value": null`` and an ``error`` and exits
1. Importing this package loads none of its modules.
"""
