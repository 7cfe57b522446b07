"""The port's measurement entry points (counterparts of ``bench.py`` and
``tools/bench_scaling.py``, ``bench_hybrid.py``, ``bench_dense_scale.py``,
``bench_batch_curve.py``, ``bench_int4_quality.py``,
``bench_quality_at_scale.py``, ``bench_fusion_sweep.py``,
``bench_dense_encoder.py``, ``bench_sharded_cpu.py``,
``bench_sharded_tpu.py``, ``profile_trace.py``, ``profile_latency.py``,
``profile_search.py``, ``profile_stages_1m.py``, ``profile_host_scale.py``,
``profile_hybrid.py``, ``profile_device.py``, ``profile_fused.py``,
``profile_narrow.py``, ``profile_blocksel.py``, ``profile_topk2.py`` and
``profile_topk_fix.py``), run as

    python -m osr_tpu_torch.bench {headline,scaling,hybrid,dense-scale,
        batch-curve,int4-quality,quality-at-scale,fusion-sweep,dense-encoder,
        sharded-scale,sharded-overhead,profile-trace,profile-latency,
        profile-search,profile-stages-1m,profile-host-scale,profile-hybrid,
        profile-device,profile-fused,profile-narrow,profile-blocksel,
        profile-topk2,profile-topk-fix}

``headline`` is the default. Each mode runs on the CUDA card; without one
it prints its JSON line with ``"value": null`` and an ``error`` and exits
1 (``profile-host-scale``, which touches no device, runs on the host
there). Importing this package loads none of its modules.
"""
