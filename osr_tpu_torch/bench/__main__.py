"""``python -m osr_tpu_torch.bench [mode] [options]``: the mode is one of
headline (the default), scaling, hybrid, dense-scale, batch-curve,
int4-quality, quality-at-scale, fusion-sweep, dense-encoder,
sharded-scale, sharded-overhead, profile-trace, profile-latency,
profile-search, profile-stages-1m, profile-host-scale, profile-hybrid,
profile-device, profile-fused, profile-narrow, profile-blocksel,
profile-topk2, profile-topk-fix, storage, pipeline-87k and evidence; the
options are the mode's own (``--help`` after the mode lists them)."""

import sys

MODES = (
    "headline", "scaling", "hybrid", "dense-scale", "batch-curve",
    "int4-quality", "quality-at-scale", "fusion-sweep", "dense-encoder",
    "sharded-scale", "sharded-overhead", "profile-trace", "profile-latency",
    "profile-search", "profile-stages-1m", "profile-host-scale",
    "profile-hybrid", "profile-device", "profile-fused", "profile-narrow",
    "profile-blocksel", "profile-topk2", "profile-topk-fix", "storage",
    "pipeline-87k", "evidence",
)


def main(argv=None) -> int:
    import importlib

    argv = list(sys.argv[1:] if argv is None else argv)
    mode = argv.pop(0) if argv and argv[0] in MODES else "headline"
    module = importlib.import_module(
        f"osr_tpu_torch.bench.{mode.replace('-', '_')}"
    )
    return module.main(argv)


if __name__ == "__main__":
    sys.exit(main())
