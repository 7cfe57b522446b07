"""The benchmark of ``osr_tpu_torch`` on one CUDA card: a harness driven by
data (``configs/``, ``traffic/``, ``metrics/``), frozen copies of the
workload generators and the operation counts, and plain references that
decide ``correct``. See ``README.md``."""
