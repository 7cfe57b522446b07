"""Plain references that decide ``correct``. NumPy and PyTorch only: they
import nothing of the program (``osr_tpu_torch``), nor JAX, nor
``osr_tpu``, and take nothing the program made. They rebuild from the
benchmark's own inputs what the program derives (the index, its
quantization, the scores) and score in float64."""
