"""Kernel names that ``trace.py`` does not hold, as the trace gives them,
demangled or mangled: K2 is ``csrc/head_wgmma.cu``'s
``head_wgmma_kernel<kInt8 = true, kEpi = kEpiBlockMax = 0>``."""

import re

K2 = re.compile(r"head_wgmma_kernel(ILb1ELi0E|<\s*true\s*,\s*0\s*>)")
