"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Every wrapper takes its kernel's plain version for a tensor on the CPU and,
for a CUDA tensor, launches the kernel or raises. ``launch_counts`` counts
the launches per kernel (the wrapper adds one where it launches, nowhere
else), so a run can show that its path went through the kernels; clear it
before the run to be measured.
"""
from __future__ import annotations

from collections import Counter

launch_counts: Counter = Counter()
