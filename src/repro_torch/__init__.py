"""PyTorch/CUDA port of the MPIX collective library.

A second package beside the JAX reference (``repro``): the same schedule
IR, algorithm builders and compiled executor, executed over
``torch.distributed`` point-to-point rounds or as one hand-written CUDA
kernel per schedule.  Importing it loads no GPU-only module; the CUDA
library is built on first use (see ``repro_torch.cuda``).
"""
