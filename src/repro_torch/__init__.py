"""PyTorch/CUDA port of the MPIX collective library and its models.

A second package beside the JAX reference (``repro``): the same schedule
IR, algorithm builders and compiled executor, executed over
``torch.distributed`` point-to-point rounds or as one hand-written CUDA
kernel per schedule; and the dense attention models served on one card,
whose prefill attention runs a hand-written flash-attention kernel.
Importing it loads no GPU-only module; the CUDA library is built on
first use (see ``repro_torch.cuda``).
"""
