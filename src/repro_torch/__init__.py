"""PyTorch/CUDA port of the Hetis serving reproduction.

A second package beside ``repro`` (the JAX reference): the same module
layout and names, PyTorch tensors instead of JAX arrays, and hand-written
CUDA kernels for Hopper (sm_90a) in place of the Pallas TPU kernels.  It
imports nothing of ``repro`` and nothing of JAX; its parity tests hold it
against the reference.  Entry points default to ``device="cuda"``.
"""
