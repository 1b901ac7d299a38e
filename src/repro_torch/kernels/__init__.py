"""Hand-written CUDA kernels for Hopper (sm_90a) in place of the
reference's Pallas TPU kernels.

  paged_attention — causal chunk attention over the head-granular paged
                    KV pool (the fused step's attention; decode rows are
                    1-token chunks).

Each kernel ships ``ops.py`` (the wrapper: CUDA kernel on CUDA tensors,
plain version on CPU tensors), ``ref.py`` (the plain PyTorch version) and
its source under ``csrc/``, built by ``build.py`` at first use.
"""
