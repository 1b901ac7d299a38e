"""Hand-written CUDA kernels for Hopper (sm_90a) in place of the
reference's Pallas TPU kernels.

  paged_attention — attention over the head-granular paged KV pool:
                    causal chunk attention (the fused step, where decode
                    rows are 1-token chunks, and the split schedule's
                    prefill call) and decode attention (the split
                    schedule's decode call).
  flash_attention — dense causal / sliding-window GQA attention (the
                    dense prefill, ``prefill_mode="dense"``).

Each kernel package ships ``ops.py`` (the wrappers: CUDA kernel on CUDA
tensors, plain version on CPU tensors), ``ref.py`` (the plain PyTorch
versions) and its sources under ``csrc/``, built by ``build.py`` at first
use.
"""
