"""PyTorch/CUDA port of the tpu-operator workloads.

The JAX package ``tpu_operator`` is the reference; this package mirrors
its module layout (``tpu_operator_torch/workloads/X.py`` ports
``tpu_operator/workloads/X.py``) and runs on an NVIDIA H100. Every Pallas
kernel on a ported path is a hand-written CUDA kernel under
``tpu_operator_torch/kernels/``, built at first use.

The package imports ``torch`` and numpy only — never ``jax`` and nothing
of ``tpu_operator`` — and importing it builds nothing.
"""
