"""PyTorch/CUDA port of gpt_2_distributed_tpu for NVIDIA Hopper.

A package of its own beside the JAX package: it imports torch and numpy,
never JAX or the JAX package. Kernels are CUDA C++ in ``csrc/``, built at
first use by ``kernels/build.py``.
"""
