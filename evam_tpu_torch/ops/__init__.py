"""Tensor ops of the port (counterpart of ``evam_tpu/ops``).

Plain functions on torch tensors. Kernels written by hand for the card
live beside their plain versions (``ops/qgemm.py``); their CUDA sources
are under ``evam_tpu_torch/csrc``.
"""
