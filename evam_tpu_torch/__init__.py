"""evam_tpu_torch: the PyTorch/CUDA port of ``evam_tpu``.

A second package beside ``evam_tpu`` (which stays the reference). It
mirrors that package's layout module for module — ``ops/``,
``models/``, ``engine/``, ``stages/``, ``media/`` — and adds
``csrc/`` for the CUDA C++ kernels that replace ``evam_tpu``'s Pallas
kernels. It imports ``torch`` and numpy, never ``jax``, ``flax`` or
anything of ``evam_tpu``.

Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no card and no explicit ``cpu`` they raise
(:func:`evam_tpu_torch.device.resolve_device`).
"""
