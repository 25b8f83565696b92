"""Built-in model zoo as ``torch.nn`` modules (counterpart of ``evam_tpu/models/zoo``)."""
