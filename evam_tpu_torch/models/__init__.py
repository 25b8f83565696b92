"""Models of the port (counterpart of ``evam_tpu/models``)."""
