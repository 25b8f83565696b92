"""Frame sources (counterpart of ``evam_tpu/media``)."""
