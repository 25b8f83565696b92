"""Per-frame stages and the stream runner (counterpart of ``evam_tpu/stages``)."""
