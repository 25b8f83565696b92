"""Batch engine, step builders and hub (counterpart of ``evam_tpu/engine``)."""
