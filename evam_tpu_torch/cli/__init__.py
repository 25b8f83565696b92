"""Command line of the port (counterpart of ``evam_tpu/cli``)."""
