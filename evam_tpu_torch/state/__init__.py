"""Crash-consistent stream serving state, ``EVAM_CKPT`` (counterpart of
``evam_tpu/state``): see ``state/checkpoint.py``."""

from evam_tpu_torch.state.checkpoint import (  # noqa: F401
    SCHEMA_V1_FIELDS,
    SCHEMA_VERSION,
    CheckpointCorrupt,
    CheckpointError,
    CheckpointStore,
    CheckpointVersionError,
    StreamCheckpoint,
    active,
    decode,
    encode,
    is_checkpoint_blob,
    reset_cache,
)
