"""Frame sources (counterpart of ``evam_tpu/media``): the sources, the
decode worker, the shared decode pool and the RTSP demux."""

from evam_tpu_torch.media.decode import DecodeWorker
from evam_tpu_torch.media.demux import DemuxStream, RtspDemux
from evam_tpu_torch.media.pool import DecodePool, PooledStream
from evam_tpu_torch.media.source import (
    AppSource,
    FileSource,
    FrameEvent,
    SyntheticSource,
    VideoSource,
    create_source,
)

__all__ = [
    "DemuxStream",
    "RtspDemux",
    "AppSource",
    "FileSource",
    "FrameEvent",
    "SyntheticSource",
    "VideoSource",
    "create_source",
    "DecodeWorker",
    "DecodePool",
    "PooledStream",
]
