"""Persistent AOT cache (EVAM_AOT), counterpart of ``evam_tpu/aot/``.

A content-addressed on-disk store of compiled device code, shared by
process restarts, supervisor rebuilds, fleet shard spin-up and every
warmup path. The reference stores serialized XLA executables; the port
compiles no XLA (a bucket's warmup is one eager step, then a CUDA graph
capture, and a graph cannot be serialized), so what it stores is the
hand kernels' shared libraries (``ops/kernels.py``): a hit loads a
library instead of running ``nvcc``. Off (the default) the layer is one
memoized ``active()`` None-check, and every path runs as without it.
"""

from evam_tpu_torch.aot.cache import (  # noqa: F401
    AotCache,
    MISS_REASONS,
    active,
    cache_key,
    disabled_summary,
    reset_cache,
    summary,
)
