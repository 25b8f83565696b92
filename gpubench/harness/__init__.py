"""The benchmark's machinery, shared by every cell: discovery by name,
weights from the seed, the traffic generator, the profiler's reduction,
the operation and byte reckoning, and the run itself."""
