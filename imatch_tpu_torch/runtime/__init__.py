"""Host runtime: the priority gate and the query coalescer."""
