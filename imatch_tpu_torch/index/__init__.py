"""In-device vector index: exact two-phase top-k and the store."""
