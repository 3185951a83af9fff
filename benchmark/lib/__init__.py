"""Shared, frozen parts of the benchmark: arithmetic, data, drivers, trace."""
