"""Multi-device paths: the row-sharded index engines over a device list."""
