"""The H100 benchmark of imatch_tpu_torch (see README.md)."""
