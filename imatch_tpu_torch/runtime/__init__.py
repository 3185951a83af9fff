"""Host runtime: the native decode pool (a copy of the JAX package's),
the priority gate and the query coalescer."""

from imatch_tpu_torch.runtime.loader import (
    NativeImageLoader,
    decode_image_bytes,
    default_loader,
)

__all__ = ["NativeImageLoader", "decode_image_bytes", "default_loader"]
