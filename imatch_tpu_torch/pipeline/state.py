"""Application state — the reference app's module globals, made explicit.

Counterpart of ``imatch_tpu/pipeline/state.py`` ``AppState`` for this
slice: directories, the lazily built embedder, the store and the image
metadata mirror, with no segmenter and the ``NullCaptioner``. The store
starts empty: snapshot load and save come with the store's persistence
(ROADMAP.md, next slice).
"""

from __future__ import annotations

import logging
import os
import threading
from typing import Dict, Optional

from imatch_tpu_torch.device import DeviceLike, resolve_device
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.pipeline.captioner import NullCaptioner
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

logger = logging.getLogger("imatch.state")


class AppState:
    def __init__(
        self,
        root: str = ".",
        embedder: Optional[ClipEmbedder] = None,
        captioner=None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        self.static_dir = os.path.join(self.root, "static")
        self.uploads_dir = os.path.join(self.static_dir, "uploads")
        self.processed_dir = os.path.join(self.static_dir, "processed")
        self.encoded_dir = os.path.join(self.static_dir, "encoded")
        for d in (self.uploads_dir, self.processed_dir, self.encoded_dir):
            os.makedirs(d, exist_ok=True)
        self.embedder = embedder
        self.captioner = captioner if captioner is not None else NullCaptioner()
        self.segmenter = None
        self.lock = threading.RLock()
        self._embedder_lock = threading.Lock()
        self.image_metadata: Dict[str, dict] = {}
        self.store = VectorStore(device=self.device)

    def get_embedder(self) -> ClipEmbedder:
        """Built on first use, under its own lock: holding ``self.lock``
        through a checkpoint load would stall every other endpoint."""
        if self.embedder is None:
            with self._embedder_lock:
                if self.embedder is None:
                    self.embedder = ClipEmbedder(device=self.device)
        return self.embedder
