"""Application state — the reference app's module globals, made explicit.

Counterpart of ``imatch_tpu/pipeline/state.py`` ``AppState``:
directories, the lazily built embedder, the captioner (``get_captioner``
on the state's device unless one is passed), the store (loaded from the
snapshot and journal under ``data_dir`` unless ``autoload=False``) and
the image metadata mirror hydrated from it, the saved filters
(``filters.json``) and the back-fill progress dict, with no segmenter.
``snapshot`` is the durability point after an upload and ``reset``
empties the app, its filters included.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Dict, Optional

from imatch_tpu_torch.device import DeviceLike, resolve_device
from imatch_tpu_torch.index.store import VectorStore
from imatch_tpu_torch.pipeline import filters as filters_mod
from imatch_tpu_torch.pipeline.captioner import get_captioner
from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

logger = logging.getLogger("imatch.state")


class AppState:
    def __init__(
        self,
        root: str = ".",
        embedder: Optional[ClipEmbedder] = None,
        captioner=None,
        device: DeviceLike = None,
        autoload: bool = True,
    ):
        self.device = resolve_device(device)
        self.root = os.path.abspath(root)
        self.static_dir = os.path.join(self.root, "static")
        self.uploads_dir = os.path.join(self.static_dir, "uploads")
        self.processed_dir = os.path.join(self.static_dir, "processed")
        self.encoded_dir = os.path.join(self.static_dir, "encoded")
        self.data_dir = os.path.join(self.root, os.environ.get("IMATCH_DATA_DIR", "index_data"))
        self.filters_file = os.path.join(self.root, "filters.json")
        for d in (self.uploads_dir, self.processed_dir, self.encoded_dir, self.data_dir):
            os.makedirs(d, exist_ok=True)
        self.embedder = embedder
        self.captioner = captioner if captioner is not None else get_captioner(self.device)
        self.segmenter = None
        self.lock = threading.RLock()
        self._embedder_lock = threading.Lock()
        self.filter_progress: Dict[str, dict] = {}
        self.image_metadata: Dict[str, dict] = {}
        self.store = (
            VectorStore.load(self.data_dir, device=self.device)
            if autoload
            else VectorStore(device=self.device)
        )
        self._hydrate_metadata()

    def get_embedder(self) -> ClipEmbedder:
        """Built on first use, under its own lock: holding ``self.lock``
        through a checkpoint load would stall every other endpoint."""
        if self.embedder is None:
            with self._embedder_lock:
                if self.embedder is None:
                    self.embedder = ClipEmbedder(device=self.device)
        return self.embedder

    def _hydrate_metadata(self):
        """The mirror of the store's metadata (the reference's
        load_metadata_from_chromadb)."""
        got = self.store.get(include=["metadatas"])
        for id_, md in zip(got["ids"], got["metadatas"]):
            if md is not None:
                self.image_metadata[id_] = md
        if got["ids"]:
            logger.info("hydrated %d image records", len(got["ids"]))

    # -- filters ------------------------------------------------------------

    def load_filters(self):
        return filters_mod.load_filters(self.filters_file)

    def save_filters(self, filters):
        filters_mod.save_filters(self.filters_file, filters)

    # -- persistence --------------------------------------------------------

    def snapshot(self, force: bool = False):
        """Durability point. Mutations are already journaled op by op; this
        compacts the journal into a full snapshot when it has grown (or at
        once with force)."""
        self.store.checkpoint(force=force)

    # -- reset --------------------------------------------------------------

    def reset(self):
        """reset_system: empty the store, the mirror, the back-fill
        progress and the saved filters, wipe the image directories,
        snapshot."""
        with self.lock:
            # logical state FIRST: if the rmtree below fails part way (an
            # in-flight ingest writes files outside state.lock), the API
            # must not list images from a stale mirror over an empty store
            all_ids = self.store.get(include=[])["ids"]
            if all_ids:
                self.store.delete(all_ids)
            self.image_metadata.clear()
            self.filter_progress.clear()
            self.save_filters([])
            for d in (self.processed_dir, self.encoded_dir, self.uploads_dir):
                if os.path.isdir(d):
                    # racing file creation must not abort the reset: any
                    # stragglers are orphan files, not logical state
                    shutil.rmtree(d, ignore_errors=True)
                os.makedirs(d, exist_ok=True)
            self.snapshot(force=True)
