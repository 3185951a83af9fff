"""CLIP embedding service — the ``generate_clip_embedding`` equivalent.

Counterpart of ``imatch_tpu/pipeline/embedder.py`` ``ClipEmbedder`` with
this slice's subset: ``embed_images``, ``embed_texts``, ``embed_image``,
``embed_text`` and their ``*_device`` forms (embeddings left on the card
to feed ``VectorStore.query`` without a host round trip), power-of-two
chunk buckets, the vocab fold for the byte-fallback tokenizer, the text
LRU, and a lock around the towers.

Weights, in order of precedence: ``params=`` (a numpy param tree in the
JAX layout, e.g. ``init_params(jax.random.key(0))`` carried across, which
torch's RNG cannot reproduce), a converted HF checkpoint
(``checkpoint=`` or IMATCH_CLIP_CHECKPOINT), else a seeded random init
from a ``torch.Generator`` (normal(0.02), as the JAX init draws). The
device is ``cuda`` unless ``device="cpu"`` is passed (device.py); compute
is bf16 on the card and fp32 on the CPU.

Not in this slice (ROADMAP.md): the fused bulk-ingest step, data
parallelism and the W8A8 image tower.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from imatch_tpu_torch.device import DeviceLike, default_compute_dtype, resolve_device
from imatch_tpu_torch.models.clip.bridge import params_from_numpy
from imatch_tpu_torch.models.clip.configs import CLIPConfig, get_config
from imatch_tpu_torch.models.clip.model import encode_image, encode_text, init_random
from imatch_tpu_torch.ops.preprocess import preprocess_images
from imatch_tpu_torch.ops.tokenizer import default_tokenizer

logger = logging.getLogger("imatch.embedder")

SEED = 0  # the random init's, so embeddings are stable across restarts


def pow2_bucket(n: int, cap: int) -> int:
    """Padded size of an ``n``-row chunk: the next power of two, at most
    ``cap`` (a few stable shapes instead of one per batch size)."""
    return min(cap, 1 << max(0, n - 1).bit_length())


class ClipEmbedder:
    """Owns the CLIP modules; thread-safe."""

    def __init__(
        self,
        config: str | CLIPConfig | None = None,
        checkpoint: Optional[str] = None,
        params: Optional[Dict] = None,
        device: DeviceLike = None,
        compute_dtype: Optional[torch.dtype] = None,
    ):
        config = config or os.environ.get("IMATCH_CLIP_CONFIG", "vit-b32")
        self.cfg = get_config(config) if isinstance(config, str) else config
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        checkpoint = checkpoint or os.environ.get("IMATCH_CLIP_CHECKPOINT")
        t0 = time.time()
        if params is None and checkpoint:
            from imatch_tpu_torch.models.clip.convert import load_hf_checkpoint

            logger.info("loading CLIP checkpoint from %s", checkpoint)
            params = load_hf_checkpoint(checkpoint, self.cfg)
        if params is not None:
            self.model = params_from_numpy(
                params, self.cfg, device=self.device, dtype=self.compute_dtype
            )
        else:
            logger.info(
                "no checkpoint or params given; seeded random init "
                "(torch.Generator seed %d, normal(0.02), %s) — not the JAX "
                "package's init_params(jax.random.key(0)) weights",
                SEED,
                self.cfg.name,
            )
            gen = torch.Generator(device=self.device).manual_seed(SEED)
            self.model = init_random(
                self.cfg, device=self.device, dtype=self.compute_dtype, generator=gen
            )
        self.tokenizer = default_tokenizer()
        self._lock = threading.Lock()
        # Query-text LRU of device-resident embeddings: a repeated query
        # skips the tokenizer and the text tower. IMATCH_TEXT_CACHE entries
        # (default 1024; 0 disables).
        self._text_cache_cap = int(os.environ.get("IMATCH_TEXT_CACHE", "1024"))
        self._text_cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        # Pool at the TOKENIZER's eos id. When the tokenizer's vocab is
        # larger than the model's (byte fallback vs a small config), ids
        # fold into [0, vocab-2] with the model's top id reserved for eos:
        # a blind clamp would alias regular tokens onto eos and pool at the
        # wrong position.
        if self.tokenizer.vocab_size > self.cfg.text.vocab_size:
            self._fold_vocab = True
            self._model_eos = self.cfg.text.vocab_size - 1
        else:
            self._fold_vocab = False
            self._model_eos = self.tokenizer.eos_id
        logger.info(
            "embedder ready in %.2fs (%s, %s, %s)",
            time.time() - t0,
            self.cfg.name,
            self.device,
            str(self.compute_dtype).replace("torch.", ""),
        )

    @property
    def dim(self) -> int:
        return self.cfg.projection_dim

    def _chunks(self, n: int):
        """(start, rows, padded rows) of each tower call: chunks of at most
        IMATCH_EMBED_CHUNK rows (default 512), each padded up to a power
        of two by repeating its last row."""
        chunk = int(os.environ.get("IMATCH_EMBED_CHUNK", "512"))
        for s in range(0, n, chunk):
            b = min(chunk, n - s)
            yield s, b, pow2_bucket(b, chunk)

    def _run_tower(self, fn, rows: torch.Tensor) -> torch.Tensor:
        outs = []
        with self._lock:
            for s, b, bp in self._chunks(rows.shape[0]):
                part = rows[s : s + b]
                if bp > b:
                    part = torch.cat([part, part[-1:].expand(bp - b, *part.shape[1:])])
                outs.append(fn(part)[:b])
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _embed_pixels(self, pixels: torch.Tensor) -> torch.Tensor:
        return self._run_tower(lambda p: encode_image(self.model, p), pixels)

    def _embed_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        return self._run_tower(
            lambda t: encode_text(self.model, t, eos_token_id=self._model_eos), ids
        )

    def _tokenize(self, texts: Sequence[str]) -> np.ndarray:
        tokens = np.asarray(
            self.tokenizer.encode_batch(texts, max_length=self.cfg.text.max_positions)
        )
        if self._fold_vocab:
            is_eos = tokens == self.tokenizer.eos_id
            tokens = np.where(
                is_eos, self._model_eos, tokens % (self.cfg.text.vocab_size - 1)
            )
        return tokens

    # -- device-resident embeddings ------------------------------------------

    def embed_images_device(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """uint8 HWC RGB frames (any geometries) -> (N, proj) unit fp32 on
        the device."""
        if len(images) == 0:
            return torch.zeros((0, self.dim), device=self.device)
        pixels = preprocess_images(
            images,
            device=self.device,
            out_size=self.cfg.vision.image_size,
            dtype=self.compute_dtype,
        )
        return self._embed_pixels(pixels)

    def embed_image_device(self, image: np.ndarray) -> torch.Tensor:
        return self.embed_images_device([image])[0]

    def embed_texts_device(self, texts: Sequence[str]) -> torch.Tensor:
        if len(texts) == 0:
            return torch.zeros((0, self.dim), device=self.device)
        return self._embed_tokens(self._tokenize(list(texts)))

    def embed_text_device(self, text: str) -> torch.Tensor:
        """One text's (proj,) embedding on the device, served from the LRU
        when the same text was embedded before."""
        if self._text_cache_cap > 0:
            with self._lock:
                emb = self._text_cache.get(text)
                if emb is not None:
                    self._text_cache.move_to_end(text)
                    return emb
        emb = self._embed_tokens(self._tokenize([text]))[0]
        if self._text_cache_cap > 0:
            with self._lock:
                self._text_cache[text] = emb
                self._text_cache.move_to_end(text)
                while len(self._text_cache) > self._text_cache_cap:
                    self._text_cache.popitem(last=False)
        return emb

    # -- host embeddings -----------------------------------------------------

    def embed_images(self, images: Sequence[np.ndarray]) -> np.ndarray:
        """uint8 HWC RGB arrays (any geometries) -> (N, proj) unit fp32."""
        return self.embed_images_device(images).cpu().numpy()

    def embed_texts(self, texts: Sequence[str]) -> np.ndarray:
        """Strings -> (N, proj) unit fp32, eos-padded to the context length."""
        return self.embed_texts_device(texts).cpu().numpy()

    def embed_image(self, image: np.ndarray) -> np.ndarray:
        return self.embed_images([image])[0]

    def embed_text(self, text: str) -> np.ndarray:
        return self.embed_texts([text])[0]
