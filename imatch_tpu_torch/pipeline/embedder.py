"""CLIP embedding service — the ``generate_clip_embedding`` equivalent.

Counterpart of ``imatch_tpu/pipeline/embedder.py`` ``ClipEmbedder``:
``embed_images``, ``embed_texts``, ``embed_image``, ``embed_text`` and
their ``*_device`` forms (embeddings left on the card to feed
``VectorStore.query`` without a host round trip), power-of-two chunk
buckets, the vocab fold for the byte-fallback tokenizer, the text LRU, a
lock around the towers, the opt-in W8A8 image tower
(``IMATCH_EMBED_QUANT=int8``) and the fused bulk-ingest step
(``ids_and_embed_images_stream``).

Weights, in order of precedence: ``params=`` (a numpy param tree in the
JAX layout, e.g. ``init_params(jax.random.key(0))`` carried across, which
torch's RNG cannot reproduce), a converted HF checkpoint
(``checkpoint=`` or IMATCH_CLIP_CHECKPOINT), else a seeded random init
from a ``torch.Generator`` (normal(0.02), as the JAX init draws). The
device is ``cuda`` unless ``device="cpu"`` is passed (device.py); compute
is bf16 on the card and fp32 on the CPU.

Not ported yet (ROADMAP.md): data parallelism, the GATE priority gate,
METRICS and the ``device_embeddings`` stream mode (it needs
index/patch.py).
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
from PIL import Image

from imatch_tpu_torch.device import DeviceLike, default_compute_dtype, resolve_device
from imatch_tpu_torch.models.clip.bridge import params_from_numpy
from imatch_tpu_torch.models.clip.configs import CLIPConfig, get_config
from imatch_tpu_torch.models.clip.model import encode_image, encode_text, init_random
from imatch_tpu_torch.ops.phash import (
    DEVICE_BUCKET_MIN,
    bits_to_hex,
    host_bits_from_small,
    image_id,
    phash_core,
)
from imatch_tpu_torch.ops.preprocess import preprocess_core, preprocess_images
from imatch_tpu_torch.ops.resize import resample_matrix, resize_crop_matrices
from imatch_tpu_torch.ops.tokenizer import default_tokenizer
from imatch_tpu_torch.utils.batching import pow2_bucket

logger = logging.getLogger("imatch.embedder")

SEED = 0  # the random init's, so embeddings are stable across restarts


class ClipEmbedder:
    """Owns the CLIP modules; thread-safe."""

    def __init__(
        self,
        config: str | CLIPConfig | None = None,
        checkpoint: Optional[str] = None,
        params: Optional[Dict] = None,
        device: DeviceLike = None,
        compute_dtype: Optional[torch.dtype] = None,
        quant: Optional[str] = None,
    ):
        """``quant``: ``"int8"`` for the W8A8 image tower, default from
        IMATCH_EMBED_QUANT (unset or ``none``: the full-precision tower).
        The text tower is never quantized: queries keep full fidelity."""
        config = config or os.environ.get("IMATCH_CLIP_CONFIG", "vit-b32")
        self.cfg = get_config(config) if isinstance(config, str) else config
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype or default_compute_dtype(self.device)
        if quant is None:
            quant = os.environ.get("IMATCH_EMBED_QUANT", "")
        self.quant = quant.strip().lower()
        if self.quant not in ("", "none", "int8"):
            raise ValueError(
                f"IMATCH_EMBED_QUANT={self.quant!r}: expected 'int8' or unset"
            )
        checkpoint = checkpoint or os.environ.get("IMATCH_CLIP_CHECKPOINT")
        t0 = time.time()
        if params is None and checkpoint:
            from imatch_tpu_torch.models.clip.convert import load_hf_checkpoint

            logger.info("loading CLIP checkpoint from %s", checkpoint)
            params = load_hf_checkpoint(checkpoint, self.cfg)
        if params is not None:
            self.model = params_from_numpy(
                params, self.cfg, device=self.device, dtype=self.compute_dtype,
                quant=self.quant,
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
                self.cfg,
                device=self.device,
                dtype=self.compute_dtype,
                generator=gen,
                quant=self.quant,
            )
        if self.quant == "int8":
            logger.info("image tower quantized: W8A8 int8 (K3/K4 quantize)")
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

    # -- bulk ingest -----------------------------------------------------------

    def _fused_step(self, frames: torch.Tensor, consts) -> tuple:
        """The fused bulk-ingest step: uint8 frames uploaded once feed both
        consumers, CLIP preprocess + image tower and the pHash bits (with
        the 32x32 grids for the host tail). Returns device tensors
        (embeddings, bits, confident, grids)."""
        a_v_c, a_h_c, a_v_p, a_h_p = consts
        pixels = preprocess_core(frames, a_v_c, a_h_c, dtype=self.compute_dtype)
        emb = encode_image(self.model, pixels)
        bits, confident, small = phash_core(frames, a_v_p, a_h_p)
        return emb, bits, confident, small

    def ids_and_embed_images_stream(
        self, images: Sequence[Optional[np.ndarray]], pool=None, max_in_flight: int = 4
    ):
        """Bulk-ingest fast path, streamed: pHash ids AND CLIP embeddings
        from one device upload per geometry chunk (``_fused_step``),
        yielded per chunk so the caller's host stages (dup check, saves,
        store insert) overlap the device work of later chunks.

        Same-geometry runs of at least ``DEVICE_BUCKET_MIN`` images go
        through the fused step in chunks of IMATCH_EMBED_CHUNK, each padded
        to a power of two; up to ``max_in_flight`` chunks are queued on the
        device ahead of the consumer (bounding the frames resident there),
        and each yield fetches one finished chunk. Confident device hashes
        are the host id; the rest take the fp64 tail on their 32x32 grid.
        Smaller buckets are embedded on the plain path and hashed on the
        host (over ``pool`` when given), in one final yield. None entries
        (failed decodes) are not yielded.

        Yields (indices, ids, embeddings (len(indices), proj) fp32 numpy).
        """
        buckets: Dict[tuple, list] = {}
        for i, im in enumerate(images):
            if im is not None:
                buckets.setdefault(im.shape[:2], []).append(i)
        out_size = self.cfg.vision.image_size
        small_idx: list = []
        in_flight: list = []  # (indices, device (emb, bits, confident, grids))

        def drain_one():
            idxs_chunk, handles = in_flight.pop(0)
            e, bits, conf, small = (t.cpu().numpy() for t in handles)
            ids_c = [
                f"img_{bits_to_hex(bits[j]) if conf[j] else host_bits_from_small(small[j])}"
                for j in range(len(idxs_chunk))
            ]
            return idxs_chunk, ids_c, e

        for (h, w), idxs in buckets.items():
            if len(idxs) < DEVICE_BUCKET_MIN:
                small_idx.extend(idxs)
                continue
            a_v_c, a_h_c = resize_crop_matrices(h, w, out_size)
            consts = tuple(
                torch.from_numpy(m).to(self.device)
                for m in (
                    a_v_c,
                    a_h_c,
                    resample_matrix(h, 32, "lanczos", quantize_8bpc=True),
                    resample_matrix(w, 32, "lanczos", quantize_8bpc=True),
                )
            )
            for s, b, bp in self._chunks(len(idxs)):
                part = np.stack([images[i] for i in idxs[s : s + b]])
                with self._lock:
                    dev = torch.from_numpy(part).to(self.device)
                    if bp > b:
                        dev = torch.cat([dev, dev[-1:].expand(bp - b, *dev.shape[1:])])
                    handles = self._fused_step(dev, consts)
                in_flight.append((idxs[s : s + b], tuple(t[:b] for t in handles)))
                if len(in_flight) >= max_in_flight:
                    yield drain_one()
        while in_flight:
            yield drain_one()

        if small_idx:
            rest = self.embed_images([images[i] for i in small_idx])

            def host_one(i):
                return image_id(Image.fromarray(images[i]))

            if pool is not None and len(small_idx) > 1:
                ids_r = list(pool.map(host_one, small_idx))
            else:
                ids_r = [host_one(i) for i in small_idx]
            yield small_idx, ids_r, rest

    def ids_and_embed_images(self, images: Sequence[Optional[np.ndarray]], pool=None):
        """Whole-batch form of ``ids_and_embed_images_stream``: (ids, (N,
        proj) fp32) with None ids and zero rows for None entries."""
        ids: list = [None] * len(images)
        emb = np.zeros((len(images), self.dim), np.float32)
        for idxs, ids_c, e in self.ids_and_embed_images_stream(images, pool):
            for j, i in enumerate(idxs):
                ids[i] = ids_c[j]
                emb[i] = e[j]
        return ids, emb
