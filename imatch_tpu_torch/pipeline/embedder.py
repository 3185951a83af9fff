"""CLIP embedding service — the ``generate_clip_embedding`` equivalent.

Counterpart of ``imatch_tpu/pipeline/embedder.py`` ``ClipEmbedder``:
``embed_images``, ``embed_texts``, ``embed_image``, ``embed_text`` and
their ``*_device`` forms (embeddings left on the card to feed
``VectorStore.query`` without a host round trip), power-of-two chunk
buckets, the vocab fold for the byte-fallback tokenizer, the text LRU, a
lock around the towers, the opt-in W8A8 image tower
(``IMATCH_EMBED_QUANT=int8``), the fused bulk-ingest step
(``ids_and_embed_images_stream``, whose ``device_embeddings`` mode leaves
the embeddings on the card for a device-resident store add, and which
parks at ``GATE.checkpoint()`` between chunks while a search is in
flight), query image batches chunked by a source-pixel budget
(IMATCH_QUERY_PIXEL_BUDGET), and the JAX package's METRICS names
(``images_embedded``, ``embed.image``, ``embed.text``,
``embed.text_cache_hit``, ``ingest.fused``) with two timers of its own:
``embed.wait``, a tower call's wait for the lock, and ``embed.tokenize``.

On one CUDA device holding the whole model (no data shards, no model
shards) the text tower runs as a CUDA graph, one a padded row bucket
(rows, ``max_positions``), captured the first time the bucket is seen and
replayed under the lock: the same kernels (K2 among them) in the same
order, one launch in place of about 20 a layer. Two counters of its own:
``embed.text_graph_capture`` and ``embed.text_graph_replay``. Every other
placement, and the image tower, runs eagerly.

Weights, in order of precedence: ``params=`` (a numpy param tree in the
JAX layout, e.g. ``init_params(jax.random.key(0))`` carried across, which
torch's RNG cannot reproduce), a converted HF checkpoint
(``checkpoint=`` or IMATCH_CLIP_CHECKPOINT), else a seeded random init
from a ``torch.Generator`` (normal(0.02), as the JAX init draws). The
device is ``cuda`` unless ``device="cpu"`` is passed (device.py); compute
is bf16 on the card and fp32 on the CPU.

Data parallelism (``data_parallel=`` or IMATCH_EMBED_DP, as JAX's
embedder): the towers run over the first n visible cards (fewer: a
warning, and those), or over an explicit device list ``mesh=`` (a device
may repeat: P logical shards of one card, or of the CPU). The weights are
replicated (one copy a distinct device) and each padded chunk, text, image
or the fused bulk-ingest step's frames, splits into equal row blocks, one
a shard, gathered back in shard order on the first device; chunks pad to
``pow2_bucket(b, max(chunk, d), multiple=d)``. The W8A8 tower replicates
the same way.

Over a grid that spans processes (``mesh=`` a grid from parallel/
distributed.py's ``initialize`` and ``make_mesh``; every process embeds
the same rows) the grid's shard count is kept: each process runs only its
own shards' blocks (K2 at a data shard's rows) on its own replicas, and
the embeddings are all-gathered in shard order, so every process returns
what one process over the same shard count returns.
"""

from __future__ import annotations

import copy
import logging
import os
import threading
import time
from collections import OrderedDict
from functools import partial
from typing import Dict, NamedTuple, Optional, Sequence

import numpy as np
import torch
from PIL import Image

from imatch_tpu_torch.device import DeviceLike, default_compute_dtype, resolve_device
from imatch_tpu_torch.models.clip.bridge import params_from_numpy
from imatch_tpu_torch.models.clip.configs import CLIPConfig, get_config
from imatch_tpu_torch.models.clip.model import encode_image, encode_text, init_random
from imatch_tpu_torch.ops.collectives import gather
from imatch_tpu_torch.ops.kernels.flash_attention import flash_mha
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
from imatch_tpu_torch.parallel.mesh import as_grid
from imatch_tpu_torch.runtime.scheduler import GATE
from imatch_tpu_torch.utils.batching import pow2_bucket
from imatch_tpu_torch.utils.metrics import METRICS

logger = logging.getLogger("imatch.embedder")

SEED = 0  # the random init's, so embeddings are stable across restarts


class _TextGraph(NamedTuple):
    """One row bucket's captured text tower: its static ids and output,
    and the K2 launches (all, fp32) one replay makes."""

    ids: torch.Tensor
    graph: "torch.cuda.CUDAGraph"
    out: torch.Tensor
    k2: int
    k2_fp32: int


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
        data_parallel: Optional[int] = None,
        mesh: Optional[Sequence] = None,
    ):
        """``quant``: ``"int8"`` for the W8A8 image tower, default from
        IMATCH_EMBED_QUANT (unset or ``none``: the full-precision tower).
        The text tower is never quantized: queries keep full fidelity.
        ``data_parallel``: shard embed batches over this many cards
        (default IMATCH_EMBED_DP; 0 or 1: one device). ``mesh``: the data
        shards' devices themselves, in order (overrides both)."""
        config = config or os.environ.get("IMATCH_CLIP_CONFIG", "vit-b32")
        self.cfg = get_config(config) if isinstance(config, str) else config
        if data_parallel is None:
            data_parallel = int(os.environ.get("IMATCH_EMBED_DP", "0"))
        self.mesh = self._data_shards(device, data_parallel, mesh)
        # JAX's dp: 0 for one device, else the shard count
        self.dp = len(self.mesh) if (mesh is not None or data_parallel > 1) else 0
        self._spanning = getattr(self.mesh, "spans_processes", False)
        self._local = [j for j in range(len(self.mesh)) if not self._spanning or self.mesh.is_local(j)]
        self.device = self.mesh[self._local[0]]
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
        # the weights replicated over the data shards: one copy a device
        self._replicas = {self.device: self.model}
        for dev in (self.mesh[j] for j in self._local):
            if dev not in self._replicas:
                self._replicas[dev] = copy.deepcopy(self.model).to(dev)
        self.tokenizer = default_tokenizer()
        self._lock = threading.Lock()
        # Query-text LRU of device-resident embeddings: a repeated query
        # skips the tokenizer and the text tower. IMATCH_TEXT_CACHE entries
        # (default 1024; 0 disables).
        self._text_cache_cap = int(os.environ.get("IMATCH_TEXT_CACHE", "1024"))
        self._text_cache: "OrderedDict[str, torch.Tensor]" = OrderedDict()
        # The text tower's CUDA graphs by (padded rows, positions), under
        # the lock, with the model and the text tower's parameters they
        # read and those parameters' addresses at capture (_text_graph).
        self._text_graphs: Dict[tuple, _TextGraph] = {}
        self._graph_model = None
        self._graph_params: list = []
        self._graph_ptrs: list = []
        self._graph_pool = None
        self._graph_stream = None
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
            "embedder ready in %.2fs (%s, %s, %s, dp=%d)",
            time.time() - t0,
            self.cfg.name,
            self.device,
            str(self.compute_dtype).replace("torch.", ""),
            self.dp or 1,
        )

    @staticmethod
    def _data_shards(device, data_parallel, mesh) -> Sequence:
        """The data shards' devices: ``mesh`` (a grid as it is given, a
        list as its grid), else the first ``data_parallel`` visible cards
        (fewer: a warning, and those; on the CPU there is one), else
        ``device`` alone."""
        if mesh is not None:
            grid = as_grid(mesh)
            return grid if grid.spans_processes else list(grid)
        dev = resolve_device(device)
        if data_parallel <= 1:
            return [dev]
        visible = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        devices = (visible if dev.type == "cuda" else [dev])[:data_parallel]
        if len(devices) < data_parallel:
            logger.warning(
                "requested dp=%d but only %d devices; using %d",
                data_parallel,
                len(devices),
                len(devices),
            )
        return devices

    @property
    def dim(self) -> int:
        return self.cfg.projection_dim

    def _chunks(self, n: int):
        """``_chunk_bounds`` at IMATCH_EMBED_CHUNK rows (default 512)."""
        return self._chunk_bounds(n, int(os.environ.get("IMATCH_EMBED_CHUNK", "512")))

    def _chunk_bounds(self, n: int, chunk: int):
        """(start, rows, padded rows) of each tower call: chunks of at most
        ``chunk`` rows, each padded up to a power of two by repeating its
        last row, then to a multiple of the data shards."""
        d = self.dp or 1
        for s in range(0, n, chunk):
            b = min(chunk, n - s)
            yield s, b, pow2_bucket(b, max(chunk, d), multiple=d)

    def _sharded(self, fn, rows: torch.Tensor):
        """``fn(model, block)`` on each data shard's equal block of
        ``rows`` (on the shard's device, with its replica), the results
        gathered on the first device in shard order (a tuple of results
        gathered one by one). Over processes: this process's shards only,
        every process's results all-gathered."""
        if len(self.mesh) == 1:
            return fn(self.model, rows)
        per = rows.shape[0] // len(self.mesh)
        outs = [
            fn(self._replicas[self.mesh[j]], rows[j * per : (j + 1) * per].to(self.mesh[j]))
            for j in self._local
        ]
        group = torch.distributed.group.WORLD if self._spanning else None
        if isinstance(outs[0], tuple):
            return tuple(gather(parts, self.device, group=group) for parts in zip(*outs))
        return gather(outs, self.device, group=group)

    def _run_tower(self, fn, rows: torch.Tensor, metric: str) -> torch.Tensor:
        """The tower over ``rows`` under the embedder's lock: the wait for
        the lock is ``embed.wait``, the enqueue under it ``metric``."""
        outs = []
        with METRICS.timer("embed.wait"):
            self._lock.acquire()
        try:
            with METRICS.timer(metric):
                for s, b, bp in self._chunks(rows.shape[0]):
                    part = rows[s : s + b]
                    if bp > b:
                        part = torch.cat([part, part[-1:].expand(bp - b, *part.shape[1:])])
                    outs.append(self._sharded(fn, part)[:b])
        finally:
            self._lock.release()
        return outs[0] if len(outs) == 1 else torch.cat(outs)

    def _embed_pixels(self, pixels: torch.Tensor) -> torch.Tensor:
        return self._run_tower(encode_image, pixels, "embed.image")

    def _embed_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        ids = torch.from_numpy(np.asarray(tokens, np.int64)).to(self.device)
        if self._text_graph_eligible():
            fn = self._replay_text
        else:
            fn = partial(encode_text, eos_token_id=self._model_eos)
        return self._run_tower(fn, ids, "embed.text")

    def _text_graph_eligible(self) -> bool:
        """Whether the text tower replays as a CUDA graph: one CUDA device
        holding the whole model (no data shards, no model shards, no
        model row across processes)."""
        m = self.model
        return (
            self.device.type == "cuda"
            and len(self.mesh) == 1
            and len(m.peers) == 0
            and getattr(m, "row_group", None) is None
        )

    def _replay_text(self, model, ids: torch.Tensor) -> torch.Tensor:
        """``encode_text`` over ``ids`` as its bucket's graph, under the
        lock: the ids copied into the graph's input, one replay, the
        output cloned. The clone is needed: once the lock is released the
        next replay rewrites the graph's output, while this call's
        consumers are still queued behind it on the stream."""
        g = self._text_graph(model, tuple(ids.shape))
        g.ids.copy_(ids)
        g.graph.replay()
        METRICS.inc("embed.text_graph_replay")
        flash_mha.launches += g.k2
        flash_mha.fp32_launches += g.k2_fp32
        return g.out.clone()

    def _text_graph(self, model, shape: tuple) -> _TextGraph:
        """The graph for ``shape``, captured on first use. A graph reads
        the weights at the addresses it captured: weights copied in place
        keep it valid; a new model, or a text-tower parameter given new
        storage (``p.data = ...``, as ``cast_compute`` does), drops every
        graph, checked at each call by the parameters' addresses."""
        if model is not self._graph_model or [p.data_ptr() for p in self._graph_params] != self._graph_ptrs:
            self._text_graphs.clear()
            self._graph_pool = None  # the dropped graphs' memory goes with them
            self._graph_model = model
            self._graph_params = list(model.text.parameters())
            self._graph_ptrs = [p.data_ptr() for p in self._graph_params]
        g = self._text_graphs.get(shape)
        if g is None:
            g = self._text_graphs[shape] = self._capture_text(model, shape)
        return g

    def _capture_text(self, model, shape: tuple) -> _TextGraph:
        """Capture ``encode_text`` at ``shape`` (rows, positions) into the
        graphs' shared pool, on a side stream: one eager run first, which
        does the lazy set-up a capture may not (cuBLAS's workspace, K2's
        shared-memory grant), then the capture, in ``thread_local`` mode
        since other workers may synchronize or allocate meanwhile. Neither
        run counts in K2's launch counters: each replay adds the graph's."""
        if self._graph_stream is None:
            self._graph_stream = torch.cuda.Stream(self.device)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        start = flash_mha.launches, flash_mha.fp32_launches
        ids = torch.full(shape, self._model_eos, dtype=torch.int64, device=self.device)
        main, side = torch.cuda.current_stream(self.device), self._graph_stream
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            encode_text(model, ids, eos_token_id=self._model_eos)
            warm = flash_mha.launches, flash_mha.fp32_launches
            graph.capture_begin(pool=self._graph_pool, capture_error_mode="thread_local")
            try:
                out = encode_text(model, ids, eos_token_id=self._model_eos)
            finally:
                graph.capture_end()
        main.wait_stream(side)
        k2, k2_fp32 = flash_mha.launches - warm[0], flash_mha.fp32_launches - warm[1]
        flash_mha.launches, flash_mha.fp32_launches = start
        METRICS.inc("embed.text_graph_capture")
        return _TextGraph(ids, graph, out, k2, k2_fp32)

    def _tokenize(self, texts: Sequence[str]) -> np.ndarray:
        with METRICS.timer("embed.tokenize"):
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

    def _embed_frames(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        pixels = preprocess_images(
            images,
            device=self.device,
            out_size=self.cfg.vision.image_size,
            dtype=self.compute_dtype,
        )
        return self._embed_pixels(pixels)

    def embed_images_device(self, images: Sequence[np.ndarray]) -> torch.Tensor:
        """uint8 HWC RGB frames (any geometries) -> (N, proj) unit fp32 on
        the device: query images, not counted in ``images_embedded``.

        Preprocessing holds every frame in fp32 on the device before its
        resize, so a batch of camera photos is taken in chunks of at most
        IMATCH_QUERY_PIXEL_BUDGET source pixels (default 2^26, 0.8 GB of
        fp32; a frame above it goes alone): the transient memory stays
        bounded, and a batch of small frames is one chunk."""
        n = len(images)
        if n == 0:
            return torch.zeros((0, self.dim), device=self.device)
        budget = int(os.environ.get("IMATCH_QUERY_PIXEL_BUDGET", str(1 << 26)))
        outs = []
        start = 0
        while start < n:
            end, px = start, 0
            while end < n:
                im_px = images[end].shape[0] * images[end].shape[1]
                if end > start and px + im_px > budget:
                    break
                px += im_px
                end += 1
            outs.append(self._embed_frames(images[start:end]))
            start = end
        return outs[0] if len(outs) == 1 else torch.cat(outs)

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
                    METRICS.inc("embed.text_cache_hit")
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
        if len(images) == 0:
            return np.zeros((0, self.dim), np.float32)
        METRICS.inc("images_embedded", len(images))
        return self._embed_frames(images).cpu().numpy()

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
        the 32x32 grids for the host tail), each data shard on its block
        of the frames (the resample constants replicated). Returns device
        tensors (embeddings, bits, confident, grids)."""
        per_device = {}

        def step(model, block):
            dev = block.device
            if dev not in per_device:
                per_device[dev] = [c.to(dev) for c in consts]
            a_v_c, a_h_c, a_v_p, a_h_p = per_device[dev]
            pixels = preprocess_core(block, a_v_c, a_h_c, dtype=self.compute_dtype)
            emb = encode_image(model, pixels)
            bits, confident, small = phash_core(block, a_v_p, a_h_p)
            return emb, bits, confident, small

        return self._sharded(step, frames)

    def ids_and_embed_images_stream(
        self,
        images: Sequence[Optional[np.ndarray]],
        pool=None,
        max_in_flight: int = 4,
        device_embeddings: bool = False,
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

        Before each chunk's dispatch the stream calls ``GATE.checkpoint()``:
        while a search's store query is in flight it parks there. Past the
        first ``max_in_flight`` chunks each dispatch follows a drain, whose
        copy to the host has waited for its chunk, so a store query queues
        behind at most ``max_in_flight`` chunks (the search's text or image
        tower runs before its priority section, while chunks still
        dispatch).

        Yields (indices, ids, embeddings (len(indices), proj) fp32 numpy).
        With ``device_embeddings=True`` the fused chunks yield their
        embeddings as tensors left on the device (only the hash bits cross
        to the host), for a store add that scatters them device to device;
        the small-bucket tail still yields numpy.
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
            if device_embeddings:
                e = handles[0]  # stays on the device for a d2d store add
                bits, conf, small = (t.cpu().numpy() for t in handles[1:])
            else:
                e, bits, conf, small = (t.cpu().numpy() for t in handles)
            # counted per finished chunk: a stream that dies part way must
            # not count what the caller's fallback embeds again
            METRICS.inc("images_embedded", len(idxs_chunk))
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
                GATE.checkpoint()  # bulk ingest yields to live searches
                part = np.stack([images[i] for i in idxs[s : s + b]])
                with self._lock, METRICS.timer("ingest.fused"):
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
