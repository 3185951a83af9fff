"""MoondreamTorch — the in-process captioner and VQA service.

Counterpart of ``imatch_tpu/models/moondream/runtime.py`` ``MoondreamJax``,
with its interface: ``encode_image`` / ``caption`` / ``query`` with dict
results, and the batched ``encode_image_batch`` / ``caption_batch`` /
``query_yes_no_batch`` in fixed chunks (IMATCH_VLM_ENC_CHUNK 16,
IMATCH_VLM_CAP_CHUNK 16, IMATCH_VLM_VQA_CHUNK 64), each chunk padded to a
power of two by repeating its last row. Yes/no questions ("Yes or No:
...", the filter system's whole traffic) take one cache-free prefill and
a yes-vs-no comparison (generate.vqa_yes_no). The vision encoding is an
(P, D) fp32 array the caller may cache (pipeline/captioner.py).

Runs on ``cuda`` unless ``device="cpu"`` is passed (device.py); compute
is bf16 on the card and fp32 on the CPU, as MoondreamJax on the TPU and
the CPU. Environment, as in JAX:

- IMATCH_MD_CONFIG: the geometry (default ``tiny-md``, ``moondream2``
  when IMATCH_MD_CHECKPOINT is set); IMATCH_MD_CHECKPOINT: a converted HF
  checkpoint; without one, seeded random weights (``init_random``), or
  ``params=``, a numpy tree in the JAX layout (e.g. JAX's
  ``init_md_params(jax.random.key(0))``, which torch's RNG cannot
  reproduce).
- IMATCH_MD_PARAM_DTYPE: the weights' storage precision, bf16 (the card's
  default) or fp32 (the CPU's).
- IMATCH_MD_PACKED (default 1): one packed q/k/v/MLP-in projection a
  decoder layer.
- IMATCH_MD_VOCAB / IMATCH_MD_MERGES: a GPT-2 vocab, else the byte
  fallback; with a checkpoint the byte fallback needs
  IMATCH_MD_ALLOW_BYTE_VOCAB=1.
- IMATCH_MD_SEG (default 8): caption decode in segments of that many
  steps (0: one loop); the tokens are the same either way.
- IMATCH_MD_QUANT=int8: int8 decoder and LM-head weights
  (``quantize_int8``, after the cast and the packing, as in JAX).
- IMATCH_MD_CACHE=int8: the caption and query decode's KV cache in int8
  with per-slot scales.
- IMATCH_MD_ACT=int8: the W8A8 prefill (K4 and K3 feeding int8 x int8
  products) of captions, queries and yes/no chunks; it needs
  IMATCH_MD_QUANT=int8, and another value than int8, none or unset is a
  ValueError, as in JAX.

The bulk paths park at ``GATE.checkpoint()`` (runtime/scheduler.py)
before each encode chunk, decode segment and yes/no chunk, a point where
the host has already waited for the previous one, so a search during a
back-fill waits for at most one of them. Each call is timed under the JAX
package's ``vlm.*`` METRICS names.
"""

from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional

import numpy as np
import torch

from imatch_tpu_torch.device import DeviceLike, default_compute_dtype, resolve_device
from imatch_tpu_torch.models.moondream.bridge import init_random, md_params_from_numpy
from imatch_tpu_torch.models.moondream.configs import get_md_config
from imatch_tpu_torch.models.moondream.generate import (
    finish_gen,
    gen_segment,
    greedy_generate,
    init_gen_state,
    prefill,
    vqa_yes_no,
)
from imatch_tpu_torch.models.moondream.model import encode_image_features, quantize_int8
from imatch_tpu_torch.ops.resize import resample_matrix
from imatch_tpu_torch.runtime.scheduler import GATE
from imatch_tpu_torch.utils.metrics import METRICS
from imatch_tpu_torch.ops.tokenizer_gpt2 import GPT2Tokenizer
from imatch_tpu_torch.utils.batching import pad_rows, pow2_bucket, to_rgb

CAPTION_PROMPT = "\n\nQuestion: Describe this image.\n\nAnswer:"
SEED = 0  # the random init's, so captions are stable across restarts

def _is_yes_no(question: str) -> bool:
    ql = question.lower()
    return "yes or no:" in ql or "yes/no:" in ql


def _int8_modes() -> tuple:
    """(int8 weights, W8A8 prefill, int8 cache) from the environment, with
    JAX's validation of IMATCH_MD_ACT."""
    quant = os.environ.get("IMATCH_MD_QUANT", "") == "int8"
    md_act = os.environ.get("IMATCH_MD_ACT", "").strip().lower()
    if md_act not in ("", "none", "int8"):
        raise ValueError(f"IMATCH_MD_ACT={md_act!r}: expected 'int8' or unset")
    if md_act == "int8" and not quant:
        raise ValueError(
            "IMATCH_MD_ACT=int8 (W8A8 prefill) requires "
            "IMATCH_MD_QUANT=int8 (the int8 weights it contracts with)"
        )
    return quant, md_act == "int8", os.environ.get("IMATCH_MD_CACHE", "") == "int8"


class MoondreamTorch:
    available = True

    def __init__(
        self,
        config: Optional[str] = None,
        checkpoint: Optional[str] = None,
        params: Optional[Dict] = None,
        device: DeviceLike = None,
    ):
        quant, self.act_quant, int8_cache = _int8_modes()
        self.cache_dtype = torch.int8 if int8_cache else None
        self.device = resolve_device(device)
        self.dtype = default_compute_dtype(self.device)
        checkpoint = checkpoint or os.environ.get("IMATCH_MD_CHECKPOINT")
        config = config or os.environ.get(
            "IMATCH_MD_CONFIG", "moondream2" if checkpoint else "tiny-md"
        )
        self.cfg = get_md_config(config)
        pdt = os.environ.get(
            "IMATCH_MD_PARAM_DTYPE", "bf16" if self.device.type == "cuda" else "fp32"
        )
        if pdt not in ("bf16", "bfloat16", "fp32", "float32"):
            raise ValueError(
                f"unknown IMATCH_MD_PARAM_DTYPE {pdt!r}; valid: bf16, fp32"
                " (int8 decode is IMATCH_MD_QUANT=int8)"
            )
        param_dtype = torch.bfloat16 if pdt in ("bf16", "bfloat16") else torch.float32
        packed = os.environ.get("IMATCH_MD_PACKED", "1") != "0"
        if checkpoint and params is None:
            from imatch_tpu_torch.models.moondream.convert import load_md_checkpoint

            params = load_md_checkpoint(checkpoint, self.cfg)
        if params is not None:
            self.model = md_params_from_numpy(
                params, self.cfg, device=self.device, dtype=self.dtype,
                param_dtype=param_dtype, packed=packed,
            )
        else:
            self.model = init_random(
                self.cfg, seed=SEED, device=self.device, dtype=self.dtype,
                param_dtype=param_dtype, packed=packed,
            )
        if quant:
            quantize_int8(self.model)
        vocab = os.environ.get("IMATCH_MD_VOCAB")
        merges = os.environ.get("IMATCH_MD_MERGES")
        if vocab and merges:
            self.tokenizer = GPT2Tokenizer.from_files(vocab, merges)
        else:
            if checkpoint and os.environ.get("IMATCH_MD_ALLOW_BYTE_VOCAB", "") != "1":
                # real weights and the byte-fallback vocab give garbage
                # captions and answers (byte ids mean nothing to the model)
                raise RuntimeError(
                    "IMATCH_MD_CHECKPOINT is set but IMATCH_MD_VOCAB/"
                    "IMATCH_MD_MERGES are not: real moondream weights "
                    "need the real GPT-2 vocab (WEIGHTS.md). Set "
                    "IMATCH_MD_ALLOW_BYTE_VOCAB=1 to override."
                )
            self.tokenizer = GPT2Tokenizer.byte_fallback(
                bos_id=min(256, self.cfg.text.vocab_size - 2),
                eos_id=min(257, self.cfg.text.vocab_size - 1),
            )
        tok = self.tokenizer
        self._yes_ids = tuple(tok.token_ids_for_word("yes") or [tok.encode("Y")[0], tok.encode("y")[0]])
        self._no_ids = tuple(tok.token_ids_for_word("no") or [tok.encode("N")[0], tok.encode("n")[0]])
        self._lock = threading.Lock()
        self._size = self.cfg.vision.image_size
        self._resize_cache: Dict[tuple, tuple] = {}

    # -- image encoding -------------------------------------------------

    def _preprocess(self, image) -> torch.Tensor:
        """PIL image or HWC uint8 array -> (1, S, S, 3) fp32 in [-1, 1].

        A full-frame squash to (S, S), bicubic, not a shortest-edge resize
        and center crop: moondream2's trained preprocessing resizes the
        whole frame, so a crop would drop the edges of non-square images."""
        arr = to_rgb(image)
        h, w = arr.shape[:2]
        key = (h, w)
        if key not in self._resize_cache:
            if len(self._resize_cache) >= 64:  # bound the device matrices kept
                self._resize_cache.pop(next(iter(self._resize_cache)))
            self._resize_cache[key] = tuple(
                torch.from_numpy(resample_matrix(n, self._size, "bicubic")).to(self.device)
                for n in (h, w)
            )
        a_v, a_h = self._resize_cache[key]
        # the native dtype crosses to the device, the cast happens there
        x = torch.tensor(arr, device=self.device)[None].float()
        x = torch.einsum("xw,bhwc->bhxc", a_h, x)
        x = torch.einsum("yh,bhxc->byxc", a_v, x)
        return x * (2.0 / 255.0) - 1.0  # SigLIP normalization (mean = std = 0.5)

    def _encode(self, pixels: torch.Tensor) -> np.ndarray:
        return encode_image_features(self.model, pixels).float().cpu().numpy()

    def encode_image(self, image) -> Dict[str, np.ndarray]:
        with self._lock, METRICS.timer("vlm.encode"):
            return {"features": self._encode(self._preprocess(image))[0]}

    def _feats(self, encoded: Any) -> torch.Tensor:
        f = encoded["features"] if isinstance(encoded, dict) else encoded
        f = torch.as_tensor(np.asarray(f, np.float32), device=self.device)
        return f[None] if f.ndim == 2 else f

    # -- generation -----------------------------------------------------

    def _prompt_id_list(self, text: str, max_new: int = 0) -> list:
        """Tokenized prompt, BOS first, cut so that prompt + image patches
        + max_new decode steps fit max_seq. Every prompt entering prefill
        passes through this budget."""
        ids = [self.tokenizer.bos_id] + self.tokenizer.encode(text)
        budget = self.cfg.text.max_seq - self.cfg.vision.num_patches - max_new - 1
        return ids[: max(budget, 1)]

    def _tokens(self, ids: list, rows: int) -> torch.Tensor:
        return torch.tensor([ids] * rows, dtype=torch.int64, device=self.device)

    def _prefill(self, feats, tokens, max_new: int):
        return prefill(
            self.model, feats, tokens, max_new=max_new,
            act_quant=self.act_quant, cache_dtype=self.cache_dtype,
        )

    def _vqa(self, feats, tokens):
        return vqa_yes_no(
            self.model, feats, tokens, self._yes_ids, self._no_ids, act_quant=self.act_quant
        )

    def _generate(self, feats, tokens, max_new: int):
        logits, cache, pos = self._prefill(feats, tokens, max_new)
        return greedy_generate(self.model, logits, cache, pos, max_new=max_new)

    def _generate_segmented(self, feats, tokens, max_new: int, seg: int):
        """Prefill, then decode in segments of ``seg`` steps, parking at the
        gate before each (every decode step reads ``done`` on the host, so
        the card holds no queued segment there)."""
        logits, cache, pos = self._prefill(feats, tokens, max_new)
        state = init_gen_state(self.model, logits, cache, pos, max_new=max_new)
        for _ in range(-(-max_new // seg)):
            GATE.checkpoint()
            state = gen_segment(self.model, state, steps=seg, max_new=max_new)
        return finish_gen(state, eos=self.cfg.text.eos_token_id, max_new=max_new)

    def _run_generate(self, feats, tokens, max_new: int):
        seg = int(os.environ.get("IMATCH_MD_SEG", "8"))
        if 0 < seg < max_new:
            return self._generate_segmented(feats, tokens, max_new, seg)
        return self._generate(feats, tokens, max_new)

    def _decode_texts(self, result, rows: int) -> list:
        toks = result.tokens.cpu().numpy()
        lens = result.lengths.cpu().numpy()
        return [self.tokenizer.decode(toks[i][: int(lens[i])]).strip() for i in range(rows)]

    def caption(self, encoded: Any, max_new: int = 48) -> Dict[str, str]:
        with self._lock, METRICS.timer("vlm.caption"):
            tokens = self._tokens(self._prompt_id_list(CAPTION_PROMPT, max_new=max_new), 1)
            result = self._run_generate(self._feats(encoded), tokens, max_new)
            return {"caption": self._decode_texts(result, 1)[0]}

    def query(self, encoded: Any, question: str, max_new: int = 32) -> Dict[str, str]:
        with self._lock, METRICS.timer("vlm.query"):
            feats = self._feats(encoded)
            prompt = f"\n\nQuestion: {question}\n\nAnswer:"
            tokens = self._tokens(self._prompt_id_list(prompt, max_new=max_new), 1)
            if _is_yes_no(question):
                is_yes = self._vqa(feats, tokens)
                return {"answer": "Yes" if bool(is_yes[0]) else "No"}
            result = self._run_generate(feats, tokens, max_new)
            return {"answer": self._decode_texts(result, 1)[0]}

    # -- batched paths ----------------------------------------------------
    #
    # Fixed-size chunks, the last padded to a power of two: a whole-folder
    # batch would exhaust device memory (the KV cache is ~100 MB a row at
    # moondream2 geometry) and the bucket keeps the shapes few.

    def encode_image_batch(self, images) -> list:
        """Vision-encode a batch in chunks of IMATCH_VLM_ENC_CHUNK (16).
        ``_preprocess`` maps every geometry to one (S, S, 3) input, so a
        chunk spans the batch in order, whatever the frames' sizes."""
        chunk = int(os.environ.get("IMATCH_VLM_ENC_CHUNK", "16"))
        arrs = [to_rgb(im) for im in images]
        out: list = [None] * len(arrs)
        with self._lock, METRICS.timer("vlm.encode_batch"):
            for s in range(0, len(arrs), chunk):
                GATE.checkpoint()  # the last chunk's features are on the host
                part = list(range(s, min(s + chunk, len(arrs))))
                pix = torch.cat([self._preprocess(arrs[i]) for i in part], dim=0)
                feats = self._encode(pad_rows(pix, pow2_bucket(len(part), chunk)))
                for j, i in enumerate(part):
                    out[i] = {"features": feats[j]}
        return out

    def _batched_feats(self, part: list, rows: int) -> torch.Tensor:
        return pad_rows(torch.cat([self._feats(e) for e in part], dim=0), rows)

    def caption_batch(self, encoded_list, max_new: int = 48) -> list:
        """Batched prefill and one shared decode loop a chunk of
        IMATCH_VLM_CAP_CHUNK (16) captions."""
        if not encoded_list:
            return []
        chunk = int(os.environ.get("IMATCH_VLM_CAP_CHUNK", "16"))
        ids = self._prompt_id_list(CAPTION_PROMPT, max_new=max_new)
        texts: list = []
        with self._lock, METRICS.timer("vlm.caption_batch"):
            for s in range(0, len(encoded_list), chunk):
                part = encoded_list[s : s + chunk]
                b = pow2_bucket(len(part), chunk)
                result = self._run_generate(self._batched_feats(part, b), self._tokens(ids, b), max_new)
                texts.extend(self._decode_texts(result, len(part)))
        return texts

    def query_yes_no_batch(self, encoded_list, question: str) -> list:
        """Prefill-only yes/no for a batch of images and one question, in
        chunks of IMATCH_VLM_VQA_CHUNK (64); the prefill is cache-free."""
        if not encoded_list:
            return []
        chunk = int(os.environ.get("IMATCH_VLM_VQA_CHUNK", "64"))
        # max_new=1: prefill only, but the prompt must still fit the budget
        ids = self._prompt_id_list(f"\n\nQuestion: {question}\n\nAnswer:", max_new=1)
        out: list = []
        with self._lock, METRICS.timer("vlm.query_batch"):
            for s in range(0, len(encoded_list), chunk):
                GATE.checkpoint()  # the last chunk's answers are on the host
                part = encoded_list[s : s + chunk]
                b = pow2_bucket(len(part), chunk)
                ans = self._vqa(self._batched_feats(part, b), self._tokens(ids, b))
                out.extend(bool(a) for a in ans.cpu().numpy()[: len(part)])
        return out
