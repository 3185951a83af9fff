"""Autoregressive generation and the yes/no VQA fast path.

Counterpart of ``imatch_tpu/models/moondream/generate.py``. Generation is
a Python loop of single-token ``decoder_forward`` calls that write the KV
cache in place (JAX runs a ``lax.while_loop`` over a donated carry), with
per-row EOS masking for batched decode. ``gen_segment`` advances it by a
bounded number of steps; segments compose to exactly ``greedy_generate``
(the same step body and EOS masking). The loop tests for all rows done
once a step, on the host.

``vqa_yes_no`` answers a yes/no question with one cache-free prefill and
a yes-vs-no probability comparison: no decode loop, no KV cache.

Every row of a batch has the same prompt length, so the position is one
int (JAX carries it per row, all rows equal).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from imatch_tpu_torch.models.moondream.model import (
    KVCache,
    MoondreamModel,
    decoder_forward,
    embed_tokens,
    init_cache,
    lm_logits,
)


@torch.no_grad()
def prefill(
    model: MoondreamModel,
    image_embeds: torch.Tensor,
    token_ids: torch.Tensor,
    *,
    max_new: int = 0,
    use_cache: bool = True,
) -> Tuple[torch.Tensor, Optional[KVCache], int]:
    """Run [BOS; image patches; prompt tokens] through the decoder.

    moondream2 checkpoints were trained with the BOS embedding at position
    0 BEFORE the image patches, so token_ids[:, 0] must be BOS (the
    runtime's ``_prompt_id_list`` guarantees it).

    image_embeds: (B, P, D) projected vision features; token_ids: (B, S)
    prompt ids, BOS first, no padding. ``max_new > 0`` sizes the KV cache
    to the 128-slot bucket just above prompt + max_new instead of max_seq.
    ``use_cache=False``: cache-free, no KV buffers at all (the VQA path
    reads only the logits). The cache is built from the cache-free
    forward's own keys and values, padded. Returns (last logits (B, V)
    fp32, cache or None, next position)."""
    cfg = model.cfg
    b = token_ids.shape[0]
    tok = embed_tokens(model, token_ids)
    img = image_embeds.to(tok.dtype)
    seq = torch.cat([tok[:, :1], img, tok[:, 1:]], dim=1)
    s = seq.shape[1]
    if not use_cache:
        hidden, _ = decoder_forward(model, seq, None, 0)
        return lm_logits(model, hidden[:, -1:, :])[:, 0], None, s
    n = cfg.text.max_seq
    if max_new:
        n = min(n, -(-(s + max_new) // 128) * 128)
    hidden, (ks, vs) = decoder_forward(model, seq, None, 0, collect_kv=True)
    cache = init_cache(cfg, b, device=ks.device, dtype=ks.dtype, cache_len=n)
    cache.k[:, :, :, :s] = ks
    cache.v[:, :, :, :s] = vs
    del ks, vs
    return lm_logits(model, hidden[:, -1:, :])[:, 0], cache, s


class GenResult(NamedTuple):
    tokens: torch.Tensor  # (B, max_new) int64, eos-padded
    lengths: torch.Tensor  # (B,) produced tokens per row (incl. eos)


class GenState(NamedTuple):
    """The decode loop's state, exposed so the loop can run in bounded
    segments with the cache staying on the device between them."""

    i: int  # tokens produced so far
    last: torch.Tensor  # (B,) last emitted token
    pos: int  # next cache slot
    cache: KVCache
    done: torch.Tensor  # (B,) bool, per-row EOS
    out: torch.Tensor  # (B, max_new) int64, eos-padded


def init_gen_state(
    model: MoondreamModel,
    first_logits: torch.Tensor,
    cache: KVCache,
    start_pos: int,
    *,
    max_new: int,
) -> GenState:
    eos = model.cfg.text.eos_token_id
    b = first_logits.shape[0]
    first_tok = torch.argmax(first_logits, dim=-1)
    out = torch.full((b, max_new), eos, dtype=torch.int64, device=first_logits.device)
    out[:, 0] = first_tok
    return GenState(1, first_tok, start_pos, cache, first_tok == eos, out)


@torch.no_grad()
def _decode_step(model: MoondreamModel, state: GenState) -> GenState:
    eos = model.cfg.text.eos_token_id
    i, last, pos, cache, done, out = state
    emb = embed_tokens(model, last[:, None])
    hidden, cache = decoder_forward(model, emb, cache, pos)
    nxt = torch.argmax(lm_logits(model, hidden)[:, 0], dim=-1)
    nxt = torch.where(done, eos, nxt)
    out[:, i] = nxt
    return GenState(i + 1, nxt, pos + 1, cache, done | (nxt == eos), out)


def gen_segment(model: MoondreamModel, state: GenState, *, steps: int, max_new: int) -> GenState:
    """Advance the greedy decode by at most ``steps`` tokens; a segment
    past the end (every row done, or max_new reached) does nothing."""
    limit = min(state.i + steps, max_new)
    while state.i < limit and not bool(state.done.all()):
        state = _decode_step(model, state)
    return state


def finish_gen(state: GenState, *, eos: int, max_new: int) -> GenResult:
    out = state.out
    is_eos = out == eos
    lengths = torch.argmax(is_eos.int(), dim=1) + 1
    lengths = torch.where(is_eos.any(dim=1), lengths, max_new)
    return GenResult(out, lengths)


def greedy_generate(
    model: MoondreamModel,
    first_logits: torch.Tensor,
    cache: KVCache,
    start_pos: int,
    *,
    max_new: int = 64,
) -> GenResult:
    """Greedy decode from a prefilled cache; stops per row at EOS. One
    segment of max_new steps."""
    state = init_gen_state(model, first_logits, cache, start_pos, max_new=max_new)
    state = gen_segment(model, state, steps=max_new, max_new=max_new)
    return finish_gen(state, eos=model.cfg.text.eos_token_id, max_new=max_new)


@torch.no_grad()
def vqa_yes_no(
    model: MoondreamModel,
    image_embeds: torch.Tensor,
    token_ids: torch.Tensor,
    yes_ids: Sequence[int],
    no_ids: Sequence[int],
) -> torch.Tensor:
    """Batched yes/no: True where P(yes) > P(no), probabilities summed
    over the token variants of each answer word. Cache-free prefill."""
    logits, _, _ = prefill(model, image_embeds, token_ids, use_cache=False)
    probs = torch.softmax(logits, dim=-1)
    dev = probs.device
    p_yes = probs[:, torch.as_tensor(list(yes_ids), device=dev)].sum(dim=-1)
    p_no = probs[:, torch.as_tensor(list(no_ids), device=dev)].sum(dim=-1)
    return p_yes > p_no
