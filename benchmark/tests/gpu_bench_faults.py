"""Faults planted under the caption-search cell's timed path, each with
a ``monkeypatch`` (pytest's): the CPU tests plant them at the tiny sizes,
and ``plant.py`` runs a cell on a card with one planted, for the readings
its limits were set from. Each breaks one stage the cell's ``why`` names
and has to come out not correct."""

from __future__ import annotations


def _decode_step(monkeypatch, change):
    from imatch_tpu_torch.models.moondream import generate

    real = generate._decode_step
    monkeypatch.setattr(generate, "_decode_step", lambda model, state: change(real, model, state))


def decode_at_wrong_position(monkeypatch):
    """Every decode step runs one position late: its rotary angle and its
    cache slot off by one, the slot it skips left empty."""

    def late(real, model, state):
        return real(model, state._replace(pos=state.pos + 1))._replace(pos=state.pos + 1)

    _decode_step(monkeypatch, late)


def token_altered(monkeypatch):
    """The sixth generated token replaced by the next id where it is
    produced (and fed back as such)."""
    def altered(real, model, state):
        st = real(model, state)
        if state.i != 5:
            return st
        tok = (st.last + 1) % model.cfg.text.vocab_size
        st.out[:, 5] = tok
        return st._replace(last=tok, done=state.done | (tok == model.cfg.text.eos_token_id))

    _decode_step(monkeypatch, altered)


def _previous(monkeypatch, cls, name, arg=None):
    """Each call of ``cls.name`` after the first runs on the previous
    call's ``arg``-th argument (another request's), or with ``arg`` None
    returns the previous call's answer."""
    real = getattr(cls, name)
    last = {}

    def swapped(self, *args, **kw):
        if arg is None:
            out = real(self, *args, **kw)
            prev = last.get("v", out)
            last["v"] = out
            return prev
        args = list(args)
        mine = args[arg]
        if "v" in last:
            args[arg] = last["v"]
        last["v"] = mine
        return real(self, *args, **kw)

    monkeypatch.setattr(cls, name, swapped)


def caption_of_another_request(monkeypatch):
    """The captioner answers with the previous request's caption."""
    from imatch_tpu_torch.models.moondream.runtime import MoondreamTorch

    _previous(monkeypatch, MoondreamTorch, "caption")


def captioner_wrong_image(monkeypatch):
    """The captioner encodes the previous request's image."""
    from imatch_tpu_torch.models.moondream.runtime import MoondreamTorch

    _previous(monkeypatch, MoondreamTorch, "encode_image", 0)


def image_tower_wrong_image(monkeypatch):
    """The CLIP image tower embeds the previous request's image."""
    from imatch_tpu_torch.pipeline.embedder import ClipEmbedder

    _previous(monkeypatch, ClipEmbedder, "embed_image_device", 0)


def caption_dropped(monkeypatch):
    """The caption left out of the query the text tower embeds."""
    from imatch_tpu_torch.pipeline import search

    monkeypatch.setattr(search, "enhance_query_with_caption", lambda state, image, query, **kw: query)


def answer_altered(monkeypatch):
    """The store's first result replaced by its neighbour row."""
    from imatch_tpu_torch.index.store import VectorStore

    real = VectorStore._query_impl

    def altered(self, q, n, include):
        out = real(self, q, n, include)
        if out["ids"] and out["ids"][0]:
            other = "img_" + format(int(out["ids"][0][0][4:], 16) ^ 1, "016x")
            out["ids"][0][0] = other
            out["metadatas"][0][0] = self.get(ids=[other])["metadatas"][0]
        return out

    monkeypatch.setattr(VectorStore, "_query_impl", altered)


CAPTION_FAULTS = {
    "caption-decode-wrong-position": decode_at_wrong_position,
    "caption-token-altered": token_altered,
    "caption-of-another-request": caption_of_another_request,
    "captioner-wrong-image": captioner_wrong_image,
    "image-tower-wrong-image": image_tower_wrong_image,
    "caption-dropped": caption_dropped,
    "answer-altered": answer_altered,
}
