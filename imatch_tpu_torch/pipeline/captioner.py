"""Captioner/VQA interface — the Moondream slot.

Counterpart of ``imatch_tpu/pipeline/captioner.py``: a handle exposing
``encode_image`` / ``caption`` / ``query``, with a degraded mode when
none is available (captioning and filters disabled), as in the reference
app.

Implementations:
- ``NullCaptioner``  — unavailable (the degraded mode).
- ``MoondreamTorch`` — the port's Moondream-class VLM
  (models/moondream/runtime.py), selected with IMATCH_CAPTIONER=moondream
  or by ``auto``.
- ``CloudCaptioner`` — the hosted Moondream API over stdlib HTTP,
  selected when MOONDREAM_API_KEY is set.

Encoded images are cached to ``static/encoded/<id>.npz`` in the JAX
package's format (``save_encoded`` / ``load_encoded``): a cache written
by either package loads in the other.
"""

from __future__ import annotations

import base64
import io
import json as _json
import logging
import os
import threading
import urllib.request
from typing import Any, Dict, Optional

import numpy as np

from imatch_tpu_torch.device import DeviceLike

logger = logging.getLogger("imatch.captioner")


class NullCaptioner:
    """Moondream-unavailable degraded mode."""

    available = False

    def encode_image(self, image: np.ndarray) -> Optional[Any]:
        return None

    def caption(self, encoded: Any) -> Dict[str, str]:
        raise RuntimeError("captioner unavailable")

    def query(self, encoded: Any, question: str) -> Dict[str, str]:
        raise RuntimeError("captioner unavailable")


class CloudCaptioner:
    """Hosted Moondream API client — the reference's cloud-first mode
    (``md.vl(api_key=...)``), implemented directly over
    the HTTP API so no vendor SDK is needed.

    ``encode_image`` packs the frame as a JPEG data URL (what the API
    consumes); ``caption``/``query`` POST JSON to
    ``{MOONDREAM_API_URL}/caption`` and ``/query`` with the
    ``X-Moondream-Auth`` header. Responses: {"caption": ...} /
    {"answer": ...} — the same dict shapes the local VLM returns, so the
    ingest/filter pipeline is agnostic to which backend answers.
    """

    available = True

    def __init__(self, api_key: str, base_url: Optional[str] = None, timeout: float = 60.0):
        self.api_key = api_key
        self.base_url = (
            base_url
            or os.environ.get("MOONDREAM_API_URL", "https://api.moondream.ai/v1")
        ).rstrip("/")
        self.timeout = timeout

    def encode_image(self, image: np.ndarray) -> Dict[str, Any]:
        from PIL import Image

        from imatch_tpu_torch.utils.batching import to_rgb

        buf = io.BytesIO()
        Image.fromarray(to_rgb(image)).save(buf, "JPEG", quality=92)
        b64 = base64.b64encode(buf.getvalue()).decode("ascii")
        url = f"data:image/jpeg;base64,{b64}"
        # Stored as a uint8 byte array: save_encoded/load_encoded (npz)
        # round-trip it losslessly, and it avoids the 4x UTF-32 bloat a
        # numpy unicode scalar would pay on disk.
        return {"image_url": np.frombuffer(url.encode("ascii"), np.uint8)}

    @staticmethod
    def _url(encoded: Dict[str, Any]) -> str:
        u = encoded["image_url"]
        if isinstance(u, np.ndarray):
            if u.dtype == np.uint8:
                return u.tobytes().decode("ascii")
            return str(u[()])  # legacy unicode-array caches
        return str(u)

    # transient statuses worth one bounded retry round (rate limit /
    # upstream hiccup); anything else fails fast with the body attached
    _RETRY_STATUSES = (429, 500, 502, 503, 504)

    def _post(self, endpoint: str, payload: dict) -> dict:
        import time as _time
        from urllib.error import HTTPError, URLError

        req = urllib.request.Request(
            f"{self.base_url}/{endpoint}",
            data=_json.dumps(payload).encode("utf-8"),
            headers={
                "Content-Type": "application/json",
                "X-Moondream-Auth": self.api_key,
            },
            method="POST",
        )
        attempts = 3
        for attempt in range(attempts):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                    return _json.loads(resp.read().decode("utf-8"))
            except HTTPError as e:
                body = ""
                try:
                    body = e.read().decode("utf-8", "replace")[:500]
                except Exception:
                    pass
                if e.code in self._RETRY_STATUSES and attempt < attempts - 1:
                    delay = 0.5 * (2**attempt)
                    logger.warning(
                        "moondream API %s -> HTTP %d, retrying in %.1fs",
                        endpoint,
                        e.code,
                        delay,
                    )
                    _time.sleep(delay)
                    continue
                raise RuntimeError(
                    f"moondream API {endpoint} failed: HTTP {e.code} {body}"
                ) from e
            except (URLError, TimeoutError, OSError) as e:
                # DNS blips / connection resets / socket timeouts are at
                # least as transient as a 503 — same bounded retry
                if attempt < attempts - 1:
                    delay = 0.5 * (2**attempt)
                    logger.warning(
                        "moondream API %s -> %s, retrying in %.1fs",
                        endpoint,
                        e,
                        delay,
                    )
                    _time.sleep(delay)
                    continue
                raise RuntimeError(
                    f"moondream API {endpoint} failed: {e}"
                ) from e

    def caption(self, encoded: Dict[str, Any]) -> Dict[str, str]:
        out = self._post(
            "caption",
            {"image_url": self._url(encoded), "length": "normal"},
        )
        return {"caption": out.get("caption", "")}

    def query(self, encoded: Dict[str, Any], question: str) -> Dict[str, str]:
        out = self._post(
            "query",
            {"image_url": self._url(encoded), "question": question},
        )
        return {"answer": out.get("answer", "")}


def save_encoded(path_dir: str, image_id: str, encoded: Any) -> str:
    """Atomic (tmp + os.replace): a crash mid-write must not leave a
    truncated .npz that poisons every later backfill of this image —
    the same torn-write discipline as save_filters and the store
    snapshot."""
    os.makedirs(path_dir, exist_ok=True)
    path = os.path.join(path_dir, f"{image_id}.npz")
    # np.savez appends ".npz" to names lacking it — keep the suffix.
    # pid + thread id: two serving threads saving the SAME image id
    # concurrently (double-upload race) must not share a tmp — one
    # thread's finally-unlink would delete the other's in-progress file
    # and its os.replace would promote a torn write
    tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp.npz"
    try:
        if isinstance(encoded, dict):
            np.savez(tmp, **{k: np.asarray(v) for k, v in encoded.items()})
        else:
            np.savez(tmp, encoded=np.asarray(encoded))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def load_encoded(path_dir: str, image_id: str) -> Optional[Dict[str, np.ndarray]]:
    path = os.path.join(path_dir, f"{image_id}.npz")
    if not os.path.exists(path):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception as e:  # legacy torn files: behave like a cache miss
        logger.warning("unreadable encoded cache %s: %s", path, e)
        return None


def get_captioner(device: DeviceLike = None):
    """Factory from IMATCH_CAPTIONER env, the reference app's cloud ->
    local -> disabled fallback chain:

    - ``null``: disabled.
    - ``cloud``: hosted API (requires MOONDREAM_API_KEY).
    - ``moondream``: the local VLM, ``MoondreamTorch`` on ``device``
      (raise on init failure).
    - ``auto`` (default): cloud when MOONDREAM_API_KEY is set, else
      local, else the null degraded mode.
    """
    choice = os.environ.get("IMATCH_CAPTIONER", "auto")
    if choice == "null":
        return NullCaptioner()
    api_key = os.environ.get("MOONDREAM_API_KEY")
    if choice == "cloud" or (choice == "auto" and api_key):
        if api_key:
            logger.info(
                "moondream cloud API captioner (key configured, %d chars)",
                len(api_key),
            )
            return CloudCaptioner(api_key)
        if choice == "cloud":
            raise RuntimeError("IMATCH_CAPTIONER=cloud needs MOONDREAM_API_KEY")
    try:
        from imatch_tpu_torch.models.moondream.runtime import MoondreamTorch

        return MoondreamTorch(device=device)
    except Exception:
        if choice == "moondream":
            raise
        logger.warning(
            "captioner init failed; captions and filters disabled",
            exc_info=True,
        )
        return NullCaptioner()
