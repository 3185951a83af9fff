"""Captioner/VQA interface — the Moondream slot, degraded mode only.

Counterpart of ``NullCaptioner`` in ``imatch_tpu/pipeline/captioner.py``:
captioning and filters unavailable, as in the reference app when
Moondream is absent. The Moondream captioner and the cloud client are a
later slice (ROADMAP.md Queue 1 step 10).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np


class NullCaptioner:
    """Moondream-unavailable degraded mode."""

    available = False

    def encode_image(self, image: np.ndarray) -> Optional[Any]:
        return None

    def caption(self, encoded: Any) -> Dict[str, str]:
        raise RuntimeError("captioner unavailable")

    def query(self, encoded: Any, question: str) -> Dict[str, str]:
        raise RuntimeError("captioner unavailable")
