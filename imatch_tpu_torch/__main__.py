"""Launcher: ``python -m imatch_tpu_torch``, the PyTorch port's run.py.

Env config (the same names as run.py):
  PORT                    server port (default 8000)
  IMATCH_ROOT             app data root (static/) (default .)
  IMATCH_CLIP_CONFIG      vit-b32 | vit-l14 | longclip-l14-248 (default vit-b32)
  IMATCH_CLIP_CHECKPOINT  local HF checkpoint dir for real weights
  IMATCH_INDEX_ENGINE     tilemax (default) | pallas | auto
  IMATCH_SCORE_DTYPE      bf16 (default) | fp32
  IMATCH_EMBED_QUANT      int8 for the W8A8 image tower (default unset)
  IMATCH_DEVICE           cuda (default) | cpu

On ``cuda`` the CUDA kernels are built (nvcc, ops/kernels/_build.py) and
the CLIP weights loaded before the server starts listening, so the first
request pays neither.
"""

from __future__ import annotations

import logging
import os


def main() -> None:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    from imatch_tpu_torch.device import resolve_device
    from imatch_tpu_torch.serving.app import create_app
    from imatch_tpu_torch.serving.server import serve

    device = resolve_device(os.environ.get("IMATCH_DEVICE") or None)
    if device.type == "cuda":
        from imatch_tpu_torch.ops.kernels import _build

        _build.build()
    app = create_app(root=os.environ.get("IMATCH_ROOT", "."), device=device)
    app.state.get_embedder()
    serve(app, port=int(os.environ.get("PORT", "8000")))


if __name__ == "__main__":
    main()
