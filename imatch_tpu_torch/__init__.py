"""imatch_tpu_torch — the PyTorch/CUDA port of imatch_tpu for one NVIDIA H100.

It mirrors ``imatch_tpu``'s module paths (the counterpart of
``imatch_tpu/index/store.py`` is ``imatch_tpu_torch/index/store.py``),
imports ``torch`` and never ``jax`` or ``imatch_tpu``, and keeps its own
copies of the framework-free modules it needs. Each TPU kernel on its path
is a CUDA C++ kernel under ``csrc/``, built with nvcc on first use
(``ops/kernels/_build.py``).

This slice serves the main path: upload, and text, image and multimodal
search, with the CLIP towers (attention through K2, ``csrc/
flash_attention.cu``) and the exact two-phase top-k (phase 1 through K1,
``csrc/tile_max.cu``). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
