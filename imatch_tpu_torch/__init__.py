"""imatch_tpu_torch — the PyTorch/CUDA port of imatch_tpu for one NVIDIA H100.

It mirrors ``imatch_tpu``'s module paths (the counterpart of
``imatch_tpu/index/store.py`` is ``imatch_tpu_torch/index/store.py``),
imports ``torch`` and never ``jax`` or ``imatch_tpu``, and keeps its own
copies of the framework-free modules it needs. Each TPU kernel on its path
is a CUDA C++ kernel under ``csrc/``, built with nvcc on first use
(``ops/kernels/_build.py``).

It serves upload, bulk ingest and text, image and multimodal search: the
CLIP towers (attention through K2, ``csrc/flash_attention.cu``; the W8A8
image tower's activation quantizes through K3 and K4, ``csrc/quantize.cu``)
and the exact two-phase top-k (phase 1 through K1, ``csrc/tile_max.cu``,
whose int8 variant serves the int8 score tier and the tilemax-host capacity
tier). The experiment scripts under ``scripts/`` run the last two TPU
kernels' ports, K5 (``csrc/int4_tile_max.cu``) and K6
(``csrc/tile_max_t.cu``). ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
