"""Experiment scripts of the port, run as modules on the card:

    python -m imatch_tpu_torch.scripts.exp_int4_kernel     # K5
    python -m imatch_tpu_torch.scripts.exp_pallas_search   # K6 beside K1

Ports of ``scripts/exp_int4_kernel.py`` and ``scripts/exp_pallas_search.py``,
the only callers of the TPU kernels K5 and K6. Each prints one JSON line;
``--device cpu`` runs the correctness part at a small size. Beside them,
two measurement scripts for the card: ``kernel_ab`` (every kernel and the
image towers, to compare two checkouts) and ``md_stages`` (the Moondream
captioner's stages).
"""
