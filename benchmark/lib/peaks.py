"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit). Every roofline
and mfu share of the benchmark divides by these numbers; a card set below
700 W reads lower against them, so each result carries the card's power
limit beside them."""

BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
INT8_OPS = 1979e12
HBM_BYTES_PER_S = 3.35e12

CARD = "NVIDIA H100 SXM"
