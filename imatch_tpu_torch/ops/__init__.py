"""Compute ops: CUDA kernel wrappers, attention, preprocess, pHash, tokenizer."""
