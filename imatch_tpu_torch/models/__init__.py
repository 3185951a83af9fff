"""Model code: the CLIP family."""
