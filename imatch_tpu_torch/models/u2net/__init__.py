"""U²-Net background removal (models/u2net)."""
