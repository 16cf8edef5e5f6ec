"""The dataset generator: source images to target and styled (Amiga-degraded)
PNG crops, with per-crop palettes and dithering on the card."""
