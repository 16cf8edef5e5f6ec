"""The traffic's frames, made from the seed: emulator frames, pixel-doubled
(each source pixel 2x2) from a palette, RGBA with alpha 255."""
from __future__ import annotations

import numpy as np


def rng(seed: int, stream: int = 0) -> np.random.Generator:
    """A generator for one use of the seed (any whole number)."""
    return np.random.default_rng([seed % (1 << 64), stream])


def recording(seed: int, n: int, height: int, width: int, colours: int) -> np.ndarray:
    """``n`` distinct uint8 ``(height, width, 4)`` frames from a palette of
    ``colours`` random colours."""
    r = rng(seed, 1)
    palette = r.integers(0, 256, (colours, 3), dtype=np.uint8)
    index = r.integers(0, colours, (n, height // 2, width // 2), dtype=np.uint8)
    out = np.empty((n, height, width, 4), np.uint8)
    rgb = palette[index]
    for dy in (0, 1):
        for dx in (0, 1):
            out[:, dy::2, dx::2, :3] = rgb
    out[..., 3] = 255
    return out
