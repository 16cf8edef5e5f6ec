"""Frozen fp32 forward of the heavyweight residual U-Net's graph
(``configs/residual_unet_heavy.json``: depth 4, 4 blocks a level, base 72,
block ratio 1.5, a graph made from a seed).

The forward and the graph's op types are those of ``residual_unet.py``,
which reads the depth and the blocks a level from the initializers' names;
this module gives them under the configuration's name, by which
``common.Reference`` finds a configuration's forward.
"""
from .residual_unet import forward, ops

__all__ = ["forward", "ops"]
