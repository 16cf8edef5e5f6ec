from . import activations, conv, gamma, pixel_shuffle  # noqa: F401

from .activations import ACTIVATION_NAMES, apply_activation, init_activation  # noqa: F401
from .conv import conv2d, init_conv  # noqa: F401
from .gamma import (  # noqa: F401
    linear_to_srgb,
    linear_to_srgb_approx,
    linear_to_srgb_poly,
    srgb_to_linear,
    srgb_to_linear_approx,
    srgb_to_linear_poly,
)
from .pixel_shuffle import pixel_shuffle, pixel_unshuffle  # noqa: F401
