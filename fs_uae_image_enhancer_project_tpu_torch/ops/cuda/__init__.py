"""Hand-written CUDA kernels for Hopper (``sm_90a``), built with nvcc into a
plain-C shared library and loaded with ctypes (see :mod:`.build`). Nothing
here compiles or loads a kernel at import time."""
