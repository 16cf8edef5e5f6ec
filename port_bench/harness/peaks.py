"""Published peaks of one NVIDIA H100 SXM (dense, no sparsity), at its full
700 W power limit: the bf16 tensor-core rate and the HBM3 bandwidth."""

BF16_FLOP_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
