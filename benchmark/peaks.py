"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity, at the card's full 700 W power limit). A card set below
700 W reaches less; the result line carries its power limit."""

BF16_FLOPS = 989e12        # bf16 / fp16 tensor cores
HBM_BYTES_PER_S = 3.35e12  # HBM3
