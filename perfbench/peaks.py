"""The device's published peaks (NVIDIA H100 SXM data sheet, at its full
700 W power limit; a card set lower runs slower under load, so the harness
records the card's limit beside every run)."""

#: HBM3 bandwidth of one H100 SXM, bytes per second
HBM_BYTES_PER_S = 3.35e12
#: dense bfloat16 tensor-core rate of one H100 SXM, FLOP per second
BF16_FLOPS_PER_S = 989e12
