"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the 700 W limit): the card's power limit is printed beside every share."""

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
SECTOR_BYTES = 32  # the card reads and writes memory in 32-byte sectors
