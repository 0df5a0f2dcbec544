"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit). A result line carries the card's
name and power limit beside any share of these."""

F32_FLOPS = 67e12  # float32 outside the tensor cores, operations a second
HBM_BYTES = 3.35e12  # HBM3 bandwidth, bytes a second
