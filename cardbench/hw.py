"""Published peaks of one NVIDIA H100 SXM5 80GB (NVIDIA's data sheet, dense
rates, at the 700 W limit).  A share of a roofline or of a peak is stated
against these, with the card's power limit printed beside it."""

BF16_FLOPS = 989e12  # tensor cores, dense
HBM_BYTES_S = 3.35e12
