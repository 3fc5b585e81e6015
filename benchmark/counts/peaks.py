"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores
BF16_FLOPS_PER_S = 989e12  # bf16 on the tensor cores, dense
SMS = 132
SFU_EXPS_PER_CLOCK_PER_SM = 16
BOOST_CLOCK_HZ = 1980e6
EXPS_PER_S = SFU_EXPS_PER_CLOCK_PER_SM * SMS * BOOST_CLOCK_HZ
