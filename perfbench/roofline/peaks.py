"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what the rooflines and the MFU
divide by."""

BF16_FLOPS = 989.4e12          # dense bf16 tensor cores, FLOP/s
F32_FLOPS = 67e12              # float32 outside the tensor cores, FLOP/s
HBM_BYTES = 3.35e12            # device memory, bytes/s
SMS = 132                      # streaming multiprocessors
SFU_EXPS_PER_CLOCK_PER_SM = 16 # exp2 on the special-function units
BOOST_CLOCK_HZ = 1.98e9        # the SM clock at its published maximum
