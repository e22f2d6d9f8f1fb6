"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full power limit of 700 W)."""

F32_FLOPS_PER_S = 67e12        # f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12      # HBM3
