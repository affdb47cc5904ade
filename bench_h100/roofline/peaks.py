"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense).

f32 products on the tensor cores run as split TF32, three TF32 products
per f32 product, so the f32 work of K1, K2 and of the whole step is held to
a third of the 495 TFLOP/s TF32 rate (the port's kernel-table convention).
"""

F32_FLOPS = 67e12                  # f32 on the CUDA cores
SPLIT_TF32_FLOPS = 495e12 / 3      # f32 products on the tensor cores, 165 T/s
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
HBM_BYTES = 3.35e12                # bytes/s


def bound_s(flops: float, nbytes: float, peak: float) -> float:
    """The least time the chip could take: the larger of the operations
    over ``peak`` and the bytes over the HBM rate."""
    return max(flops / peak, nbytes / HBM_BYTES)
