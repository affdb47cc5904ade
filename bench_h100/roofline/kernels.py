"""Operations and bytes of the port's kernels at the shapes of one launch.

Copied from the arithmetic of the port's ``chip_smoke.py`` (``phase_k1``,
``phase_k2``, ``phase_k5``): each input byte read once, each output byte
written once, the work these inputs need.
"""

from bench_h100.roofline import peaks


def k1(b: int, h: int, t: int, d: int, lengths) -> tuple:
    """Rel-pos flash attention (K1) on (B, H, T, d) f32 with per-row valid
    key counts ``lengths``: (flops, bytes).  Every query row against the
    valid keys of its row: q_u.k, q_v.p and p.v, 2 d flops each."""
    flops = sum(6 * h * d * t * int(n) for n in lengths)
    nbytes = 4 * (5 * b * h * t * d + h * (2 * t - 1) * d + b)
    return flops, nbytes


def k2(t: int, c: int, kernel_sizes=(3, 7, 11), dilations=(1, 3, 5)) -> tuple:
    """One fused HiFiGAN stage (K2) on (1, T, C) f32: 18 convs of C x C,
    three stacks of kernel k and 2 x len(dilations) convs each; (flops,
    bytes).  At the default geometry the convs are 2 * 2 * 3 * (3 + 7 + 11)
    = 252 flops per T C^2."""
    taps = sum(2 * len(dilations) * k for k in kernel_sizes)
    flops = 2 * taps * t * c * c
    nbytes = 4 * (2 * t * c + taps * c * c + 2 * len(dilations) * len(kernel_sizes) * c)
    return flops, nbytes


def k5(b: int, t: int, c: int) -> tuple:
    """Alias-free SnakeBeta (K5) on (B, T, C) f32: (flops, bytes), 56 flops
    a sample (two 6-tap phase filters up, the snake on two samples, two
    down) and x, out, alpha and beta moved once."""
    return 56 * b * t * c, 4 * (2 * b * t * c + 2 * c)


K1_PEAK = K2_PEAK = peaks.SPLIT_TF32_FLOPS   # split TF32 on the tensor cores
K5_PEAK = peaks.F32_FLOPS                     # f32 on the CUDA cores
