"""The whole step's share of the chip's f32 peak: the model FLOPs of the
audio delivered (``roofline/model_flops.py``, at each sentence's own phone
and frame counts, so padding is no work) over the window times the split
TF32 rate, 165 T/s (f32 products on the tensor cores)."""

from bench_h100.roofline import model_flops, peaks


def read(run):
    if not run.served:
        return None
    flops = sum(model_flops.sentence(run.config, r["phones"], r["frames"]) for r in run.served)
    return 100.0 * flops / (run.window_s * peaks.SPLIT_TF32_FLOPS)
