"""The vocoders' ``receptive_frames`` R, on which the interface cuts the
mel it vocodes (``infer/interface.py::_run_e2e``): at the published kernel
sizes, rates and dilations, with few channels, in float64 on the CPU.

The wave's first 384 L samples read mel frames up to L + R - 1 and none
past them: changing every frame from L + R on leaves those samples as they
were, bit for bit, and their gradient with respect to frame L + R - 1 is
not zero (a finite change there is lost in float64's rounding of the
larger terms, its infinitesimal one is not), so R is not padded for
comfort.
"""

import pytest
import torch

from toucan_tpu_torch.models.vocoders.bigvgan import BigVGAN
from toucan_tpu_torch.models.vocoders.hifigan import HiFiGANGenerator

torch.set_num_threads(2)

LENGTH = 20


@pytest.mark.parametrize("make,reach", [(lambda: HiFiGANGenerator(channels=16), 13),
                                        (lambda: BigVGAN(channels=16), 18)],
                         ids=["hifigan", "bigvgan"])
def test_receptive_frames_are_exact(make, reach):
    torch.manual_seed(0)
    voc = make().double().eval()
    r = voc.receptive_frames
    assert r == reach
    mel = torch.randn(1, LENGTH + r + 6, 80, dtype=torch.float64)

    def kept(m):
        return voc(m, differentiable=True)[0, :LENGTH * 384, 0]

    with torch.no_grad():
        want = kept(mel)
        far = mel.clone()
        far[:, LENGTH + r:] += 10 * torch.randn_like(far[:, LENGTH + r:])
        assert torch.equal(kept(far), want)
    mel.requires_grad_(True)
    grad, = torch.autograd.grad(kept(mel).sum(), mel)
    assert (grad[0, LENGTH + r - 1] != 0).any()
    assert (grad[0, LENGTH + r:] == 0).all()


def test_k4_int8_gives_no_receptive_frames():
    """K4's int8 scales are the max over every row of a window, the rows
    past a cut too; its bf16 mode and the other stages' kernels read no
    row past their convs' reach."""
    assert HiFiGANGenerator(channels=256, imcol_mode="int8").receptive_frames is None
    assert HiFiGANGenerator(channels=256, imcol_mode="bf16").receptive_frames == 13
    assert HiFiGANGenerator(channels=256, stage_mode="int8").receptive_frames == 13
