"""Long-form vocoder synthesis sharded over the time axis of the mesh.

Counterpart of ``toucan_tpu/dist/longform.py``.  The mel's frames split
over the mesh's 'data' ranks; each rank vocodes its chunk plus a halo of
its ring neighbours' frames and crops the halo from its wave, which then
equals the unsharded synthesis because the halo exceeds the generator's
receptive field (under 16 mel frames for HiFiGAN, about 23 for BigVGAN;
``HALO_FRAMES = 32`` covers both).  The chunks at the sequence's ends use
windows shifted inside the sequence instead of a synthetic halo, so the
generator's own edge semantics (conv zero padding, BigVGAN's
replicate-padded resamplers) apply at the true edge, as in the unsharded
call: with trained (nonzero-bias) weights a zero or replicated halo there
would show.

The exchange is JAX's four ``ppermute``s (each rank receives its left
neighbour's last 2 x halo frames and its right neighbour's first 2 x halo),
sent as two ``dist.mesh.ppermute`` calls of stacked edges, outside any
kernel: on the card each chunk's vocoding runs the vocoder's kernels (K2
for the f32 HiFiGAN, K5 for BigVGAN, K3/K4 for a quantised HiFiGAN).
``vocoder`` is any callable taking (1, T, 80) to (1, 384 T, 1), a module
or ``ToucanTTSInterface._vocoder_call``.
"""

from __future__ import annotations

import numpy as np
import torch

from toucan_tpu_torch.dist.mesh import AXES, all_gather, ppermute

HALO_FRAMES = 32
SAMPLES_PER_FRAME = 384


def _axis(mesh, axis: str):
    """(group, size, this rank's index) of a mesh dim."""
    return mesh.get_group(axis), mesh.size(AXES.index(axis)), mesh.get_local_rank(axis)


@torch.no_grad()
def _vocode(vocoder, mel):
    """(T, 80) -> (384 T,) wave."""
    return vocoder(mel[None])[0, :, 0]


def sharded_vocoder_synthesis(vocoder, mel_local: torch.Tensor, mesh, axis: str = "data",
                              halo: int = HALO_FRAMES) -> torch.Tensor:
    """This rank's chunk (chunk, 80) of a mel split evenly over ``axis`` ->
    its wave (chunk * 384,).  Every rank of the axis calls it."""
    group, n, idx = _axis(mesh, axis)
    chunk = mel_local.shape[0]
    if n == 1:
        return _vocode(vocoder, mel_local)
    assert chunk >= 2 * halo, "chunks must cover two halos"
    # the ring exchange: from the left neighbour its last 2*halo frames,
    # from the right its first 2*halo (the doubled span feeds the shifted
    # windows of the edge chunks)
    from_left = ppermute(mel_local[-2 * halo:].contiguous(), group, 1)
    from_right = ppermute(mel_local[:2 * halo].contiguous(), group, -1)
    left2, left1 = from_left[:halo], from_left[halo:]
    right1, right2 = from_right[:halo], from_right[halo:]
    if idx == 0:
        extended, offset = torch.cat([mel_local, right1, right2]), 0
    elif idx == n - 1:
        extended, offset = torch.cat([left2, left1, mel_local]), 2 * halo
    else:
        extended, offset = torch.cat([left1, mel_local, right1]), halo
    wave = _vocode(vocoder, extended)
    return wave[offset * SAMPLES_PER_FRAME:(offset + chunk) * SAMPLES_PER_FRAME]


def synthesize_longform(vocoder, mel, mesh, axis: str = "data",
                        halo: int = HALO_FRAMES) -> np.ndarray:
    """mel (T, 80), the same on every rank -> the whole wave (T * 384,) on
    every rank.  T pads to a multiple of the axis size (the padded frames'
    wave is cut off), and when it was padded the last ``halo`` frames' wave
    is patched from an unsharded synthesis of the true tail window, whose
    end is the true edge.  Inputs shorter than 2 * halo * n are vocoded
    whole.  The synthesis runs on the mel's device (the host for an array)."""
    if not torch.is_tensor(mel):
        mel = torch.from_numpy(np.asarray(mel, np.float32))
    group, n, idx = _axis(mesh, axis)
    t = mel.shape[0]
    if t < 2 * halo * n:
        return _vocode(vocoder, mel).cpu().numpy()
    t_pad = -(-t // n) * n
    mel_p = torch.zeros((t_pad, mel.shape[1]), dtype=mel.dtype, device=mel.device)
    mel_p[:t] = mel
    chunk = t_pad // n
    local = sharded_vocoder_synthesis(vocoder, mel_p[idx * chunk:(idx + 1) * chunk], mesh,
                                      axis, halo)
    out = all_gather(local, group).reshape(-1)[:t * SAMPLES_PER_FRAME]
    if t_pad != t:
        window = 2 * halo  # the true tail's window; its first halo frames warm up
        tail = _vocode(vocoder, mel[t - window:])
        keep = (window - halo) * SAMPLES_PER_FRAME
        out[-keep:] = tail[-keep:]
    return out.cpu().numpy()
