"""toucan_tpu_torch: the PyTorch/CUDA port of toucan-tpu for NVIDIA Hopper.

The JAX package ``toucan_tpu`` beside it is the unchanged reference.  This
package mirrors its layout and imports neither JAX nor anything of
``toucan_tpu``:

  frontend   text -> articulatory features (host Python, copied verbatim)
  nn         PyTorch modules (conformer, predictors, glow, ...)
  kernels    wrappers of the hand-written CUDA kernels, each with its plain
             PyTorch version and a launch counter
  csrc       the CUDA C++ sources (built with nvcc at first use)
  models     ToucanTTS and the HiFiGAN generator
  infer      the end-to-end text -> wave interface
  weights    state dicts from the JAX package's variables

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
