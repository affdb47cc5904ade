"""toucan_tpu_torch: the PyTorch/CUDA port of toucan-tpu for NVIDIA Hopper.

The JAX package ``toucan_tpu`` beside it is the unchanged reference.  This
package mirrors its layout and imports neither JAX nor anything of
``toucan_tpu``:

  frontend   text -> articulatory features (host Python, copied verbatim),
             audio front end, the numpy F0 tracker
  native     host C++ through ctypes (the F0 tracker, the resampler)
  data       prosody extraction from an alignment (durations, pitch, energy),
             training batches (padding, samplers) and their prefetcher
  nn         PyTorch modules (conformer, predictors, glow, ...)
  kernels    wrappers of the hand-written CUDA kernels, each with its plain
             PyTorch version and a launch counter
  csrc       the CUDA C++ sources (built with nvcc at first use)
  models     ToucanTTS, StochasticToucanTTS, the vocoders, the GST, the
             aligner, the embedding GAN and VAE, the spectrogram critic
  infer      the end-to-end text -> wave interface, prosody cloning, the
             slider interface
  train      acoustic training on one device: losses, schedules, the step,
             checkpoints and SWA, the mono and meta loop
  weights    state dicts from the JAX package's variables (and its train state)
  load       state dicts from the reference's checkpoint files
  run        the serving scripts (``python -m toucan_tpu_torch.run.<name>``)

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``, in
f32 unless asked for ``dtype=torch.bfloat16`` or ``matmul_precision="default"``.
"""

__version__ = "0.1.0"
