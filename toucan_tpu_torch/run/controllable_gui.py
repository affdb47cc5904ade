"""Gradio GUI: the twin of ``run_controllable_GUI.py``.

    python -m toucan_tpu_torch.run.controllable_gui [--device cpu]
        [--dtype bfloat16] [--matmul_precision default]

Text box, language/accent dropdowns, voice seed, four prosody sliders and
six embedding sliders -> 48 kHz audio.  Gradio is optional; without it the
module still exposes ``build_interface`` for programmatic use.
"""

from __future__ import annotations

import argparse
import os

from toucan_tpu_torch.run import add_interface_args, interface_kwargs, meta_interface, model_path


def build_interface(device=None, dtype=None, matmul_precision: str = "float32"):
    """The ``ControllableInterface`` of the Meta checkpoint and the trained
    embedding GAN (``Embedding/embedding_gan.pt``, required: a generator
    with random weights would give garbage voices)."""
    from toucan_tpu_torch.infer.controllable import ControllableInterface
    from toucan_tpu_torch.load import load_embedding_gan
    from toucan_tpu_torch.models.embedding_gan import GanWrapper

    tts = meta_interface(device=device, dtype=dtype, matmul_precision=matmul_precision)
    gan_ckpt_path = model_path("Embedding", "embedding_gan.pt")
    if not os.path.exists(gan_ckpt_path):
        raise FileNotFoundError(
            f"embedding GAN checkpoint not found at {gan_ckpt_path}; "
            "fetch it with run_model_downloader.py — the GUI's artificial "
            "voices depend on the trained generator")
    g_sd, generator, _, _ = load_embedding_gan(gan_ckpt_path)
    return ControllableInterface(tts, GanWrapper(g_sd, generator, device=tts.device))


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_interface_args(parser)
    args = parser.parse_args(argv)
    controllable = build_interface(**interface_kwargs(args))
    try:
        import gradio as gr
    except ImportError:
        print("gradio not installed; use build_interface() programmatically")
        return

    from toucan_tpu_torch.infer.controllable import LANGUAGE_NAME_TO_CODE

    def run(*inputs):
        sr, wav, plot_path = controllable.read(*inputs, return_plot=True)
        return (sr, wav), plot_path

    gr.Interface(
        fn=run,
        inputs=[gr.Textbox(lines=2, label="Text"),
                gr.Dropdown(sorted(LANGUAGE_NAME_TO_CODE), value="English", label="Language"),
                gr.Dropdown(sorted(LANGUAGE_NAME_TO_CODE), value="English", label="Accent"),
                gr.Slider(0, 1099, step=1, value=0, label="Voice seed"),
                gr.Slider(0.5, 1.5, value=1.0, label="Duration scale"),
                gr.Slider(0.5, 1.5, value=1.0, label="Pause duration scale"),
                gr.Slider(0.0, 2.0, value=1.0, label="Pitch variance scale"),
                gr.Slider(0.0, 2.0, value=1.0, label="Energy variance scale")]
        + [gr.Slider(-10.0, 10.0, value=0.0, label=f"Embedding slider {i + 1}")
           for i in range(6)],
        outputs=[gr.Audio(type="numpy", label="Speech"),
                 gr.Image(type="filepath", label="Alignment and pitch")],
        title="IMS Toucan",
        allow_flagging="never").launch()


if __name__ == "__main__":
    main()
