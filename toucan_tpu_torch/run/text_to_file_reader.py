"""Read texts to an audio file: the twin of ``run_text_to_file_reader.py``.

    python -m toucan_tpu_torch.run.text_to_file_reader [--model_id Meta]
        [--lang en] [--out output.wav] [--device cpu] [--dtype bfloat16]
        [--matmul_precision default] TEXT [TEXT ...]
"""

from __future__ import annotations

import argparse

from toucan_tpu_torch.run import add_interface_args, interface_kwargs, model_path


def read_texts(model_id, sentences, filename, language="en", faster_vocoder=True,
               **kwargs):
    """Synthesize ``sentences`` (a string or a list) with the
    ``ToucanTTS_<model_id>`` checkpoint and write them, joined by silence,
    to ``filename``; ``kwargs`` go to the interface."""
    from toucan_tpu_torch.load import interface_from_torch

    tts = interface_from_torch(
        model_path(f"ToucanTTS_{model_id}", "best.pt"),
        model_path("Avocodo" if faster_vocoder else "BigVGAN", "best.pt"),
        model_path("Embedding", "embedding_function.pt"),
        vocoder_kind="hifigan" if faster_vocoder else "bigvgan", language=language, **kwargs)
    if isinstance(sentences, str):
        sentences = [sentences]
    tts.read_to_file(text_list=sentences, file_location=filename)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--model_id", default="Meta")
    parser.add_argument("--lang", default="en")
    parser.add_argument("--out", default="output.wav")
    add_interface_args(parser)
    parser.add_argument("text", nargs="+")
    args = parser.parse_args(argv)
    read_texts(args.model_id, args.text, args.out, language=args.lang, **interface_kwargs(args))


if __name__ == "__main__":
    main()
