"""Prosody cloning: the twin of ``run_prosody_override.py``.

    python -m toucan_tpu_torch.run.prosody_override REFERENCE_AUDIO TRANSCRIPT
        [--voice_audio VOICE] [--lang en] [--out cloned.wav] [--device cpu]
        [--dtype bfloat16] [--matmul_precision default]

The reference recording (and the voice's) is read with
``frontend.audio.read_wave``: PCM or IEEE-float WAV, or any format
soundfile reads where it is installed.
"""

from __future__ import annotations

import argparse

from toucan_tpu_torch.run import add_interface_args, interface_kwargs, meta_interface, model_path


def main(argv=None):
    from toucan_tpu_torch.frontend.audio import read_wave
    from toucan_tpu_torch.infer.cloner import UtteranceCloner
    from toucan_tpu_torch.load import load_aligner

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("reference_audio")
    parser.add_argument("transcript")
    parser.add_argument("--voice_audio", default=None)
    parser.add_argument("--lang", default="en")
    parser.add_argument("--out", default="cloned.wav")
    add_interface_args(parser)
    args = parser.parse_args(argv)

    tts = meta_interface(language=args.lang, **interface_kwargs(args))
    cloner = UtteranceCloner(tts, load_aligner(model_path("Aligner", "aligner.pt")),
                             language=args.lang)
    wave, sr = read_wave(args.reference_audio)
    voice = None
    if args.voice_audio:
        voice, _ = read_wave(args.voice_audio)
    cloner.clone_utterance(wave, args.transcript, reference_wave_for_voice=voice, sr=sr,
                           lang=args.lang, filename_of_result=args.out)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
