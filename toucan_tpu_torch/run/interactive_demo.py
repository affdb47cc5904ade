"""Interactive reading loop: the twin of ``run_interactive_demo.py``.

    python -m toucan_tpu_torch.run.interactive_demo [--device cpu]
        [--dtype bfloat16] [--matmul_precision default]

Asks for a language, then reads each line typed until an empty one: aloud
through ``read_aloud`` where the ``sounddevice`` module imports (host
audio), else into ``demo_output_<n>.wav``.
"""

from __future__ import annotations

import argparse

from toucan_tpu_torch.run import add_interface_args, interface_kwargs, meta_interface


def host_player():
    """The ``sounddevice`` module, or None where it does not import."""
    try:
        import sounddevice
    except (ImportError, OSError):
        return None
    return sounddevice


def main(argv=None, ask=input, player=None):
    """``ask`` reads a line (``input``); ``player`` stands in for
    ``sounddevice`` (default: ``host_player()``)."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_interface_args(parser)
    args = parser.parse_args(argv)
    lang = ask("language code (e.g. en): ").strip() or "en"
    tts = meta_interface(language=lang, **interface_kwargs(args))
    player = player or host_player()
    index = 0
    while True:
        text = ask("what should be read? (empty quits)\n").strip()
        if not text:
            break
        if player is not None:
            tts.read_aloud(text, blocking=True, _player=player)
        else:
            tts.read_to_file([text], f"demo_output_{index}.wav", silent=False)
            print(f"wrote demo_output_{index}.wav")
            index += 1


if __name__ == "__main__":
    main()
