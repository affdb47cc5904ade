"""The plain reference: a frozen copy of the port's synthesis path.

Copied from ``toucan_tpu_torch`` and cut to what ``ToucanTTS.infer`` and
the two vocoders run, with the imports rewritten: ``frontend/`` (English
only: text normalisation, the built-in G2P or espeak where installed, the
articulatory features), ``nn/`` and ``models/toucan_tts.py`` (the acoustic
model), ``models/hifigan.py`` and ``models/bigvgan.py``.  In place of the
kernels it runs their plain versions: K1 and K2 from ``kernels_plain.py``,
K5 from ``nn/alias_free.py``.  It imports nothing of ``toucan_tpu_torch``,
so a change to the program cannot move it.  ``models.build`` makes a
configuration's modules.
"""
