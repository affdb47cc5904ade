"""GUI backend: artificial voices + slider control (ControllableInterface).

Equivalent of ``InferenceInterfaces/ControllableInterface.py``: WGAN-sampled
voice seeds, six PCA-slider embedding controls, language/accent selection,
and the 1800-phone input guard with per-language overflow messages.
"""

from __future__ import annotations

import numpy as np

LANGUAGE_NAME_TO_CODE = {
    "English": "en", "German": "de", "Greek": "el", "Spanish": "es",
    "Finnish": "fi", "Russian": "ru", "Hungarian": "hu", "Dutch": "nl",
    "French": "fr", "Polish": "pl", "Portuguese": "pt", "Italian": "it",
    "Chinese": "cmn", "Vietnamese": "vi",
}

_TOO_LONG = {
    "German": "Deine Eingabe war zu lang. Bitte versuche es entweder mit einem "
              "kürzeren Text oder teile ihn in mehrere Teile auf.",
    "English": "Your input was too long. Please try either a shorter text or "
               "split it into several parts.",
}
MAX_PHONES = 1800


class ControllableInterface:
    def __init__(self, tts_interface, gan_wrapper, language: str = "English",
                 accent: str = "English"):
        self.model = tts_interface
        self.wgan = gan_wrapper
        self.current_language = ""
        self.current_accent = ""

    def read(self, prompt: str, language: str = "English", accent: str = "English",
             voice_seed: int = 0, duration_scaling_factor: float = 1.0,
             pause_duration_scaling_factor: float = 1.0,
             pitch_variance_scale: float = 1.0, energy_variance_scale: float = 1.0,
             emb_slider_1: float = 0.0, emb_slider_2: float = 0.0,
             emb_slider_3: float = 0.0, emb_slider_4: float = 0.0,
             emb_slider_5: float = 0.0, emb_slider_6: float = 0.0,
             input_is_phones: bool = False, return_plot: bool = False):
        """Returns (sample_rate, wave) at 48 kHz compatibility rate, plus a
        spectrogram/prosody plot filepath when ``return_plot`` (the GUI shows
        it, mirroring the reference's ``return_plot_as_filepath``)."""
        language = language.split()[0]
        accent = accent.split()[0]
        if self.current_language != language:
            self.model.set_phonemizer_language(LANGUAGE_NAME_TO_CODE[language])
            self.current_language = language
        if self.current_accent != accent:
            self.model.set_accent_language(LANGUAGE_NAME_TO_CODE[accent])
            self.current_accent = accent

        self.wgan.set_latent(voice_seed)
        sliders = [emb_slider_1, emb_slider_2, emb_slider_3,
                   emb_slider_4, emb_slider_5, emb_slider_6]
        embedding = self.wgan.modify_embed(np.asarray(sliders, np.float32))
        self.model.set_utterance_embedding(embedding=embedding)

        if not input_is_phones:
            try:
                phones = self.model.text2phone.get_phone_string(prompt)
            except RuntimeError:
                phones = prompt  # no G2P: treat as phones directly
            if len(phones) > MAX_PHONES:
                prompt = _TOO_LONG.get(language, _TOO_LONG["English"])

        out = self.model(prompt,
                         input_is_phones=input_is_phones,
                         duration_scaling_factor=duration_scaling_factor,
                         pitch_variance_scale=pitch_variance_scale,
                         energy_variance_scale=energy_variance_scale,
                         pause_duration_scaling_factor=pause_duration_scaling_factor,
                         return_plot_as_filepath=return_plot)
        if return_plot:
            wav, plot_path = out
            return 48000, np.repeat(wav, 2), plot_path
        wav48 = np.repeat(out, 2)  # 24 kHz -> 48 kHz compatibility
        return 48000, wav48
