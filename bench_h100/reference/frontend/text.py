"""Text -> IPA -> articulatory feature vectors.

Behavioral equivalent of the reference frontend
(the reference toolkit's ``Preprocessing/TextFrontend.py``): G2P via espeak-ng
(through ``phonemizer``) or pypinyin+dragonmapper for Mandarin, IPA
normalization, tone-contour symbolization, and character-by-character
conversion to 62-dim articulatory feature vectors with contextual modifier
dims (stress / tone / length).

G2P engines are optional host-side dependencies; when they are absent the
frontend still fully supports IPA input (``phones_to_features``), which is
what every numeric test and the on-device pipeline consume.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from bench_h100.reference.frontend.inventory import (
    NUM_FEATURES,
    feature_index,
    phone_ids,
    phone_vectors,
    vectors_to_ctc_ids,
)

# Tone register marks, high to low.
_REGISTERS = "˥˦˧˨˩"
_REGISTER_HEIGHT = {c: 5 - i for i, c in enumerate(_REGISTERS)}

# Contour placeholders inserted between register marks.
RISING, FALLING, PEAKING, DIPPING = "⭧", "⭨", "⮁", "⮃"

PRIMARY_STRESS = "ˈ"
LENGTHENED, HALF_LENGTH, SHORTENED = "ː", "ˑ", "̆"
NASALIZED = "̃"

# Modifier characters that edit the *previous* phone's vector.
_SUFFIX_MODIFIERS = {
    LENGTHENED: "lengthened",
    HALF_LENGTH: "half-length",
    SHORTENED: "shortened",
    NASALIZED: "nasal",
    "˥": "very-high-tone",
    "˦": "high-tone",
    "˧": "mid-tone",
    "˨": "low-tone",
    "˩": "very-low-tone",
    RISING: "rising-tone",
    FALLING: "falling-tone",
    PEAKING: "peaking-tone",
    DIPPING: "dipping-tone",
}

# IPA normalization applied to every phonemized string, in order.
# (reference: TextFrontend.py:316-412)
_REPLACEMENTS = [
    # punctuation from non-latin scripts
    ("。", "."), ("，", ","), ("【", '"'), ("】", '"'), ("、", ","),
    ("‥", "…"), ("؟", "?"), ("،", ","), ("“", '"'), ("”", '"'),
    ("؛", ","), ("《", '"'), ("》", '"'), ("？", "?"), ("！", "!"),
    (" ：", ":"), (" ；", ";"), ("－", "-"), ("·", " "),
    # latin punctuation
    ("/", " "), ("—", ""), ("...", "…"), ("\n", ", "), ("\t", " "),
    ("¡", ""), ("¿", ""),
    # merge phone variants the inventory does not distinguish
    ("ɫ", "l"), ("ɚ", "ə"), ("ᵻ", "ɨ"), ("ɧ", "ç"), ("ɥ", "j"),
    ("ɬ", "s"), ("ɮ", "z"), ("ɺ", "ɾ"), ("ʲ", "j"),
    ("ˌ", ""),  # secondary stress is dropped
    # combining tone diacritics -> register marks
    ("̋", "˥"), ("́", "˦"), ("̄", "˧"), ("̀", "˨"),
    ("̏", "˩"), ("̂", FALLING), ("̌", RISING),
    ("꜖", "˩"), ("꜕", "˨"), ("꜔", "˧"), ("꜓", "˦"), ("꜒", "˥"),
    # pause-like punctuation becomes silence
    ('"', "~"), (" - ", "~ "), ("- ", "~ "), ("-", ""), ("…", "."),
    (":", "~"), (";", "~"), (",", "~"),  # must stay last
]

_UNSUPPORTED_IPA = (
    "̹̙̞̯̤̪̩̠̟ꜜ̬̽ʰ|̝•ˠ↘‖̰‿̜ᷝ̈ᷠʷ̚↗ꜛ̻̥ˁ̘̺͡"
)

# Characters that carry only segmental identity get stripped when the caller
# wants plot labels / alignment text rather than feature extraction.
_NON_SEGMENTAL = [PRIMARY_STRESS, LENGTHENED, HALF_LENGTH, SHORTENED,
                  NASALIZED, RISING, FALLING, PEAKING, DIPPING,
                  "̌", "̂"] + list(_REGISTERS)

# language -> (espeak voice, text preprocessor name)
_LANGUAGES = {
    "en": "en-us", "de": "de", "el": "el", "es": "es", "fi": "fi",
    "ru": "ru", "hu": "hu", "nl": "nl", "fr": "fr-fr", "it": "it",
    "pt": "pt", "pt-br": "pt-br", "pl": "pl", "cmn": "cmn", "vi": "vi",
    "uk": "uk", "fa": "fa",
}
SUPPORTED_LANGUAGES = tuple(_LANGUAGES)

# ids used by the language embedding table (reference: TextFrontend.py:490-524)
_LANGUAGE_IDS = {
    "de": 1, "el": 2, "es": 3, "fi": 4, "ru": 5, "hu": 6, "nl": 7, "fr": 8,
    "pt": 9, "pl": 10, "it": 11, "en": 12, "cmn": 13, "vi": 14, "uk": 15,
    "fa": 16, "pt-br": 17,
}

# Northern-Vietnamese espeak output numbers its tones; map to IPA contours.
# (reference: TextFrontend.py:304-312, incl. the espeak "ɜ means 3" bug)
_VI_TONES = [("1", "˧"), ("2", "˨˩"), ("ɜ", "˧˥"), ("3", "˧˥"),
             ("4", "˦˧˥"), ("5", "˧˩˧"), ("6", "˧˩ʔ˨"), ("7", "˧")]


def language_id(language: str) -> int:
    return _LANGUAGE_IDS[language]


def english_text_expansion(text: str) -> str:
    """Expand common English abbreviations (keithito/tacotron cleaner set)."""
    pairs = [("Mrs.", "misess"), ("Mr.", "mister"), ("Dr.", "doctor"),
             ("St.", "saint"), ("Co.", "company"), ("Jr.", "junior"),
             ("Maj.", "major"), ("Gen.", "general"), ("Drs.", "doctors"),
             ("Rev.", "reverend"), ("Lt.", "lieutenant"), ("Hon.", "honorable"),
             ("Sgt.", "sergeant"), ("Capt.", "captain"), ("Esq.", "esquire"),
             ("Ltd.", "limited"), ("Col.", "colonel"), ("Ft.", "fort"),
             ("etc.", "et cetera"), ("vs.", "versus"), ("Prof.", "professor"),
             ("Ms.", "miz")]
    for abbrev, expansion in pairs:
        text = re.sub(r"\b%s\." % abbrev[:-1], expansion, text, flags=re.IGNORECASE)
    return text


def remove_french_spacing(text: str) -> str:
    text = text.replace(" »", '"').replace("« ", '"')
    for punc in "!;:.,?-":
        text = text.replace(f" {punc}", punc)
    return text


def _tone_contours():
    """Enumerate register-mark bigrams/trigrams and their contour class."""
    rising, falling, peaking, dipping = [], [], [], []
    for a in _REGISTERS:
        for b in _REGISTERS:
            (falling if _REGISTER_HEIGHT[a] > _REGISTER_HEIGHT[b] else rising).append(a + b)
            for c in _REGISTERS:
                if _REGISTER_HEIGHT[a] > _REGISTER_HEIGHT[b] < _REGISTER_HEIGHT[c]:
                    dipping.append(a + b + c)
                elif _REGISTER_HEIGHT[a] < _REGISTER_HEIGHT[b] > _REGISTER_HEIGHT[c]:
                    peaking.append(a + b + c)
    return rising, falling, peaking, dipping


@dataclass
class TextFrontend:
    """Articulatory text frontend for one language.

    ``use_g2p=False`` builds a frontend that only accepts IPA input — useful
    on hosts without espeak-ng.
    """

    language: str
    use_stress: bool = True
    use_word_boundaries: bool = True
    add_silence_to_end: bool = True
    use_explicit_eos: bool = True
    use_g2p: bool = True
    _g2p: object = field(default=None, repr=False)

    def __post_init__(self):
        if self.language not in _LANGUAGES:
            raise ValueError(f"unsupported language: {self.language!r} "
                             f"(supported: {sorted(_LANGUAGES)})")
        self.g2p_lang = _LANGUAGES[self.language]
        (self.rising_perms, self.falling_perms,
         self.peaking_perms, self.dipping_perms) = _tone_contours()
        self.phone_to_vector = phone_vectors()
        self.phone_to_id = phone_ids()
        self.id_to_phone = {v: k for k, v in self.phone_to_id.items()}
        if self.use_g2p and self.g2p_lang != "cmn":
            try:
                from phonemizer.backend import EspeakBackend
                self._g2p = EspeakBackend(
                    language=self.g2p_lang,
                    punctuation_marks=';:,.!?¡¿—…"«»“”~/。【】、‥،؟“”؛',
                    preserve_punctuation=True,
                    language_switch="remove-flags",
                    with_stress=self.use_stress)
            except ImportError:
                self._g2p = None

    # ------------------------------------------------------------------ G2P

    def _expand(self, text: str) -> str:
        if self.language == "en":
            return english_text_expansion(text)
        if self.language == "fr":
            return remove_french_spacing(text)
        return text

    def phonemize(self, text: str) -> str:
        """Raw G2P output for ``text`` (before IPA normalization)."""
        text = self._expand(text)
        if self._g2p is None:
            if self.language == "en":
                # built-in rule-based fallback keeps plain-text English
                # working on hosts without espeak (see frontend/g2p_en.py);
                # espeak remains the reference-parity path when installed.
                from bench_h100.reference.frontend.g2p_en import phonemize_english
                return phonemize_english(text)
            raise RuntimeError(
                "no G2P engine available (phonemizer/espeak-ng not installed) "
                f"and no built-in ruleset for {self.language!r} — pass IPA "
                "input via phones_to_features / input_phonemes=True")
        phones = self._g2p.phonemize([text], strip=True)[0]
        if self.g2p_lang == "vi":
            for num, ipa in _VI_TONES:
                phones = phones.replace(num, ipa)
        return phones

    # ------------------------------------------------- IPA post-processing

    def postprocess_phoneme_string(self, phones: str, for_feature_extraction: bool = True,
                                   include_eos_symbol: bool = True,
                                   for_plot_labels: bool = False) -> str:
        """Normalize an IPA string into the inventory's alphabet."""
        replacements = list(_REPLACEMENTS)
        replacements += [(c, "") for c in _UNSUPPORTED_IPA]
        if not for_feature_extraction:
            replacements += [(c, "") for c in _NON_SEGMENTAL]
        for old, new in replacements:
            phones = phones.replace(old, new)
        phones = re.sub("~+", "~", phones)
        phones = re.sub(r"\s+", " ", phones)
        phones = re.sub(r"\.+", ".", phones)
        phones = phones.lstrip("~").rstrip("~")

        # register-mark sequences -> contour placeholders (3-mark first)
        for perm in self.peaking_perms:
            phones = phones.replace(perm, PEAKING.join(perm))
        for perm in self.dipping_perms:
            phones = phones.replace(perm, DIPPING.join(perm))
        for perm in self.rising_perms:
            phones = phones.replace(perm, RISING.join(perm))
        for perm in self.falling_perms:
            phones = phones.replace(perm, FALLING.join(perm))

        if self.add_silence_to_end:
            phones += "~"  # trailing silence improves prosody at inference
        if include_eos_symbol:
            phones += "#"
        if not self.use_word_boundaries:
            phones = phones.replace(" ", "")
        if for_plot_labels:
            phones = phones.replace(" ", "|")
        phones = "~" + phones
        return re.sub("~+", "~", phones)

    def get_phone_string(self, text: str, include_eos_symbol: bool = True,
                         for_feature_extraction: bool = False,
                         for_plot_labels: bool = False) -> str:
        return self.postprocess_phoneme_string(
            self.phonemize(text), for_feature_extraction, include_eos_symbol, for_plot_labels)

    # ----------------------------------------------------- feature vectors

    def phones_to_features(self, phones: str, handle_missing: bool = True) -> np.ndarray:
        """Convert a normalized IPA string to a (T, 62) feature array.

        Stress marks flag the *following* phone; length/tone/nasality marks
        flag the *preceding* one (reference: TextFrontend.py:213-288).
        """
        phones = phones.replace("ɚ", "ə").replace("ᵻ", "ɨ")
        f2i = feature_index()
        rows: list = []
        stressed = False
        for char in phones:
            if char == PRIMARY_STRESS:
                stressed = True
            elif char in _SUFFIX_MODIFIERS:
                if rows:
                    rows[-1][f2i[_SUFFIX_MODIFIERS[char]]] = 1
            else:
                vec = self.phone_to_vector.get(char)
                if vec is None:
                    if handle_missing:
                        continue
                    raise KeyError(f"unknown phoneme: {char!r}")
                rows.append(list(vec))
                if stressed:
                    stressed = False
                    rows[-1][f2i["stressed"]] = 1
        return np.asarray(rows, dtype=np.float32).reshape(-1, NUM_FEATURES)

    def string_to_features(self, text: str, input_phonemes: bool = False) -> np.ndarray:
        """Full path: text (or IPA) -> normalized IPA -> (T, 62) features."""
        if input_phonemes:
            phones = text
        else:
            phones = self.get_phone_string(text, include_eos_symbol=True,
                                           for_feature_extraction=True)
        return self.phones_to_features(phones)

    # alias matching the reference API name
    string_to_tensor = string_to_features

    def text_vectors_to_id_sequence(self, text_vector) -> list:
        return vectors_to_ctc_ids(np.asarray(text_vector))

    @staticmethod
    def get_example_sentence(lang: str):
        examples = {
            "en": "This is a complex sentence, it even has a pause!",
            "de": "Dies ist ein komplexer Satz, er hat sogar eine Pause!",
            "el": "Αυτή είναι μια σύνθετη πρόταση, έχει ακόμη και παύση!",
            "es": "Esta es una oración compleja, ¡incluso tiene una pausa!",
            "fi": "Tämä on monimutkainen lause, sillä on jopa tauko!",
            "ru": "Это сложное предложение, в нем даже есть пауза!",
            "hu": "Ez egy összetett mondat, még szünet is van benne!",
            "nl": "Dit is een complexe zin, er zit zelfs een pauze in!",
            "fr": "C'est une phrase complexe, elle a même une pause !",
            "pt": "Esta é uma frase complexa, tem até uma pausa!",
            "pt-br": "Esta é uma frase complexa, tem até uma pausa!",
            "pl": "To jest zdanie złożone, ma nawet pauzę!",
            "it": "Questa è una frase complessa, ha anche una pausa!",
            "cmn": "这是一个复杂的句子，它甚至包含一个停顿。",
            "vi": "Đây là một câu phức tạp, nó thậm chí còn chứa một khoảng dừng.",
            "uk": "Це складне речення, воно навіть має паузу!",
            "fa": "این یک جمله پیچیده است، حتی یک مکث دارد!",
        }
        return examples.get(lang)
