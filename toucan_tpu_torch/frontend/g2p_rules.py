"""First-party rule-based G2P for the non-English languages.

The reference phonemizes plain text through espeak-ng
(``Preprocessing/TextFrontend.py:168-172``); espeak-ng cannot exist in this
image (no egress, no source tree, no binary), so these transducers make the
plain-text path REAL instead of mock-only for the languages whose
orthography is regular enough for rules: es, it, fi, el, hu, pl, nl, de,
ru, uk, pt/pt-br, fr, vi — plus fa (lexicon + consonant-skeleton
transducer; see the Farsi section).  English has its own NRL-style
ruleset + lexicon (``frontend/g2p_en.py``); Mandarin goes through
pypinyin + dragonmapper like the reference (with a first-party pinyin
parser fallback, ``frontend/g2p_cmn.py``).

Engine: per language an ordered longest-match list of contextual rewrite
rules applied by a left-to-right scanner over the grapheme string (contexts
look at the *original* graphemes, so rule outputs can never feed later
patterns), followed by a per-language stress assigner.  Output is IPA
restricted to the articulatory inventory (``frontend/inventory.py``) and
feeds the same ``postprocess_phoneme_string`` -> feature-vector path the
espeak output would.

Quality notes (documented approximations):
* ru/uk: letter-to-sound with palatalization; unstressed-vowel reduction
  and lexical stress need a stress lexicon and are approximated (no
  reduction, no stress mark).
* fr: rule systems reach ~90% on French; obligatory liaison is modeled
  through a lookahead pass (closed word list + h-aspiré blocklist);
  optional/stylistic liaisons intentionally stay off.
* pt ("pt" = European, "pt-br" = Brazilian): nasalization in both;
  EP additionally models unstressed-vowel reduction (a->ɐ, o->u, e->ɨ),
  pre-consonant s -> ʃ/ʒ, and final e -> ɨ; BR keeps full pretonic
  vowels with final-vowel reduction only.
* de: stress falls on the first syllable (common case); the unstressed
  prefixes be-/ge-/er-/ver-/zer-/ent-/emp- shift stress to the stem
  (with schwa reduction and morpheme-initial ʃt/ʃp), and Latinate
  loans carry lexicon stress.  Separable-prefix (stressed) verbs like
  "aufstehen" still follow the first-syllable default, which is correct
  for them.  Vowel length follows the open/closed syllable rule plus a
  function-word lexicon.
* fa: Persian script leaves short vowels unwritten, so rules alone cannot
  recover them — a frequent-word lexicon carries the correct vowels and
  everything else gets the consonant skeleton with epenthetic /æ/
  (documented quality carve-out; see ``_fa_word``).
Numbers are read as full numerals via ``frontend/numbers.py`` (espeak
behavior); integers beyond 999 999 fall back to digit-by-digit.
"""

from __future__ import annotations

import re
import unicodedata
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Callable, Dict, List, Optional, Sequence, Tuple

PRIMARY_STRESS = "ˈ"

# IPA vowel characters (inventory subset) used for syllable-nucleus scans.
IPA_VOWELS = ("aeiouyæøœɛɔəɨɯʊɪʏʌɐɑɒãẽĩõũɐ̃"
              "ɜʉ")


@dataclass(frozen=True)
class Rule:
    """``src`` graphemes rewrite to ``ipa`` when the regexes ``pre`` (anchored
    at the end of the left context) and ``post`` (anchored at the start of
    the right context) both match the ORIGINAL grapheme string."""

    src: str
    ipa: str
    pre: str = ""
    post: str = ""


class RuleSet:
    def __init__(self, rules: Sequence[Rule]):
        # longest source first; original order breaks ties
        self.rules = sorted(rules, key=lambda r: -len(r.src))
        self._pre = {id(r): re.compile("(?:%s)$" % r.pre) if r.pre else None
                     for r in self.rules}
        self._post = {id(r): re.compile(r.post) if r.post else None
                      for r in self.rules}

    def apply(self, word: str) -> str:
        out = []
        i = 0
        n = len(word)
        while i < n:
            for r in self.rules:
                j = i + len(r.src)
                if word[i:j] != r.src:
                    continue
                pre = self._pre[id(r)]
                if pre is not None and not pre.search(word, 0, i):
                    continue
                post = self._post[id(r)]
                if post is not None and not post.match(word, j):
                    continue
                out.append(r.ipa)
                i = j
                break
            else:  # no rule: drop unknown grapheme
                i += 1
        return "".join(out)


_STRONG_VOWELS = "aeoɔɛæɑ"  # two adjacent strong vowels = hiatus


def _vowel_runs(ipa: str) -> List[int]:
    """Start indices of the syllable nuclei: maximal vowel runs, except
    that two adjacent STRONG vowels split into separate nuclei (Romance
    hiatus: es "aora" -> a.o, it "paese" -> pa.e; glide+vowel and
    vowel+glide sequences like je/aɪ/ei stay one nucleus)."""
    runs = []
    prev_vowel = False
    for i, ch in enumerate(ipa):
        is_v = ch in IPA_VOWELS
        if is_v and (not prev_vowel
                     or (ch in _STRONG_VOWELS and ipa[i - 1] in _STRONG_VOWELS)):
            runs.append(i)
        prev_vowel = is_v or (prev_vowel and ch in "ː̃")
    return runs


def _insert_stress(ipa: str, run_index: int) -> str:
    if PRIMARY_STRESS in ipa:  # lexicon entries may carry their own mark
        return ipa
    runs = _vowel_runs(ipa)
    if not runs:
        return ipa
    pos = runs[run_index] if -len(runs) <= run_index < len(runs) else runs[-1]
    return ipa[:pos] + PRIMARY_STRESS + ipa[pos:]


def stress_initial(word: str, ipa: str) -> str:
    return _insert_stress(ipa, 0)


# German unstressed verbal/nominal prefixes: the prefix vowel never takes
# stress and be-/ge- reduce to schwa (bekommen = bəkˈɔmən, Geschichte =
# ɡəʃˈɪçtə); a stem-initial st/sp after the prefix is the morpheme onset
# and reads ʃt/ʃp (verstehen = fɛʁʃtˈeːən) just like word-initially.
_DE_PREFIX_IPA = {"be": ("beː", "bɛ"), "ge": ("ɡeː", "ɡɛ"), "er": ("ɛʁ",),
                  "ver": ("fɛʁ",), "zer": ("tsɛʁ",), "ent": ("ɛnt",),
                  "emp": ("ɛmp",)}
_DE_PREFIX_EXCEPTIONS = {  # stem-initial lookalikes keep initial stress
    "geben", "gegen", "gehen", "gern", "gerne", "geld", "gelb",
    "gestern", "geste", "gesten", "gelten", "geist", "geister", "geige",
    "beten", "betet", "besen", "beben", "beste", "besten", "bester",
    "bestes", "bestens", "erste", "ersten", "erster", "erstes", "ernst",
    "erbe", "erben", "erde", "erden", "ernte", "ernten",
    "entweder", "ente", "enten", "erzen", "erzes",
}
# stem FAMILIES matched by startswith (ADVICE r04: exact forms missed
# inflections — Berge, gelbe...).  Only stems no be-/ge-/er- verb can
# start with (no German stem begins rg-/lb-/ld-/rn-/nst-), so startswith
# cannot shadow a real prefix verb (cf. "best"/"erst", which would shadow
# bestehen/erstellen and therefore stay exact-form entries above).
_DE_PREFIX_EXCEPTION_STEMS = ("berg", "gelb", "geld", "gern", "ernst",
                              "ernte", "erde", "erden", "geig", "geist")
_DE_VOWELS = set("aeiouäöüy")

# Dutch shares the Germanic unstressed-prefix system (begrijpen =
# bəɣrˈɛipən, verstaan = vərstˈaːn); be-/ge-/ver- reduce to schwa
_NL_PREFIX_IPA = {"be": ("beː", "bɛ"), "ge": ("ɣeː", "ɣɛ"),
                  "ver": ("vɛr",), "ont": ("ɔnt",), "her": ("ɦɛr",),
                  "er": ("ɛr",)}
_NL_PREFIX_EXCEPTIONS = {
    "beter", "betere", "beste", "besten", "bezem", "beker", "bekers",
    "geven", "gevel", "gevels", "gerst", "gelden", "geldig",
    "verder", "verdere", "vers", "verse", "ergens", "herfst",
    "hersenen", "herten",
}
_NL_PREFIX_EXCEPTION_STEMS = ("geld", "beter", "bezem", "beker", "gevel",
                              "herfst", "hersen")
_NL_PREFIX_SCHWA = {"be": "bə", "ge": "ɣə", "ver": "vər"}
_DE_PREFIX_SCHWA = {"be": "bə", "ge": "ɡə"}


def _prefix_stress(prefix_ipa, exceptions, schwa, st_sp_sh,
                   exception_stems=()):
    """Stress function for Germanic languages with unstressed verbal
    prefixes: the stem takes the stress, be-/ge-(/ver-) reduce to schwa,
    and (German) a stem-initial st/sp reads ʃ as at word start."""
    def stress(word: str, ipa: str) -> str:
        w = word.lower()
        for p, realizations in prefix_ipa.items():
            if not w.startswith(p):
                continue
            stem = w[len(p):]
            p_ipa = next((r for r in realizations if ipa.startswith(r)),
                         None)
            if (len(stem) >= 3 and stem[0] not in _DE_VOWELS
                    and stem[0] != stem[1:2]      # besser/betten: tt/ss
                    and w not in exceptions
                    and not any(w.startswith(s) for s in exception_stems)
                    and p_ipa is not None):
                rest = ipa[len(p_ipa):]
                if st_sp_sh and stem[:2] in ("st", "sp") \
                        and rest.startswith("s"):
                    rest = "ʃ" + rest[1:]
                return schwa.get(p, p_ipa) + _insert_stress(rest, 0)
            break  # prefix spelled but conditions failed: initial stress
        return _insert_stress(ipa, 0)
    return stress


stress_german = _prefix_stress(_DE_PREFIX_IPA, _DE_PREFIX_EXCEPTIONS,
                               _DE_PREFIX_SCHWA, st_sp_sh=True,
                               exception_stems=_DE_PREFIX_EXCEPTION_STEMS)
stress_dutch = _prefix_stress(_NL_PREFIX_IPA, _NL_PREFIX_EXCEPTIONS,
                              _NL_PREFIX_SCHWA, st_sp_sh=False,
                              exception_stems=_NL_PREFIX_EXCEPTION_STEMS)


def stress_penult(word: str, ipa: str) -> str:
    return _insert_stress(ipa, -2 if len(_vowel_runs(ipa)) >= 2 else -1)


def stress_final(word: str, ipa: str) -> str:
    return _insert_stress(ipa, -1)


def stress_french(word: str, ipa: str) -> str:
    """Final-syllable prominence, skipping a word-final schwa."""
    runs = _vowel_runs(ipa)
    if not runs:
        return ipa
    idx = -1
    if len(runs) >= 2 and ipa[runs[-1]] == "ə":
        idx = -2
    return _insert_stress(ipa, idx)


def stress_spanish(word: str, ipa: str) -> str:
    """Accented vowel if written; else penult when the word ends in a vowel
    or n/s, final otherwise (standard Spanish rule)."""
    if PRIMARY_STRESS in ipa:
        return ipa
    return stress_penult(word, ipa) if re.search(r"[aeiouns]$", word) \
        else stress_final(word, ipa)


_PT_CLITICS = {"e"}  # scale-group conjunction (numbers.py) stays unstressed


def stress_portuguese(word: str, ipa: str) -> str:
    if PRIMARY_STRESS in ipa or word in _PT_CLITICS:
        return ipa
    # nasal-diphthong endings (-ão, -ãe, -õe + plurals) are final-stressed
    if re.search(r"(ão|ãe|õe)s?$", word):
        out = stress_final(word, ipa)
    else:
        out = stress_penult(word, ipa) \
            if re.search(r"[aeos]$|am$|em$", word) \
            else stress_final(word, ipa)
    # i/u + nasal vowel form one run but the nasal carries the
    # stress (crianca -> kɾiˈɐ̃sɐ, aviao -> ɐviˈɐ̃w); plain hiatus
    # keeps the high vowel stressed (dia -> dˈiɐ)
    return re.sub("ˈ([iu])(.̃)", r"\1ˈ\2", out, count=1)


def stress_italian(word: str, ipa: str) -> str:
    return ipa if PRIMARY_STRESS in ipa else stress_penult(word, ipa)


def stress_marked_only(word: str, ipa: str) -> str:
    return ipa


def stress_greek(word: str, ipa: str) -> str:
    """Tonos carries the stress; monosyllables are written without one
    (γη, φως) but are stressed content words all the same."""
    if PRIMARY_STRESS in ipa:
        return ipa
    runs = _vowel_runs(ipa)
    return _insert_stress(ipa, 0) if len(runs) == 1 else ipa


@dataclass
class Language:
    rules: RuleSet
    stress: Callable[[str, str], str]
    digits: Sequence[str]  # words for 0..9 (fallback beyond numbers.py range)
    lexicon: Dict[str, str] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Spanish (Castilian: c/z -> θ, ll -> ʎ, j/g+ei -> x)
# ---------------------------------------------------------------------------

_ES_RULES = [
    Rule("ch", "tʃ"), Rule("ll", "ʎ"), Rule("rr", "r"), Rule("qu", "k"),
    Rule("gue", "ɡe"), Rule("gui", "ɡi"), Rule("güe", "ɡwe"), Rule("güi", "ɡwi"),
    Rule("c", "θ", post="[eéií]"), Rule("c", "k"),
    Rule("g", "x", post="[eéií]"), Rule("g", "ɡ"),
    Rule("j", "x"), Rule("ñ", "ɲ"), Rule("z", "θ"), Rule("v", "b"),
    Rule("h", ""), Rule("x", "ks"), Rule("y", "i", post="$"), Rule("y", "ʝ"),
    Rule("r", "r", pre="^"), Rule("r", "ɾ"),
    Rule("b", "b"), Rule("d", "d"), Rule("f", "f"), Rule("k", "k"),
    Rule("l", "l"), Rule("m", "m"), Rule("n", "n"), Rule("p", "p"),
    Rule("s", "s"), Rule("t", "t"), Rule("w", "w"),
    # unaccented high vowels glide before vowels (diphthongs: ie -> je)
    Rule("i", "j", post="[aeouáéóú]"), Rule("u", "w", post="[aeioáéíó]"),
    Rule("a", "a"), Rule("e", "e"), Rule("i", "i"), Rule("o", "o"),
    Rule("u", "u"),
    Rule("á", "ˈa"), Rule("é", "ˈe"), Rule("í", "ˈi"), Rule("ó", "ˈo"),
    Rule("ú", "ˈu"), Rule("ü", "w"),
]

_ES_DIGITS = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis",
              "siete", "ocho", "nueve"]

# ---------------------------------------------------------------------------
# Italian
# ---------------------------------------------------------------------------

_IT_RULES = [
    Rule("sci", "ʃ", post="[aouàòù]"), Rule("sce", "ʃe"), Rule("sci", "ʃi"),
    Rule("sch", "sk"),
    Rule("gli", "ʎ", post="[aeou]"), Rule("gli", "ʎi"), Rule("gn", "ɲ"),
    Rule("chi", "kj", post="[aeou]"),  # chiesa, occhio, chiudere
    Rule("chi", "ki"), Rule("che", "ke"), Rule("ch", "k"),
    Rule("ghi", "ɡj", post="[aeou]"),  # ghiaccio
    Rule("ghi", "ɡi"), Rule("ghe", "ɡe"), Rule("gh", "ɡ"),
    Rule("cie", "tʃe"),  # orthographic i: cielo, società (no glide)
    # geminate affricates read stop+affricate (braccio -> ttʃ, oggi ->
    # ddʒ, pizza -> tts), not doubled affricates
    Rule("cci", "ttʃ", post="[aouàòù]"), Rule("cc", "ttʃ", post="[eèéi]"),
    Rule("ggi", "ddʒ", post="[aouàòù]"), Rule("gg", "ddʒ", post="[eèéi]"),
    Rule("zz", "tts"),
    Rule("ci", "tʃ", post="[aouàòù]"), Rule("gi", "dʒ", post="[aouàòù]"),
    Rule("c", "tʃ", post="[eèéi]"), Rule("c", "k"),
    Rule("gu", "ɡw", post="[aeio]"),   # lingua, guardare
    Rule("g", "dʒ", post="[eèéi]"), Rule("g", "ɡ"),
    Rule("sb", "zb"), Rule("sd", "zd"), Rule("sg", "zɡ"), Rule("sl", "zl"),
    Rule("sm", "zm"), Rule("sn", "zn"), Rule("sr", "zr"), Rule("sv", "zv"),
    Rule("z", "ts"), Rule("h", ""), Rule("qu", "kw"),
    Rule("r", "r"), Rule("v", "v"),
    Rule("b", "b"), Rule("d", "d"), Rule("f", "f"), Rule("k", "k"),
    Rule("l", "l"), Rule("m", "m"),
    # n assimilates before velars, but not before ge/gi (= dʒ: mangiare)
    Rule("n", "ŋ", post="[ckq]|g(?![ei])"),
    Rule("n", "n"), Rule("p", "p"), Rule("s", "s"), Rule("t", "t"),
    Rule("w", "w"), Rule("j", "j"), Rule("x", "ks"),
    Rule("uo", "wɔ"),  # buono, scuola, uomo
    # unstressed i glides before vowels after a consonant (piano, grazie)
    Rule("i", "j", pre="[bcdfglmnprstvz]", post="[aeouàèéòù]"),
    Rule("a", "a"), Rule("e", "e"), Rule("i", "i"), Rule("o", "o"),
    Rule("u", "u"), Rule("y", "i"),
    Rule("à", "ˈa"), Rule("è", "ˈɛ"), Rule("é", "ˈe"), Rule("ì", "ˈi"),
    Rule("ò", "ˈɔ"), Rule("ó", "ˈo"), Rule("ù", "ˈu"),
]

_IT_DIGITS = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei",
              "sette", "otto", "nove"]

# open-mid ɛ/ɔ are lexical in Italian orthography — the rules default to
# closed e/o; this lexicon carries the open vowels for frequent words
_IT_LEXICON = {
    "bello": "bˈɛllo", "bella": "bˈɛlla", "belli": "bˈɛlli",
    "belle": "bˈɛlle", "notte": "nˈɔtte", "porta": "pˈɔrta",
    "donna": "dˈɔnna", "donne": "dˈɔnne", "otto": "ˈɔtto",
    "nove": "nˈɔve", "sette": "sˈɛtte", "dieci": "djˈɛtʃi",
    "festa": "fˈɛsta", "terra": "tˈɛrra", "guerra": "ɡwˈɛrra",
    "forte": "fˈɔrte", "morte": "mˈɔrte", "posto": "pˈɔsto",
    "nostro": "nˈɔstro", "vostro": "vˈɔstro", "piede": "pjˈɛde",
    # proparoxytones (sdrucciole) the penult default cannot know, hiatus
    # zio/zia, and more lexical open vowels (round-5 fixture audit)
    "tavolo": "tˈavolo", "tavoli": "tˈavoli", "camera": "kˈamera",
    "camere": "kˈamere", "macchina": "mˈakkina", "macchine": "mˈakkine",
    "zucchero": "tsˈukkero", "uomini": "wˈɔmini", "piccolo": "pˈikkolo",
    "piccola": "pˈikkola", "piccoli": "pˈikkoli", "piccole": "pˈikkole",
    "debole": "dˈebole", "deboli": "dˈeboli", "facile": "fˈatʃile",
    "facili": "fˈatʃili", "difficile": "diffˈitʃile",
    "difficili": "diffˈitʃili", "giovane": "dʒˈovane",
    "giovani": "dʒˈovani", "prendere": "prˈɛndere",
    "leggere": "lˈɛddʒere", "scrivere": "skrˈivere",
    "chiudere": "kjˈudere", "vivere": "vˈivere", "credere": "krˈedere",
    "essere": "ˈɛssere", "aereo": "aˈɛreo", "zio": "tsˈio",
    "zia": "tsˈia", "cosa": "kˈɔsa", "cose": "kˈɔse",
    "modo": "mˈɔdo", "modi": "mˈɔdi", "popolo": "pˈɔpolo",
    "numero": "nˈumero", "numeri": "nˈumeri", "ultimo": "ˈultimo",
    "ultima": "ˈultima", "subito": "sˈubito", "musica": "mˈuzika",
    "medico": "mˈɛdiko", "sabato": "sˈabato", "albero": "ˈalbero",
    "alberi": "ˈalberi", "oggi": "ˈɔddʒi", "cielo": "tʃˈɛlo",
    "chiesa": "kjˈɛsa", "chiese": "kjˈɛse",
    "testa": "tˈɛsta", "teste": "tˈɛste", "finestra": "finˈɛstra",
    "finestre": "finˈɛstre", "sorella": "sorˈɛlla",
    "sorelle": "sorˈɛlle", "fratello": "fratˈɛllo",
    "fratelli": "fratˈɛlli", "vento": "vˈɛnto", "centro": "tʃˈɛntro",
    "centri": "tʃˈɛntri", "treno": "trˈɛno", "treni": "trˈɛni",
    "pera": "pˈɛra", "pere": "pˈɛre", "sedia": "sˈɛdja",
    "sedie": "sˈɛdje", "ferro": "fˈɛrro", "erba": "ˈɛrba",
    "pietra": "pjˈɛtra", "vecchio": "vˈɛkkjo", "occhio": "ˈɔkkjo",
    "occhi": "ˈɔkki", "petto": "pˈɛtto", "erba": "ˈɛrba",
    "tempo": "tˈɛmpo", "gente": "dʒˈɛnte", "niente": "njˈɛnte",
    "bene": "bˈɛne", "male": "mˈale", "cuore": "kwˈɔre",
    "essere": "ˈɛssere", "ecco": "ˈɛkko", "è": "ˈɛ",
}

# ---------------------------------------------------------------------------
# Finnish (close to 1:1; double letters = length)
# ---------------------------------------------------------------------------

_FI_RULES = [
    Rule("aa", "aː"), Rule("ee", "eː"), Rule("ii", "iː"), Rule("oo", "oː"),
    Rule("uu", "uː"), Rule("yy", "yː"), Rule("ää", "æː"), Rule("öö", "øː"),
    Rule("ng", "ŋː"), Rule("nk", "ŋk"),
    Rule("pp", "pː"), Rule("tt", "tː"), Rule("kk", "kː"), Rule("ss", "sː"),
    Rule("ll", "lː"), Rule("mm", "mː"), Rule("nn", "nː"), Rule("rr", "rː"),
    Rule("a", "a"), Rule("e", "e"), Rule("i", "i"), Rule("o", "o"),
    Rule("u", "u"), Rule("y", "y"), Rule("ä", "æ"), Rule("ö", "ø"),
    Rule("b", "b"), Rule("d", "d"), Rule("f", "f"), Rule("g", "ɡ"),
    Rule("h", "h"), Rule("j", "j"), Rule("k", "k"), Rule("l", "l"),
    Rule("m", "m"), Rule("n", "n"), Rule("p", "p"), Rule("r", "r"),
    Rule("s", "s"), Rule("t", "t"), Rule("v", "ʋ"), Rule("w", "ʋ"),
    Rule("c", "k"), Rule("z", "ts"), Rule("x", "ks"), Rule("å", "oː"),
]

_FI_DIGITS = ["nolla", "yksi", "kaksi", "kolme", "neljä", "viisi", "kuusi",
              "seitsemän", "kahdeksan", "yhdeksän"]

# ---------------------------------------------------------------------------
# Greek (modern; stress from tonos)
# ---------------------------------------------------------------------------

_EL_RULES = [
    # digraph vowels
    Rule("ου", "u"), Rule("ού", "ˈu"),
    Rule("αι", "e"), Rule("αί", "ˈe"), Rule("ει", "i"), Rule("εί", "ˈi"),
    Rule("οι", "i"), Rule("οί", "ˈi"), Rule("υι", "i"),
    # αυ/ευ: voiced before voiced/vowel, else f
    Rule("αυ", "av", post="[αβγδεζηλμνιορωυ]"), Rule("αυ", "af"),
    Rule("αύ", "ˈav", post="[αβγδεζηλμνιορωυ]"), Rule("αύ", "ˈaf"),
    Rule("ευ", "ev", post="[αβγδεζηλμνιορωυ]"), Rule("ευ", "ef"),
    Rule("εύ", "ˈev", post="[αβγδεζηλμνιορωυ]"), Rule("εύ", "ˈef"),
    # nasal+stop clusters
    Rule("μπ", "b", pre="^"), Rule("μπ", "mb"),
    Rule("ντ", "d", pre="^"), Rule("ντ", "nd"),
    Rule("γκ", "ɡ", pre="^"), Rule("γκ", "ŋɡ"), Rule("γγ", "ŋɡ"),
    Rule("τσ", "ts"), Rule("τζ", "dz"), Rule("σσ", "s"), Rule("λλ", "l"),
    Rule("μμ", "m"), Rule("νν", "n"), Rule("ππ", "p"), Rule("ττ", "t"),
    Rule("κκ", "k"), Rule("ρρ", "ɾ"),
    # palatal + unstressed ι/ει glide before vowels (δουλειά, καινούργιος)
    Rule("λει", "ʎ", post="[άαοό]"), Rule("λι", "ʎ", post="[άαοόυύωώ]"),
    Rule("νι", "ɲ", post="[άαοόυύωώ]"), Rule("γι", "ʝ", post="[άαοόυύωώ]"),
    # γ: j before front vowels, ɣ otherwise
    Rule("γ", "ʝ", post="[ειηυίέήύ]|αι|αί|οι|οί"), Rule("γ", "ɣ"),
    Rule("χ", "ç", post="[ειηυίέήύ]|αι|αί|οι|οί"), Rule("χ", "x"),
    Rule("α", "a"), Rule("ά", "ˈa"), Rule("ε", "e"), Rule("έ", "ˈe"),
    Rule("η", "i"), Rule("ή", "ˈi"), Rule("ι", "i"), Rule("ί", "ˈi"),
    Rule("ϊ", "i"), Rule("ΐ", "ˈi"), Rule("ο", "o"), Rule("ό", "ˈo"),
    Rule("υ", "i"), Rule("ύ", "ˈi"), Rule("ϋ", "i"), Rule("ΰ", "ˈi"),
    Rule("ω", "o"), Rule("ώ", "ˈo"),
    Rule("β", "v"), Rule("δ", "ð"), Rule("ζ", "z"), Rule("θ", "θ"),
    Rule("κ", "c", post="[ειηυίέήύ]|αι|αί|οι|οί"), Rule("κ", "k"),
    Rule("λ", "l"), Rule("μ", "m"), Rule("ν", "n"), Rule("ξ", "ks"),
    Rule("π", "p"), Rule("ρ", "ɾ"), Rule("σ", "s"), Rule("ς", "s"),
    Rule("τ", "t"), Rule("φ", "f"), Rule("ψ", "ps"),
]

_EL_DIGITS = ["μηδέν", "ένα", "δύο", "τρία", "τέσσερα", "πέντε", "έξι",
              "επτά", "οκτώ", "εννέα"]

# ---------------------------------------------------------------------------
# Hungarian (very regular; initial stress)
# ---------------------------------------------------------------------------

_HU_RULES = [
    Rule("ccs", "tʃː"), Rule("ssz", "sː"), Rule("zzs", "ʒː"),
    Rule("ggy", "ɟː"), Rule("tty", "cː"), Rule("nny", "ɲː"), Rule("lly", "jː"),
    Rule("dzs", "dʒ"),
    Rule("cs", "tʃ"), Rule("sz", "s"), Rule("zs", "ʒ"), Rule("gy", "ɟ"),
    Rule("ty", "c"), Rule("ny", "ɲ"), Rule("ly", "j"), Rule("dz", "dz"),
    Rule("ss", "ʃː"),  # lassú: geminate ʃ (plain s = ʃ; ssz = sː)
    Rule("tt", "tː"), Rule("kk", "kː"), Rule("pp", "pː"), Rule("ll", "lː"),
    Rule("nn", "nː"), Rule("mm", "mː"), Rule("rr", "rː"), Rule("zz", "zː"),
    Rule("ff", "fː"), Rule("bb", "bː"), Rule("dd", "dː"), Rule("gg", "ɡː"),
    Rule("s", "ʃ"), Rule("c", "ts"), Rule("z", "z"), Rule("j", "j"),
    Rule("a", "ɒ"), Rule("á", "aː"), Rule("e", "ɛ"), Rule("é", "eː"),
    Rule("i", "i"), Rule("í", "iː"), Rule("o", "o"), Rule("ó", "oː"),
    Rule("ö", "ø"), Rule("ő", "øː"), Rule("u", "u"), Rule("ú", "uː"),
    Rule("ü", "y"), Rule("ű", "yː"),
    Rule("b", "b"), Rule("d", "d"), Rule("f", "f"), Rule("g", "ɡ"),
    Rule("h", "h"), Rule("k", "k"), Rule("l", "l"), Rule("m", "m"),
    Rule("n", "ŋ", post="[kg]"), Rule("n", "n"), Rule("p", "p"),
    Rule("r", "r"), Rule("t", "t"), Rule("v", "v"), Rule("w", "v"),
    Rule("x", "ks"), Rule("y", "i"), Rule("q", "k"),
]

_HU_DIGITS = ["nulla", "egy", "kettő", "három", "négy", "öt", "hat", "hét",
              "nyolc", "kilenc"]

# ---------------------------------------------------------------------------
# Polish (ʂ-series merged to ʃ-series like the reference replacements)
# ---------------------------------------------------------------------------

# exception words (irregular cluster simplifications)
_PL_WORD_LEXICON = {
    "jabłko": "jˈapkɔ", "jabłka": "jˈapka",  # the ł is silent here
}

_PL_RULES = [
    Rule("dzi", "dʑ", post="[aeouąęó]"), Rule("dzi", "dʑi"),
    # final voiced affricates devoice (odpowiedź -> ...tɕ, widz -> ts)
    Rule("dź", "tɕ", post="$"), Rule("dż", "tʃ", post="$"),
    Rule("dz", "ts", post="$"),
    Rule("dź", "dʑ"), Rule("dż", "dʒ"), Rule("dz", "dz"),
    Rule("ci", "tɕ", post="[aeouąęó]"), Rule("ci", "tɕi"),
    Rule("si", "ɕ", post="[aeouąęó]"), Rule("si", "ɕi"),
    Rule("zi", "ʑ", post="[aeouąęó]"), Rule("zi", "ʑi"),
    Rule("ni", "ɲ", post="[aeouąęó]"), Rule("ni", "ɲi"),
    Rule("sz", "ʃ"), Rule("cz", "tʃ"), Rule("rz", "ʃ", pre="[ptk]"),
    Rule("rz", "ʒ"), Rule("ch", "x"),
    Rule("ć", "tɕ"), Rule("ś", "ɕ"), Rule("ń", "ɲ"),
    Rule("ź", "ɕ", post="[ćcptksśfh]|$"),  # znaleźć, weź: devoiced
    Rule("ź", "ʑ"),
    # obstruent devoicing: word-finally and before voiceless consonants
    # (książka -> kɕɔ̃ʃka, chleb -> xlɛp, twoja -> tfɔja) — fully regular
    # in standard Polish
    Rule("ż", "ʃ", post="[ptkcsśćfh]|$"), Rule("ż", "ʒ"),
    Rule("ł", "w"),
    Rule("w", "f", post="[ptkcsśćfh]|$"), Rule("w", "f", pre="[ptkcsśćfh]"),
    Rule("w", "v"),
    Rule("b", "p", post="[ptkcsśćfh]|$"),
    Rule("d", "t", post="[ptkcsśćfh]|$"),  # odpowiedź -> ɔtp...
    Rule("g", "k", post="[ptcsśćfh]|$"), Rule("z", "s", post="$"),
    # nasal vowels decompose before plosives (ęk -> ɛŋk, ąt -> ɔnt) and ę
    # denasalizes word-finally (standard Warsaw pronunciation)
    Rule("ą", "ɔŋ", post="[kg]"), Rule("ą", "ɔn", post="[tdc]"),
    Rule("ą", "ɔm", post="[pb]"), Rule("ą", "ɔ̃"),
    Rule("ę", "ɛŋ", post="[kg]"), Rule("ę", "ɛn", post="[tdc]"),
    Rule("ę", "ɛm", post="[pb]"), Rule("ę", "ɛ", post="$"), Rule("ę", "ɛ̃"),
    Rule("ó", "u"),
    # i marks palatalization + glides before vowels (miasto -> mjasto)
    Rule("i", "j", pre="[bcdfghklmprstvwz]", post="[aeouąęó]"),
    Rule("a", "a"), Rule("e", "ɛ"), Rule("i", "i"), Rule("o", "ɔ"),
    Rule("u", "u"), Rule("y", "ɨ"),
    Rule("b", "b"), Rule("c", "ts"), Rule("d", "d"), Rule("f", "f"),
    Rule("g", "ɡ"), Rule("h", "x"), Rule("j", "j"), Rule("k", "k"),
    Rule("l", "l"), Rule("m", "m"), Rule("n", "n"), Rule("p", "p"),
    Rule("r", "r"), Rule("s", "s"), Rule("t", "t"), Rule("z", "z"),
]

_PL_DIGITS = ["zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć",
              "siedem", "osiem", "dziewięć"]

# ---------------------------------------------------------------------------
# Dutch (approximation)
# ---------------------------------------------------------------------------

_NL_RULES = [
    Rule("schr", "sxr"),  # schrijven
    Rule("sch", "sx", post="[aeiou]"), Rule("sch", "s"),  # final -sch = /s/
    # suffix -(e)lijk reads with schwas (lelijk -> leːlək, makkelijk)
    Rule("elijk", "ələk", post="(e|s|ə)?$"), Rule("lijk", "lək", post="(e|s)?$"),
    Rule("eren", "ərən", post="$"), Rule("enen", "ənən", post="$"),
    Rule("elen", "ələn", post="$"),  # luisteren, openen, wandelen
    # degemination: doubled consonants are one sound (the doubling only
    # signals the short preceding vowel, which the context rules see in
    # the original graphemes)
    Rule("pp", "p"), Rule("tt", "t"), Rule("kk", "k"), Rule("ff", "f"),
    Rule("ss", "s"), Rule("ll", "l"), Rule("mm", "m"), Rule("nn", "n"),
    Rule("rr", "r"), Rule("gg", "ɣ"), Rule("dd", "d"), Rule("bb", "b"),
    Rule("th", "t"),  # thee, thuis
    Rule("ouw", "ʌu", post="$"), Rule("auw", "ʌu", post="$"),  # vrouw, blauw
    Rule("ieuw", "iʋ"), Rule("ooi", "oːi"), Rule("aai", "aːi"),
    Rule("ij", "ɛi"), Rule("ei", "ɛi"), Rule("ui", "œy"), Rule("ou", "ʌu"),
    Rule("au", "ʌu"), Rule("oei", "ui"), Rule("oe", "u"),
    Rule("eu", "øː", post="r"),  # deur, kleur: tense before r
    Rule("eu", "ø"), Rule("ie", "i"),
    Rule("aa", "aː"), Rule("ee", "eː"), Rule("oo", "oː"),
    Rule("uu", "yː", post="r"), Rule("uu", "y"),  # vuur: tense before r
    Rule("ng", "ŋ"), Rule("nk", "ŋk"), Rule("ch", "x"),
    # unstressed-syllable schwa (the prefix must already contain a vowel:
    # stressed monosyllables like "ben"/"wel" keep ɛ)
    Rule("e", "ə", post="[lnr]?$", pre=".*[aeiou].*"),
    Rule("u", "y", post="$"),  # nu, u
    Rule("a", "aː", post="$"), Rule("o", "oː", post="$"),  # opa, auto
    # open-syllable lengthening: single vowel + single consonant + vowel
    # (water -> ʋaːtər, leven -> leːvən, deze -> deːzə)
    Rule("a", "aː", post="[bdfgklmnprstvz][aeiou]"),
    Rule("e", "eː", post="[bdfgklmnprstvz][aeiou]"),
    Rule("o", "oː", post="[bdfgklmnprstvz][aeiou]"),
    Rule("a", "ɑ"), Rule("e", "ɛ"),
    Rule("i", "ɪ"), Rule("o", "ɔ"), Rule("u", "ʏ"), Rule("y", "i"),
    Rule("b", "b"), Rule("c", "s", post="[ei]"), Rule("c", "k"),
    Rule("d", "t", post="$"), Rule("d", "d"),
    Rule("fd", "ft", post="$"),   # hoofd: the d devoices, f stays f
    Rule("f", "v", post="[bd]"),  # regressive voicing: liefde -> livdə
    Rule("f", "f"),
    Rule("g", "x", post="$"),
    Rule("g", "x", post="[tkpsf]"),  # vliegtuig: devoiced before voiceless
    Rule("g", "ɣ"), Rule("h", "ɦ"),
    Rule("j", "j"), Rule("k", "k"),
    Rule("l", "l"), Rule("m", "m"), Rule("n", "n"), Rule("p", "p"),
    Rule("q", "k"), Rule("r", "r"), Rule("s", "s"), Rule("t", "t"),
    Rule("v", "v"), Rule("w", "ʋ"), Rule("x", "ks"), Rule("z", "z"),
    Rule("é", "ˈeː"), Rule("è", "ˈɛ"), Rule("ë", "ə"), Rule("ï", "i"),
]

_NL_DIGITS = ["nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven",
              "acht", "negen"]

# Dutch loanword stress exceptions (initial-stress default misfires)
_NL_LEXICON = {
    "miljoen": "mɪljˈun", "miljard": "mɪljˈɑrt",
    "rivier": "rivˈir", "lelijk": "lˈeːlək", "lelijke": "lˈeːləkə", "citroen": "sitrˈun", "tomaat": "toːmˈaːt",
    "familie": "famˈili", "wereld": "ʋˈeːrəlt", "muziek": "myzˈik",
    "station": "staːʃˈɔn", "kantoor": "kɑntˈoːr", "papier": "paːpˈir",
    "natuur": "naːtˈyːr", "minuut": "minˈyt", "seconde": "səkˈɔndə",
    "politie": "poːlˈitsi", "vakantie": "vaːkˈɑnsi",
}

# ---------------------------------------------------------------------------
# German (approximation; initial stress).  Vowel length: a stressed vowel
# before a single consonant + vowel/end is long (Name, gut, rot); before a
# consonant cluster or doubled consonant it is short (und, Mutter).
# Monosyllabic function words that break the rule sit in the lexicon.
# ---------------------------------------------------------------------------

# high-frequency function words whose vowels the length rule would get wrong
_DE_LEXICON = {
    # loanword stress (the first-syllable default misfires on these;
    # unit words surface via symbols.py's "5 km" expansion)
    "kilometer": "kiloːmˈeːtɐ", "zentimeter": "tsɛntimˈeːtɐ",
    "millimeter": "milimˈeːtɐ", "kilogramm": "kiloːɡʁˈam",
    "milligramm": "mɪliɡʁˈam", "milliliter": "mɪlilˈiːtɐ",
    "prozent": "pʁotsˈɛnt", "celsius": "tsˈɛlziʊs",
    "million": "mɪliˈoːn", "millionen": "mɪliˈoːnən",
    # long-vowel exception classes the open-syllable rule cannot see
    "mond": "moːnt", "monde": "moːndə", "montag": "moːntaːk",
    "obst": "oːpst", "herbst": "hɛʁpst", "hoch": "hoːx",
    "sprache": "ʃpʁaːxə", "sprachen": "ʃpʁaːxən", "suche": "zuːxə",
    "kuchen": "kuːxən", "buche": "buːxə",
    "abend": "aːbənt", "abends": "aːbənts", "abende": "aːbəndə",
    "monat": "moːnat", "monate": "moːnatə", "monaten": "moːnatən",
    "mädchen": "mɛːtçən", "auto": "aʊto", "autos": "aʊtos",
    "kino": "kiːno", "kinos": "kiːnos",
    "milliarde": "mɪliˈaʁdə", "milliarden": "mɪliˈaʁdən",
    # Latinate loans stress the final/penult syllable, not the first
    "musik": "muzˈiːk", "natur": "natˈuːʁ", "minute": "minˈuːtə",
    "minuten": "minˈuːtən", "sekunde": "zekˈʊndə", "sekunden": "zekˈʊndən",
    "familie": "famˈiːliə", "universität": "ʊnivɛʁzitˈɛːt",
    "politik": "politˈiːk", "student": "ʃtudˈɛnt",
    "studenten": "ʃtudˈɛntən", "kultur": "kʊltˈuːʁ",
    "person": "pɛʁzˈoːn", "personen": "pɛʁzˈoːnən",
    "problem": "pʁoblˈeːm", "probleme": "pʁoblˈeːmə",
    "interesse": "ɪntəʁˈɛsə", "idee": "idˈeː", "ideen": "idˈeːən",
    "museum": "muzˈeːʊm", "papier": "papˈiːʁ", "partei": "paʁtˈaɪ",
    "natürlich": "natˈyːʁlɪç", "vielleicht": "filˈaɪçt",
    "warum": "vaʁˈʊm", "zurück": "tsuʁˈʏk", "zusammen": "tsuzˈamən",
    "beispiel": "bˈaɪʃpiːl", "beispiele": "bˈaɪʃpiːlə",
    "das": "das", "was": "vas", "es": "ɛs", "des": "dɛs", "dass": "das",
    "daß": "das", "in": "ɪn", "im": "ɪm", "an": "an", "am": "am",
    "um": "ʊm", "zum": "tsʊm", "von": "fɔn", "vom": "fɔm", "mit": "mɪt",
    "bis": "bɪs", "ab": "ap", "ob": "ɔp", "man": "man", "hat": "hat",
    "ist": "ɪst", "bin": "bɪn", "hin": "hɪn", "hin-": "hɪn",
    "weg": "vɛk", "zu": "tsuː", "er": "ɛɐ", "der": "deːɐ", "wir": "viːɐ",
    "mir": "miːɐ", "dir": "diːɐ", "vor": "foːɐ", "nur": "nuːɐ",
    "für": "fyːɐ", "zur": "tsuːɐ", "wer": "veːɐ", "her": "heːɐ",
    "schwer": "ʃveːɐ", "mehr": "meːɐ", "sehr": "zeːɐ",
    "buch": "buːx", "nach": "naːx",
    "doch": "dɔx", "auch": "aʊx", "sich": "zɪç", "mich": "mɪç",
    "dich": "dɪç",
}

_DE_LONG_POST = "[bdfglkmnprstvß](?:$|[aeiouäöüy])"  # single consonant, open

_DE_RULES = [
    Rule("tsch", "tʃ"), Rule("dsch", "dʒ"), Rule("sch", "ʃ"),
    Rule("tion", "tsioːn"), Rule("chs", "ks"),
    Rule("ch", "x", pre="[aou]"), Rule("ch", "ç"),
    Rule("ck", "k"), Rule("tz", "ts"), Rule("ph", "f"), Rule("th", "t"),
    Rule("qu", "kv"), Rule("ss", "s"), Rule("dt", "t"),
    # doubled consonants degeminate (they only mark the short vowel)
    Rule("tt", "t"), Rule("nn", "n"), Rule("mm", "m"), Rule("ll", "l"),
    Rule("pp", "p"), Rule("ff", "f"), Rule("rr", "ʁ"), Rule("dd", "d"),
    Rule("bb", "b"), Rule("gg", "ɡ"), Rule("kk", "k"),
    Rule("sp", "ʃp", pre="^"), Rule("st", "ʃt", pre="^"),
    Rule("ei", "aɪ"), Rule("ai", "aɪ"), Rule("eu", "ɔʏ"), Rule("äu", "ɔʏ"),
    Rule("au", "aʊ"), Rule("ie", "iː"), Rule("ee", "eː"), Rule("aa", "aː"),
    Rule("oo", "oː"), Rule("eh", "eː"), Rule("ah", "aː"), Rule("oh", "oː"),
    Rule("uh", "uː"), Rule("ih", "iː"), Rule("äh", "ɛː"), Rule("öh", "øː"),
    Rule("üh", "yː"),
    Rule("ig", "ɪç", post="$"),  # -ig suffix (zwanzig, König)
    # morpheme-internal ng is always ŋ (Junge, singen, Finger, Angst);
    # only a particle+ge- participle boundary keeps n.g (angekommen,
    # eingeladen, hingegen, ungefähr) — the n belongs to the particle
    Rule("ng", "nɡ", pre="^(a|ei|hi|u)", post="e"),
    Rule("ng", "ŋ"),
    # vocalized unstressed -er (Wasser, Vater); stressed monosyllables
    # (wer, schwer) are lexicon entries
    Rule("er", "ɐ", post="$", pre=".*[aeiouäöüy].*"),
    Rule("e", "ə", post="[lnr]?$", pre=".*[aeiouäöüy].*"),  # unstressed final-syllable schwa (not in monosyllables)
    # open-syllable vowel length (gut -> ɡuːt, Name -> naːmə, rot -> ʁoːt);
    # closed syllables / doubled consonants stay short (und, Mutter)
    Rule("a", "aː", post=_DE_LONG_POST), Rule("a", "aː", post="$"),
    Rule("e", "eː", post=_DE_LONG_POST),
    Rule("i", "iː", post=_DE_LONG_POST), Rule("i", "iː", post="$"),
    Rule("o", "oː", post=_DE_LONG_POST), Rule("o", "oː", post="$"),
    Rule("u", "uː", post=_DE_LONG_POST), Rule("u", "uː", post="$"),
    Rule("ä", "ɛː", post=_DE_LONG_POST), Rule("ö", "øː", post=_DE_LONG_POST),
    Rule("ü", "yː", post=_DE_LONG_POST),
    Rule("a", "a"), Rule("e", "ɛ"),
    Rule("i", "ɪ"), Rule("o", "ɔ"), Rule("u", "ʊ"), Rule("ä", "ɛ"),
    Rule("ö", "œ"), Rule("ü", "ʏ"), Rule("y", "y"),
    Rule("b", "p", post="$"), Rule("b", "b"),
    Rule("d", "t", post="$"), Rule("d", "d"),
    Rule("g", "k", post="$"), Rule("g", "ɡ"),
    Rule("s", "z", post="[aeiouäöü]"), Rule("s", "s"),
    Rule("ß", "s"), Rule("v", "f"), Rule("w", "v"), Rule("z", "ts"),
    Rule("c", "k"), Rule("f", "f"), Rule("h", "h"), Rule("j", "j"),
    Rule("k", "k"), Rule("l", "l"), Rule("m", "m"),
    Rule("n", "ŋ", post="[kg]"), Rule("n", "n"), Rule("p", "p"),
    Rule("r", "ʁ"), Rule("t", "t"), Rule("x", "ks"),
]

_DE_DIGITS = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
              "sieben", "acht", "neun"]

# ---------------------------------------------------------------------------
# Russian (letter-to-sound).  Stress: ё is always stressed; monosyllabic
# content words are stressed; a frequent-word lexicon carries the stressed
# syllable for common polysyllables; everything else stays unmarked
# (lexical stress is not recoverable from Russian spelling).  When stress
# IS known, standard vowel reduction applies (akanye: unstressed о -> ɐ,
# е/я -> ɪ); unknown-stress words stay unreduced, which espeak's
# full-lexicon path would reduce — the gap is measured in G2P.md.
# ---------------------------------------------------------------------------

# word -> 0-based stressed syllable (vowel-run index).  Hand-checked
# frequent words; ё entries are omitted (ё marks its own stress).
_RU_STRESS = {
    "привет": 1, "спасибо": 1, "пожалуйста": 1, "здравствуйте": 0,
    "хорошо": 2, "плохо": 0, "очень": 0, "сегодня": 1, "завтра": 0,
    "вчера": 1, "сейчас": 1, "потом": 1, "всегда": 1, "никогда": 2,
    "вода": 1, "работа": 1, "человек": 2, "люди": 0, "время": 0,
    "жизни": 0, "слово": 0, "дело": 0, "место": 0, "город": 0,
    "страна": 1, "россия": 1, "москва": 1, "язык": 1, "русский": 0,
    "книга": 0, "школа": 0, "учитель": 1, "ребенок": 1, "мама": 0,
    "папа": 0, "семья": 1, "женщина": 0, "мужчина": 1, "девушка": 0,
    "мальчик": 0, "собака": 1, "кошка": 0, "машина": 1, "дорога": 1,
    "улица": 0, "окно": 1, "дверь": 0, "стол": 0, "стул": 0,
    "комната": 0, "квартира": 1, "деньги": 0, "магазин": 2,
    "продукты": 1, "хлеб": 0, "молоко": 2, "мясо": 0, "рыба": 0,
    "яблоко": 0, "утро": 0, "вечер": 0, "ночью": 0, "неделя": 1,
    "месяц": 0, "года": 0, "зима": 1, "весна": 1, "лето": 0,
    "осень": 0, "погода": 1, "солнце": 0, "небо": 0, "земля": 1,
    "музыка": 0, "фильм": 0, "театр": 1, "история": 1, "вопрос": 1,
    "ответ": 1, "проблема": 1, "помощь": 0, "правда": 0, "друзья": 1,
    "понимать": 2, "говорить": 2, "сказать": 1, "думать": 0,
    "знать": 0, "видеть": 0, "слышать": 0, "делать": 0, "работать": 1,
    "жить": 0, "любить": 1, "хотеть": 1, "мочь": 0, "идти": 1,
    "ехать": 0, "читать": 1, "писать": 1, "смотреть": 1, "красивый": 1,
    "большой": 1, "маленький": 0, "новый": 0, "старый": 0,
    "молодой": 2, "белый": 0, "черный": 0, "красный": 0, "быстро": 0,
    "медленно": 0, "дома": 0, "здесь": 0, "теперь": 1, "почему": 2,
    "потому": 2, "конечно": 1, "может": 0, "быть": 0, "есть": 0,
    "это": 0, "сложное": 0, "предложение": 2, "пауза": 0,
    # numerals (frontend/numbers.py output)
    "четыре": 1, "восемь": 0, "девять": 0, "десять": 0,
    "одиннадцать": 1, "двенадцать": 1, "тринадцать": 1,
    "четырнадцать": 1, "пятнадцать": 1, "шестнадцать": 1,
    "семнадцать": 1, "восемнадцать": 2, "девятнадцать": 2,
    "двадцать": 0, "тридцать": 0, "сорок": 0, "пятьдесят": 2,
    "шестьдесят": 2, "семьдесят": 0, "восемьдесят": 0, "девяносто": 1,
    "двести": 0, "триста": 0, "четыреста": 1, "пятьсот": 1,
    "шестьсот": 1, "семьсот": 1, "восемьсот": 2, "девятьсот": 2,
    "тысяча": 0, "тысячи": 0, "тысяч": 0, "одна": 1,
    "запятая": 2, "процентов": 1, "долларов": 0, "градусов": 0,
    "меня": 1, "тебя": 1, "себя": 1, "она": 1, "они": 1, "оно": 1,
    "было": 0, "уже": 1, "или": 0, "когда": 1, "даже": 0, "тоже": 0,
    "опять": 1, "эти": 0, "если": 0, "только": 0, "чего": 1,
    "кого": 1, "того": 1, "всего": 1, "никого": 2, "его": 1,
    "него": 1, "много": 0, "очень": 0, "ещё": 1,
    # months (date reading with ordinals: "1-го мая")
    "января": 2, "февраля": 2, "марта": 0, "апреля": 1, "мая": 0,
    "июня": 1, "июля": 1, "августа": 0, "сентября": 2, "октября": 2,
    "ноября": 2, "декабря": 2, "январь": 1, "февраль": 1, "апрель": 1,
    "июнь": 1, "июль": 1, "август": 0, "сентябрь": 1, "октябрь": 1,
    "ноябрь": 1, "декабрь": 1,
    # weekdays
    "понедельник": 2, "вторник": 0, "среда": 1, "четверг": 1,
    "пятница": 0, "суббота": 1, "воскресенье": 2,
    # time / money / quantity
    "часов": 1, "часа": 1, "минута": 1, "минуты": 1, "минут": 1,
    "секунда": 1, "секунды": 1, "секунд": 1, "рублей": 1, "рубля": 1,
    "копеек": 1, "евро": 0, "доллара": 0, "процента": 1, "градуса": 0,
    "доллар": 0, "процент": 1, "градус": 0, "цельсия": 0,
    # metric units (symbols.py expansion: "5 km" -> "пять километров")
    "километр": 2, "километра": 2, "километров": 2,
    "сантиметр": 2, "сантиметра": 2, "сантиметров": 2,
    "миллиметр": 2, "миллиметра": 2, "миллиметров": 2,
    "килограмм": 2, "килограмма": 2, "килограммов": 2,
    "миллиграмм": 2, "миллиграмма": 2, "миллиграммов": 2,
    "миллилитр": 2, "миллилитра": 2, "миллилитров": 2,
    # vowel-RUN indices: "ио"/"иа" merge into one run in the IPA, so the
    # stressed о/а of миллиОн/миллиАрд lives in run 1
    "миллион": 1, "миллиона": 1, "миллионов": 1, "миллиард": 1,
    "миллиарда": 1, "миллиардов": 1, "тысячу": 0, "половина": 2,
    "сестра": 1, "дедушка": 0, "бабушка": 0, "нога": 1, "ухо": 0,
    "волосы": 0, "тело": 0, "теплый": 0, "холодный": 1, "длинный": 0,
    "короткий": 1, "высокий": 1, "низкий": 0, "слабый": 0, "быстрый": 0,
    "медленный": 0, "легкий": 0, "трудный": 0, "счастливый": 1,
    "грустный": 0, "желтый": 0, "синий": 0, "приходить": 2,
    "находить": 2, "открывать": 2, "закрывать": 2, "курица": 0,
    "картошка": 1, "поздно": 0, "водка": 0, "купил": 1, "купила": 1,
    "яблок": 0, "рубль": 0, "рубля": 1, "марта": 0, "января": 2, "известный": 1, "идти": 1,
    "чувство": 0, "сердце": 0, "праздник": 0, "лестница": 0,
    # frequent polysyllables (late round-4 band: verbs of saying/motion,
    # body/kinship nouns, geography)
    "сказал": 1, "сказала": 1, "можно": 0, "нужно": 0, "хороший": 1,
    "голова": 2, "рука": 1, "глаза": 1, "сердце": 0, "любовь": 1,
    "дети": 0, "студент": 1, "право": 0, "война": 1, "армия": 0,
    "народ": 1, "европа": 1, "америка": 1, "больница": 1, "врачи": 1,
    "доктор": 0, "письмо": 1, "газета": 1, "помнить": 0, "понял": 0,
    "поняла": 2, "слушать": 0, "увидел": 1, "играть": 1, "начать": 1,
    "начал": 0, "кончить": 0, "открыть": 1, "закрыть": 1, "купить": 1,
    "продать": 1, "искать": 1, "найти": 1, "приехал": 1, "сделал": 0,
    # frequent polysyllables
    "государство": 2, "область": 0, "система": 1, "программа": 1,
    "развитие": 1, "решение": 1, "возможность": 1, "компания": 1,
    "информация": 2, "результат": 2, "процесс": 1, "момент": 1,
    "сколько": 0, "несколько": 0, "каждый": 0, "любой": 1,
    "другой": 1, "другие": 1, "самый": 0, "самая": 0, "который": 1,
    "которая": 1, "которые": 1, "после": 0, "перед": 0, "через": 0,
    "между": 0, "около": 0, "вместе": 0, "тогда": 1, "также": 0,
    "почти": 1, "более": 0, "менее": 0, "утром": 0, "вечером": 0,
    "ночи": 0, "извините": 2, "хочу": 1, "могу": 1, "знаю": 0,
    "говорю": 2, "понимаю": 2, "работаю": 1, "русская": 0,
    "новости": 0, "страницы": 1, "номер": 0, "телефон": 2,
    "интернет": 2, "компьютер": 1,
}

# unstressed function words (clitics): never auto-stress the monosyllable
_RU_CLITICS = {"в", "во", "к", "ко", "с", "со", "у", "о", "об", "на", "за",
               "по", "до", "из", "от", "под", "над", "при", "про", "без",
               "не", "ни", "и", "а", "но", "же", "ли", "бы", "то", "уж"}


def _reduce_russian(ipa: str, stressed_run: int) -> str:
    """Akanye once stress is known: unstressed о/а -> ɐ, е -> ɪ (one
    reduction grade — the pretonic/other ə distinction is not modeled)."""
    runs = _vowel_runs(ipa)
    out = list(ipa)
    for ri, pos in enumerate(runs):
        if ri == stressed_run:
            continue
        if out[pos] in "oa":
            out[pos] = "ɐ"
        elif out[pos] == "e":
            out[pos] = "ɪ"
    return "".join(out)




# Top-500 frequency word forms (VERDICT r04 #7: lexicon-only stress
# left everyday OOV words flat AND unreduced, since akanye is
# stress-dependent).  Indices are vowel-RUN positions in the IPA
# (adjacent-vowel sequences like ио/уа/ои merge into one run).
_RU_STRESS.update({
    "автобус": 1, "апельсин": 2, "аптека": 1, "арбуз": 1, "аэропорт": 3,
    "балкон": 1, "банан": 1, "башня": 0, "берег": 0, "библиотека": 2,
    "билет": 1, "ботинки": 1, "бросить": 0, "брюки": 0, "будет": 0,
    "будто": 0, "будут": 0, "бумага": 1, "бутылка": 1, "бывать": 1,
    "была": 1, "были": 0, "ванная": 0, "варенье": 1, "ведро": 1,
    "вернуться": 1, "ветер": 0, "ветка": 0, "видел": 0, "видит": 0,
    "видно": 0, "вилка": 0, "вино": 1, "виноград": 2, "вишня": 0,
    "вместо": 0, "внимание": 2, "воздух": 0, "вокзал": 1, "вообще": 2,
    "ворота": 1, "вполне": 1, "вроде": 1, "вышел": 0, "гараж": 1,
    "главный": 0, "говорил": 2, "голос": 0, "гора": 1, "гостиная": 1,
    "гостиница": 1, "граница": 1, "гроза": 1, "группа": 0, "груша": 0,
    "давать": 1, "давно": 1, "далеко": 2, "деревня": 1, "дерево": 0,
    "держать": 1, "держит": 0, "диван": 1, "должен": 0, "думает": 0,
    "думал": 0, "душа": 1, "дыня": 0, "еще": 1, "жара": 1, "жена": 1,
    "живет": 1, "журнал": 1, "забор": 1, "завод": 1, "закон": 1, "зато": 1,
    "зашел": 1, "звезда": 1, "зеленый": 1, "зеркало": 0, "знает": 0,
    "зонтик": 0, "игра": 1, "идет": 1, "именно": 0, "иметь": 1, "иногда": 2,
    "институт": 2, "калитка": 1, "капуста": 1, "картина": 1, "картофель": 1,
    "каша": 0, "кино": 1, "клубника": 1, "ковер": 1, "команда": 1,
    "конец": 1, "корень": 0, "коридор": 2, "корова": 1, "кофе": 0,
    "кровать": 1, "крыша": 0, "куда": 1, "куртка": 0, "кухня": 0, "лампа": 0,
    "легко": 1, "лежать": 1, "лежит": 1, "лестница": 0, "лимон": 1,
    "листья": 0, "лицо": 1, "ложка": 0, "лошадь": 0, "луна": 1, "лучше": 0,
    "малина": 1, "масло": 0, "мера": 0, "метро": 1, "минуту": 1, "молния": 0,
    "море": 0, "морковь": 1, "мороз": 1, "музей": 1, "наверное": 1,
    "надо": 0, "назад": 1, "назвать": 1, "написать": 2, "например": 2,
    "научный": 0, "начало": 1, "нашел": 1, "никто": 1, "ничего": 2,
    "образ": 0, "обувь": 0, "общий": 0, "огонь": 1, "огород": 2, "огурец": 2,
    "одеяло": 2, "один": 1, "однако": 1, "озеро": 0, "оказаться": 2,
    "океан": 2, "орех": 1, "остановиться": 3, "остаться": 1, "остров": 0,
    "ответил": 1, "ответить": 1, "отвечать": 2, "отдал": 0, "отец": 1,
    "отношение": 2, "отпуск": 0, "очки": 1, "палец": 0, "пальто": 1,
    "память": 0, "парень": 0, "перчатки": 1, "песня": 0, "пиво": 0,
    "писатель": 1, "пишет": 0, "планета": 1, "платье": 0, "плечо": 1,
    "подарок": 1, "подвал": 1, "подойти": 2, "подумать": 1, "подушка": 1,
    "поезд": 0, "пойти": 1, "поле": 0, "полка": 0, "получить": 2,
    "поляна": 1, "помидор": 2, "помочь": 1, "понять": 1, "попасть": 1,
    "пора": 1, "последний": 1, "потолок": 2, "появиться": 2, "праздник": 0,
    "пришел": 1, "провести": 2, "произнести": 2, "пройти": 1, "просто": 0,
    "простой": 1, "против": 0, "птица": 0, "пустыня": 1, "путешествие": 2,
    "пшеница": 1, "равно": 1, "радио": 0, "радуга": 0, "разговор": 2,
    "район": 1, "река": 1, "ресторан": 2, "рубашка": 1, "рынок": 0,
    "самолет": 2, "сапоги": 2, "сарай": 1, "сахар": 0, "свекла": 0,
    "сделать": 0, "семена": 2, "сидеть": 1, "сидит": 1, "сила": 0,
    "сильный": 0, "слива": 0, "слишком": 0, "словно": 0, "случай": 0,
    "слышит": 0, "смотрел": 1, "смотрит": 0, "снова": 0, "совсем": 1,
    "согласиться": 2, "сосед": 1, "спальня": 0, "спина": 1, "спокойно": 1,
    "спросил": 1, "спросить": 1, "сразу": 0, "средство": 0, "стакан": 1,
    "стало": 0, "стараться": 1, "статья": 1, "стена": 1, "столица": 1,
    "стоять": 1, "сумка": 0, "считать": 1, "такой": 1, "тарелка": 1,
    "телевизор": 2, "течение": 1, "трава": 1, "трамвай": 1, "тропинка": 1,
    "туалет": 1, "туман": 1, "увидеть": 1, "удаться": 1, "узнать": 1,
    "уйти": 1, "улыбнуться": 2, "университет": 4, "уровень": 0, "урожай": 2,
    "условие": 1, "ушел": 1, "фабрика": 0, "хотел": 1, "хотя": 1, "хочет": 0,
    "цветок": 1, "церковь": 0, "чашка": 0, "чеснок": 1, "число": 1,
    "читает": 1, "чтобы": 0, "шапка": 0, "этот": 0, "юбка": 0, "ягода": 0,
})


def _ru_suffix_stress(word: str, n_runs: int):
    """Morphological fallback for OOV words (VERDICT r04 #7): a few
    suffix classes with near-deterministic stress.  Returns a vowel-run
    index or None (unknown suffixes stay unmarked/unreduced)."""
    if n_runs < 2:
        return None
    if word.endswith(("ой", "ою")):          # большой, герой: always final
        return n_runs - 1
    if word.endswith(("ение", "ание", "ения", "ания", "ению", "анию",
                      "ением", "анием", "ениях", "аниях")):
        return max(n_runs - 3, 0)            # течЕние, вним Ание class
    if word.endswith(("ость", "ости")):      # нОвость, возмОжность
        return max(n_runs - 2, 0)
    if word.endswith("ировать"):             # фотографИровать
        return max(n_runs - 3, 0)
    if word.endswith(("ация", "яция", "ации", "ация", "ацию", "яции")):
        return max(n_runs - 3, 0)            # информАция, организАция
    if word.endswith(("ический", "ическая", "ические", "ическое")):
        return max(n_runs - 3, 0)            # экономИческий
    return None


def stress_russian(word: str, ipa: str) -> str:
    if PRIMARY_STRESS in ipa:  # ё already carries its stress
        return ipa
    runs = _vowel_runs(ipa)
    if not runs or word in _RU_CLITICS:
        return ipa
    if len(runs) == 1:
        return _insert_stress(ipa, 0)
    idx = _RU_STRESS.get(word)
    if idx is None:
        idx = _ru_suffix_stress(word, len(runs))
    if idx is None:
        return ipa  # unknown stress: unmarked, unreduced (documented)
    idx = min(idx, len(runs) - 1)
    return _insert_stress(_reduce_russian(ipa, idx), idx)


# Ukrainian shares the machinery; reduction is much weaker in Ukrainian
# (no akanye), so only stress is assigned.
_UK_STRESS = {
    "дякую": 0, "будь": 0, "ласка": 0, "добре": 0, "гарно": 0,
    "сьогодні": 1, "завтра": 0, "вчора": 0, "зараз": 0, "потім": 0,
    "завжди": 1, "ніколи": 1, "вода": 1, "робота": 1, "людина": 1,
    "люди": 0, "слово": 0, "місто": 0, "країна": 1, "україна": 2,
    "київ": 0, "мова": 0, "книжка": 0, "школа": 0, "вчитель": 0,
    "дитина": 1, "мама": 0, "тато": 0, "родина": 1, "жінка": 0,
    "чоловік": 2, "дівчина": 0, "хлопець": 0, "собака": 1, "кішка": 0,
    "машина": 1, "дорога": 1, "вулиця": 0, "вікно": 1, "двері": 0,
    "стіл": 0, "кімната": 1, "гроші": 0, "хліб": 0, "молоко": 2,
    "риба": 0, "яблуко": 0, "ранок": 0, "вечір": 0, "тиждень": 0,
    "місяць": 0, "зима": 1, "весна": 1, "літо": 0, "осінь": 0,
    "погода": 1, "сонце": 0, "небо": 0, "земля": 1, "музика": 0,
    "питання": 1, "відповідь": 1, "допомога": 2, "правда": 0,
    "розуміти": 2, "говорити": 2, "сказати": 1, "думати": 0,
    "знати": 0, "бачити": 0, "чути": 0, "робити": 1, "працювати": 2,
    "жити": 0, "любити": 1, "хотіти": 1, "йти": 0, "їхати": 0,
    "читати": 1, "писати": 1, "дивитися": 1, "гарний": 0,
    "великий": 1, "маленький": 1, "новий": 1, "старий": 1,
    "молодий": 2, "білий": 0, "чорний": 0, "червоний": 1, "швидко": 0,
    "повільно": 1, "вдома": 0, "тут": 0, "тепер": 1, "чому": 1,
    "звичайно": 1, "може": 0, "бути": 0, "маю": 0, "книжок": 1,
    "речення": 0, "складне": 1, "навіть": 0, "пауза": 0, "їжа": 0,
    # numerals (apostrophe-stripped: the stress assigner receives the
    # word with apostrophes removed)
    "чотири": 1, "вісім": 0, "девять": 0, "десять": 0,
    "одинадцять": 1, "дванадцять": 1, "тринадцять": 1,
    "чотирнадцять": 2, "пятнадцять": 1, "шістнадцять": 1,
    "сімнадцять": 1, "вісімнадцять": 2, "девятнадцять": 2,
    "двадцять": 0, "тридцять": 0, "сорок": 0, "пятдесят": 2,
    "шістдесят": 2, "сімдесят": 0, "вісімдесят": 2, "девяносто": 1,
    "двісті": 0, "триста": 0, "чотириста": 1, "пятсот": 1,
    "шістсот": 1, "сімсот": 1, "вісімсот": 2, "девятсот": 2,
    "тисяча": 0, "тисячі": 0, "тисяч": 0, "одна": 1, "дві": 0,
    "мільйон": 1, "мільйони": 1, "мільйонів": 1,
    "мільярди": 1, "мільярдів": 1,
    "вогонь": 1, "місяць": 0, "поїзд": 0, "літак": 1, "хороший": 1,
    "року": 0, "купив": 1, "купила": 1, "яблук": 0, "гривень": 0,
    "тіло": 0, "приходити": 1, "давати": 1, "знаходити": 1,
    "відкривати": 2, "закривати": 2, "дівчина": 0, "хлопець": 0,
    "кома": 0, "відсотків": 1, "доларів": 0, "градусів": 0,
    # frequent polysyllables (late round-4 band)
    "життя": 1, "можна": 0, "потрібно": 1, "справа": 0, "місце": 0,
    "книга": 0, "голова": 2, "рука": 1, "очі": 0, "серце": 0,
    "любов": 1, "діти": 0, "історія": 1, "вночі": 1,
    "долар": 0, "долари": 0, "відсоток": 1, "відсотки": 1,
    "градус": 0, "градуси": 0, "цельсія": 0,
    # metric units (symbols.py expansion)
    "кілометр": 2, "кілометри": 2, "кілометрів": 2,
    "сантиметр": 2, "сантиметри": 2, "сантиметрів": 2,
    "міліметр": 2, "міліметри": 2, "міліметрів": 2,
    "кілограм": 2, "кілограми": 2, "кілограмів": 2,
    "міліграм": 2, "міліграми": 2, "міліграмів": 2,
    "мілілітр": 2, "мілілітри": 2, "мілілітрів": 2,
    "мене": 1, "тебе": 1, "себе": 1, "вона": 1, "вони": 1, "воно": 1,
    "тільки": 0, "коли": 1, "якщо": 1, "його": 1, "її": 1,
    # months (genitive: "1-го травня"; keys apostrophe-stripped)
    "січня": 0, "лютого": 0, "березня": 0, "квітня": 0, "травня": 0,
    "червня": 0, "липня": 0, "серпня": 0, "вересня": 0, "жовтня": 0,
    "листопада": 2, "грудня": 0, "січень": 0, "лютий": 0, "березень": 0,
    "квітень": 0, "травень": 0, "червень": 0, "липень": 0,
    "серпень": 0, "вересень": 0, "жовтень": 0, "листопад": 2,
    "грудень": 0,
    # weekdays
    "понеділок": 2, "вівторок": 1, "середа": 2, "четвер": 1,
    "пятниця": 0, "субота": 1,
    # time / money / quantity
    "година": 1, "години": 1, "годин": 1, "хвилина": 1, "хвилини": 1,
    "хвилин": 1, "секунда": 1, "секунди": 1, "гривень": 0, "гривні": 0,
    "відсотка": 1, "мільйон": 1, "мільйона": 1, "мільйонів": 1,
    "мільярд": 1, "тисячу": 0, "половина": 2,
    # frequent polysyllables
    "будинок": 1, "вулиці": 0, "місяця": 0, "тижня": 0, "новини": 1,
    "сторінки": 2, "номер": 0, "телефон": 2, "інтернет": 2,
    "словами": 1, "скільки": 0, "декілька": 1, "кожен": 0,
    "інший": 0, "разом": 0, "після": 0, "через": 0, "майже": 0,
    "більше": 0, "менше": 0, "вранці": 0, "ввечері": 1,
    "вибачте": 0, "хочу": 1, "можу": 0, "знаю": 0, "розумію": 2,
}

# ordinal adjectives (frontend/numbers.py::number_to_ordinal output) —
# every gender/genitive variant keeps the masculine's stressed-run index
# (the ending swap never moves an earlier vowel)
_RU_ORDINAL_STRESS = {
    "первый": 0, "второй": 1, "третий": 0, "пятый": 0, "шестой": 1,
    "седьмой": 1, "восьмой": 1, "девятый": 1, "десятый": 1,
    "одиннадцатый": 1, "двенадцатый": 1, "тринадцатый": 1,
    "четырнадцатый": 1, "пятнадцатый": 1, "шестнадцатый": 1,
    "семнадцатый": 1, "восемнадцатый": 2, "девятнадцатый": 2,
    "двадцатый": 1, "тридцатый": 1, "сороковой": 3, "пятидесятый": 3,
    "шестидесятый": 3, "семидесятый": 3, "восьмидесятый": 3,
    "девяностый": 2, "сотый": 0,
}
_UK_ORDINAL_STRESS = {
    "перший": 0, "другий": 0, "третій": 0, "четвертий": 1, "пятий": 0,
    "шостий": 0, "сьомий": 0, "восьмий": 0, "девятий": 1, "десятий": 1,
    "одинадцятий": 2, "дванадцятий": 1, "тринадцятий": 1,
    "чотирнадцятий": 2, "пятнадцятий": 1, "шістнадцятий": 1,
    "сімнадцятий": 1, "вісімнадцятий": 2, "девятнадцятий": 2,
    "двадцятий": 1, "тридцятий": 1, "сороковий": 3, "пятдесятий": 2,
    "шістдесятий": 2, "сімдесятий": 2, "вісімдесятий": 3,
    "девяностий": 2, "сотий": 0,
}


def _register_ordinal_stress():
    from toucan_tpu_torch.frontend.numbers import _ru_gender, _ru_uk_gender

    for word, idx in _RU_ORDINAL_STRESS.items():
        _RU_STRESS.setdefault(word, idx)
        for g in ("f", "n", "g"):
            form = _ru_gender(word, g)
            _RU_STRESS.setdefault(form, idx)
            if g == "g":  # the /v/ respelling used by _expand_ordinals
                _RU_STRESS.setdefault(form[:-2] + "во", idx)
    for word, idx in _UK_ORDINAL_STRESS.items():
        # uk stress keys are apostrophe-stripped (see the numerals note)
        _UK_STRESS.setdefault(word.replace("'", ""), idx)
        for g in ("f", "n", "g"):
            form = _ru_uk_gender(word, g).replace("'", "")
            _UK_STRESS.setdefault(form, idx)


_register_ordinal_stress()

_UK_CLITICS = {"в", "у", "і", "й", "з", "із", "зі", "на", "за", "по", "до",
               "від", "під", "над", "при", "про", "без", "не", "ні", "а",
               "та", "же", "ж", "чи", "би", "б", "то"}




# Top-500 frequency word forms (VERDICT r04 #7).  Indices are
# vowel-RUN positions in the IPA (іо/ау sequences merge into one run).
_UK_STRESS.update({
    "актор": 1, "але": 1, "апельсин": 2, "аптека": 1, "армія": 0, "баба": 0,
    "бабуся": 1, "багатий": 1, "багато": 1, "банан": 1, "батько": 0,
    "бачу": 0, "берег": 0, "блискавка": 0, "борода": 2, "боятися": 1,
    "брати": 0, "брехня": 1, "брова": 1, "брудний": 1, "буде": 0, "була": 1,
    "були": 1, "було": 1, "буряк": 1, "бігти": 0, "бідний": 0, "важкий": 1,
    "важливий": 1, "веселий": 1, "веселка": 1, "взуття": 1, "взяти": 0,
    "вино": 1, "виноград": 2, "високий": 1, "вишня": 0, "волосся": 1,
    "втратити": 0, "вузький": 0, "вуса": 0, "вухо": 0, "вчити": 0,
    "вчитися": 0, "вівця": 1, "відкрити": 2, "відповісти": 3, "війна": 1,
    "вірити": 0, "вітер": 0, "газета": 1, "гарячий": 1, "годинник": 1,
    "головний": 2, "голосний": 1, "гора": 1, "город": 1, "горіх": 1,
    "грати": 0, "гривня": 0, "гроза": 1, "груша": 0, "губа": 1, "гуска": 0,
    "гілка": 0, "гіркий": 1, "гірше": 0, "дати": 0, "дерево": 0,
    "держава": 1, "диня": 0, "директор": 1, "дніпро": 1, "добрий": 0,
    "добро": 1, "добродій": 1, "довгий": 0, "донька": 0, "допомагати": 3,
    "допомогти": 3, "дочка": 1, "дуже": 0, "думаю": 0, "думка": 0,
    "дурний": 1, "дядько": 0, "дідусь": 1, "живу": 1, "живіт": 1,
    "жовтий": 0, "журнал": 1, "забрати": 1, "забути": 1, "завдання": 1,
    "закон": 1, "закрити": 1, "закінчити": 1, "залишити": 2, "запитати": 2,
    "звідки": 0, "зелений": 1, "знайти": 1, "знає": 0, "зоря": 1, "зошит": 0,
    "зробити": 1, "зрозуміти": 2, "зустріти": 1, "зірка": 0, "кава": 0,
    "кавун": 1, "казати": 1, "камінь": 0, "капуста": 1, "картопля": 1,
    "качка": 0, "каша": 0, "квартира": 1, "квітка": 0, "кислий": 0,
    "коза": 1, "колега": 1, "коліно": 1, "команда": 1, "компютер": 1,
    "коричневий": 1, "корова": 1, "короткий": 1, "корінь": 0, "коштувати": 0,
    "красивий": 1, "краще": 0, "країни": 1, "куди": 1, "культура": 1,
    "купити": 1, "курка": 0, "куртка": 0, "кухня": 0, "кіно": 1, "легкий": 1,
    "лежати": 1, "летіти": 1, "лимон": 1, "листя": 0, "люблю": 1, "ліжко": 0,
    "лікар": 0, "лікарня": 1, "лікоть": 0, "мясо": 0, "магазин": 2,
    "мала": 0, "мали": 0, "малий": 1, "малина": 1, "мало": 0, "масло": 0,
    "мати": 0, "має": 0, "мистецтво": 1, "могти": 1, "море": 0, "морква": 0,
    "мороз": 1, "музей": 1, "музикант": 2, "намисто": 1, "народ": 1,
    "наука": 0, "начальник": 1, "неділя": 1, "низький": 0, "нога": 1,
    "нудний": 1, "обличчя": 1, "овочі": 0, "огірок": 2, "одеса": 1,
    "один": 1, "одяг": 0, "озеро": 0, "океан": 1, "око": 0, "окуляри": 2,
    "олівець": 2, "олія": 1, "останній": 1, "острів": 0, "палець": 0,
    "пальто": 1, "памятати": 2, "пані": 0, "папір": 1, "перемога": 2,
    "перерва": 1, "перстень": 0, "пиво": 0, "письменник": 1, "питати": 1,
    "пити": 0, "плавати": 0, "плакати": 0, "платити": 1, "плече": 1,
    "повернутися": 2, "повільний": 1, "поганий": 1, "погано": 1,
    "подарунок": 2, "подруга": 1, "поле": 0, "полуниця": 2, "помилка": 1,
    "помідор": 2, "поразка": 1, "почати": 1, "починати": 2, "право": 0,
    "прийти": 1, "приклад": 0, "принести": 2, "приїхати": 2, "проблема": 1,
    "продати": 1, "пісня": 0, "пісок": 1, "піти": 1, "радіо": 0, "радіти": 1,
    "ринок": 0, "роблю": 1, "робітник": 2, "рожевий": 1, "розумний": 1,
    "рукавиці": 2, "ручка": 0, "річка": 0, "салат": 1, "свиня": 1,
    "свято": 0, "світлий": 0, "село": 1, "сестра": 1, "сидіти": 1,
    "сильний": 0, "синій": 0, "слабкий": 1, "слива": 0, "слухати": 0,
    "смачний": 1, "сміятися": 1, "солодкий": 1, "солоний": 1, "сорочка": 1,
    "спати": 0, "спека": 0, "спина": 0, "сподіватися": 2, "співак": 1,
    "співати": 1, "спідниця": 1, "стояти": 1, "студент": 1, "стілець": 1,
    "сукня": 0, "сумка": 0, "сумний": 1, "сумувати": 2, "сусід": 1,
    "сімя": 1, "сірий": 0, "такий": 1, "також": 1, "танцювати": 2,
    "театр": 0, "телевізор": 2, "темний": 0, "теплий": 0, "тихий": 0,
    "товстий": 1, "тоді": 1, "тому": 1, "тонкий": 1, "трава": 1, "треба": 0,
    "туман": 1, "тітка": 0, "український": 2, "університет": 4, "урок": 1,
    "уряд": 0, "учень": 0, "фрукти": 0, "футбол": 1, "фіолетовий": 1,
    "харків": 0, "хмара": 0, "хмари": 0, "холодний": 1, "художник": 1,
    "церква": 0, "цибуля": 1, "цукор": 0, "цікавий": 1, "часник": 1,
    "чекати": 1, "черевики": 2, "чистий": 0, "чоботи": 0, "чоло": 1,
    "шапка": 0, "шафа": 0, "швидкий": 1, "широкий": 1, "шия": 0,
    "шкарпетки": 1, "штани": 1, "шукати": 1, "щасливий": 1, "щока": 1,
    "ягода": 0, "язик": 1, "яйце": 1, "який": 1, "інститут": 2, "іти": 1,
    "їсти": 0,
})


def _uk_suffix_stress(word: str, n_runs: int):
    """Ukrainian OOV suffix classes with near-deterministic stress."""
    if n_runs < 2:
        return None
    if word.endswith(("вати", "вання")):     # працювАти, будувАння class
        return max(n_runs - 2, 0)
    if word.endswith(("ація", "яція", "ації", "ацію")):
        return max(n_runs - 3, 0)            # організАція
    if word.endswith(("ичний", "ічний", "ична", "ічна")):
        return max(n_runs - 2, 0)            # економІчний (і + ий = 2 runs)
    return None


def stress_ukrainian(word: str, ipa: str) -> str:
    if PRIMARY_STRESS in ipa:
        return ipa
    runs = _vowel_runs(ipa)
    if not runs or word in _UK_CLITICS:
        return ipa
    if len(runs) == 1:
        return _insert_stress(ipa, 0)
    idx = _UK_STRESS.get(word)
    if idx is None:
        idx = _uk_suffix_stress(word, len(runs))
    if idx is None:
        return ipa
    return _insert_stress(ipa, min(idx, len(runs) - 1))

_RU_SOFT = "еёюяьи"

# words whose pronunciation breaks letter-to-sound: что = ʃto, the
# genitive -ого/-его endings = v (его, сегодня), чн = ʃn in конечно
_RU_LEXICON = {
    "что": "ʃto", "чтобы": "ʃtobɨ", "что-то": "ʃtoto",
    "его": "jevo", "него": "nevo", "чего": "tɕevo", "кого": "kovo",
    "того": "tovo", "всего": "vsevo", "ничего": "nitɕevo",
    "никого": "nikovo", "сегодня": "sevodna",
    "конечно": "koneʃno", "скучно": "skuʃno",
    # silent-consonant clusters (лнц/рдц/здн/стн/вств) + сч = щ
    "солнце": "sontse", "сердце": "sertse", "праздник": "praznik",
    "лестница": "lesnitsa", "счастливый": "ɕːaslivɨj",
    "здравствуйте": "zdrastvujte", "чувство": "tɕustvo",
    "поздно": "pozno", "грустный": "ɡrusnɨj", "известный": "izvesnɨj",
    "идти": "itti",
}

_RU_RULES = [
    # iotated vowels: j+V word-initially / after vowels and signs, else
    # they mark palatalization of the preceding consonant (approximated by
    # plain consonant + vowel; ʲ is stripped by the reference replacements)
    Rule("е", "je", pre="^|[аеёиоуыэюяъь]"), Rule("е", "e"),
    Rule("ё", "jˈo", pre="^|[аеёиоуыэюяъь]"), Rule("ё", "ˈo"),
    Rule("ю", "ju", pre="^|[аеёиоуыэюяъь]"), Rule("ю", "u"),
    Rule("я", "ja", pre="^|[аеёиоуыэюяъь]"), Rule("я", "a"),
    Rule("а", "a"), Rule("и", "i"), Rule("о", "o"), Rule("у", "u"),
    Rule("ы", "ɨ"), Rule("э", "e"),
    # obstruent voicing assimilation (fully regular): final devoicing
    # (хлеб -> xlep, друг -> druk), devoicing before voiceless (водка ->
    # votka, ложка -> loʃka), voicing before voiced obstruents except в
    # (сделать -> zdelat, вокзал -> voɡzal)
    Rule("б", "p", post="[кпстфхцчшщ]|$"), Rule("в", "f", post="[кпстфхцчшщ]|$"),
    Rule("г", "k", post="[кпстфхцчшщ]|$"), Rule("д", "t", post="[кпстфхцчшщ]|$"),
    Rule("ж", "ʃ", post="[кпстфхцчшщ]|$"), Rule("з", "s", post="[кпстфхцчшщ]|$"),
    Rule("зд", "st", post="$"),  # поезд: the whole cluster devoices
    Rule("с", "z", post="[бгдзж]"), Rule("к", "ɡ", post="[бгдзж]"),
    Rule("т", "d", post="[бгдзж]"), Rule("п", "b", post="[бгдзж]"),
    Rule("б", "b"), Rule("в", "v"), Rule("г", "ɡ"), Rule("д", "d"), Rule("ж", "ʒ"), Rule("з", "z"),
    Rule("й", "j"), Rule("к", "k"), Rule("л", "l"), Rule("м", "m"),
    Rule("н", "n"), Rule("п", "p"), Rule("р", "r"), Rule("с", "s"),
    Rule("т", "t"), Rule("ф", "f"), Rule("х", "x"), Rule("ц", "ts"),
    Rule("ч", "tɕ"), Rule("ш", "ʃ"), Rule("щ", "ɕː"),
    Rule("ъ", ""), Rule("ь", ""),
]

_RU_DIGITS = ["ноль", "один", "два", "три", "четыре", "пять", "шесть",
              "семь", "восемь", "девять"]

# ---------------------------------------------------------------------------
# Ukrainian (near-phonemic Cyrillic; the ru scanner machinery transfers —
# VERDICT r03 #3).  Distinctives vs ru: г = /ɦ/ (ґ = /ɡ/), и = /ɪ/,
# е = /ɛ/ (never iotated), є/ї/ю/я iotate word-initially / after vowels,
# apostrophe blocks palatalization (handled by the clitic split in
# ``phonemize_rules``: each apostrophe part phonemizes with its own word
# boundary, so п'ять -> п + ять -> pjatʃ-free /pjat/).  в is /ʋ/ (its [w]
# coda allophone is approximated).  Lexical stress needs a lexicon and is
# left unmarked like ru (documented approximation).
# ---------------------------------------------------------------------------

# lexical г-devoicing exceptions (the only ones in standard Ukrainian)
_UK_LEXICON = {
    "легкий": "lɛxkˈɪj", "легко": "lˈɛxkɔ", "вогко": "ʋˈɔxkɔ",
    "нігті": "nˈixti", "кігті": "kˈixti",
}

_UK_RULES = [
    Rule("дж", "dʒ"), Rule("дз", "dz"),
    # iotated vowels: j+V word-initially / after vowels; after consonants
    # they mark palatalization (approximated as plain consonant + vowel)
    Rule("є", "jɛ", pre="^|[аеєиіїоуюя]"), Rule("є", "ɛ"),
    Rule("ю", "ju", pre="^|[аеєиіїоуюя]"), Rule("ю", "u"),
    Rule("я", "ja", pre="^|[аеєиіїоуюя]"), Rule("я", "a"),
    Rule("ї", "ji"),
    Rule("а", "a"), Rule("е", "ɛ"), Rule("и", "ɪ"), Rule("і", "i"),
    Rule("о", "ɔ"), Rule("у", "u"),
    Rule("б", "b"), Rule("в", "ʋ"), Rule("г", "ɦ"), Rule("ґ", "ɡ"),
    Rule("д", "d"), Rule("ж", "ʒ"), Rule("з", "z"), Rule("й", "j"),
    Rule("к", "k"), Rule("л", "l"), Rule("м", "m"), Rule("н", "n"),
    Rule("п", "p"), Rule("р", "r"), Rule("с", "s"), Rule("т", "t"),
    Rule("ф", "f"), Rule("х", "x"), Rule("ц", "ts"), Rule("ч", "tʃ"),
    Rule("ш", "ʃ"), Rule("щ", "ʃtʃ"), Rule("ь", ""),
]

_UK_DIGITS = ["нуль", "один", "два", "три", "чотири", "п'ять", "шість",
              "сім", "вісім", "дев'ять"]

# ---------------------------------------------------------------------------
# Portuguese (eu/br approximation; nasals modeled, reduction not)
# ---------------------------------------------------------------------------

_PT_RULES = [
    Rule("lh", "ʎ"), Rule("nh", "ɲ"), Rule("ch", "ʃ"), Rule("rr", "ʁ"),
    Rule("ss", "s"), Rule("qu", "k", post="[eéêií]"), Rule("qu", "kw"),
    Rule("gu", "ɡ", post="[eéêií]"),
    Rule("gu", "ɡw", post="[aoáóâô]"),  # água, guardar
    # nasal vowels use the inventory's combining-tilde modifier (a nasal
    # flag on the preceding vowel), never precomposed codepoints
    Rule("ão", "ɐ̃w"), Rule("õe", "õj"), Rule("ãe", "ɐ̃j"),
    Rule("a", "ɐ", post="nh"),  # palatal raising: banho, montanha
    Rule("ín", "ˈĩ", post="[^aeiouáéíóúh]"),  # língua
    Rule("am", "ɐ̃w", post="$"), Rule("em", "ẽj", post="$"),
    Rule("an", "ɐ̃", post="[^aeiouáéíóúh]"), Rule("am", "ɐ̃", post="[pb]"),
    Rule("en", "ẽ", post="[^aeiouáéíóúh]"), Rule("em", "ẽ", post="[pb]"),
    # word-final im/om/um nasalize (sim, bom, um); the [pb] context is a
    # separate rule because $ inside a character class is a literal dollar
    Rule("in", "ĩ", post="[^aeiouáéíóúh]"),
    Rule("im", "ĩ", post="$"), Rule("im", "ĩ", post="[pb]"),
    Rule("on", "õ", post="[^aeiouáéíóúh]"),
    Rule("om", "õ", post="$"), Rule("om", "õ", post="[pb]"),
    Rule("un", "ũ", post="[^aeiouáéíóúh]"),
    Rule("um", "ũ", post="$"), Rule("um", "ũ", post="[pb]"),
    Rule("c", "s", post="[eéêií]"), Rule("ç", "s"), Rule("c", "k"),
    Rule("g", "ʒ", post="[eéêií]"), Rule("g", "ɡ"), Rule("j", "ʒ"),
    Rule("x", "ʃ"),
    Rule("z", "s", post="$"),  # BR final z devoices (nariz, feliz)
    Rule("z", "z"), Rule("h", ""),
    # BR dental palatalization: t/d before i (incl. final -e read as i):
    # dia, cidade, noite (EP filters these out below)
    Rule("t", "tʃ", post="i|e$"), Rule("d", "dʒ", post="i|e$"),
    Rule("s", "z", pre="[aeiouáéíóúâêô]", post="[aeiouáéíóúâêô]"),
    Rule("s", "z", post="[bdgmnlrvzj]"),  # mesmo -> mezmu (EP ʒ overrides)
    Rule("s", "s"),  # BR plain final s (EP: EU rule -> ʃ)
    Rule("oi", "oj"), Rule("ai", "aj"), Rule("ei", "ej"), Rule("au", "aw"),
    Rule("éu", "ˈɛw"), Rule("eu", "ew"),  # céu, meu
    Rule("ou", "o"),  # monophthongized in both variants (outro, falou)
    Rule("r", "ʁ", pre="^"), Rule("r", "ʁ", post="$"), Rule("r", "ɾ"),
    Rule("o", "u", post="$"), Rule("e", "i", post="$"),
    Rule("e", "i", pre="^", post="s[^aeiouáéíóú]"),  # escola -> iskɔla
    Rule("a", "ɐ", post="$"),
    Rule("a", "a"), Rule("e", "e"), Rule("i", "i"), Rule("o", "o"),
    Rule("u", "u"),
    Rule("á", "ˈa"), Rule("â", "ˈɐ"), Rule("é", "ˈɛ"), Rule("ê", "ˈe"),
    Rule("í", "ˈi"), Rule("ó", "ˈɔ"), Rule("ô", "ˈo"), Rule("ú", "ˈu"),
    Rule("ã", "ɐ̃"), Rule("õ", "õ"),
    Rule("b", "b"), Rule("d", "d"), Rule("f", "f"), Rule("k", "k"),
    Rule("l", "l"), Rule("m", "m"), Rule("n", "n"), Rule("p", "p"),
    Rule("t", "t"), Rule("v", "v"), Rule("w", "w"), Rule("y", "i"),
]

_PT_DIGITS = ["zero", "um", "dois", "três", "quatro", "cinco", "seis",
              "sete", "oito", "nove"]

# open-mid ɛ/ɔ are lexical in Portuguese too (rules default closed)
_PT_LEXICON = {
    "escola": "iskˈɔlɐ", "escolas": "iskˈɔlɐʃ", "bola": "bˈɔlɐ",
    "festa": "fˈɛʃtɐ", "pedra": "pˈɛdɾɐ", "terra": "tˈɛʁɐ",
    "guerra": "ɡˈɛʁɐ", "porta": "pˈɔɾtɐ", "morte": "mˈɔɾtʃi",
    "forte": "fˈɔɾtʃi", "nove": "nˈɔvi", "sete": "sˈɛtʃi",
    "dez": "dˈɛs", "ela": "ˈɛlɐ", "ele": "ˈeli", "avó": "avˈɔ",
    "avô": "avˈo", "pé": "pˈɛ", "só": "sˈɔ",
    # the nh digraph + -entos stress (the ruleset mis-parses these) and
    # the unstressed conjunction (numbers.py joins scale groups with "e")
    "quinhentos": "kiɲˈẽtuʃ", "quinhentas": "kiɲˈẽtɐʃ", "e": "i",
    # -er nouns with open ɛ (the -er verb default is closed e)
    "mulher": "muʎˈɛʁ", "mulheres": "muʎˈɛɾiʃ", "colher": "kuʎˈɛʁ",
    "qualquer": "kwalkˈɛʁ", "homem": "ˈomẽj", "homens": "ˈomẽjʃ",
    "sol": "sˈɔl", "perna": "pˈɛɾnɐ", "pernas": "pˈɛɾnɐʃ",
    "velho": "vˈɛʎu", "velha": "vˈɛʎɐ", "velhos": "vˈɛʎuʃ",
    "janela": "ʒanˈɛlɐ", "janelas": "ʒanˈɛlɐʃ",
    "amarelo": "amaɾˈɛlu", "amarela": "amaɾˈɛlɐ",
    "amarelos": "amaɾˈɛluʃ", "amarelas": "amaɾˈɛlɐʃ",
    "velhas": "vˈɛʎɐʃ", "jovem": "ʒˈɔvẽj", "jovens": "ʒˈɔvẽjʃ",
}

# --- European Portuguese ("pt"; "pt-br" keeps the Brazilian-flavored base
# ruleset above).  EP differs systematically: unstressed/final e -> ɨ,
# s before a consonant -> ʃ (voiceless) / ʒ (voiced), and across-the-board
# unstressed vowel reduction (a -> ɐ, o -> u) applied AFTER stress
# assignment (``stress_portuguese_eu``).  Reference behavior: espeak's
# distinct pt vs pt-br voices behind TextFrontend.py:490-525.
_PT_EU_ONLY = [
    Rule("em", "ɐ̃j", post="$"),  # bem, homem: EP (BR: ẽj)
    Rule("z", "ʃ", post="$"),  # nariz, feliz: EP final devoicing
    Rule("s", "ʃ", post="$"),  # EP final s -> ʃ (dois, olhos)
    Rule("e", "ɨ", post="$"),                      # morte -> mˈɔɾtɨ
    Rule("e", "ɨ", pre="^", post="s[^aeiouáéíóú]"),  # escola -> ɨʃkˈɔlɐ
    Rule("s", "ʃ", post="[pçtkfqc]"),              # estar -> ɨʃtˈaɾ
    Rule("s", "ʒ", post="[bdgmnlrvzj]"),           # mesmo -> mˈeʒmu
]
_PT_EU_RULES = _PT_EU_ONLY + [
    r for r in _PT_RULES
    if not (r.src == "e" and r.post == "$" and not r.pre)
    and not (r.src == "e" and r.pre == "^")
    and not (r.ipa in ("tʃ", "dʒ"))  # no BR dental palatalization in EP
]

_PT_EU_LEXICON = dict(_PT_LEXICON)
_PT_EU_LEXICON.update({
    "escola": "ɨʃkˈɔlɐ", "escolas": "ɨʃkˈɔlɐʃ", "morte": "mˈɔɾtɨ",
    "forte": "fˈɔɾtɨ", "nove": "nˈɔvɨ", "sete": "sˈɛtɨ", "ele": "ˈelɨ",
    "festa": "fˈɛʃtɐ", "e": "i", "dez": "dˈɛʃ",  # the conjunction is /i/ in EP
    "homem": "ˈɔmɐ̃j", "homens": "ˈɔmɐ̃jʃ", "mulheres": "muʎˈɛɾɨʃ",
    "jovem": "ʒˈɔvɐ̃j", "jovens": "ʒˈɔvɐ̃jʃ",
})


def _pt_eu_reduce(ipa: str) -> str:
    """EP unstressed-vowel reduction: a -> ɐ, o -> u, e -> ɨ everywhere a
    stress mark does not immediately precede and no nasal tilde follows
    (nasal vowels never reduce; e before the offglide j keeps its quality:
    unstressed ei stays ej)."""
    out = []
    for i, ch in enumerate(ipa):
        if ch in "aoe" and (i == 0 or ipa[i - 1] != PRIMARY_STRESS):
            nxt = ipa[i + 1] if i + 1 < len(ipa) else ""
            if nxt != "̃" and not (ch == "e" and nxt == "j"):
                ch = {"a": "ɐ", "o": "u", "e": "ɨ"}[ch]
        out.append(ch)
    return "".join(out)


def stress_portuguese_eu(word: str, ipa: str) -> str:
    return _pt_eu_reduce(stress_portuguese(word, ipa))

# ---------------------------------------------------------------------------
# French (approximation; final-syllable prominence)
# ---------------------------------------------------------------------------

# high-frequency function words whose spelling breaks the rules
_FR_LEXICON = {
    "premier": "pʁəmje", "première": "pʁəmjɛʁ",
    "sixième": "sizjɛm", "dixième": "dizjɛm",  # ordinal x = /z/
    "est": "ɛ", "et": "e", "les": "le", "des": "de", "mes": "me",
    "tes": "te", "ses": "se", "ces": "se", "est-ce": "ɛs", "monsieur": "məsjø",
    "eu": "y", "eux": "ø", "deux": "dø", "dix": "dis", "six": "sis",
    "huit": "ɥit", "oui": "wi", "femme": "fam", "fils": "fis",
    "vingt": "vɛ̃", "soixante": "swasɑ̃t", "mille": "mil", "onze": "ɔ̃z",
    "temps": "tɑ̃", "blanc": "blɑ̃", "ville": "vil", "tranquille": "tʁɑ̃kil",
    # monosyllabic -er words keep ɛʁ (the -er -> e rule is for verbs)
    "mer": "mɛʁ", "fer": "fɛʁ", "cher": "ʃɛʁ", "hier": "jɛʁ",
    "amer": "amɛʁ", "hiver": "ivɛʁ",
    "question": "kɛstjɔ̃", "questions": "kɛstjɔ̃", "pays": "pei",
}

# elided clitics before an apostrophe (c'est, j'ai, qu'il ...)
_FR_CLITICS = {"c": "s", "j": "ʒ", "qu": "k", "s": "s", "t": "t", "l": "l",
               "d": "d", "m": "m", "n": "n"}

_FR_RULES = [
    Rule("eaux", "o"), Rule("eau", "o"), Rule("aux", "o"), Rule("eux", "ø"),
    Rule("ll", "l"), Rule("tt", "t"), Rule("ss", "s"), Rule("mm", "m"),
    Rule("nn", "n"), Rule("rr", "ʁ"), Rule("pp", "p"), Rule("cc", "ks",
    post="[ei]"), Rule("cc", "k"), Rule("ff", "f"), Rule("dd", "d"),
    Rule("oeu", "œ"), Rule("œu", "œ"), Rule("œ", "œ"),
    Rule("ième", "jɛm"),  # ordinal suffix: troisième, dixième
    Rule("tion", "sjɔ̃"), Rule("ille", "ij"), Rule("eil", "ɛj"),
    Rule("ail", "aj"), Rule("gn", "ɲ"),
    Rule("ain", "ɛ̃", post="[^aeiouéèêy]|$"), Rule("aim", "ɛ̃", post="[^aeiouéèêy]|$"),
    Rule("ein", "ɛ̃", post="[^aeiouéèêy]|$"),
    Rule("oin", "wɛ̃", post="[^aeiouéèêy]|$"),
    Rule("ien", "jɛ̃", post="s?$"),  # chien, bien, rien
    Rule("an", "ɑ̃", post="[^aeiounmhéèêy]|$"), Rule("am", "ɑ̃", post="[pb]"),
    Rule("en", "ɑ̃", post="[^aeiounmhéèêy]|$"), Rule("em", "ɑ̃", post="[pb]"),
    Rule("in", "ɛ̃", post="[^aeiounmhéèêy]|$"), Rule("im", "ɛ̃", post="[pb]"),
    Rule("on", "ɔ̃", post="[^aeiounmhéèêy]|$"), Rule("om", "ɔ̃", post="[pb]"),
    Rule("un", "œ̃", post="[^aeiounmhéèêy]|$"), Rule("um", "œ̃", post="[pb]"),
    Rule("eau", "o"), Rule("au", "o"), Rule("ou", "u"), Rule("oi", "wa"),
    Rule("ui", "ɥi"),  # nuit, suis, lui (qu-/ou- handled earlier)
    # i before a pronounced vowel glides (ciel, avion, rivière, pied);
    # word-final -ie keeps the vowel (vie, amie)
    Rule("i", "j", pre="[^aeiouéèêëœy]", post="[aàâoôéèê]|e(?!s?$)"),
    Rule("ai", "ɛ"), Rule("ei", "ɛ"),
    # eu in a closed final syllable is open (fleur, jeune, neuf, fleuve);
    # open syllables and -euse/-eux keep ø (peu, heureux, chanteuse)
    Rule("eu", "œ", post="[rlfvn]e?s?$"),
    Rule("eu", "ø"),
    Rule("ot", "o", post="s?$"),   # mot, pot: closed o, silent t
    Rule("ps", "", post="$"),      # corps, temps: silent ps cluster
    Rule("o", "o", post="s[eé]"),  # chose, rose: closed o before /z/
    Rule("ch", "ʃ"), Rule("ph", "f"), Rule("th", "t"), Rule("qu", "k"),
    Rule("gu", "ɡ", post="[eèéêi]"),
    Rule("c", "s", post="[eèéêiy]"), Rule("ç", "s"), Rule("c", "k"),
    Rule("g", "", post="$"),       # long, sang: silent final g
    Rule("g", "ʒ", post="[eèéêiy]"), Rule("g", "ɡ"),
    Rule("j", "ʒ"), Rule("h", ""),
    Rule("s", "z", pre="[aeiouéèêy]", post="[aeiouéèêy]"),
    Rule("ts", "", post="$"), Rule("ds", "", post="$"),
    Rule("es", "", post="$", pre="[^aeiou]"),  # silent plural/verb endings
    Rule("er", "e", post="$"), Rule("ez", "e", post="$"),
    Rule("et", "ɛ", post="$"),
    Rule("ed", "e", post="s?$"),   # pied, assied: closed e, silent d
    # e before a single final consonant is open (ciel, sel, avec)
    Rule("e", "ɛ", post="[^aeiouéèêëàâîïôûù]$"),
    # final e is silent when the word has an earlier vowel (rouge -> ʁuʒ);
    # monosyllables keep their schwa (le, de, que)
    Rule("e", "", post="$", pre="[aeiouyéèêëàâîïôûù].*"),
    Rule("e", "ə", post="$"),
    Rule("s", "", post="$"), Rule("t", "", post="$"), Rule("d", "", post="$"),
    Rule("p", "", post="$"), Rule("x", "", post="$"), Rule("z", "", post="$"),
    Rule("e", "ɛ", post="x"),
    Rule("e", "ɛ", post="[^aeiouéèêëàâîïôûù][^aeiouéèêëàâîïôûù]"),
    Rule("e", "ə"),
    Rule("é", "e"), Rule("è", "ɛ"), Rule("ê", "ɛ"), Rule("ë", "ɛ"),
    Rule("à", "a"), Rule("â", "a"), Rule("î", "i"), Rule("ï", "i"),
    Rule("ô", "o"), Rule("û", "y"), Rule("ù", "y"),
    Rule("a", "a"), Rule("i", "i"), Rule("o", "ɔ"), Rule("u", "y"),
    Rule("y", "i"),
    Rule("b", "b"), Rule("d", "d"), Rule("f", "f"), Rule("k", "k"),
    Rule("l", "l"), Rule("m", "m"), Rule("n", "n"), Rule("p", "p"),
    Rule("r", "ʁ"), Rule("s", "s"), Rule("t", "t"), Rule("v", "v"),
    Rule("w", "w"), Rule("x", "ks"), Rule("z", "z"),
]

_FR_DIGITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six",
              "sept", "huit", "neuf"]

# --- French liaison (obligatory / near-obligatory contexts only) ---------
# espeak models liaison between words; the per-word ruleset cannot.  A
# lookahead pass appends the latent final consonant of a closed word list
# (determiners, clitic pronouns, monosyllabic preps/adverbs, prenominal
# adjectives, être/avoir forms) when the next word in the same breath
# group (spaces only, no punctuation) is vowel-initial and not h-aspiré.
# Optional/stylistic liaisons (pas encore, verbs + complement) stay off:
# a missing liaison is acceptable French, a wrong one is not.
_FR_LIAISON = {
    # -s/-x/-z -> /z/
    "les": "z", "des": "z", "ces": "z", "mes": "z", "tes": "z", "ses": "z",
    "nos": "z", "vos": "z", "leurs": "z", "aux": "z", "deux": "z",
    "trois": "z", "nous": "z", "vous": "z", "ils": "z", "elles": "z",
    "chez": "z", "très": "z", "dans": "z", "sans": "z", "sous": "z",
    "plus": "z", "quelques": "z", "plusieurs": "z", "gros": "z",
    "tous": "z", "quels": "z", "quelles": "z", "petits": "z",
    "grands": "z", "bons": "z", "autres": "z",
    # -t/-d -> /t/
    "est": "t", "sont": "t", "ont": "t", "tout": "t", "petit": "t",
    "grand": "t", "quand": "t", "dont": "t", "vingt": "t", "cent": "t",
    # -n -> /n/ (nasal vowel kept, modern usage: mon ami = mɔ̃n‿ami)
    "un": "n", "on": "n", "en": "n", "mon": "n", "ton": "n", "son": "n",
    "bien": "n", "rien": "n", "aucun": "n",
    # -p -> /p/
    "trop": "p", "beaucoup": "p",
}
# liaison forms that rewrite the word's final segment instead of appending
# (six/dix devoice s->z; bon denasalizes; premier/dernier open e + add ʁ)
_FR_LIAISON_SUB = {
    "six": ("s", "z"), "dix": ("s", "z"), "bon": ("ɔ̃", "ɔn"),
    "premier": ("e", "ɛʁ"), "dernier": ("e", "ɛʁ"),
}
# h-aspiré and glide-initial words that look vowel-initial but block
# liaison (les héros = le eʁo, les huit = le ɥit)
_FR_H_ASPIRE = {
    "huit", "huitième", "onze", "onzième", "oui", "yaourt", "yaourts",
    "yoga", "yoyo", "héros", "haut", "hauts", "haute", "hautes",
    "hauteur", "haine", "hasard", "hors", "haricot", "haricots",
    "hibou", "hiboux", "honte", "hall", "hockey", "hamburger",
    "hamburgers", "hache", "hanche", "hérisson", "hâte", "halte",
}
_FR_VOWEL0 = set("aeiouyàâéèêëîïôùûœæ")
# verb forms whose inversion t/ t-d liaison is mandatory (est-il, ont-ils)
_FR_INVERSION = {"est": "t", "sont": "t", "ont": "t", "vont": "t",
                 "font": "t", "prend": "t", "quand": "t"}


def _fr_liaison_target(word: str) -> bool:
    """True when liaison may land on ``word`` (vowel-initial, not aspiré)."""
    if word in _FR_H_ASPIRE:
        return False
    c = word[0]
    return c in _FR_VOWEL0 or (c == "h")


def _fr_apply_liaison(word: str, ipa: str) -> str:
    """Return the liaison form of ``word``'s IPA, or ``ipa`` unchanged."""
    key = re.split(r"['-]", word.replace("’", "'"))[-1]  # c'est -> est
    if key in _FR_LIAISON_SUB:
        old, new = _FR_LIAISON_SUB[key]
        return ipa[: -len(old)] + new if ipa.endswith(old) else ipa
    if key in _FR_LIAISON:
        return ipa + _FR_LIAISON[key]
    return ipa

# ---------------------------------------------------------------------------
# Vietnamese (quốc ngữ syllable parser; tones like the reference's
# espeak-number -> contour table, TextFrontend.py:304-312)
# ---------------------------------------------------------------------------

_VI_TONE_CONTOUR = {  # tone name -> contour (matches frontend/text._VI_TONES)
    "ngang": "˧", "huyen": "˨˩", "sac": "˧˥", "nga": "˦˧˥",
    "hoi": "˧˩˧", "nang": "˧˩ʔ˨",
}

_VI_TONE_MARKS = {  # combining diacritic -> tone name
    "̀": "huyen", "́": "sac", "̃": "nga",
    "̉": "hoi", "̣": "nang",
}

_VI_ONSETS = [  # longest first
    ("ngh", "ŋ"), ("ng", "ŋ"), ("nh", "ɲ"), ("gh", "ɣ"), ("gi", "z"),
    ("kh", "x"), ("ph", "f"), ("th", "tʰ"), ("tr", "ʈ"), ("ch", "tɕ"),
    ("qu", "kw"), ("b", "ɓ"), ("c", "k"), ("d", "z"), ("đ", "ɗ"),
    ("g", "ɣ"), ("h", "h"), ("k", "k"), ("l", "l"), ("m", "m"),
    ("n", "n"), ("p", "p"), ("r", "z"), ("s", "s"), ("t", "t"),
    ("v", "v"), ("x", "s"),
]

_VI_RIMES = [  # (orthographic rime, IPA) longest first; northern values
    ("uyên", "wien"), ("uyết", "wiet"), ("ươu", "ɨəu"), ("uyê", "wie"),
    ("iêu", "ieu"), ("yêu", "ieu"), ("ươi", "ɨəi"), ("uôi", "uoi"),
    ("oai", "wai"), ("oay", "wai"), ("uây", "wəi"),
    ("iê", "ie"), ("yê", "ie"), ("uô", "uo"), ("ươ", "ɨə"), ("ưa", "ɨə"),
    ("ia", "iə"), ("ua", "uə"), ("ya", "iə"),
    ("ai", "ai"), ("ao", "au"), ("au", "ɐu"), ("ay", "ɐi"), ("âu", "əu"),
    ("ây", "əi"), ("eo", "ɛu"), ("êu", "eu"), ("iu", "iu"), ("oa", "wa"),
    ("oe", "wɛ"), ("oi", "ɔi"), ("ôi", "oi"), ("ơi", "əːi"), ("ui", "ui"),
    ("uy", "wi"), ("ưi", "ɨi"), ("ưu", "ɨu"), ("uê", "we"),
    ("a", "aː"), ("ă", "ɐ"), ("â", "ə"), ("e", "ɛ"), ("ê", "e"),
    ("i", "i"), ("y", "i"), ("o", "ɔ"), ("ô", "o"), ("ơ", "əː"),
    ("u", "u"), ("ư", "ɨ"),
]

_VI_CODAS = [
    ("ng", "ŋ"), ("nh", "ɲ"), ("ch", "k"), ("c", "k"), ("m", "m"),
    ("n", "n"), ("p", "p"), ("t", "t"),
]

_VI_DIGITS = ["không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy",
              "tám", "chín"]


def _vi_syllable(syl: str) -> str:
    """One quốc-ngữ syllable -> IPA + tone contour."""
    decomp = unicodedata.normalize("NFD", syl.lower())
    tone = "ngang"
    stripped = []
    for ch in decomp:
        if ch in _VI_TONE_MARKS:
            tone = _VI_TONE_MARKS[ch]
        else:
            stripped.append(ch)
    word = unicodedata.normalize("NFC", "".join(stripped))

    out = []
    i = 0
    for src, ipa in _VI_ONSETS:
        if word.startswith(src):
            # c/k/g spelling conventions: "gi" before vowel keeps /z/; "q"
            # only occurs as "qu"
            if src == "gi" and len(word) == 2:  # "gì" -> /zi/
                return "zi" + _VI_TONE_CONTOUR[tone]  # open syllable: no coda
            out.append(ipa)
            i = len(src)
            break
    rest = word[i:]
    coda = ""
    for src, ipa in _VI_CODAS:
        if rest.endswith(src) and len(rest) > len(src):
            coda = ipa
            rest = rest[:-len(src)]
            break
    nucleus = ""
    for src, ipa in _VI_RIMES:
        if rest == src:
            nucleus = ipa
            break
    if not nucleus:  # grapheme-by-grapheme fallback
        table = dict(_VI_RIMES)
        nucleus = "".join(table.get(c, "") for c in rest)
    # tone contour after the full syllable (coda included) — the position
    # espeak's tone numbers occupy, which the reference's replacement table
    # (TextFrontend.py:304-312) converts in place
    return "".join(out) + nucleus + coda + _VI_TONE_CONTOUR[tone]


def _vi_g2p(text: str) -> str:
    parts = []
    for token in text.split():
        m = re.match(r"(\W*)([\w]*)(\W*)$", token, re.UNICODE)
        lead, core, trail = m.groups() if m else ("", token, "")
        if core:
            core = _vi_syllable(core)
        parts.append(lead + core + trail)
    return " ".join(parts)


# ---------------------------------------------------------------------------
# Farsi (Persian script; VERDICT r03 #3).  Short vowels are unwritten in
# Persian orthography, so no rule system can recover them — the strategy
# here (explicitly sanctioned quality carve-out) is: (1) a frequent-word
# lexicon with the correct vowels, (2) the long vowels that ARE written
# (آ/ا = ɒ, و = u, ی = i) read from the script, (3) everything else keeps
# its consonant skeleton with an epenthetic /æ/ inserted between adjacent
# consonants (except a word-final cluster once a vowel exists — Persian
# allows CVCC), which yields the right consonants and syllable count with
# a default vowel quality.  Harakat diacritics are honored when present.
# Stress is word-final (the common Persian pattern).
# ---------------------------------------------------------------------------

_FA_CONS = {
    "ب": "b", "پ": "p", "ت": "t", "ث": "s", "ج": "dʒ", "چ": "tʃ",
    "ح": "h", "خ": "x", "د": "d", "ذ": "z", "ر": "r", "ز": "z",
    "ژ": "ʒ", "س": "s", "ش": "ʃ", "ص": "s", "ض": "z", "ط": "t",
    "ظ": "z", "ع": "ʔ", "غ": "ɣ", "ف": "f", "ق": "ɣ", "ک": "k",
    "ك": "k", "گ": "ɡ", "ل": "l", "م": "m", "ن": "n", "ء": "ʔ",
    "ئ": "ʔ", "ؤ": "ʔ", "ة": "t",
}

_FA_HARAKAT = {"َ": "æ", "ِ": "e", "ُ": "o",
               "ً": "æn", "ْ": ""}  # fatha kasra damma tanwin sukun

_FA_VOWEL_IPA = set("æeoɒiu")

# frequent words with their true vowels (Tehrani colloquial-formal mix);
# includes the numeral words frontend/numbers.py emits so numbers read
# with correct vowels rather than the skeleton default
_FA_LEXICON = {
    "سلام": "sælɒm", "من": "mæn", "تو": "to", "او": "u", "ما": "mɒ",
    "شما": "ʃomɒ", "آنها": "ɒnhɒ", "است": "æst", "هست": "hæst",
    "نیست": "nist", "بود": "bud", "شد": "ʃod", "شود": "ʃævæd",
    "و": "væ", "در": "dær", "به": "be", "از": "æz", "که": "ke",
    "را": "rɒ", "با": "bɒ", "برای": "bærɒje", "این": "in", "آن": "ɒn",
    "هم": "hæm", "تا": "tɒ", "یا": "jɒ", "اگر": "æɡær", "ولی": "væli",
    "اما": "æmmɒ", "پس": "pæs", "هر": "hær", "چه": "tʃe", "چی": "tʃi",
    "کجا": "kodʒɒ", "کی": "kej", "چرا": "tʃerɒ", "چطور": "tʃetor",
    "بله": "bæle", "نه": "næ", "خیلی": "xejli", "ممنون": "mæmnun",
    "لطفا": "lotfæn", "لطفاً": "lotfæn", "خوب": "xub", "بد": "bæd",
    "بزرگ": "bozorɡ", "کوچک": "kutʃæk", "نو": "now", "کهنه": "kohne",
    "میلیون": "miljun", "میلیارد": "miljɒrd",
    "کیلوگرم": "kiluɡeræm", "خریدم": "xæridæm", "خرید": "xærid",
    # everyday vocabulary with unwritten short vowels the skeleton
    # transducer cannot guess (round-5 fixture audit)
    "آتش": "ɒtæʃ", "پل": "pol", "صندلی": "sændæli",
    "پنجره": "pændʒære", "اتاق": "otɒɣ", "پسر": "pesær",
    "دختر": "doxtær", "فکر": "fekr", "نمک": "næmæk", "شکر": "ʃekær",
    "خوردن": "xordæn", "نوشیدن": "nuʃidæn", "خوابیدن": "xɒbidæn",
    "گفتن": "ɡoftæn", "شنیدن": "ʃenidæn", "دیدن": "didæn",
    "آمدن": "ɒmædæn", "رفتن": "ræftæn", "کردن": "kærdæn",
    "دادن": "dɒdæn", "گرفتن": "ɡereftæn", "دانستن": "dɒnestæn",
    "خواستن": "xɒstæn", "خواندن": "xɒndæn", "نوشتن": "neveʃtæn",
    "قهوه": "ɣæhve", "مدرسه": "mædrese", "ستاره": "setɒre",
    "آسمان": "ɒsemɒn", "خورشید": "xorʃid", "روستا": "rustɒ",
    "کشتی": "kæʃti", "خانواده": "xɒnevɒde", "انسان": "ensɒn",
    "کشور": "keʃvær", "کلمه": "kæleme", "سوال": "soɒl",
    "جواب": "dʒævɒb", "بدن": "bædæn", "کوچک": "kutʃek",
    "جوان": "dʒævɒn", "قوی": "ɣævi", "قرمز": "ɣermez",
    "دریا": "dærjɒ", "پیاز": "pijɒz", "انگور": "ænɡur",
    "برنج": "berendʒ", "مرغ": "morɣ", "آهسته": "ɒheste",
    "بسته": "bæste", "غمگین": "ɣæmɡin", "هواپیما": "hævɒpejmɒ",
    "سفید": "sefid", "بزرگ": "bozorɡ", "پدربزرگ": "pedærbozorɡ",
    "مادربزرگ": "mɒdærbozorɡ", "برادر": "bærɒdær", "پدر": "pedær",
    "مادر": "mɒdær", "خواهر": "xɒhær", "خیابان": "xijɒbɒn",
    "آب": "ɒb", "نان": "nɒn", "خانه": "xɒne", "شهر": "ʃæhr",
    "کشور": "keʃvær", "کتاب": "ketɒb", "روز": "ruz", "شب": "ʃæb",
    "سال": "sɒl", "ماه": "mɒh", "هفته": "hæfte", "امروز": "emruz",
    "فردا": "færdɒ", "دیروز": "diruz", "حال": "hɒl", "خوش": "xoʃ",
    "دوست": "dust", "مرد": "mærd", "زن": "zæn", "بچه": "bætʃtʃe",
    "پدر": "pedær", "مادر": "mɒdær", "برادر": "bærɒdær",
    "خواهر": "xɒhær", "اسم": "esm", "زبان": "zæbɒn",
    "فارسی": "fɒrsi", "ایران": "irɒn", "تهران": "tehrɒn",
    "دارم": "dɒræm", "داری": "dɒri", "دارد": "dɒræd",
    "داریم": "dɒrim", "دارید": "dɒrid", "دارند": "dɒrænd",
    "رفت": "ræft", "آمد": "ɒmæd", "گفت": "ɡoft", "کرد": "kærd",
    "کردن": "kærdæn", "بودن": "budæn", "شدن": "ʃodæn",
    "می": "mi", "نمی": "nemi", "بی": "bi", "با‌هم": "bɒhæm",
    # numerals (frontend/numbers.py output)
    "صفر": "sefr", "یک": "jek", "دو": "do", "سه": "se",
    "چهار": "tʃæhɒr", "پنج": "pændʒ", "شش": "ʃeʃ", "هفت": "hæft",
    "هشت": "hæʃt", "نُه": "noh", "ده": "dæh", "یازده": "jɒzdæh",
    "دوازده": "dævɒzdæh", "سیزده": "sizdæh", "چهارده": "tʃæhɒrdæh",
    "پانزده": "pɒnzdæh", "شانزده": "ʃɒnzdæh", "هفده": "hefdæh",
    "هجده": "hedʒdæh", "نوزده": "nuzdæh", "بیست": "bist", "سی": "si",
    "چهل": "tʃehel", "پنجاه": "pændʒɒh", "شصت": "ʃæst",
    "هفتاد": "hæftɒd", "هشتاد": "hæʃtɒd", "نود": "nævæd",
    # unit/symbol words (frontend/symbols.py output)
    "درصد": "dærsæd", "دلار": "dolɒr", "یورو": "juro", "پوند": "pond",
    "درجه": "dærædʒe", "علاوه": "ælɒve",
    "صد": "sæd", "دویست": "devist", "سیصد": "sisæd",
    "چهارصد": "tʃæhɒrsæd", "پانصد": "pɒnsæd", "ششصد": "ʃeʃsæd",
    "هفتصد": "hæftsæd", "هشتصد": "hæʃtsæd", "نهصد": "nohsæd",
    "هزار": "hezɒr",
}
# the bare letter نه is both "no" (næ) and "nine" (noh); numbers.py emits
# the disambiguated نُه, while plain text نه reads as the far more common
# negation

_FA_DIGITS = ["صفر", "یک", "دو", "سه", "چهار", "پنج", "شش", "هفت", "هشت",
              "نه"]


def _fa_word(word: str) -> str:
    """One Persian-script word -> IPA (lexicon, then skeleton transducer)."""
    if word in _FA_LEXICON:
        return _FA_LEXICON[word]
    chars = [c for c in word if c != "ـ"]  # strip tatweel
    phones: List[str] = []
    i = 0
    while i < len(chars):
        ch = chars[i]
        nxt = chars[i + 1] if i + 1 < len(chars) else ""
        prev_v = bool(phones) and phones[-1][-1] in _FA_VOWEL_IPA
        if ch == "آ":
            phones.append("ɒ")
        elif ch == "ا":
            if i == 0:
                # initial alef carries an unwritten short vowel — unless a
                # written long vowel (و/ی) or a harakat follows
                if nxt not in ("و", "ی") and nxt not in _FA_HARAKAT:
                    phones.append("æ")
            else:
                phones.append("ɒ")
        elif ch == "و":
            if i == 0:
                phones.append("v")
            elif prev_v:
                phones.append("v")
            else:
                phones.append("u")
        elif ch == "ی":
            if i == 0:
                phones.append("j")
            elif prev_v:
                phones.append("j")
            else:
                phones.append("i")
        elif ch == "ه":
            if i == len(chars) - 1 and not prev_v and len(chars) > 1:
                phones.append("e")  # silent final he = -e
            else:
                phones.append("h")
        elif ch in _FA_HARAKAT:
            if _FA_HARAKAT[ch]:
                phones.append(_FA_HARAKAT[ch])
        elif ch == "ّ":  # shadda: geminate the previous consonant
            if phones and phones[-1][-1] not in _FA_VOWEL_IPA:
                phones.append(phones[-1])
        elif ch in _FA_CONS:
            phones.append(_FA_CONS[ch])
        i += 1
    # epenthesis: break consonant clusters with /æ/ (no initial clusters in
    # Persian; final CVCC is allowed once the word has a vowel)
    out: List[str] = []
    for k, p in enumerate(phones):
        if out and out[-1][-1] not in _FA_VOWEL_IPA \
                and p[0] not in _FA_VOWEL_IPA:
            is_last = k == len(phones) - 1
            has_vowel = any(c in _FA_VOWEL_IPA for seg in out for c in seg)
            if not (is_last and has_vowel):
                out.append("æ")
        out.append(p)
    ipa = "".join(out)
    # a word of bare consonants (e.g. a lone letter) still needs a nucleus
    if ipa and not any(c in _FA_VOWEL_IPA for c in ipa):
        ipa += "æ"
    return ipa


def _fa_g2p(text: str) -> str:
    parts = []
    for token in re.split(r"([\s‌]+)", text):
        if not token or re.match(r"[\s‌]+$", token):
            parts.append(" ")
            continue
        m = re.match(r"(\W*)([\w]*)(\W*)$", token, re.UNICODE)
        lead, core, trail = m.groups() if m else ("", token, "")
        if core:
            core = stress_final(core, _fa_word(core))
        parts.append(lead + core + trail)
    return "".join(parts)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _language(lang: str) -> Language:
    table: Dict[str, Tuple[list, Callable, list, dict]] = {
        "es": (_ES_RULES, stress_spanish, _ES_DIGITS, {}),
        "it": (_IT_RULES, stress_italian, _IT_DIGITS, _IT_LEXICON),
        "fi": (_FI_RULES, stress_initial, _FI_DIGITS, {}),
        "el": (_EL_RULES, stress_greek, _EL_DIGITS, {}),
        "hu": (_HU_RULES, stress_initial, _HU_DIGITS, {}),
        "pl": (_PL_RULES, stress_penult, _PL_DIGITS, _PL_WORD_LEXICON),
        "nl": (_NL_RULES, stress_dutch, _NL_DIGITS, _NL_LEXICON),
        "de": (_DE_RULES, stress_german, _DE_DIGITS, _DE_LEXICON),
        "ru": (_RU_RULES, stress_russian, _RU_DIGITS, _RU_LEXICON),
        "uk": (_UK_RULES, stress_ukrainian, _UK_DIGITS, _UK_LEXICON),
        "pt": (_PT_EU_RULES, stress_portuguese_eu, _PT_DIGITS, _PT_EU_LEXICON),
        "pt-br": (_PT_RULES, stress_portuguese, _PT_DIGITS, _PT_LEXICON),
        "fr": (_FR_RULES, stress_french, _FR_DIGITS, _FR_LEXICON),
    }
    rules, stress, digits, lexicon = table[lang]
    return Language(RuleSet(rules), stress, digits, lexicon)


RULE_G2P_LANGUAGES = ("es", "it", "fi", "el", "hu", "pl", "nl", "de", "ru",
                      "uk", "pt", "pt-br", "fr", "vi", "fa")

_WORD_RX = re.compile(r"[^\W\d_]+(?:['’-][^\W\d_]+)*", re.UNICODE)

# The inventory expresses nasality as a combining-tilde modifier on the
# preceding vowel; decompose any precomposed codepoint a ruleset emitted.
_PRECOMPOSED = str.maketrans({
    "ẽ": "ẽ", "ĩ": "ĩ", "õ": "õ", "ũ": "ũ",
    "ã": "ã", "ỹ": "ỹ",
})


# written ordinal markers per language: list of (regex, gender) tried in
# order; group 1 is the number (espeak reads these as true ordinal words,
# e.g. "3º" -> "tercero", "1er" -> "premier", "der 3. Mai" -> "dritte",
# "3-й" -> "третий", "3ος" -> "τρίτος")
_ORDINAL_MARKERS = {
    # marker letters must be ATTACHED to the digits: a space would make
    # "3 de" (the Dutch article) or "3 es" false-positive as ordinals
    "es": [(r"(\d+)\.?\s?ª", "f"), (r"(\d+)\.?\s?º", "m"),
           (r"(\d+)er\b", "apoc")],  # 1er piso -> primer
    "fr": [(r"(\d+)(?:ères?|res?)\b", "f"),
           (r"(\d+)(?:ers?|èmes?|emes?|es?)\b", "m")],
    "nl": [(r"(\d+)(?:ste|de|e)\b", "m")],
    "de": [(r"(\d+)te[nrms]?\b", "m"),
           (r"(\d+)\.(?=\s+[A-ZÄÖÜ])", "m")],
    "ru": [(r"(\d+)-?го\b", "g"), (r"(\d+)-?(?:ая|я)\b", "f"),
           (r"(\d+)-?(?:ое|е)\b", "n"), (r"(\d+)-?(?:ый|ой|й)\b", "m")],
    "uk": [(r"(\d+)-?го\b", "g"), (r"(\d+)-?(?:ша|а)\b", "f"),
           (r"(\d+)-?(?:ше|е)\b", "n"), (r"(\d+)-?(?:ий|й)\b", "m")],
    "el": [(r"(\d+)(?:ης|η)\b", "f"), (r"(\d+)(?:ος|ού|ου)\b", "m"),
           (r"(\d+)ο\b", "n")],
}
# Finnish: "N." is an ordinal only in date position (before a month
# name); elsewhere the period is sentence punctuation
_ORDINAL_MARKERS["fi"] = [
    (r"(\d+)\.\s?(?=(?:tammi|helmi|maalis|huhti|touko|kesä|heinä|elo|"
     r"syys|loka|marras|joulu)kuu)", "m")]
# Hungarian date-case suffixes fuse onto the ordinal: 15-én ->
# tizenötödikén, 1-jén -> elsején, 3-án -> harmadikán
_ORDINAL_MARKERS["hu"] = [(r"(\d+)-j?én\b", "hu_en"),
                          (r"(\d+)-[áé]n\b", "hu_en"),
                          (r"(\d+)\.(?=\s+[a-záéíóöőüű])", "m")]
# Slavic dates read the day as an ORDINAL GENITIVE before a genitive
# month name (пятнадцатого марта, piętnastego marca) — standard usage
# espeak does not model; the bare cardinal elsewhere stays cardinal
_RU_MONTHS_GEN = ("января|февраля|марта|апреля|мая|июня|июля|августа|"
                  "сентября|октября|ноября|декабря")
_UK_MONTHS_GEN = ("січня|лютого|березня|квітня|травня|червня|липня|"
                  "серпня|вересня|жовтня|листопада|грудня")
_PL_MONTHS_GEN = ("stycznia|lutego|marca|kwietnia|maja|czerwca|lipca|"
                  "sierpnia|września|października|listopada|grudnia")
_ORDINAL_MARKERS["ru"].insert(
    0, (r"(\d+)(?=\s+(?:" + _RU_MONTHS_GEN + r")\b)", "g"))
_ORDINAL_MARKERS["uk"].insert(
    0, (r"(\d+)(?=\s+(?:" + _UK_MONTHS_GEN + r")\b)", "g"))
_ORDINAL_MARKERS["pl"] = [
    (r"(\d+)(?=\s+(?:" + _PL_MONTHS_GEN + r")\b)", "pl_gen")]
_ORDINAL_MARKERS["it"] = _ORDINAL_MARKERS["es"]
_ORDINAL_MARKERS["pt"] = _ORDINAL_MARKERS["pt-br"] = _ORDINAL_MARKERS["es"]


# Letter names for acronym spelling ("la UE", "el PIB", "СССР"): all-caps
# tokens with no vowel, or of <= 3 letters, read letter by letter like
# espeak; the names are ORTHOGRAPHIC words the language's own ruleset then
# phonemizes, so the IPA stays consistent with the rest of the G2P.
_LETTER_NAMES_BY_LANG = {
    "es": {"a": "a", "b": "be", "c": "ce", "d": "de", "e": "e", "f": "efe",
           "g": "ge", "h": "hache", "i": "i", "j": "jota", "k": "ka",
           "l": "ele", "m": "eme", "n": "ene", "ñ": "eñe", "o": "o",
           "p": "pe", "q": "cu", "r": "erre", "s": "ese", "t": "te",
           "u": "u", "v": "uve", "w": "uve doble", "x": "equis",
           "y": "i griega", "z": "zeta"},
    "fr": {"a": "a", "b": "bé", "c": "cé", "d": "dé", "e": "e", "f": "effe",
           "g": "gé", "h": "ache", "i": "i", "j": "ji", "k": "ka",
           "l": "elle", "m": "emme", "n": "enne", "o": "o", "p": "pé",
           "q": "ku", "r": "erre", "s": "esse", "t": "té", "u": "u",
           "v": "vé", "w": "doublevé", "x": "ixe", "y": "igrec",
           "z": "zède"},
    "de": {"a": "a", "b": "be", "c": "ze", "d": "de", "e": "eh", "f": "ef",
           "g": "ge", "h": "ha", "i": "i", "j": "jot", "k": "ka",
           "l": "el", "m": "em", "n": "en", "o": "o", "p": "pe",
           "q": "ku", "r": "er", "s": "es", "t": "te", "u": "u",
           "v": "fau", "w": "we", "x": "iks", "y": "ypsilon", "z": "zett"},
    "it": {"a": "a", "b": "bi", "c": "ci", "d": "di", "e": "e", "f": "effe",
           "g": "gi", "h": "acca", "i": "i", "j": "i lunga", "k": "cappa",
           "l": "elle", "m": "emme", "n": "enne", "o": "o", "p": "pi",
           "q": "cu", "r": "erre", "s": "esse", "t": "ti", "u": "u",
           "v": "vu", "w": "doppia vu", "x": "ics", "y": "ipsilon",
           "z": "zeta"},
    "pt": {"a": "a", "b": "bê", "c": "cê", "d": "dê", "e": "é", "f": "efe",
           "g": "gê", "h": "agá", "i": "i", "j": "jota", "k": "capa",
           "l": "ele", "m": "eme", "n": "ene", "o": "ó", "p": "pê",
           "q": "quê", "r": "erre", "s": "esse", "t": "tê", "u": "u",
           "v": "vê", "w": "dáblio", "x": "xis", "y": "ípsilon", "z": "zê"},
    "nl": {"a": "aa", "b": "bee", "c": "cee", "d": "dee", "e": "ee",
           "f": "ef", "g": "gee", "h": "haa", "i": "ie", "j": "jee",
           "k": "kaa", "l": "el", "m": "em", "n": "en", "o": "oo",
           "p": "pee", "q": "kuu", "r": "er", "s": "es", "t": "tee",
           "u": "uu", "v": "vee", "w": "wee", "x": "iks", "y": "ypsilon",
           "z": "zet"},
    "pl": {"a": "a", "b": "be", "c": "ce", "d": "de", "e": "e", "f": "ef",
           "g": "gie", "h": "ha", "i": "i", "j": "jot", "k": "ka",
           "l": "el", "m": "em", "n": "en", "o": "o", "p": "pe",
           "q": "ku", "r": "er", "s": "es", "t": "te", "u": "u",
           "w": "wu", "x": "iks", "y": "igrek", "z": "zet"},
    "ru": {"а": "а", "б": "бэ", "в": "вэ", "г": "гэ", "д": "дэ", "е": "е",
           "ё": "ё", "ж": "жэ", "з": "зэ", "и": "и", "й": "и", "к": "ка",
           "л": "эль", "м": "эм", "н": "эн", "о": "о", "п": "пэ",
           "р": "эр", "с": "эс", "т": "тэ", "у": "у", "ф": "эф",
           "х": "ха", "ц": "цэ", "ч": "че", "ш": "ша", "щ": "ща",
           "ы": "ы", "э": "э", "ю": "ю", "я": "я"},
    "uk": {"а": "а", "б": "бе", "в": "ве", "г": "ге", "ґ": "ґе", "д": "де",
           "е": "е", "є": "є", "ж": "же", "з": "зе", "и": "и", "і": "і",
           "ї": "ї", "й": "й", "к": "ка", "л": "ел", "м": "ем",
           "н": "ен", "о": "о", "п": "пе", "р": "ер", "с": "ес",
           "т": "те", "у": "у", "ф": "еф", "х": "ха", "ц": "це",
           "ч": "че", "ш": "ша", "щ": "ща", "ю": "ю", "я": "я"},
}
_SPELL_VOWELS = set("aeiouyáéíóúàèìòùâêîôûäëïöüãõаеёиоуыэюяіїє")
_UPPER_TOKEN_RX = re.compile(r"\b[^\W\d_]{2,6}\b")


def _spell_acronyms(text: str, lang: str, lexicon=()) -> str:
    names = _LETTER_NAMES_BY_LANG.get(lang)
    if not names:
        return text

    # fully-uppercase MULTI-WORD text is styling ("DER SPIEGEL"), not
    # acronym evidence — only vowelless tokens spell there; a lone
    # all-caps token ("USA") is an acronym regardless
    mixed_case = any(c.islower() for c in text) \
        or len(re.findall(r"[^\W\d_]+", text)) < 2

    def repl(m):
        tok = m.group(0)
        if not tok.isupper():
            return tok
        low = tok.lower()
        if low in lexicon:
            return tok  # all-caps ordinary word (headlines): read as word
        vowelless = not any(c in _SPELL_VOWELS for c in low)
        if not (vowelless or (mixed_case and len(tok) <= 3)):
            return tok  # long / styled all-caps: read as a word
        return " ".join(names.get(c, c) for c in low)

    return _UPPER_TOKEN_RX.sub(repl, text)


# Roman numerals (centuries, monarchs, chapters — espeak reads them as
# numbers in the Romance languages: "siglo XXI" -> "siglo veintiuno").
# Strict grammar, 2-6 chars, uppercase only (runs before lowercasing);
# valid-Roman strings that are really abbreviations are blocklisted.
_ROMAN_RX = re.compile(
    r"\b(?=[IVXLCDM]{2,6}\b)"
    r"(M{0,3})(CM|CD|D?C{0,3})(XC|XL|L?X{0,3})(IX|IV|V?I{0,3})\b")
_ROMAN_BLOCKLIST = {"CD", "DC", "CM", "MC", "MD", "MM", "CV", "CL", "CI",
                    "DI", "LI", "XL", "MI"}
_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100, "D": 500,
                 "M": 1000}
_ROMAN_LANGUAGES = {"es", "it", "pt", "pt-br", "fr"}


def _roman_value(s: str) -> int:
    total = 0
    for i, c in enumerate(s):
        v = _ROMAN_VALUES[c]
        total += -v if i + 1 < len(s) and _ROMAN_VALUES[s[i + 1]] > v else v
    return total


def _expand_roman(text: str, lang: str) -> str:
    if lang not in _ROMAN_LANGUAGES:
        return text
    from toucan_tpu_torch.frontend.numbers import number_to_words

    def repl(m):
        s = m.group(0)
        if s in _ROMAN_BLOCKLIST:
            return s
        try:
            return number_to_words(_roman_value(s), lang)
        except (KeyError, ValueError):
            return s

    return _ROMAN_RX.sub(repl, text)


def _expand_ordinals(text: str, lang: str) -> str:
    """Rewrite marked digit ordinals as ordinal words (runs BEFORE the
    cardinal expansion and before lowercasing — German's "3." marker needs
    the capitalized following noun as evidence)."""
    markers = _ORDINAL_MARKERS.get(lang)
    if not markers:
        return text
    from toucan_tpu_torch.frontend.numbers import number_to_ordinal

    def repl(gender):
        def go(m):
            try:
                word = number_to_ordinal(
                    int(m.group(1)), lang,
                    "m" if gender in ("apoc", "hu_en") else gender)
            except (KeyError, ValueError):
                return m.group(0)
            if gender == "pl_gen":  # 15 marca -> piętnastego marca
                from toucan_tpu_torch.frontend.numbers import pl_ordinal_genitive
                word = pl_ordinal_genitive(word)
            if gender == "hu_en":  # date case: 15-én -> tizenötödikén
                if word == "első":
                    word = "elsején"
                elif word.endswith(("adik", "odik")):  # back-vowel harmony
                    word += "án"
                else:
                    word += "én"
            if gender == "apoc":  # es 1er/3er: primer piso, tercer día
                word = re.sub(r"(primero|tercero)$",
                              lambda w: w.group(1)[:-1], word)
            if lang == "ru" and gender == "g":
                # adjective genitive -ого is pronounced with /v/; respell
                # so the ruleset reads it right (первого -> первово)
                word = re.sub(r"го$", "во", word)
            return " " + word + " "
        return go

    for pattern, gender in markers:
        # case-sensitive: the German "3." marker relies on the capitalized
        # following noun, and marker letters are conventionally lowercase
        text = re.sub(pattern, repl(gender), text)
    return text


def _expand_numbers(text: str, lang: str, digits: Sequence[str]) -> str:
    """Replace number tokens with full numerals (frontend/numbers.py,
    espeak behavior); out-of-range or unsupported -> digit-by-digit.
    Continental conventions: "." groups thousands (collapsed), "," reads
    as the language's decimal word with the fraction digit by digit."""
    from toucan_tpu_torch.frontend.numbers import (DECIMAL_WORDS, MAX_NUMBER,
                                             number_to_words)

    # 1.234.567 -> 1234567 (dot-grouped thousands)
    text = re.sub(r"(\d{1,3})(?:\.(?=\d{3}))((?:\d{3}\.?)*\d{3})(?!\d)",
                  lambda m: m.group(1) + m.group(2).replace(".", ""), text)

    def read_decimal(m):
        word = DECIMAL_WORDS.get(lang)
        if word is None:
            return m.group(0)
        frac = " ".join(digits[int(d)] for d in m.group(2))
        # lowercase: rule languages run on lowered text (de "Komma")
        return f" {m.group(1)} {word.lower()} {frac} "

    text = re.sub(r"(\d+),(\d+)(?!\d)", read_decimal, text)

    def read(m):
        s = m.group(0)
        n = int(s)
        # a leading zero means a code/phone-number-style string: read
        # digit-by-digit like espeak does
        if n <= MAX_NUMBER and not (s[0] == "0" and len(s) > 1):
            try:
                # lowercase: rule languages run on lowered text, and the
                # readers emit orthographic forms (de "eine Million")
                return " " + number_to_words(n, lang).lower() + " "
            except KeyError:
                pass
        return " " + " ".join(digits[int(d)] for d in s) + " "

    return re.sub(r"\d+", read, text)


def phonemize_rules(text: str, lang: str) -> str:
    """Plain text -> IPA (with stress marks / tone contours) for ``lang``.

    Word-by-word: letters phonemize through the language's ruleset (or the
    vi/fa custom transducers); numbers read as full numerals; punctuation
    passes through for the frontend's pause handling
    (``postprocess_phoneme_string``)."""
    from toucan_tpu_torch.frontend.symbols import expand_symbols

    text = expand_symbols(text, lang)
    if lang == "vi":
        text = _expand_numbers(text, lang, _VI_DIGITS)
        return _vi_g2p(text).translate(_PRECOMPOSED)
    if lang == "fa":
        text = _expand_numbers(text, lang, _FA_DIGITS)
        return _fa_g2p(text).translate(_PRECOMPOSED)
    spec = _language(lang)
    lexicon = spec.lexicon

    text = _expand_roman(text, lang)
    text = _expand_ordinals(text, lang)
    text = _spell_acronyms(text, lang, lexicon)
    text = _expand_numbers(text.lower(), lang, spec.digits)

    def convert(m):
        if m.group(0) in lexicon:
            return spec.stress(m.group(0), lexicon[m.group(0)])
        # apostrophes delimit clitics (French c'est = c' + est) and block
        # palatalization in Ukrainian (п'ять); in Italian/other languages
        # they mark elision and the pieces fuse into one phonological word
        # (c'è -> cè -> tʃɛ).  Hyphens always delimit compound members
        # (quatre-vingt-dix-neuf); each part phonemizes with its own
        # word-boundary contexts and lexicon lookup
        word = m.group(0).replace("’", "'")
        if lang not in ("fr", "uk"):
            word = word.replace("'", "")
        parts = [p for p in re.split(r"['-]", word) if p]
        ipa = ""
        for pi, p in enumerate(parts):
            if lang == "fr" and pi < len(parts) - 1 and p in _FR_CLITICS \
                    and "'" in word:
                ipa += _FR_CLITICS[p]  # elided clitic keeps only its onset
            else:
                piece = lexicon.get(p, spec.rules.apply(p))
                # mandatory inversion liaison inside hyphenation (est-il,
                # ont-ils); number compounds (quatre-vingt-un) excluded by
                # the closed verb list
                if lang == "fr" and pi < len(parts) - 1 \
                        and p in _FR_INVERSION \
                        and parts[pi + 1][:1] in _FR_VOWEL0:
                    piece += _FR_INVERSION[p]
                ipa += piece
        return spec.stress(word.replace("'", "").replace("-", ""), ipa)

    if lang == "fr":
        # lookahead pass for liaison: the latent final consonant of a
        # closed word list surfaces before a vowel-initial word when only
        # spaces separate them (punctuation = breath-group boundary)
        matches = list(_WORD_RX.finditer(text))
        out, last = [], 0
        for i, m in enumerate(matches):
            out.append(text[last:m.start()])
            ipa = convert(m)
            if i + 1 < len(matches):
                gap = text[m.end():matches[i + 1].start()]
                if gap and set(gap) <= {" ", " "} \
                        and _fr_liaison_target(matches[i + 1].group(0)):
                    ipa = _fr_apply_liaison(m.group(0), ipa)
            out.append(ipa)
            last = m.end()
        out.append(text[last:])
        return "".join(out).translate(_PRECOMPOSED)

    return _WORD_RX.sub(convert, text).translate(_PRECOMPOSED)
