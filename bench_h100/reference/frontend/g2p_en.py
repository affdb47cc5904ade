"""Built-in rule-based English G2P (espeak-ng fallback).

The reference frontend requires espeak-ng for every plain-text language
(``Preprocessing/TextFrontend.py:168-172``).  espeak is an optional host
dependency here too — when it is absent, this module keeps plain-text
*English* input working: an exceptions lexicon for frequent irregular
words, a context-sensitive letter-to-sound ruleset (NRL-style grapheme
rewrite rules: Elovitz et al. 1976, "Automatic translation of English text
to phonetics", the classic public-domain approach), a first-content-vowel
stress heuristic, and integer number reading.

Output is IPA restricted to the articulatory inventory's alphabet, with
words separated by spaces and punctuation preserved — exactly what
``TextFrontend.postprocess_phoneme_string`` expects.  It is a *fallback*:
espeak remains the reference-parity path when installed.
"""

from __future__ import annotations

import re

# ---------------------------------------------------------------- lexicon

# Frequent words with irregular spellings (general-American IPA, inventory
# alphabet; ˈ marks primary stress).
_EXCEPTIONS = {
    "choose": "tʃˈuz", "phase": "fˈeɪz", "national": "nˈæʃənəl",
    "euro": "jˈʊɹoʊ", "euros": "jˈʊɹoʊz", "dollar": "dˈɑləɹ",
    "dollars": "dˈɑləɹz", "celsius": "sˈɛlsiəs",
    "fahrenheit": "fˈɛɹənhaɪt",
    "important": "ɪmpˈɔɹtənt", "different": "dˈɪfɹənt",
    "country": "kˈʌntɹi", "countries": "kˈʌntɹiz",
    "mountain": "mˈaʊntən", "mountains": "mˈaʊntənz",
    "fountain": "fˈaʊntən", "listen": "lˈɪsən", "against": "əɡˈɛnst",
    "pretty": "pɹˈɪti", "pi": "pˈaɪ",
    # round-4 frequent-word sweep (errors found reviewing the top ~400)
    "called": "kˈɔld", "calling": "kˈɔlɪŋ", "before": "bɪfˈɔɹ",
    "follow": "fˈɑloʊ", "following": "fˈɑloʊɪŋ", "window": "wˈɪndoʊ",
    "yellow": "jˈɛloʊ", "tomorrow": "təmˈɑɹoʊ", "narrow": "nˈɛɹoʊ",
    "try": "tɹˈaɪ", "tried": "tɹˈaɪd", "trying": "tɹˈaɪɪŋ",
    "cry": "kɹˈaɪ", "fly": "flˈaɪ", "dry": "dɹˈaɪ", "sky": "skˈaɪ",
    "shy": "ʃˈaɪ", "away": "əwˈeɪ", "between": "bɪtwˈin",
    "below": "bɪlˈoʊ", "few": "fjˈu", "until": "ənˈtɪl",
    "began": "bɪɡˈæn", "begin": "bɪɡˈɪn", "paper": "pˈeɪpəɹ",
    "later": "lˈeɪtəɹ", "lady": "lˈeɪdi", "baby": "bˈeɪbi",
    "today": "tədˈeɪ", "tonight": "tənˈaɪt", "however": "haʊˈɛvəɹ",
    "across": "əkɹˈɔs", "toward": "təwˈɔɹd", "towards": "təwˈɔɹdz",
    "second": "sˈɛkənd", "upon": "əpˈɑn", "almost": "ˈɔlmoʊst",
    "become": "bɪkˈʌm", "behind": "bɪhˈaɪnd", "beside": "bɪsˈaɪd",
    "shall": "ʃˈæl", "pal": "pˈæl", "gal": "ɡˈæl", "canal": "kənˈæl",
    "danger": "dˈeɪndʒəɹ", "stranger": "stɹˈeɪndʒəɹ",
    "strange": "stɹˈeɪndʒ", "local": "lˈoʊkəl", "legal": "lˈiɡəl",
    "the": "ðə", "a": "ə", "an": "ən", "of": "ʌv", "to": "tu", "and": "ænd",
    "in": "ɪn", "is": "ɪz", "was": "wˈʌz", "he": "hi", "she": "ʃi",
    "it": "ɪt", "for": "fɔɹ", "on": "ɑn", "are": "ɑɹ", "as": "æz",
    "with": "wɪð", "his": "hɪz", "they": "ðeɪ", "i": "aɪ", "at": "æt",
    "be": "bi", "this": "ðˈɪs", "have": "hæv", "from": "fɹʌm", "or": "ɔɹ",
    "one": "wˈʌn", "had": "hæd", "by": "baɪ", "word": "wˈɜɹd", "but": "bʌt",
    "not": "nɑt", "what": "wˈʌt", "all": "ɔl", "were": "wɜɹ", "we": "wi",
    "when": "wɛn", "your": "jɔɹ", "can": "kæn", "said": "sˈɛd",
    "there": "ðɛɹ", "use": "jˈuz", "each": "ˈitʃ", "which": "wˈɪtʃ",
    "do": "du", "how": "haʊ", "their": "ðɛɹ", "if": "ɪf", "will": "wɪl",
    "up": "ʌp", "other": "ˈʌðəɹ", "about": "əbˈaʊt", "out": "aʊt",
    "many": "mˈɛni", "then": "ðɛn", "them": "ðɛm", "these": "ðiz",
    "so": "soʊ", "some": "sʌm", "her": "hɜɹ", "would": "wʊd",
    "make": "mˈeɪk", "like": "lˈaɪk", "him": "hɪm", "into": "ˈɪntu",
    "time": "tˈaɪm", "has": "hæz", "look": "lˈʊk", "two": "tˈu",
    "more": "mˈɔɹ", "write": "ɹˈaɪt", "go": "ɡˈoʊ", "see": "sˈi",
    "no": "nˈoʊ", "way": "wˈeɪ", "could": "kʊd", "people": "pˈipəl",
    "my": "maɪ", "than": "ðæn", "first": "fˈɜɹst", "water": "wˈɔtəɹ",
    "been": "bɪn", "who": "hu", "its": "ɪts", "now": "nˈaʊ",
    "find": "fˈaɪnd", "long": "lˈɔŋ", "down": "dˈaʊn", "day": "dˈeɪ",
    "did": "dɪd", "get": "ɡˈɛt", "come": "kˈʌm", "made": "mˈeɪd",
    "may": "meɪ", "any": "ˈɛni", "very": "vˈɛɹi", "after": "ˈæftəɹ",
    "where": "wɛɹ", "most": "mˈoʊst", "through": "θɹu", "our": "aʊɹ",
    "good": "ɡˈʊd", "me": "mi", "give": "ɡˈɪv", "does": "dʌz",
    "another": "ənˈʌðəɹ", "even": "ˈivən", "because": "bɪkˈʌz",
    "here": "hˈiɹ", "why": "waɪ", "again": "əɡˈɛn", "move": "mˈuv",
    "something": "sˈʌmθɪŋ", "thought": "θˈɔt", "both": "boʊθ",
    "once": "wˈʌns", "hear": "hˈiɹ", "often": "ˈɔfən", "example": "ɪɡzˈæmpəl",
    "together": "təɡˈɛðəɹ", "group": "ɡɹˈup", "always": "ˈɔlweɪz",
    "those": "ðoʊz", "only": "ˈoʊnli", "little": "lˈɪtəl", "work": "wˈɜɹk",
    "know": "nˈoʊ", "place": "plˈeɪs", "year": "jˈiɹ", "live": "lˈɪv",
    "back": "bˈæk", "gives": "ɡˈɪvz", "world": "wˈɜɹld", "put": "pˈʊt",
    "own": "ˈoʊn", "says": "sˈɛz", "great": "ɡɹˈeɪt", "new": "nˈu",
    "sound": "sˈaʊnd", "take": "tˈeɪk", "every": "ˈɛvɹi", "under": "ˈʌndəɹ",
    "also": "ˈɔlsoʊ", "found": "fˈaʊnd", "women": "wˈɪmən",
    "woman": "wˈʊmən", "want": "wˈɑnt", "show": "ʃˈoʊ", "around": "əɹˈaʊnd",
    "form": "fˈɔɹm", "three": "θɹˈi", "small": "smˈɔl", "large": "lˈɑɹdʒ",
    "must": "mʌst", "big": "bˈɪɡ", "off": "ɔf", "came": "kˈeɪm",
    "should": "ʃʊd", "mr": "mˈɪstəɹ", "mrs": "mˈɪsɪz", "laugh": "lˈæf",
    "eye": "aɪ", "eyes": "aɪz", "heart": "hˈɑɹt", "earth": "ˈɜɹθ",
    "friend": "fɹˈɛnd", "done": "dˈʌn", "gone": "ɡˈɔn", "none": "nˈʌn",
    "learn": "lˈɜɹn", "early": "ˈɜɹli", "heard": "hˈɜɹd", "sure": "ʃʊɹ",
    "four": "fˈɔɹ", "buy": "baɪ", "busy": "bˈɪzi", "business": "bˈɪznəs",
    "pause": "pˈɔz", "says'": "sˈɛz", "half": "hˈæf", "talk": "tˈɔk",
    "walk": "wˈɔk", "above": "əbˈʌv", "love": "lˈʌv", "front": "fɹˈʌnt",
    "month": "mˈʌnθ", "money": "mˈʌni", "son": "sˈʌn", "nothing": "nˈʌθɪŋ",
    "enough": "ɪnˈʌf", "young": "jˈʌŋ", "touch": "tˈʌtʃ", "blood": "blˈʌd",
    "flood": "flˈʌd", "door": "dˈɔɹ", "floor": "flˈɔɹ", "island": "ˈaɪlənd",
    "iron": "ˈaɪəɹn", "answer": "ˈænsəɹ", "beautiful": "bjˈutɪfəl",
    "sentence": "sˈɛntəns", "minute": "mˈɪnət", "usually": "jˈuʒuəli",
    "idea": "aɪdˈiə", "area": "ˈɛɹiə", "piece": "pˈis", "during": "dˈʊɹɪŋ",
    "ocean": "ˈoʊʃən", "machine": "məʃˈin", "complex": "kˈɑmplɛks",
    "science": "sˈaɪəns", "quite": "kwˈaɪt", "believe": "bɪlˈiv",
    "whole": "hˈoʊl", "though": "ðoʊ", "tough": "tˈʌf", "cough": "kˈɔf",
    "could've": "kˈʊdəv", "i'm": "aɪm", "i'll": "aɪl", "i've": "aɪv",
    "it's": "ɪts", "don't": "doʊnt", "doesn't": "dˈʌzənt",
    "can't": "kˈænt", "won't": "woʊnt", "isn't": "ˈɪzənt",
    "you're": "jʊɹ", "you": "ju", "wasn't": "wˈʌzənt", "we're": "wiɹ",
    "they're": "ðɛɹ", "there's": "ðɛɹz", "that's": "ðˈæts",
    "that": "ðæt", "haven't": "hˈævənt", "over": "ˈoʊvəɹ",
    "watch": "wˈɑtʃ", "goes": "ɡoʊz", "yes": "jˈɛs", "oh": "ˈoʊ",
    "being": "bˈiɪŋ", "really": "ɹˈɪli",
    # round-5 fixture audit: irregular vowels the rules cannot know
    "father": "fˈɑðəɹ", "fathers": "fˈɑðəɹz",
    "grandfather": "ɡɹˈændfɑðəɹ", "grandmother": "ɡɹˈændmʌðəɹ",
    "language": "lˈæŋɡwɪdʒ", "languages": "lˈæŋɡwɪdʒɪz",
    "tomato": "təmˈeɪtoʊ", "tomatoes": "təmˈeɪtoʊz",
    "potato": "pətˈeɪtoʊ", "potatoes": "pətˈeɪtoʊz",
    "onion": "ˈʌnjən", "onions": "ˈʌnjənz", "sugar": "ʃˈʊɡəɹ",
    "salt": "sˈɔlt", "pear": "pˈɛɹ", "pears": "pˈɛɹz",
    "bear": "bˈɛɹ", "wear": "wˈɛɹ", "low": "lˈoʊ", "slow": "slˈoʊ",
    "grow": "ɡɹˈoʊ", "snow": "snˈoʊ", "throw": "θɹˈoʊ",
    "flow": "flˈoʊ", "blow": "blˈoʊ", "open": "ˈoʊpən",
    "difficult": "dˈɪfɪkəlt", "engage": "ɪnɡˈeɪdʒ", "upon": "əpˈɑn",
    # -Cle with long vowel (the double-consonant collapse hides the
    # short/long signal from the ruleset: apple vs maple)
    "table": "tˈeɪbl", "tables": "tˈeɪblz", "able": "ˈeɪbl",
    "unable": "ənˈeɪbl", "cable": "kˈeɪbl", "stable": "stˈeɪbl",
    "fable": "fˈeɪbl", "maple": "mˈeɪpl", "staple": "stˈeɪpl",
    "title": "tˈaɪtl", "titles": "tˈaɪtlz", "bible": "bˈaɪbl",
    "idle": "ˈaɪdl", "rifle": "ɹˈaɪfl", "noble": "nˈoʊbl",
    "cradle": "kɹˈeɪdl",
    # number words the letter-to-sound rules get wrong
    "zero": "zˈɪɹoʊ", "seven": "sˈɛvən", "seventy": "sˈɛvənti",
    "seventeen": "sˈɛvəntin", "seventh": "sˈɛvənθ",
    "seventeenth": "sˈɛvəntinθ", "seventieth": "sˈɛvəntiθ",
    "eleven": "ɪlˈɛvən", "eleventh": "ɪlˈɛvənθ",
    "nineteen": "nˈaɪntin", "nineteenth": "nˈaɪntinθ",
    "ninety": "nˈaɪnti", "ninetieth": "nˈaɪntiθ", "ninth": "nˈaɪnθ",
    "minus": "mˈaɪnəs", "hundred": "hˈʌndɹəd", "hundredth": "hˈʌndɹədθ",
    "thousand": "θˈaʊzənd", "thousandth": "θˈaʊzəndθ",
    "million": "mˈɪljən", "millionth": "mˈɪljənθ", "billion": "bˈɪljən",
    "eighth": "ˈeɪtθ", "nineties": "nˈaɪntiz", "seventies": "sˈɛvəntiz",
    # normalization helpers (clock times, spelled acronyms, abbreviations)
    "o'clock": "əklˈɑk", "misess": "mˈɪsɪz", "versus": "vˈɜɹsəs",
    "cetera": "sˈɛtəɹə", "nasa": "nˈæsə",
    # unit words (the letter rules mangle giga-/hertz/hour compounds)
    "hour": "ˈaʊəɹ", "hours": "ˈaʊəɹz", "flour": "flˈaʊəɹ",
    "halves": "hˈævz", "hertz": "hˈɜɹts",
    "gigabyte": "ɡˈɪɡəbaɪt", "gigabytes": "ɡˈɪɡəbaɪts",
    "megabyte": "mˈɛɡəbaɪt", "megabytes": "mˈɛɡəbaɪts",
    "kilobyte": "kˈɪləbaɪt", "kilobytes": "kˈɪləbaɪts",
    "terabyte": "tˈɛɹəbaɪt", "terabytes": "tˈɛɹəbaɪts",
    "gigahertz": "ɡˈɪɡəhɜɹts", "megahertz": "mˈɛɡəhɜɹts",
    "kilohertz": "kˈɪləhɜɹts",
    "kilometer": "kəlˈɑmətəɹ", "kilometers": "kəlˈɑmətəɹz",
    "millisecond": "mˈɪlisɛkənd", "milliseconds": "mˈɪlisɛkəndz",
    "ay": "ˈeɪ", "cee": "sˈi", "dee": "dˈi", "ee": "ˈi", "ef": "ˈɛf",
    "gee": "dʒˈi", "aitch": "ˈeɪtʃ", "jay": "dʒˈeɪ", "kay": "kˈeɪ",
    "el": "ˈɛl", "em": "ˈɛm", "en": "ˈɛn", "owe": "ˈoʊ", "pee": "pˈi",
    "cue": "kjˈu", "ar": "ˈɑɹ", "ess": "ˈɛs", "tee": "tˈi", "vee": "vˈi",
    "doubleyou": "dˈʌbəlju", "ex": "ˈɛks", "zee": "zˈi", "bee": "bˈi",
    "eye": "ˈaɪ",
}

# Letter names as pseudo-words every one of which is in _EXCEPTIONS (or an
# already-correct lexicon word), so spelled-out acronyms ("TV", "e.g.",
# "3 pm") read letter by letter like espeak does.
_LETTER_WORDS = {
    "a": "ay", "b": "bee", "c": "cee", "d": "dee", "e": "ee", "f": "ef",
    "g": "gee", "h": "aitch", "i": "eye", "j": "jay", "k": "kay", "l": "el",
    "m": "em", "n": "en", "o": "owe", "p": "pee", "q": "cue", "r": "ar",
    "s": "ess", "t": "tee", "u": "you", "v": "vee", "w": "doubleyou",
    "x": "ex", "y": "why", "z": "zee",
}

# All-caps tokens that read as ordinary words, not letter sequences.
_PRONOUNCED_ACRONYMS = {"nasa", "nato", "laser", "radar", "covid", "unesco",
                        "unicef", "opec", "fifa", "lego"}


def spell_out(word: str) -> str:
    """Acronym -> space-separated letter-name pseudo-words ("tv" -> "tee vee")."""
    return " ".join(_LETTER_WORDS[c] for c in word.lower() if c in _LETTER_WORDS)

# ------------------------------------------------------------------ rules

# (grapheme, left-context regex | None, right-context regex | None, ipa).
# First match wins; rules are tried at each position in order, so longer /
# more specific graphemes come first.  Contexts are regexes anchored at the
# boundary: left matches the END of the preceding letters, right matches
# the START of the following letters.  "V"/"C" shorthands are expanded.
_V = "[aeiouy]"
_C = "[bcdfghjklmnpqrstvwxz]"

_RULES = [
    # round-5 additions (anchored contexts; the engine SEARCHES rc/lc)
    ("age", ".*[aeiouy].*[a-z]", "s?$", "ɪdʒ"),  # village, message (not page)
    ("en", ".*[aeiouy].*[a-z]", "s?$", "ən"),    # kitchen, garden, chicken
    ("on", ".*[aeiouy].*[a-z]", "s?$", "ən"),    # person, lemon, common
    # --- multi-letter suffixes / clusters (longest first) ---
    ("ought", None, None, "ɔt"),
    ("aught", None, None, "ɔt"),
    ("ation", None, None, "eɪʃən"),   # nation, station: long a
    ("otion", None, None, "oʊʃən"),   # motion, lotion: long o
    ("stion", None, None, "stʃən"),   # question, suggestion
    ("ar", None, "$", "ɑɹ"),          # car, far, star (word-final)
    # final -al: ɔl in monosyllables (call/ball — the ll collapses to l
    # before rules run), schwa in longer words (animal, several, local)
    ("al", "^" + _C + "*", "$", "ɔl"),
    ("al", _V + ".*", "$", "əl"),
    ("tion", None, None, "ʃən"),
    ("sion", _V, None, "ʒən"),
    ("sion", None, None, "ʃən"),
    ("cial", None, None, "ʃəl"),
    ("tial", None, None, "ʃəl"),
    ("cious", None, None, "ʃəs"),
    ("tious", None, None, "ʃəs"),
    ("ture", None, "$", "tʃəɹ"),
    ("sure", _V, "$", "ʒəɹ"),
    # final -se: voiceless in the -ouse/-ase/-oose noun patterns (house,
    # case, goose) — the generic intervocalic-s rule would voice them
    ("ouse", None, "$", "aʊs"),
    ("ase", None, "$", "eɪs"),
    ("oose", None, "$", "us"),
    ("ough", None, None, "oʊ"),
    ("augh", None, None, "ɔ"),
    ("eigh", None, None, "eɪ"),
    ("igh", None, None, "aɪ"),
    ("ange", None, "$", "eɪndʒ"),    # change, strange: magic-e over n
    ("other", None, "$", "ʌðəɹ"),    # mother, brother, other
    ("sch", "^$", None, "sk"),       # school, scheme
    ("dge", None, None, "dʒ"),
    ("tch", None, None, "tʃ"),
    ("qu", None, None, "kw"),
    ("squ", None, None, "skw"),
    # --- silent letter clusters at word start ---
    ("kn", "^$", None, "n"),
    ("gn", "^$", None, "n"),
    ("wr", "^$", None, "ɹ"),
    ("ps", "^$", None, "s"),
    ("pn", "^$", None, "n"),
    ("wh", "^$", "o", "h"),          # who, whole
    ("wh", None, None, "w"),
    # --- consonant digraphs ---
    ("ch", None, None, "tʃ"),
    ("sh", None, None, "ʃ"),
    ("ph", None, None, "f"),
    ("th", "^$", f"{_V}*e($|s$|d$|n)", "ð"),  # the(n/se/re) handled in lexicon
    ("th", _V, _V, "ð"),             # mother, weather
    ("th", None, None, "θ"),
    ("ck", None, None, "k"),
    ("gh", _V, None, ""),            # silent after vowel (high, weigh)
    ("ng", None, "$|s$", "ŋ"),
    ("ng", None, _V, "ŋɡ"),          # finger
    ("ng", None, None, "ŋ"),
    ("nk", None, None, "ŋk"),
    # --- vowel digraphs ---
    ("eau", None, None, "ju"),
    # --- r-colored vowels (before plain digraphs: "ear" beats "ea") ---
    ("air", None, None, "ɛɹ"),
    ("are", None, "$", "ɛɹ"),
    ("ear", None, _C, "ɜɹ"),         # learn-class mostly in lexicon
    ("ear", None, None, "iɹ"),
    ("eer", None, None, "iɹ"),
    ("ere", None, "$", "iɹ"),
    ("ire", None, "$", "aɪəɹ"),
    ("ore", None, "$", "ɔɹ"),
    ("our", None, None, "ɔɹ"),
    ("oor", None, None, "ʊɹ"),
    ("ur", None, None, "ɜɹ"),
    ("ir", None, None, "ɜɹ"),
    ("er", None, "$", "əɹ"),
    ("er", None, None, "ɜɹ"),
    ("ar", None, "$", "əɹ"),         # dollar, sugar
    ("ar", None, None, "ɑɹ"),
    ("or", _C, "$", "əɹ"),           # doctor, actor
    ("or", None, None, "ɔɹ"),
    # --- plain vowel digraphs ---
    ("ee", None, None, "i"),
    ("ea", None, "d$", "ɛ"),         # head, bread (read/lead ambiguous)
    ("ea", None, None, "i"),
    ("ai", None, None, "eɪ"),
    ("ay", None, None, "eɪ"),
    ("ey", None, "$", "i"),
    ("ei", None, None, "eɪ"),
    ("oa", None, None, "oʊ"),
    ("oo", None, "k", "ʊ"),          # book, look
    ("oo", None, None, "u"),
    ("ou", None, "s$", "ə"),         # famous
    ("ou", None, None, "aʊ"),
    ("ow", None, "$|n$|el", "aʊ"),   # now, down, towel (snow-class in lexicon)
    ("ow", None, None, "oʊ"),
    ("oi", None, None, "ɔɪ"),
    ("oy", None, None, "ɔɪ"),
    ("au", None, None, "ɔ"),
    ("aw", None, None, "ɔ"),
    ("ew", None, None, "u"),
    ("ue", None, "$", "u"),
    ("ui", None, None, "u"),
    ("ie", None, "$", "aɪ"),         # tie, lie
    ("ie", None, None, "i"),         # field, piece
    ("ioning", None, None, "jənɪŋ"),
    # --- magic-e long vowels: V C e$ (and before suffix -s/-d) ---
    ("a", None, f"{_C}e(s|d)?$", "eɪ"),
    ("i", None, f"{_C}e(s|d)?$", "aɪ"),
    ("o", None, f"{_C}e(s|d)?$", "oʊ"),
    ("u", None, f"{_C}e(s|d)?$", "ju"),
    ("e", None, f"{_C}e(s|d)?$", "i"),
    # --- single vowels ---
    ("y", "^$", None, "j"),
    ("y", _C, "$", "i"),             # happy; (try/by-class via lexicon)
    ("y", None, _V, "j"),
    ("y", None, None, "ɪ"),
    ("a", None, "l(l|w)", "ɔ"),      # all, always
    ("a", None, None, "æ"),
    ("e", None, "$", ""),            # silent final e
    # -ed suffix needs a stem with an earlier vowel (wanted, played) —
    # monosyllables keep the full vowel (red, bed)
    ("e", "[aeiouy]", "d$", "ə"),
    ("e", f"{_C}{_C}|{_V}{_C}", "s$", ""),  # silent e in -es after stem+cons
    ("e", None, None, "ɛ"),
    ("i", None, "nd$", "aɪ"),        # find, kind
    ("i", None, "ld$", "aɪ"),        # child, wild
    ("i", None, None, "ɪ"),
    ("o", None, "$", "oʊ"),
    ("o", None, "ld", "oʊ"),         # old, cold
    ("o", None, None, "ɑ"),
    ("u", None, None, "ʌ"),
    # --- single consonants ---
    ("b", None, None, "b"),
    ("c", None, "[eiy]", "s"),
    ("c", None, None, "k"),
    ("d", None, None, "d"),
    ("f", None, None, "f"),
    ("g", None, "[eiy]", "dʒ"),      # (get/give-class in lexicon)
    ("g", None, None, "ɡ"),
    ("h", _V, None, ""),             # silent post-vocalic h
    ("h", None, None, "h"),
    ("j", None, None, "dʒ"),
    ("k", None, None, "k"),
    ("l", None, None, "l"),
    ("m", None, None, "m"),
    ("n", None, "g$", "ŋ"),
    ("n", None, None, "n"),
    ("p", None, None, "p"),
    ("r", None, None, "ɹ"),
    ("s", _V, _V, "z"),              # intervocalic s is usually voiced
    ("s", None, None, "s"),
    ("t", None, None, "t"),
    ("v", None, None, "v"),
    ("w", None, None, "w"),
    ("x", "^$", None, "z"),          # xylophone
    ("x", None, None, "ks"),
    ("z", None, None, "z"),
    ("q", None, None, "k"),
    ("'", None, None, ""),
]

_COMPILED = [(g,
              re.compile(f"(?:{lc})$") if lc else None,
              re.compile(f"^(?:{rc})") if rc else None,
              ipa)
             for g, lc, rc, ipa in _RULES]

_FUNCTION_WORDS = {
    "the", "a", "an", "of", "to", "and", "in", "is", "it", "for", "on",
    "are", "as", "with", "his", "her", "its", "at", "be", "or", "by", "but",
    "not", "we", "he", "she", "they", "you", "i", "me", "him", "them", "us",
    "my", "your", "our", "their", "this", "that", "these", "those", "from",
    "was", "were", "been", "am", "do", "did", "does", "has", "have", "had",
    "will", "would", "can", "could", "shall", "should", "may", "might",
    "must", "if", "then", "than", "so", "no", "nor", "up", "out", "off",
}

_VOWEL_IPA = set("aeiouæɑɒɔʌəɛɜɪʊ")

_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
         "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
         "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
         "eighty", "ninety"]


def number_to_words(n: int) -> str:
    """Integer -> English words (enough for reading dates/counts aloud)."""
    if n < 0:
        return "minus " + number_to_words(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        t, o = divmod(n, 10)
        return _TENS[t] + (" " + _ONES[o] if o else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return _ONES[h] + " hundred" + (" " + number_to_words(r) if r else "")
    for scale, name in [(10 ** 9, "billion"), (10 ** 6, "million"),
                        (1000, "thousand")]:
        if n >= scale:
            big, r = divmod(n, scale)
            return (number_to_words(big) + " " + name +
                    (" " + number_to_words(r) if r else ""))
    return str(n)


_ORDINAL_IRREGULAR = {"one": "first", "two": "second", "three": "third",
                      "five": "fifth", "eight": "eighth", "nine": "ninth",
                      "twelve": "twelfth"}


def number_to_ordinal_words(n: int) -> str:
    """Integer -> English ordinal words ("21" -> "twenty first")."""
    words = number_to_words(n).split(" ")
    last = words[-1]
    if last in _ORDINAL_IRREGULAR:
        words[-1] = _ORDINAL_IRREGULAR[last]
    elif last.endswith("y"):
        words[-1] = last[:-1] + "ieth"
    else:
        words[-1] = last + "th"
    return " ".join(words)


def _read_time(m: "re.Match") -> str:
    """Clock times: 3:30 -> "three thirty", 9:05 am -> "nine oh five ay em"."""
    h, mnt, ampm = int(m.group(1)), int(m.group(2)), m.group(3)
    if h > 23 or mnt > 59:
        return m.group(0)
    out = number_to_words(h)
    if mnt == 0:
        if not ampm:
            out += " o'clock"
    elif mnt < 10:
        out += " owe " + number_to_words(mnt)
    else:
        out += " " + number_to_words(mnt)
    if ampm:
        out += " " + spell_out(ampm[0] + "m")
    return out


_TIME = re.compile(
    r"\b(\d{1,2}):(\d{2})(?:\s*([aApP])\.?[mM]\.?(?=[\W]|$))?(?!\d)")
_HOUR_AMPM = re.compile(r"\b(\d{1,2})\s*([aApP])\.?[mM]\.?(?=\W|$)")
_DOTTED_ABBREV = re.compile(r"\b(?:[A-Za-z]\.){2,}")
_ORDINAL = re.compile(r"\b(\d+)(?:st|nd|rd|th)\b")

# measurement units after a number ("5 km" -> "5 kilometers"); unit tokens
# are case-sensitive and only fire directly after a numeral, so prose words
# ("MS Word") and ambiguous single letters (m, g, l) are never touched
_UNITS = {
    "km/h": ("kilometer per hour", "kilometers per hour"),
    "mph": ("mile per hour", "miles per hour"),
    "kWh": ("kilowatt hour", "kilowatt hours"),
    "GHz": ("gigahertz", "gigahertz"), "MHz": ("megahertz", "megahertz"),
    "kHz": ("kilohertz", "kilohertz"), "Hz": ("hertz", "hertz"),
    "GB": ("gigabyte", "gigabytes"), "MB": ("megabyte", "megabytes"),
    "KB": ("kilobyte", "kilobytes"), "TB": ("terabyte", "terabytes"),
    "km": ("kilometer", "kilometers"), "cm": ("centimeter", "centimeters"),
    "mm": ("millimeter", "millimeters"), "kg": ("kilogram", "kilograms"),
    "mg": ("milligram", "milligrams"), "ml": ("milliliter", "milliliters"),
    "lbs": ("pounds", "pounds"), "lb": ("pound", "pounds"),
    "oz": ("ounce", "ounces"), "ft": ("foot", "feet"),
    "mi": ("mile", "miles"), "ms": ("millisecond", "milliseconds"),
}
_UNIT_RX = re.compile(
    r"(\d[\d,.]*)\s*(" + "|".join(sorted(map(re.escape, _UNITS),
                                         key=len, reverse=True))
    + r")(?![A-Za-z])")

# simple fractions between two small numbers ("3/4" -> "three quarters");
# three-part dates (3/4/2020) are excluded by the look-arounds
_FRACTION = re.compile(r"(?<![\d/.])(\d{1,2})/(\d{1,2})(?![\d/.])")
_FRACTION_DEN = {2: ("half", "halves"), 3: ("third", "thirds"),
                 4: ("quarter", "quarters")}

# digit-digit ranges read as "to" ("2-3 weeks", "1914-1918").  ADVICE
# r04: NOT for 3+-part hyphen chains (ISO dates 2024-01-15, phone numbers
# 555-867-5309) and only when the pair is range-shaped: left < right, and
# 3+-digit numbers must have equal widths (1914-1918 yes, 555-1234 no).
_RANGE = re.compile(r"(?<![\d––-])(\d+)\s*[-–]\s*(\d+)(?![-–\d])")


def _read_range(m: "re.Match") -> str:
    left, right = m.group(1), m.group(2)
    if int(left) < int(right) and (len(left) < 3 or len(left) == len(right)):
        return f"{left} to {right}"
    return m.group(0)

# four-digit years after a year-selecting word read in two-pair style
# ("in 1984" -> "in nineteen eighty four"); bare numbers elsewhere keep
# the cardinal reading
_YEAR = re.compile(
    r"\b((?:[Ii]n|[Bb]y|[Ss]ince|[Uu]ntil|[Ff]rom|[Dd]uring|"
    r"[Aa]round|[Yy]ear|[Ll]ate|[Ee]arly|[Mm]id)[\s-])"
    r"((?:1[1-9]|20)\d\d)\b")

# "of <year>" only after a season/month/era head ("summer of 1969",
# "class of 1984") — bare "of" is the least year-selective trigger
# (ADVICE r04: "a total of 1984 items" read as a year)
_YEAR_OF = re.compile(
    r"\b((?:[Ss]ummer|[Ww]inter|[Ss]pring|[Ff]all|[Aa]utumn|[Cc]lass|"
    r"[Ee]nd|[Bb]eginning|[Jj]anuary|[Ff]ebruary|[Mm]arch|[Aa]pril|"
    r"[Mm]ay|[Jj]une|[Jj]uly|[Aa]ugust|[Ss]eptember|[Oo]ctober|"
    r"[Nn]ovember|[Dd]ecember)\s+of\s+)((?:1[1-9]|20)\d\d)\b")

# Roman numerals after a capitalized word ("Henry VIII", "World War II",
# "Chapter IV") read as numbers; lone "I" stays the pronoun
_ROMAN_EN = re.compile(r"\b([A-Z][a-zA-Z]+)\s+(X{0,3}(?:IX|IV|V?I{1,3}|V|X))\b")
_ROMAN_VALUES = {"I": 1, "V": 5, "X": 10}


# single-letter numerals (V, X) are false-positive-prone ("Malcolm X"):
# they convert only after a numbering head word (ADVICE r04)
_ROMAN_HEADS = {"chapter", "act", "part", "war", "section", "phase",
                "volume", "book", "grade", "type", "mark", "class",
                "stage", "level", "article", "appendix", "title",
                "henry", "george", "edward", "louis", "charles", "james",
                "william", "richard", "pope", "king", "queen", "paul",
                "leo", "benedict", "pius", "napoleon", "philip"}


def _read_roman_en(m: "re.Match") -> str:
    head, numeral = m.group(1), m.group(2)
    if numeral == "I":  # lone "I" stays the pronoun
        return m.group(0)
    if len(numeral) == 1 and head.lower() not in _ROMAN_HEADS:
        return m.group(0)  # "Malcolm X" keeps the letter
    return head + " " + number_to_words(_roman_value(numeral))


def _roman_value(s: str) -> int:
    total = 0
    for i, c in enumerate(s):
        v = _ROMAN_VALUES[c]
        total += -v if i + 1 < len(s) and _ROMAN_VALUES[s[i + 1]] > v else v
    return total


def _read_year(n: int) -> str:
    h, r = divmod(n, 100)
    if n % 1000 == 0 or (h == 20 and 0 < r < 10):
        return number_to_words(n)      # 2000, 2005 ("two thousand five")
    out = number_to_words(h)
    if r == 0:
        out += " hundred"              # 1900 "nineteen hundred"
    elif r < 10:
        out += " owe " + number_to_words(r)  # 1906 "nineteen oh six"
    else:
        out += " " + number_to_words(r)      # 1984 "nineteen eighty four"
    return out


def _read_fraction(m: "re.Match") -> str:
    num, den = int(m.group(1)), int(m.group(2))
    if den in _FRACTION_DEN and 0 < num:
        d = _FRACTION_DEN[den][0 if num == 1 else 1]
        return number_to_words(num) + " " + d
    return number_to_words(num) + " over " + number_to_words(den)


def _normalize_english(text: str) -> str:
    """espeak-style readings for times, ordinals, dotted abbreviations and
    "No. 5" (the reference delegates all of this to espeak,
    ``Preprocessing/TextFrontend.py:298``)."""
    text = _TIME.sub(_read_time, text)
    text = _HOUR_AMPM.sub(
        lambda m: number_to_words(int(m.group(1))) + " "
        + spell_out(m.group(2) + "m"),
        text)
    text = _ROMAN_EN.sub(_read_roman_en, text)
    text = _YEAR.sub(lambda m: m.group(1) + _read_year(int(m.group(2))), text)
    text = _YEAR_OF.sub(lambda m: m.group(1) + _read_year(int(m.group(2))),
                        text)
    text = _RANGE.sub(_read_range, text)
    text = _FRACTION.sub(_read_fraction, text)
    text = _UNIT_RX.sub(
        lambda m: m.group(1) + " "
        + _UNITS[m.group(2)][0 if m.group(1) == "1" else 1],
        text)
    text = _DOTTED_ABBREV.sub(
        lambda m: spell_out(re.sub(r"\.", "", m.group(0))), text)
    text = _ORDINAL.sub(lambda m: number_to_ordinal_words(int(m.group(1))),
                        text)
    text = re.sub(r"\bNo\.\s*(?=\d)", "number ", text)
    # decades: "the 1980s" -> "nineteen eighties", "the 80s" -> "eighties"
    text = re.sub(
        r"\b(?:([12]\d)|)([2-9]0)s\b",
        lambda m: ((number_to_words(int(m.group(1))) + " ") if m.group(1)
                   else "") + _TENS[int(m.group(2)) // 10][:-1] + "ies",
        text)
    return text


def _spell_out_numbers(text: str) -> str:
    # English conventions: "," groups thousands (1,000 -> 1000);
    # "." reads as "point" with the fraction digit by digit
    text = re.sub(r"(\d{1,3})(?:,(?=\d{3}))((?:\d{3},?)*\d{3})(?!\d)",
                  lambda m: m.group(1) + m.group(2).replace(",", ""), text)
    text = re.sub(
        r"(\d+)\.(\d+)(?!\d)",
        lambda m: f"{m.group(1)} point "
                  + " ".join(number_to_words(int(d)) for d in m.group(2)),
        text)
    return re.sub(r"\d+", lambda m: number_to_words(int(m.group())), text)


def _letters_to_sounds(word: str) -> str:
    out = []
    i = 0
    n = len(word)
    while i < n:
        for g, lc, rc, ipa in _COMPILED:
            if not word.startswith(g, i):
                continue
            if lc is not None and not lc.search(word[:i]):
                continue
            if rc is not None and not rc.search(word[i + len(g):]):
                continue
            out.append(ipa)
            i += len(g)
            break
        else:
            i += 1  # unknown character: skip
    return "".join(out)


_VOICELESS = set("ptkfθsʃ")


def _fix_ed_es(word: str, ipa: str) -> str:
    """Regular-inflection phonology: -ed -> t/d/ɪd, -es -> s/z/ɪz."""
    if word.endswith("ed") and len(word) > 3 and ipa.endswith("əd"):
        stem = ipa[:-2]
        if stem.endswith(("t", "d")):
            return stem + "ɪd"
        if stem and stem[-1] in _VOICELESS:
            return stem + "t"
        return stem + "d"
    if word.endswith("s") and not word.endswith("ss") and ipa.endswith("s"):
        stem = ipa[:-1]
        if stem.endswith(("s", "z", "ʃ", "ʒ", "tʃ", "dʒ")):
            return stem + "ɪz"
        if stem and stem[-1] not in _VOICELESS:
            return stem + "z"
    return ipa


def _add_stress(word: str, ipa: str) -> str:
    """Primary stress on the first vowel of content words (heuristic; the
    reference's espeak has true lexical stress)."""
    if word in _FUNCTION_WORDS or "ˈ" in ipa:
        return ipa
    for i, ch in enumerate(ipa):
        if ch in _VOWEL_IPA:
            return ipa[:i] + "ˈ" + ipa[i:]
    return ipa


def _word_to_ipa(word: str) -> str:
    base = word.lower()
    if base in _EXCEPTIONS:
        return _EXCEPTIONS[base]
    # simple inflections of lexicon words: -s / -'s / -ed / -ing / -ly
    if base.endswith("'s") and base[:-2] in _EXCEPTIONS:
        stem = _EXCEPTIONS[base[:-2]]
        return _fix_ed_es(base[:-1], stem + "s")
    if base.endswith("s") and base[:-1] in _EXCEPTIONS:
        return _fix_ed_es(base, _EXCEPTIONS[base[:-1]] + "s")
    if base.endswith("ed") and base[:-2] in _EXCEPTIONS:
        return _fix_ed_es(base, _EXCEPTIONS[base[:-2]] + "əd")
    if base.endswith("ing") and base[:-3] in _EXCEPTIONS:
        return _EXCEPTIONS[base[:-3]] + "ɪŋ"
    if base.endswith("ly") and base[:-2] in _EXCEPTIONS:
        return _EXCEPTIONS[base[:-2]] + "li"
    # double consonant letters are single phones (hello, missing, battle)
    collapsed = re.sub(r"([bcdfghjklmnpqrstvz])\1", r"\1", base)
    ipa = _letters_to_sounds(collapsed)
    ipa = _fix_ed_es(base, ipa)
    return _add_stress(base, ipa)


_TOKEN = re.compile(r"[a-zA-Z']+|[^\sa-zA-Z']")

_VOWEL_LETTERS = set("aeiouy")


def _is_spelled_acronym(tok: str, mixed_case: bool = True) -> bool:
    """All-caps tokens read letter by letter (espeak behavior): always when
    they contain no vowel letter ("TV", "BBC"), and for short ones ("USA",
    "UK") unless they are known pronounceable acronyms ("NASA").  In fully
    uppercase text (``mixed_case=False``, e.g. "THE END") capitalization is
    styling, not acronym evidence — only vowelless tokens spell there."""
    if len(tok) < 2 or not tok.isupper() or not tok.isalpha():
        return False
    low = tok.lower()
    if low in _PRONOUNCED_ACRONYMS:
        return False
    if not any(c in _VOWEL_LETTERS for c in low):
        return True
    return mixed_case and len(tok) <= 3 and low not in _EXCEPTIONS


def phonemize_english(text: str) -> str:
    """Plain English text -> IPA string (words space-separated, punctuation
    kept in place for the frontend's pause handling)."""
    from bench_h100.reference.frontend.symbols import expand_symbols

    text = expand_symbols(text, "en")
    text = _normalize_english(text)
    text = _spell_out_numbers(text)
    pieces = []
    # fully-uppercase MULTI-WORD text is styling ("THE END"); a lone
    # all-caps token ("USA") is acronym evidence regardless
    words = re.findall(r"[a-zA-Z']+", text)
    mixed_case = any(c.islower() for c in text) or len(words) < 2
    for tok in _TOKEN.findall(text):
        if tok[0].isalpha() or tok[0] == "'":
            if _is_spelled_acronym(tok, mixed_case):
                pieces.append(" ".join(_word_to_ipa(w)
                                       for w in spell_out(tok).split(" ")))
            else:
                pieces.append(_word_to_ipa(tok))
        else:
            # punctuation attaches to the previous word like espeak's output
            if pieces:
                pieces[-1] += tok
            else:
                pieces.append(tok)
    return " ".join(p for p in pieces if p)
