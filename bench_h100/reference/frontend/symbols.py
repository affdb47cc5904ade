"""Symbol reading: %, currency signs and degrees, per language.

espeak (the reference's G2P backend, ``Preprocessing/TextFrontend.py:298``)
reads "50%" as "fifty percent" and "$5" as "five dollars"; the first-party
G2P paths previously dropped the signs.  ``expand_symbols`` rewrites the
symbols to words BEFORE numeral expansion (``frontend/numbers.py``), so
"20€" becomes "twenty euros" end-to-end.

Conventions: currency signs read after the amount regardless of written
order ("$5" -> "5 dollars"); singular forms apply at exactly 1 where the
language inflects; Slavic counts use the genitive-plural form (the most
common case after numerals — a full case grammar is out of scope and
documented in G2P.md).  Mandarin is handled in pinyin space by the caller
(百分之 prefixing is structural, not lexical).
"""

from __future__ import annotations

import re

# lang -> {symbol: (singular, plural)}; one form = invariant
_WORDS = {
    "en": {"%": "percent", "$": ("dollar", "dollars"),
           "€": ("euro", "euros"), "£": ("pound", "pounds"),
           "°": ("degree", "degrees"), "&": "and", "+": "plus"},
    "es": {"%": "por ciento", "$": ("dólar", "dólares"),
           "€": ("euro", "euros"), "£": ("libra", "libras"),
           "°": ("grado", "grados"), "&": "y", "+": "más"},
    "de": {"%": "Prozent", "$": "Dollar", "€": "Euro", "£": "Pfund",
           "°": "Grad", "&": "und", "+": "plus"},
    "fr": {"%": "pour cent", "$": ("dollar", "dollars"),
           "€": ("euro", "euros"), "£": ("livre", "livres"),
           "°": ("degré", "degrés"), "&": "et", "+": "plus"},
    "it": {"%": "per cento", "$": ("dollaro", "dollari"), "€": "euro",
           "£": ("sterlina", "sterline"), "°": ("grado", "gradi"),
           "&": "e", "+": "più"},
    "pt": {"%": "por cento", "$": ("dólar", "dólares"),
           "€": ("euro", "euros"), "£": ("libra", "libras"),
           "°": ("grau", "graus"), "&": "e", "+": "mais"},
    "nl": {"%": "procent", "$": "dollar", "€": "euro", "£": "pond",
           "°": ("graad", "graden"), "&": "en", "+": "plus"},
    "pl": {"%": "procent", "$": ("dolar", "dolary", "dolarów"),
           "€": "euro", "£": ("funt", "funty", "funtów"),
           "°": ("stopień", "stopnie", "stopni"), "&": "i", "+": "plus"},
    "ru": {"%": ("процент", "процента", "процентов"),
           "$": ("доллар", "доллара", "долларов"), "€": "евро",
           "£": ("фунт", "фунта", "фунтов"),
           "°": ("градус", "градуса", "градусов"), "&": "и", "+": "плюс"},
    "uk": {"%": ("відсоток", "відсотки", "відсотків"),
           "$": ("долар", "долари", "доларів"), "€": "євро",
           "£": ("фунт", "фунти", "фунтів"),
           "°": ("градус", "градуси", "градусів"), "&": "і", "+": "плюс"},
    "fi": {"%": "prosenttia", "$": "dollaria", "€": "euroa",
           "£": "puntaa", "°": "astetta", "&": "ja", "+": "plus"},
    "hu": {"%": "százalék", "$": "dollár", "€": "euró", "£": "font",
           "°": "fok", "&": "és", "+": "plusz"},
    "el": {"%": "τοις εκατό", "$": "δολάρια", "€": "ευρώ",
           "£": "λίρες", "°": "βαθμοί", "&": "και", "+": "συν"},
    "vi": {"%": "phần trăm", "$": "đô la", "€": "euro", "£": "bảng",
           "°": "độ", "&": "và", "+": "cộng"},
    "fa": {"%": "درصد", "$": "دلار", "€": "یورو", "£": "پوند",
           "°": "درجه", "&": "و", "+": "به‌علاوه"},
}
_WORDS["pt-br"] = _WORDS["pt"]

# metric units after a numeral ("5 km" -> "5 kilómetros"); English is
# handled in g2p_en.py (imperial + tech units there).  Forms: str =
# invariant, 2-tuple = (singular, plural), 3-tuple = Slavic
# (singular, paucal 2-4, genitive plural 5+).
_UNIT_WORDS = {
    "es": {"km": ("kilómetro", "kilómetros"),
           "cm": ("centímetro", "centímetros"),
           "mm": ("milímetro", "milímetros"),
           "kg": ("kilogramo", "kilogramos"),
           "mg": ("miligramo", "miligramos"),
           "ml": ("mililitro", "mililitros")},
    "de": {"km": "Kilometer", "cm": "Zentimeter", "mm": "Millimeter",
           "kg": "Kilogramm", "mg": "Milligramm", "ml": "Milliliter"},
    "fr": {"km": ("kilomètre", "kilomètres"),
           "cm": ("centimètre", "centimètres"),
           "mm": ("millimètre", "millimètres"),
           "kg": ("kilogramme", "kilogrammes"),
           "mg": ("milligramme", "milligrammes"),
           "ml": ("millilitre", "millilitres")},
    "it": {"km": ("chilometro", "chilometri"),
           "cm": ("centimetro", "centimetri"),
           "mm": ("millimetro", "millimetri"),
           "kg": ("chilogrammo", "chilogrammi"),
           "mg": ("milligrammo", "milligrammi"),
           "ml": ("millilitro", "millilitri")},
    "pt": {"km": ("quilómetro", "quilómetros"),
           "cm": ("centímetro", "centímetros"),
           "mm": ("milímetro", "milímetros"),
           "kg": ("quilograma", "quilogramas"),
           "mg": ("miligrama", "miligramas"),
           "ml": ("mililitro", "mililitros")},
    "pt-br": {"km": ("quilômetro", "quilômetros"),
              "cm": ("centímetro", "centímetros"),
              "mm": ("milímetro", "milímetros"),
              "kg": ("quilograma", "quilogramas"),
              "mg": ("miligrama", "miligramas"),
              "ml": ("mililitro", "mililitros")},
    "nl": {"km": "kilometer", "cm": "centimeter", "mm": "millimeter",
           "kg": "kilogram", "mg": "milligram", "ml": "milliliter"},
    "pl": {"zł": ("złoty", "złote", "złotych"),
           "km": ("kilometr", "kilometry", "kilometrów"),
           "cm": ("centymetr", "centymetry", "centymetrów"),
           "mm": ("milimetr", "milimetry", "milimetrów"),
           "kg": ("kilogram", "kilogramy", "kilogramów"),
           "mg": ("miligram", "miligramy", "miligramów"),
           "ml": ("mililitr", "mililitry", "mililitrów")},
    "ru": {"km": ("километр", "километра", "километров"),
           "cm": ("сантиметр", "сантиметра", "сантиметров"),
           "mm": ("миллиметр", "миллиметра", "миллиметров"),
           "kg": ("килограмм", "килограмма", "килограммов"),
           "mg": ("миллиграмм", "миллиграмма", "миллиграммов"),
           "ml": ("миллилитр", "миллилитра", "миллилитров")},
    "uk": {"km": ("кілометр", "кілометри", "кілометрів"),
           "cm": ("сантиметр", "сантиметри", "сантиметрів"),
           "mm": ("міліметр", "міліметри", "міліметрів"),
           "kg": ("кілограм", "кілограми", "кілограмів"),
           "mg": ("міліграм", "міліграми", "міліграмів"),
           "ml": ("мілілітр", "мілілітри", "мілілітрів")},
    "fi": {"km": ("kilometri", "kilometriä"),
           "cm": ("senttimetri", "senttimetriä"),
           "mm": ("millimetri", "millimetriä"),
           "kg": ("kilogramma", "kilogrammaa"),
           "mg": ("milligramma", "milligrammaa"),
           "ml": ("millilitra", "millilitraa")},
    "hu": {"km": "kilométer", "cm": "centiméter", "mm": "milliméter",
           "kg": "kilogramm", "mg": "milligramm", "ml": "milliliter"},
    "el": {"km": ("χιλιόμετρο", "χιλιόμετρα"),
           "cm": ("εκατοστό", "εκατοστά"),
           "mm": ("χιλιοστό", "χιλιοστά"),
           "kg": ("κιλό", "κιλά")},
    "vi": {"km": "ki lô mét", "cm": "xăng ti mét", "mm": "mi li mét",
           "kg": "ki lô gam", "mg": "mi li gam", "ml": "mi li lít"},
    "fa": {"km": "کیلومتر", "cm": "سانتی متر", "mm": "میلی متر",
           "kg": "کیلوگرم", "mg": "میلی گرم", "ml": "میلی لیتر"},
}

# Cyrillic spellings alias to the same unit rows (ru/uk texts write кг)
_UNIT_ALIAS = {"км": "km", "см": "cm", "мм": "mm", "кг": "kg",
               "мг": "mg", "мл": "ml"}
_UNIT_RX = re.compile(
    r"(\d+(?:[.,]\d+)?)\s?(km|cm|mm|kg|mg|ml|км|см|мм|кг|мг|мл|zł)"
    r"(?![\w])")

_CURRENCY = "€$£"
_DEGREE_SCALE = {"C": {"en": "Celsius", "de": "Celsius", "fr": "Celsius",
                       "es": "Celsius", "ru": "Цельсия", "uk": "Цельсія",
                       "pl": "Celsjusza", "el": "Κελσίου",
                       "fa": "سلسیوس", "default": "Celsius"},
                 "F": {"ru": "Фаренгейта", "uk": "Фаренгейта",
                       "pl": "Fahrenheita", "default": "Fahrenheit"}}


def _count_form(w, n: int | None):
    """Pick the inflected form for count ``n`` (None = unknown/decimal)."""
    if not isinstance(w, tuple):
        return w
    if len(w) == 3:  # Slavic: singular / paucal 2-4 / genitive plural
        if n is None:
            # decimal amounts govern the genitive SINGULAR (= the paucal
            # form): "21,5 градуса", not "градусов" (ADVICE r04)
            return w[1]
        if n % 10 == 1 and n % 100 != 11:
            return w[0]
        if n % 10 in (2, 3, 4) and n % 100 not in (12, 13, 14):
            return w[1]
        return w[2]
    return w[0] if n == 1 else w[1]


def _form(words, sym: str, n: int | None):
    return _count_form(words[sym], n)


def _apocope_amount(amount: str, n: int | None, lang: str) -> str:
    """Word a count ending in 1 before a noun in es/de/it ("un kilómetro",
    "veintiún dólares", "ein Dollar") — the later digit->word pass cannot
    see the following noun, so these counts are worded here."""
    if lang not in ("es", "de", "it") or n is None \
            or n % 10 != 1 or n % 100 == 11:
        return amount
    from bench_h100.reference.frontend.numbers import number_to_words
    words = number_to_words(n, lang)
    if lang == "es":
        # compound "veintiuno" -> "veintiún" (written accent);
        # free-standing "uno" / "treinta y uno" -> "un"
        words = re.sub(r"(\w)uno$", r"\1ún", words)
        words = re.sub(r"(^| )uno$", r"\1un", words)
    elif words in ("eins", "uno"):
        words = {"de": "ein", "it": "un"}[lang]
    return words


def expand_symbols(text: str, lang: str) -> str:
    """Rewrite %, currency and degree signs into words for ``lang``;
    unknown languages return the text unchanged."""
    words = _WORDS.get(lang)
    if words is None:
        return text

    def num_of(s):
        try:
            return int(s)
        except ValueError:
            return None

    # $5 / €20 / £3 (sign before amount) -> "5 dollars"
    def pre_currency(m):
        sym, amount = m.group(1), m.group(2)
        n = num_of(amount)
        return f"{_apocope_amount(amount, n, lang)} {_form(words, sym, n)}"

    text = re.sub(r"([€$£])\s?(\d+(?:[.,]\d+)?)", pre_currency, text)

    # 20€ (amount before sign)
    def post_currency(m):
        amount, sym = m.group(1), m.group(2)
        n = num_of(amount)
        return f"{_apocope_amount(amount, n, lang)} {_form(words, sym, n)}"

    text = re.sub(r"(\d+(?:[.,]\d+)?)\s?([€$£])", post_currency, text)

    # 20°C / 20° -> "20 degrees Celsius" / "20 degrees"
    def degrees(m):
        amount, scale = m.group(1), m.group(2)
        n = num_of(amount)
        deg = _form(words, "°", n)
        amount = _apocope_amount(amount, n, lang)
        if scale:
            table = _DEGREE_SCALE.get(scale.upper(), {})
            return f"{amount} {deg} {table.get(lang, table.get('default', scale))}"
        return f"{amount} {deg}"

    text = re.sub(r"(\d+(?:[.,]\d+)?)\s?°\s?([CF])?", degrees, text)

    # 50% -> "50 percent"; standalone signs read as their word too
    def percent(m):
        return f"{m.group(1)} {_form(words, '%', num_of(m.group(1)))}"

    text = re.sub(r"(\d+(?:[.,]\d+)?)\s?%", percent, text)

    # 5 km / 10kg -> "5 kilómetros" (inflected by count)
    units = _UNIT_WORDS.get(lang)
    if units:
        def unit_sub(m):
            unit = _UNIT_ALIAS.get(m.group(2), m.group(2))
            if unit not in units:
                return m.group(0)
            n = num_of(m.group(1))
            amount = _apocope_amount(m.group(1), n, lang)
            return f"{amount} {_count_form(units[unit], n)}"

        text = _UNIT_RX.sub(unit_sub, text)
    for sym in "%&+" + _CURRENCY:
        if sym in text:
            text = text.replace(sym, f" {_form(words, sym, None)} ")
    return re.sub(r"\s+", " ", text)
