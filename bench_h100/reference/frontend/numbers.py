"""Full-numeral number reading for the first-party G2P languages.

The reference reads numbers through espeak-ng's per-language numeral
expansion (behind ``Preprocessing/TextFrontend.py:298`` — espeak reads
"25" as "veinticinco", "1984" as a full German numeral).  Round 3's rule
G2P read digits one by one ("dos cinco"), a user-audible regression for
dates, years and prices; this module closes it with per-language number
grammars (VERDICT r03 #4).

``number_to_words(n, lang)`` covers 0..999 999 for every rule-G2P
language (es it fi el hu pl nl de ru pt pt-br fr vi uk fa) — the output is
ORTHOGRAPHIC text in the language's own script, which then flows through
the same ruleset/lexicon path as any other word (so the IPA stays
consistent with the rest of the G2P).  English has its own reader in
``frontend/g2p_en.py::number_to_words`` (same contract).

Slavic thousands use the correct plural class (tysiąc/tysiące/tysięcy,
тысяча/тысячи/тысяч); Romance hundreds use the irregular forms
(quinientos, seicento...); Germanic composition is unit-before-ten
(einundzwanzig, drieëntwintig).  Documented simplifications: French
"deux cent" is written without the plural -s (inaudible), Vietnamese
reads 4 as "bốn" in all positions (colloquial "tư" after mươi is
skipped), Greek uses the neuter forms throughout.
"""

from __future__ import annotations

# ------------------------------------------------------------------ Spanish

_ES_UNITS = ["cero", "uno", "dos", "tres", "cuatro", "cinco", "seis",
             "siete", "ocho", "nueve", "diez", "once", "doce", "trece",
             "catorce", "quince", "dieciséis", "diecisiete", "dieciocho",
             "diecinueve", "veinte", "veintiuno", "veintidós", "veintitrés",
             "veinticuatro", "veinticinco", "veintiséis", "veintisiete",
             "veintiocho", "veintinueve"]
_ES_TENS = [None, None, None, "treinta", "cuarenta", "cincuenta", "sesenta",
            "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = [None, "ciento", "doscientos", "trescientos",
                "cuatrocientos", "quinientos", "seiscientos", "setecientos",
                "ochocientos", "novecientos"]


def _es(n: int) -> str:
    if n < 30:
        return _ES_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _ES_TENS[t] + (f" y {_ES_UNITS[u]}" if u else "")
    if n < 1000:
        h, r = divmod(n, 100)
        if n == 100:
            return "cien"
        return _ES_HUNDREDS[h] + (f" {_es(r)}" if r else "")
    th, r = divmod(n, 1000)
    head = "mil" if th == 1 else f"{_es(th)} mil"
    return head + (f" {_es(r)}" if r else "")


# ------------------------------------------------------------------ Italian

_IT_UNITS = ["zero", "uno", "due", "tre", "quattro", "cinque", "sei",
             "sette", "otto", "nove", "dieci", "undici", "dodici", "tredici",
             "quattordici", "quindici", "sedici", "diciassette", "diciotto",
             "diciannove"]
_IT_TENS = [None, None, "venti", "trenta", "quaranta", "cinquanta",
            "sessanta", "settanta", "ottanta", "novanta"]


def _it(n: int) -> str:
    if n < 20:
        return _IT_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        tens = _IT_TENS[t]
        if u in (1, 8):  # elision: ventuno, ventotto
            tens = tens[:-1]
        unit = _IT_UNITS[u] if u else ""
        if u == 3:
            unit = "tré"  # ventitré (accented in composition)
        return tens + unit
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("cento" if h == 1 else _IT_UNITS[h] + "cento")
        rest = _it(r) if r else ""
        if rest.startswith("o"):  # centottanta elision
            head = head[:-1]
        return head + rest
    th, r = divmod(n, 1000)
    head = "mille" if th == 1 else f"{_it(th)}mila"
    return head + (_it(r) if r else "")


# ------------------------------------------------------------------ French

_FR_UNITS = ["zéro", "un", "deux", "trois", "quatre", "cinq", "six", "sept",
             "huit", "neuf", "dix", "onze", "douze", "treize", "quatorze",
             "quinze", "seize", "dix-sept", "dix-huit", "dix-neuf"]
_FR_TENS = [None, None, "vingt", "trente", "quarante", "cinquante",
            "soixante"]


def _fr(n: int) -> str:
    if n < 20:
        return _FR_UNITS[n]
    if n < 70:
        t, u = divmod(n, 10)
        if u == 1:
            return f"{_FR_TENS[t]} et un"
        return _FR_TENS[t] + (f"-{_FR_UNITS[u]}" if u else "")
    if n < 80:  # soixante-dix .. soixante-dix-neuf (vigesimal tail)
        if n == 71:
            return "soixante et onze"
        return "soixante-" + _FR_UNITS[n - 60]
    if n < 100:
        if n == 80:
            return "quatre-vingts"
        return "quatre-vingt-" + _FR_UNITS[n - 80]
    if n < 1000:
        h, r = divmod(n, 100)
        head = "cent" if h == 1 else f"{_FR_UNITS[h]} cent"
        return head + (f" {_fr(r)}" if r else "")
    th, r = divmod(n, 1000)
    head = "mille" if th == 1 else f"{_fr(th)} mille"
    return head + (f" {_fr(r)}" if r else "")


# --------------------------------------------------------------- Portuguese

_PT_UNITS = ["zero", "um", "dois", "três", "quatro", "cinco", "seis",
             "sete", "oito", "nove", "dez", "onze", "doze", "treze",
             "catorze", "quinze", "dezesseis", "dezessete", "dezoito",
             "dezenove"]
_PT_TENS = [None, None, "vinte", "trinta", "quarenta", "cinquenta",
            "sessenta", "setenta", "oitenta", "noventa"]
_PT_HUNDREDS = [None, "cento", "duzentos", "trezentos", "quatrocentos",
                "quinhentos", "seiscentos", "setecentos", "oitocentos",
                "novecentos"]


def _pt(n: int) -> str:
    if n < 20:
        return _PT_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _PT_TENS[t] + (f" e {_PT_UNITS[u]}" if u else "")
    if n < 1000:
        if n == 100:
            return "cem"
        h, r = divmod(n, 100)
        return _PT_HUNDREDS[h] + (f" e {_pt(r)}" if r else "")
    th, r = divmod(n, 1000)
    head = "mil" if th == 1 else f"{_pt(th)} mil"
    if not r:
        return head
    # "e" after mil only before a final group under 100 or exact hundreds
    joiner = " e " if (r < 100 or r % 100 == 0) else " "
    return head + joiner + _pt(r)


# ------------------------------------------------------------------- German

_DE_UNITS = ["null", "eins", "zwei", "drei", "vier", "fünf", "sechs",
             "sieben", "acht", "neun", "zehn", "elf", "zwölf", "dreizehn",
             "vierzehn", "fünfzehn", "sechzehn", "siebzehn", "achtzehn",
             "neunzehn"]
_DE_TENS = [None, None, "zwanzig", "dreißig", "vierzig", "fünfzig",
            "sechzig", "siebzig", "achtzig", "neunzig"]


def _de(n: int) -> str:
    if n < 20:
        return _DE_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        if not u:
            return _DE_TENS[t]
        unit = "ein" if u == 1 else _DE_UNITS[u]
        return f"{unit}und{_DE_TENS[t]}"
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("ein" if h == 1 else _DE_UNITS[h]) + "hundert"
        return head + (_de(r) if r else "")
    th, r = divmod(n, 1000)
    head = ("ein" if th == 1 else _de(th)) + "tausend"
    return head + (_de(r) if r else "")


# -------------------------------------------------------------------- Dutch

_NL_UNITS = ["nul", "een", "twee", "drie", "vier", "vijf", "zes", "zeven",
             "acht", "negen", "tien", "elf", "twaalf", "dertien", "veertien",
             "vijftien", "zestien", "zeventien", "achttien", "negentien"]
_NL_TENS = [None, None, "twintig", "dertig", "veertig", "vijftig", "zestig",
            "zeventig", "tachtig", "negentig"]


def _nl(n: int) -> str:
    if n < 20:
        return _NL_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        if not u:
            return _NL_TENS[t]
        unit = _NL_UNITS[u]
        joiner = "ën" if unit[-1] in "aeiou" else "en"  # tweeëntwintig
        return f"{unit}{joiner}{_NL_TENS[t]}"
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("honderd" if h == 1 else _NL_UNITS[h] + "honderd")
        return head + (_nl(r) if r else "")
    th, r = divmod(n, 1000)
    head = "duizend" if th == 1 else f"{_nl(th)}duizend"
    return head + (f" {_nl(r)}" if r else "")


# ------------------------------------------------------------------ Finnish

_FI_UNITS = ["nolla", "yksi", "kaksi", "kolme", "neljä", "viisi", "kuusi",
             "seitsemän", "kahdeksan", "yhdeksän", "kymmenen"]


def _fi(n: int) -> str:
    if n <= 10:
        return _FI_UNITS[n]
    if n < 20:
        return _FI_UNITS[n - 10] + "toista"
    if n < 100:
        t, u = divmod(n, 10)
        return _FI_UNITS[t] + "kymmentä" + (_FI_UNITS[u] if u else "")
    if n < 1000:
        h, r = divmod(n, 100)
        head = "sata" if h == 1 else _FI_UNITS[h] + "sataa"
        return head + (_fi(r) if r else "")
    th, r = divmod(n, 1000)
    head = "tuhat" if th == 1 else f"{_fi(th)}tuhatta"
    return head + (_fi(r) if r else "")


# ---------------------------------------------------------------- Hungarian

_HU_UNITS = ["nulla", "egy", "kettő", "három", "négy", "öt", "hat", "hét",
             "nyolc", "kilenc", "tíz"]
_HU_TEEN = ["", "tizenegy", "tizenkettő", "tizenhárom", "tizennégy",
            "tizenöt", "tizenhat", "tizenhét", "tizennyolc", "tizenkilenc"]
_HU_TENS = [None, None, "húsz", "harminc", "negyven", "ötven", "hatvan",
            "hetven", "nyolcvan", "kilencven"]
_HU_TWENTY = ["", "huszonegy", "huszonkettő", "huszonhárom", "huszonnégy",
              "huszonöt", "huszonhat", "huszonhét", "huszonnyolc",
              "huszonkilenc"]


def _hu(n: int) -> str:
    if n <= 10:
        return _HU_UNITS[n]
    if n < 20:
        return _HU_TEEN[n - 10]
    if n < 30:
        return "húsz" if n == 20 else _HU_TWENTY[n - 20]
    if n < 100:
        t, u = divmod(n, 10)
        return _HU_TENS[t] + (_HU_UNITS[u] if u else "")
    if n < 1000:
        h, r = divmod(n, 100)
        head = ("száz" if h == 1
                else ("két" if h == 2 else _HU_UNITS[h]) + "száz")
        return head + (_hu(r) if r else "")
    th, r = divmod(n, 1000)
    head = ("ezer" if th == 1
            else ("két" if th == 2 else _hu(th)) + "ezer")
    return head + (_hu(r) if r else "")


# -------------------------------------------------------------------- Greek

_EL_UNITS = ["μηδέν", "ένα", "δύο", "τρία", "τέσσερα", "πέντε", "έξι",
             "επτά", "οκτώ", "εννέα", "δέκα", "έντεκα", "δώδεκα"]
_EL_TEEN = {13: "δεκατρία", 14: "δεκατέσσερα", 15: "δεκαπέντε",
            16: "δεκαέξι", 17: "δεκαεπτά", 18: "δεκαοκτώ", 19: "δεκαεννέα"}
_EL_TENS = [None, None, "είκοσι", "τριάντα", "σαράντα", "πενήντα",
            "εξήντα", "εβδομήντα", "ογδόντα", "ενενήντα"]
_EL_HUNDREDS = [None, "εκατό", "διακόσια", "τριακόσια", "τετρακόσια",
                "πεντακόσια", "εξακόσια", "επτακόσια", "οκτακόσια",
                "εννιακόσια"]


def _el(n: int) -> str:
    if n <= 12:
        return _EL_UNITS[n]
    if n < 20:
        return _EL_TEEN[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _EL_TENS[t] + (f" {_EL_UNITS[u]}" if u else "")
    if n < 1000:
        h, r = divmod(n, 100)
        head = _EL_HUNDREDS[h]
        if h == 1 and r:
            head = "εκατόν"
        return head + (f" {_el(r)}" if r else "")
    th, r = divmod(n, 1000)
    head = "χίλια" if th == 1 else f"{_el(th)} χιλιάδες"
    return head + (f" {_el(r)}" if r else "")


# ------------------------------------------------------------------- Polish

_PL_UNITS = ["zero", "jeden", "dwa", "trzy", "cztery", "pięć", "sześć",
             "siedem", "osiem", "dziewięć", "dziesięć", "jedenaście",
             "dwanaście", "trzynaście", "czternaście", "piętnaście",
             "szesnaście", "siedemnaście", "osiemnaście", "dziewiętnaście"]
_PL_TENS = [None, None, "dwadzieścia", "trzydzieści", "czterdzieści",
            "pięćdziesiąt", "sześćdziesiąt", "siedemdziesiąt",
            "osiemdziesiąt", "dziewięćdziesiąt"]
_PL_HUNDREDS = [None, "sto", "dwieście", "trzysta", "czterysta", "pięćset",
                "sześćset", "siedemset", "osiemset", "dziewięćset"]


def _pl_thousand_form(th: int) -> str:
    # Polish plural classes: 1 tysiąc; 2-4 (but not 12-14) tysiące; else tysięcy
    if th == 1:
        return "tysiąc"
    if th % 10 in (2, 3, 4) and th % 100 not in (12, 13, 14):
        return "tysiące"
    return "tysięcy"


def _pl(n: int) -> str:
    if n < 20:
        return _PL_UNITS[n]
    if n < 100:
        t, u = divmod(n, 10)
        return _PL_TENS[t] + (f" {_PL_UNITS[u]}" if u else "")
    if n < 1000:
        h, r = divmod(n, 100)
        return _PL_HUNDREDS[h] + (f" {_pl(r)}" if r else "")
    th, r = divmod(n, 1000)
    head = ("tysiąc" if th == 1
            else f"{_pl(th)} {_pl_thousand_form(th)}")
    return head + (f" {_pl(r)}" if r else "")


# ------------------------------------------------------------------ Russian

_RU_UNITS = ["ноль", "один", "два", "три", "четыре", "пять", "шесть",
             "семь", "восемь", "девять", "десять", "одиннадцать",
             "двенадцать", "тринадцать", "четырнадцать", "пятнадцать",
             "шестнадцать", "семнадцать", "восемнадцать", "девятнадцать"]
_RU_TENS = [None, None, "двадцать", "тридцать", "сорок", "пятьдесят",
            "шестьдесят", "семьдесят", "восемьдесят", "девяносто"]
_RU_HUNDREDS = [None, "сто", "двести", "триста", "четыреста", "пятьсот",
                "шестьсот", "семьсот", "восемьсот", "девятьсот"]


def _ru_under_1000(n: int, feminine=False) -> str:
    parts = []
    h, r = divmod(n, 100)
    if h:
        parts.append(_RU_HUNDREDS[h])
    if r >= 20:
        t, u = divmod(r, 10)
        parts.append(_RU_TENS[t])
        r = u
    if r:
        word = _RU_UNITS[r]
        if feminine and r == 1:
            word = "одна"
        elif feminine and r == 2:
            word = "две"
        parts.append(word)
    return " ".join(parts) if parts else _RU_UNITS[0]


def _ru(n: int) -> str:
    if n < 1000:
        return _ru_under_1000(n)
    th, r = divmod(n, 1000)
    if th % 10 == 1 and th % 100 != 11:
        form = "тысяча"
    elif th % 10 in (2, 3, 4) and th % 100 not in (12, 13, 14):
        form = "тысячи"
    else:
        form = "тысяч"
    head = form if th == 1 else f"{_ru_under_1000(th, feminine=True)} {form}"
    return head + (f" {_ru_under_1000(r)}" if r else "")


# ---------------------------------------------------------------- Ukrainian

_UK_UNITS = ["нуль", "один", "два", "три", "чотири", "п'ять", "шість",
             "сім", "вісім", "дев'ять", "десять", "одинадцять",
             "дванадцять", "тринадцять", "чотирнадцять", "п'ятнадцять",
             "шістнадцять", "сімнадцять", "вісімнадцять", "дев'ятнадцять"]
_UK_TENS = [None, None, "двадцять", "тридцять", "сорок", "п'ятдесят",
            "шістдесят", "сімдесят", "вісімдесят", "дев'яносто"]
_UK_HUNDREDS = [None, "сто", "двісті", "триста", "чотириста", "п'ятсот",
                "шістсот", "сімсот", "вісімсот", "дев'ятсот"]


def _uk_under_1000(n: int, feminine=False) -> str:
    parts = []
    h, r = divmod(n, 100)
    if h:
        parts.append(_UK_HUNDREDS[h])
    if r >= 20:
        t, u = divmod(r, 10)
        parts.append(_UK_TENS[t])
        r = u
    if r:
        word = _UK_UNITS[r]
        if feminine and r == 1:
            word = "одна"
        elif feminine and r == 2:
            word = "дві"
        parts.append(word)
    return " ".join(parts) if parts else _UK_UNITS[0]


def _uk(n: int) -> str:
    if n < 1000:
        return _uk_under_1000(n)
    th, r = divmod(n, 1000)
    if th % 10 == 1 and th % 100 != 11:
        form = "тисяча"
    elif th % 10 in (2, 3, 4) and th % 100 not in (12, 13, 14):
        form = "тисячі"
    else:
        form = "тисяч"
    head = form if th == 1 else f"{_uk_under_1000(th, feminine=True)} {form}"
    return head + (f" {_uk_under_1000(r)}" if r else "")


# --------------------------------------------------------------- Vietnamese

_VI_UNITS = ["không", "một", "hai", "ba", "bốn", "năm", "sáu", "bảy",
             "tám", "chín"]


def _vi(n: int) -> str:
    if n < 10:
        return _VI_UNITS[n]
    if n < 20:
        u = n - 10
        unit = "lăm" if u == 5 else (_VI_UNITS[u] if u else "")
        return ("mười " + unit).strip()
    if n < 100:
        t, u = divmod(n, 10)
        unit = {1: "mốt", 5: "lăm"}.get(u, _VI_UNITS[u]) if u else ""
        return f"{_VI_UNITS[t]} mươi" + (f" {unit}" if unit else "")
    if n < 1000:
        h, r = divmod(n, 100)
        head = f"{_VI_UNITS[h]} trăm"
        if not r:
            return head
        if r < 10:  # linh for skipped tens: 105 = một trăm linh năm
            return f"{head} linh {_VI_UNITS[r]}"
        return f"{head} {_vi(r)}"
    th, r = divmod(n, 1000)
    head = f"{_vi(th)} nghìn"
    if not r:
        return head
    if r < 100:
        return f"{head} không trăm {_vi(r)}" if r >= 10 else \
            f"{head} không trăm linh {_VI_UNITS[r]}"
    return f"{head} {_vi(r)}"


# -------------------------------------------------------------------- Farsi

_FA_UNITS = ["صفر", "یک", "دو", "سه", "چهار", "پنج", "شش", "هفت", "هشت",
             "نه", "ده", "یازده", "دوازده", "سیزده", "چهارده", "پانزده",
             "شانزده", "هفده", "هجده", "نوزده"]
_FA_TENS = [None, None, "بیست", "سی", "چهل", "پنجاه", "شصت", "هفتاد",
            "هشتاد", "نود"]
_FA_HUNDREDS = [None, "صد", "دویست", "سیصد", "چهارصد", "پانصد", "ششصد",
                "هفتصد", "هشتصد", "نهصد"]


def _fa(n: int) -> str:
    # parts joined by the conjunction "و" (o): بیست و یک = bist-o-yek
    if n < 20:
        return _FA_UNITS[n]
    parts = []
    th, n = divmod(n, 1000)
    if th:
        parts.append("هزار" if th == 1 else f"{_fa(th)} هزار")
    h, n = divmod(n, 100)
    if h:
        parts.append(_FA_HUNDREDS[h])
    if n >= 20:
        t, n = divmod(n, 10)
        parts.append(_FA_TENS[t])
    if n:
        parts.append(_FA_UNITS[n])
    return " و ".join(parts)


# ------------------------------------------------- millions and billions

# VERDICT r04 missing #2: espeak (behind ``TextFrontend.py:298``) reads
# "2500000" as "dos millones quinientos mil"; the grammars above stop at
# 999 999.  This layer extends every language to 999 999 999 999 with the
# correct per-language scale-word morphology: Slavic million/milliard
# plural classes (миллион/миллиона/миллионов), Romance plural + apocope
# before the scale word (veintiún millones, ventun milioni), German
# "eine Million" vs "zwei Millionen" as separate words, Dutch/Hungarian/
# Vietnamese/Farsi invariant scale words, Finnish nominative/partitive
# (miljoona / kaksi miljoonaa), Greek neuter plural (ένα εκατομμύριο /
# δύο εκατομμύρια).  Spanish and Portuguese have no standalone 10⁹ word
# (milliard-system): 2.5e9 reads "dos mil quinientos millones".


def _slavic_class(c: int) -> int:
    """0 = singular (1), 1 = paucal (2-4), 2 = genitive plural."""
    if c % 10 == 1 and c % 100 != 11:
        return 0
    if c % 10 in (2, 3, 4) and c % 100 not in (12, 13, 14):
        return 1
    return 2


def _es_count(c: int) -> str:
    words = _es(c)
    if words.endswith("veintiuno"):
        return words[: -len("veintiuno")] + "veintiún"
    if words.endswith("uno"):  # uno / treinta y uno -> un / treinta y un
        return words[:-1]
    return words


def _it_count(c: int) -> str:
    words = _it(c)
    return words[:-1] if words.endswith("uno") else words  # ventun milioni


def _scaled_es(n: int) -> str:
    m, rest = divmod(n, 10**6)  # m up to 999 999: "dos mil ... millones"
    head = "un millón" if m == 1 else f"{_es_count(m)} millones"
    return head + (f" {_es(rest)}" if rest else "")


def _scaled_pt(n: int) -> str:
    m, rest = divmod(n, 10**6)
    head = "um milhão" if m == 1 else f"{_pt(m)} milhões"
    return head + (f" e {_pt(rest)}" if rest else "")


def _group_word(c: int, forms) -> str:
    """forms: (singular, plural) or (sg, paucal, gen-pl) for Slavic."""
    if len(forms) == 3:
        return forms[_slavic_class(c)]
    return forms[0] if c == 1 else forms[1]


def _scaled_generic(lang, n: int) -> str:
    reader = _READERS[lang]
    million, billion, count, one, join = _SCALE[lang]
    parts = []
    b, n = divmod(n, 10**9)
    if b:
        cw = one if b == 1 else count(b)
        parts.append((cw + " " if cw else "") + _group_word(b, billion))
    m, rest = divmod(n, 10**6)
    if m:
        cw = one if m == 1 else count(m)
        parts.append((cw + " " if cw else "") + _group_word(m, million))
    if rest:
        parts.append(reader(rest))
    return join.join(parts)


# lang -> (million forms, billion forms, count-word fn, word-for-one, join)
_SCALE = {
    "it": (("milione", "milioni"), ("miliardo", "miliardi"), _it_count,
           "un", " "),
    "fr": (("million", "millions"), ("milliard", "milliards"), _fr,
           "un", " "),
    "de": (("Million", "Millionen"), ("Milliarde", "Milliarden"), _de,
           "eine", " "),
    "nl": (("miljoen", "miljoen"), ("miljard", "miljard"), _nl,
           "een", " "),  # Dutch scale words are invariant after numerals
    "fi": (("miljoona", "miljoonaa"), ("miljardi", "miljardia"), _fi,
           "", " "),  # 1e6 = "miljoona" bare; counts take the partitive
    "hu": (("millió", "millió"), ("milliárd", "milliárd"),
           # attributive kettő -> két (kétmillió, huszonkétmillió)
           lambda c: (_hu(c)[: -len("kettő")] + "két"
                      if _hu(c).endswith("kettő") else _hu(c)),
           "egy", " "),
    "el": (("εκατομμύριο", "εκατομμύρια"),
           ("δισεκατομμύριο", "δισεκατομμύρια"), _el, "ένα", " "),
    "pl": (("milion", "miliony", "milionów"),
           ("miliard", "miliardy", "miliardów"), _pl, "", " "),
    "ru": (("миллион", "миллиона", "миллионов"),
           ("миллиард", "миллиарда", "миллиардов"),
           lambda c: _ru_under_1000(c) if c < 1000 else _ru(c),
           "один", " "),
    "uk": (("мільйон", "мільйони", "мільйонів"),
           ("мільярд", "мільярди", "мільярдів"),
           lambda c: _uk_under_1000(c) if c < 1000 else _uk(c),
           "один", " "),
    "vi": (("triệu", "triệu"), ("tỷ", "tỷ"), _vi, "một", " "),
    "fa": (("میلیون", "میلیون"), ("میلیارد", "میلیارد"), _fa,
           "یک", " و "),
}


def _large(lang: str, n: int) -> str:
    if lang in ("es",):
        return _scaled_es(n)
    if lang in ("pt", "pt-br"):
        return _scaled_pt(n)
    return _scaled_generic(lang, n)


# ----------------------------------------------------------------- registry

_READERS = {
    "es": _es, "it": _it, "fr": _fr, "pt": _pt, "pt-br": _pt, "de": _de,
    "nl": _nl, "fi": _fi, "hu": _hu, "el": _el, "pl": _pl, "ru": _ru,
    "uk": _uk, "vi": _vi, "fa": _fa,
}

MAX_NUMBER = 999_999_999_999

# how the decimal separator reads per language (espeak behavior: the
# integer part reads as a numeral, the separator as this word, the
# fraction digit by digit)
DECIMAL_WORDS = {
    "es": "coma", "it": "virgola", "fr": "virgule", "pt": "vírgula",
    "pt-br": "vírgula", "de": "Komma", "nl": "komma", "fi": "pilkku",
    "hu": "vessző", "el": "κόμμα", "pl": "przecinek", "ru": "запятая",
    "uk": "кома", "vi": "phẩy", "fa": "ممیز", "en": "point",
}


def number_to_words(n: int, lang: str) -> str:
    """Read integer ``n`` (0..999 999 999 999) as words in ``lang``'s
    orthography.

    Raises KeyError for an unsupported language and ValueError outside the
    supported range (callers fall back to digit-by-digit reading)."""
    if not 0 <= n <= MAX_NUMBER:
        raise ValueError(f"number out of range: {n}")
    if n >= 10**6:
        return _large(lang, n)
    return _READERS[lang](n)


# ---------------------------------------------------------------- ordinals

# Written ordinal markers ("3º", "1er", "3e", "der 3.", "3-й", "3ος") read
# as true ordinal words, like espeak.  Masculine base forms; feminine /
# neuter / genitive variants derive via the per-language ending transforms
# below (driven by which marker the text used).

_ES_ORDINALS = {
    1: "primero", 2: "segundo", 3: "tercero", 4: "cuarto", 5: "quinto",
    6: "sexto", 7: "séptimo", 8: "octavo", 9: "noveno", 10: "décimo",
    11: "undécimo", 12: "duodécimo", 18: "decimoctavo", 20: "vigésimo",
    30: "trigésimo", 40: "cuadragésimo", 50: "quincuagésimo",
    60: "sexagésimo", 70: "septuagésimo", 80: "octogésimo",
    90: "nonagésimo", 100: "centésimo",
}


def _es_ordinal(n: int) -> str:
    if n in _ES_ORDINALS:
        return _ES_ORDINALS[n]
    if 13 <= n <= 19:
        return "decimo" + _ES_ORDINALS[n - 10]
    if 21 <= n <= 99:
        t, u = divmod(n, 10)
        if u:
            return _ES_ORDINALS[t * 10] + " " + _es_ordinal(u)
    raise ValueError(n)


_PT_ORDINALS = {
    1: "primeiro", 2: "segundo", 3: "terceiro", 4: "quarto", 5: "quinto",
    6: "sexto", 7: "sétimo", 8: "oitavo", 9: "nono", 10: "décimo",
    20: "vigésimo", 30: "trigésimo", 40: "quadragésimo",
    50: "quinquagésimo", 60: "sexagésimo", 70: "septuagésimo",
    80: "octogésimo", 90: "nonagésimo", 100: "centésimo",
}


def _pt_ordinal(n: int) -> str:
    if n in _PT_ORDINALS:
        return _PT_ORDINALS[n]
    if 11 <= n <= 99:
        t, u = divmod(n, 10)
        if u:
            return _PT_ORDINALS[t * 10] + " " + _PT_ORDINALS[u]
    raise ValueError(n)


_IT_ORDINALS = {
    1: "primo", 2: "secondo", 3: "terzo", 4: "quarto", 5: "quinto",
    6: "sesto", 7: "settimo", 8: "ottavo", 9: "nono", 10: "decimo",
}


def _it_ordinal(n: int) -> str:
    if n in _IT_ORDINALS:
        return _IT_ORDINALS[n]
    if not 11 <= n <= 100:
        raise ValueError(n)
    c = _it(n)
    if c.endswith("tré"):       # ventitré -> ventitreesimo (accent drops)
        return c[:-1] + "eesimo"
    if c.endswith("sei"):       # ventisei -> ventiseiesimo (i kept)
        return c + "esimo"
    return c[:-1] + "esimo"     # venti -> ventesimo, undici -> undicesimo


def _fr_ordinal(n: int) -> str:
    if n == 1:
        return "premier"
    if not 2 <= n <= 100:
        raise ValueError(n)
    c = _fr(n)
    if c.endswith("e"):         # quatre -> quatrième
        c = c[:-1]
    elif c.endswith("cinq"):    # cinq -> cinquième
        c += "u"
    elif c.endswith("neuf"):    # neuf -> neuvième
        c = c[:-1] + "v"
    return c + "ième"


_NL_ORDINALS = {1: "eerste", 3: "derde", 8: "achtste"}


def _nl_ordinal(n: int) -> str:
    if n in _NL_ORDINALS:
        return _NL_ORDINALS[n]
    if not 1 <= n <= 100:
        raise ValueError(n)
    return _nl(n) + ("de" if n < 20 else "ste")


_DE_ORDINALS = {1: "erste", 3: "dritte", 7: "siebte", 8: "achte"}


def _de_ordinal(n: int) -> str:
    if n in _DE_ORDINALS:
        return _DE_ORDINALS[n]
    if not 1 <= n <= 100:
        raise ValueError(n)
    return _de(n) + ("te" if n < 20 else "ste")


_RU_ORDINALS = {
    1: "первый", 2: "второй", 3: "третий", 4: "четвёртый", 5: "пятый",
    6: "шестой", 7: "седьмой", 8: "восьмой", 9: "девятый", 10: "десятый",
    11: "одиннадцатый", 12: "двенадцатый", 13: "тринадцатый",
    14: "четырнадцатый", 15: "пятнадцатый", 16: "шестнадцатый",
    17: "семнадцатый", 18: "восемнадцатый", 19: "девятнадцатый",
    20: "двадцатый", 30: "тридцатый", 40: "сороковой", 50: "пятидесятый",
    60: "шестидесятый", 70: "семидесятый", 80: "восьмидесятый",
    90: "девяностый", 100: "сотый",
}


def _ru_ordinal(n: int) -> str:
    if n in _RU_ORDINALS:
        return _RU_ORDINALS[n]
    if 21 <= n <= 99:
        t, u = divmod(n, 10)
        if u:
            return _RU_TENS[t] + " " + _RU_ORDINALS[u]
    raise ValueError(n)


_UK_ORDINALS = {
    1: "перший", 2: "другий", 3: "третій", 4: "четвертий", 5: "п'ятий",
    6: "шостий", 7: "сьомий", 8: "восьмий", 9: "дев'ятий", 10: "десятий",
    11: "одинадцятий", 12: "дванадцятий", 13: "тринадцятий",
    14: "чотирнадцятий", 15: "п'ятнадцятий", 16: "шістнадцятий",
    17: "сімнадцятий", 18: "вісімнадцятий", 19: "дев'ятнадцятий",
    20: "двадцятий", 30: "тридцятий", 40: "сороковий", 50: "п'ятдесятий",
    60: "шістдесятий", 70: "сімдесятий", 80: "вісімдесятий",
    90: "дев'яностий", 100: "сотий",
}


def _uk_ordinal(n: int) -> str:
    if n in _UK_ORDINALS:
        return _UK_ORDINALS[n]
    if 21 <= n <= 99:
        t, u = divmod(n, 10)
        if u:
            return _UK_TENS[t] + " " + _UK_ORDINALS[u]
    raise ValueError(n)


_EL_ORDINALS = {
    1: "πρώτος", 2: "δεύτερος", 3: "τρίτος", 4: "τέταρτος", 5: "πέμπτος",
    6: "έκτος", 7: "έβδομος", 8: "όγδοος", 9: "ένατος", 10: "δέκατος",
    11: "ενδέκατος", 12: "δωδέκατος", 20: "εικοστός", 30: "τριακοστός",
    40: "τεσσαρακοστός", 50: "πεντηκοστός", 60: "εξηκοστός",
    70: "εβδομηκοστός", 80: "ογδοηκοστός", 90: "ενενηκοστός",
    100: "εκατοστός",
}


def _el_ordinal(n: int) -> str:
    if n in _EL_ORDINALS:
        return _EL_ORDINALS[n]
    if 13 <= n <= 19:
        return "δέκατος " + _EL_ORDINALS[n - 10]
    if 21 <= n <= 99:
        t, u = divmod(n, 10)
        if u:
            return _EL_ORDINALS[t * 10] + " " + _EL_ORDINALS[u]
    raise ValueError(n)


def _romance_feminine(word: str) -> str:
    # primero -> primera (applies per space-separated component)
    return " ".join(w[:-1] + "a" if w.endswith("o") else w
                    for w in word.split(" "))


def _ru_uk_gender(word: str, gender: str) -> str:
    def one(w: str) -> str:
        for m_end, f_end, n_end, g_end in (("ый", "ая", "ое", "ого"),
                                           ("ій", "я", "є", "ього"),
                                           ("ий", "а", "е", "ого"),
                                           ("ой", "ая", "ое", "ого")):
            if w.endswith(m_end):
                repl = {"f": f_end, "n": n_end, "g": g_end}[gender]
                return w[: -len(m_end)] + repl
        return w
    if gender == "m":
        return word
    parts = word.split(" ")
    parts[-1] = one(parts[-1])  # only the ordinal component inflects
    return " ".join(parts)


def _ru_gender(word: str, gender: str) -> str:
    # Russian третий is soft-stem: третья / третье / третьего
    if word.split(" ")[-1] == "третий" and gender != "m":
        head = word[: -len("третий")]
        return head + {"f": "третья", "n": "третье", "g": "третьего"}[gender]
    return _ru_uk_gender(word, gender)


def _el_gender(word: str, gender: str) -> str:
    if gender == "m":
        return word
    parts = word.split(" ")
    last = parts[-1]
    if last.endswith("ός"):
        parts[-1] = last[:-2] + {"f": "ή", "n": "ό"}[gender]
    elif last.endswith("ος"):
        parts[-1] = last[:-2] + {"f": "η", "n": "ο"}[gender]
    return " ".join(parts)


_FI_ORDINALS = {
    1: "ensimmäinen", 2: "toinen", 3: "kolmas", 4: "neljäs", 5: "viides",
    6: "kuudes", 7: "seitsemäs", 8: "kahdeksas", 9: "yhdeksäs",
    10: "kymmenes", 11: "yhdestoista", 12: "kahdestoista",
    13: "kolmastoista", 14: "neljästoista", 15: "viidestoista",
    16: "kuudestoista", 17: "seitsemästoista", 18: "kahdeksastoista",
    19: "yhdeksästoista", 20: "kahdeskymmenes", 30: "kolmaskymmenes",
}
_FI_ORD_UNITS = {1: "yhdes", 2: "kahdes", 3: "kolmas", 4: "neljäs",
                 5: "viides", 6: "kuudes", 7: "seitsemäs",
                 8: "kahdeksas", 9: "yhdeksäs"}


def _fi_ordinal(n: int) -> str:
    """Finnish ordinals 1..31 (date reading: '15. maaliskuuta')."""
    if n in _FI_ORDINALS:
        return _FI_ORDINALS[n]
    if 21 <= n <= 31 and n % 10 in _FI_ORD_UNITS:
        return _FI_ORDINALS[n // 10 * 10] + _FI_ORD_UNITS[n % 10]
    raise ValueError(n)


_HU_ORDINALS = {
    1: "első", 2: "második", 3: "harmadik", 4: "negyedik", 5: "ötödik",
    6: "hatodik", 7: "hetedik", 8: "nyolcadik", 9: "kilencedik",
    10: "tizedik", 11: "tizenegyedik", 12: "tizenkettedik",
    13: "tizenharmadik", 14: "tizennegyedik", 15: "tizenötödik",
    16: "tizenhatodik", 17: "tizenhetedik", 18: "tizennyolcadik",
    19: "tizenkilencedik", 20: "huszadik", 30: "harmincadik",
}
_HU_ORD_UNITS = {1: "egyedik", 2: "kettedik", 3: "harmadik",
                 4: "negyedik", 5: "ötödik", 6: "hatodik", 7: "hetedik",
                 8: "nyolcadik", 9: "kilencedik"}


def _hu_ordinal(n: int) -> str:
    """Hungarian ordinals 1..31 (date suffixes: 15-én -> tizenötödikén)."""
    if n in _HU_ORDINALS:
        return _HU_ORDINALS[n]
    if 21 <= n <= 29:
        return "huszon" + _HU_ORD_UNITS[n % 10]
    if n == 31:
        return "harmincegyedik"
    raise ValueError(n)


_PL_ORDINALS = {
    1: "pierwszy", 2: "drugi", 3: "trzeci", 4: "czwarty", 5: "piąty",
    6: "szósty", 7: "siódmy", 8: "ósmy", 9: "dziewiąty", 10: "dziesiąty",
    11: "jedenasty", 12: "dwunasty", 13: "trzynasty", 14: "czternasty",
    15: "piętnasty", 16: "szesnasty", 17: "siedemnasty", 18: "osiemnasty",
    19: "dziewiętnasty", 20: "dwudziesty", 30: "trzydziesty",
}


def _pl_ordinal(n: int) -> str:
    """Polish ordinals 1..31 (masculine nominative; the date reader
    derives the genitive)."""
    if n in _PL_ORDINALS:
        return _PL_ORDINALS[n]
    if 21 <= n <= 31 and n % 10:
        return _PL_ORDINALS[n // 10 * 10] + " " + _PL_ORDINALS[n % 10]
    raise ValueError(n)


def pl_ordinal_genitive(word: str) -> str:
    """pierwszy -> pierwszego, drugi -> drugiego (every word of a
    compound ordinal inflects)."""
    out = []
    for w in word.split():
        if w.endswith("y"):
            out.append(w[:-1] + "ego")
        elif w.endswith("i"):
            out.append(w + "ego")
        else:
            out.append(w)
    return " ".join(out)


_ORDINAL_READERS = {
    "fi": _fi_ordinal, "hu": _hu_ordinal, "pl": _pl_ordinal,
    "es": _es_ordinal, "it": _it_ordinal, "pt": _pt_ordinal,
    "pt-br": _pt_ordinal, "fr": _fr_ordinal, "nl": _nl_ordinal,
    "de": _de_ordinal, "ru": _ru_ordinal, "uk": _uk_ordinal,
    "el": _el_ordinal,
}


def number_to_ordinal(n: int, lang: str, gender: str = "m") -> str:
    """Ordinal words for ``n`` in ``lang``; ``gender`` in {"m","f","n","g"}
    (g = Slavic genitive, for date markers like "1-го").  Raises KeyError
    for unsupported languages and ValueError outside each grammar's range
    (callers fall back to cardinal reading)."""
    word = _ORDINAL_READERS[lang](n)
    if gender == "f":
        if lang in ("es", "it", "pt", "pt-br"):
            return _romance_feminine(word)
        if lang == "fr":
            return "première" if n == 1 else word
    if lang == "ru":
        return _ru_gender(word, gender)
    if lang == "uk":
        return _ru_uk_gender(word, gender)
    if lang == "el":
        return _el_gender(word, gender)
    return word
