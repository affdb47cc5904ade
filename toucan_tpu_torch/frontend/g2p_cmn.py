"""First-party Mandarin G2P: pinyin -> IPA (+ a common-hanzi reading table).

The reference converts Mandarin text with pypinyin (hanzi -> numbered
pinyin) and dragonmapper (pinyin -> IPA with tone register marks)
(``Preprocessing/TextFrontend.py:196-207``).  Neither package exists in
this image, so this module provides:

* ``pinyin_to_ipa`` — a full standard-pinyin syllable parser (initial +
  final + tone number) emitting the same IPA-with-register-marks format
  dragonmapper produces (tones 1-4 -> ˥ / ˧˥ / ˧˩˧ / ˥˩, neutral bare),
  restricted to the articulatory inventory;
* ``hanzi_to_pinyin`` — a built-in reading table for the ~3,000 most
  frequent characters (the core band here plus the frequency-ranked
  extension in ``hanzi_table.py``; together they cover >99.5% of running
  newswire text).  Unknown characters degrade gracefully: they are
  skipped with a once-per-character warning instead of crashing synthesis
  (``strict=True`` restores the raise; pypinyin, when installed, gives
  full-CJK coverage with polyphone disambiguation).

Digits read as Mandarin numerals (``number_to_pinyin``: 十/百/千/万
composition with 零 insertion) and standard tone sandhi applies across
the syllable stream (``apply_tone_sandhi``: 3-3 -> 2-3, 不/一) — both
EXCEED the reference's pypinyin fallback, which carries lexical tones
only and drops digits.  pypinyin/dragonmapper remain the preferred
backends when installed (polyphone disambiguation, full hanzi coverage);
the frontend uses them first and falls back here.
"""

from __future__ import annotations

import re
import warnings

_warned_hanzi: set = set()

TONE_MARKS = {"1": "˥", "2": "˧˥", "3": "˧˩˧", "4": "˥˩", "5": "", "0": ""}

# ordered longest-first at match time
_INITIALS = [
    ("zh", "ʈʂ"), ("ch", "ʈʂʰ"), ("sh", "ʂ"),
    ("b", "p"), ("p", "pʰ"), ("m", "m"), ("f", "f"),
    ("d", "t"), ("t", "tʰ"), ("n", "n"), ("l", "l"),
    ("g", "k"), ("k", "kʰ"), ("h", "x"),
    ("j", "tɕ"), ("q", "tɕʰ"), ("x", "ɕ"),
    ("r", "ʐ"), ("z", "ts"), ("c", "tsʰ"), ("s", "s"),
]

_FINALS = {
    "a": "a", "o": "ɔ", "e": "ɤ", "i": "i", "u": "u", "ü": "y",
    "ai": "ai", "ei": "ei", "ao": "au", "ou": "ou",
    "an": "an", "en": "ən", "ang": "aŋ", "eng": "əŋ", "ong": "ʊŋ",
    "er": "əɻ",
    "ia": "ja", "ie": "jɛ", "iao": "jau", "iu": "jou", "ian": "jɛn",
    "in": "in", "iang": "jaŋ", "ing": "iŋ", "iong": "jʊŋ",
    "ua": "wa", "uo": "wɔ", "uai": "wai", "ui": "wei", "uan": "wan",
    "un": "wən", "uang": "waŋ", "ueng": "wəŋ",
    "üe": "ɥɛ", "üan": "ɥɛn", "ün": "yn",
}

# standalone syllables written with y/w (no initial)
_WHOLE = {
    "yi": "i", "ya": "ja", "ye": "jɛ", "yao": "jau", "you": "jou",
    "yan": "jɛn", "yin": "in", "yang": "jaŋ", "ying": "iŋ", "yo": "jɔ",
    "yong": "jʊŋ", "yu": "y", "yue": "ɥɛ", "yuan": "ɥɛn", "yun": "yn",
    "wu": "u", "wa": "wa", "wo": "wɔ", "wai": "wai", "wei": "wei",
    "wan": "wan", "wen": "wən", "wang": "waŋ", "weng": "wəŋ",
}

_APICAL = {"ʈʂ", "ʈʂʰ", "ʂ", "ʐ", "ts", "tsʰ", "s"}  # zhi/chi/shi/ri/zi/ci/si


def _syllable_to_ipa(syl: str) -> str:
    m = re.match(r"([a-züv]+)([0-5]?)$", syl)
    if not m:
        return syl
    body, tone = m.groups()
    body = body.replace("v", "ü")
    contour = TONE_MARKS.get(tone, "")

    if body in _WHOLE:
        return _WHOLE[body] + contour
    ini_ipa = ""
    rest = body
    for src, ipa in _INITIALS:
        if body.startswith(src):
            ini_ipa = ipa
            rest = body[len(src):]
            break
    if not rest:
        return ini_ipa + contour
    # apical vowel: zhi/chi/shi/ri/zi/ci/si
    if rest == "i" and ini_ipa in _APICAL:
        return ini_ipa + "ɨ" + contour
    # after j/q/x, written u/un/uan/ue are ü-series
    if ini_ipa in ("tɕ", "tɕʰ", "ɕ"):
        rest = {"u": "ü", "ue": "üe", "uan": "üan", "un": "ün"}.get(rest, rest)
    final = _FINALS.get(rest)
    if final is None:
        return ini_ipa + rest + contour  # unknown rime: pass through
    return ini_ipa + final + contour


_SYL_RX = re.compile(r"^([a-zA-Zü]+)([0-5])$")

# --------------------------------------------------------------- numerals

_CMN_DIGITS = ["ling2", "yi1", "er4", "san1", "si4", "wu3", "liu4", "qi1",
               "ba1", "jiu3"]


def _cmn_under_1e4(n: int, leading: bool):
    """0..9999 -> pinyin syllables with standard 零 insertion for skipped
    units and bare 十 for 10-19 at the start of a number."""
    parts = []
    started = False
    zero_pending = False
    for val, name in ((1000, "qian1"), (100, "bai3"), (10, "shi2")):
        d, n = divmod(n, val)
        if d:
            if zero_pending:
                parts.append("ling2")
                zero_pending = False
            if d == 1 and val == 10 and not started and leading:
                parts.append(name)  # 15 = shi2 wu3, but 115 = ... yi1 shi2 wu3
            else:
                parts += [_CMN_DIGITS[d], name]
            started = True
        elif started:
            zero_pending = True
    if n:
        if zero_pending:
            parts.append("ling2")
        parts.append(_CMN_DIGITS[n])
    return parts


def number_to_pinyin(n: int) -> str:
    """Integer -> numbered-pinyin reading (0..99 999 999 via 万)."""
    if not 0 <= n < 10**8:
        raise ValueError(f"number out of range: {n}")
    if n < 10:
        return _CMN_DIGITS[n]
    wan, rest = divmod(n, 10000)
    parts = []
    if wan:
        parts += _cmn_under_1e4(wan, leading=True) if wan >= 10 \
            else [_CMN_DIGITS[wan]]
        parts.append("wan4")
        if 0 < rest < 1000:
            parts.append("ling2")
        parts += _cmn_under_1e4(rest, leading=False)
    else:
        parts = _cmn_under_1e4(rest, leading=True)
    # morphemic 一 sandhi inside numerals: 一万 yi2 wan4, 一千/一百
    # yi4 qian1 / yi4 bai3; the final digit 一 keeps yi1 (shi2 yi1)
    for i, p in enumerate(parts[:-1]):
        if p == "yi1" and parts[i + 1] in ("wan4", "qian1", "bai3"):
            parts[i] = "yi2" if parts[i + 1] == "wan4" else "yi4"
    return " ".join(parts)


def _expand_cmn_numbers(text: str) -> str:
    def read(m):
        s = m.group(0)
        n = int(s)
        if n < 10**8 and not (s[0] == "0" and len(s) > 1):
            return " " + number_to_pinyin(n) + " "
        return " " + " ".join(_CMN_DIGITS[int(d)] for d in s) + " "

    # the lookbehind keeps tone digits attached to pinyin syllables
    # ("ni3") out of numeral expansion — only standalone digit runs read
    return re.sub(r"(?<![a-zA-Zü\d])\d+", read, text)


def apply_tone_sandhi(syllables):
    """Standard Mandarin tone sandhi over a numbered-pinyin syllable list
    (espeak's zh voice applies these; pypinyin/dragonmapper do NOT, so the
    first-party path exceeds the reference's fallback quality here):

    * third-tone sandhi: 3 3 -> 2 3, applied right-to-left so a run
      resolves pairwise ("wo3 hen3 hao3" -> "wo3 hen2 hao3", the standard
      [wo [hen hao]] phrasing).

    The 不/一 tone changes are NOT applied here: they are morphemic, and
    at the pinyin level "bu4"/"yi1" are ambiguous (部 bu4, 医 yi1 must
    keep their tones).  The hanzi path (``hanzi_to_pinyin``) and the
    numeral reader (``number_to_pinyin``) apply them where the morpheme
    is known; explicit numbered-pinyin input keeps its written tones.

    Tokens that are not numbered syllables pass through and break sandhi
    context (punctuation = prosodic boundary)."""
    out = list(syllables)
    # right-to-left so runs resolve like espeak ("hen3 hao3" -> "hen2 hao3")
    for i in range(len(out) - 2, -1, -1):
        m, n = _SYL_RX.match(out[i]), _SYL_RX.match(out[i + 1])
        if m and n and m.group(2) == "3" and n.group(2) == "3":
            out[i] = m.group(1) + "2"
    return out


def pinyin_to_ipa(text: str) -> str:
    """Numbered-pinyin text ("zhe4 shi4 ...") -> IPA with register marks,
    dragonmapper-compatible output format, with digits read as Mandarin
    numerals (五十 structure incl. 零 insertion) and standard tone sandhi
    applied across the syllable stream."""
    tokens = _expand_cmn_numbers(text).split()
    # split each token into (lead, core, trail); sandhi runs over the core
    # stream with explicit "#" boundary markers where punctuation breaks
    # the prosodic context (before a leading mark / after a trailing one)
    parts = []
    for token in tokens:
        m = re.match(r"(\W*)([\w0-5]*)(\W*)$", token, re.UNICODE)
        parts.append(m.groups() if m else ("", token, ""))
    stream, owner = [], []
    for j, (lead, core, trail) in enumerate(parts):
        if lead.strip():
            stream.append("#")
            owner.append(None)
        stream.append(core.lower())
        owner.append(j)
        if trail.strip():
            stream.append("#")
            owner.append(None)
    sandhied = apply_tone_sandhi(stream)
    cores = {j: s for s, j in zip(sandhied, owner) if j is not None}
    out = []
    for j, (lead, core, trail) in enumerate(parts):
        core = cores.get(j, core.lower())
        if core:
            core = _syllable_to_ipa(core)
        out.append(lead + core + trail)
    return " ".join(out)


# ---------------------------------------------------------------------------
# Common-character reading table (most frequent hanzi + the reference's
# smoke-sentence characters).  Single readings only — polyphones take their
# most common reading; install pypinyin for disambiguation.
# ---------------------------------------------------------------------------

HANZI_PINYIN = {
    "的": "de5", "一": "yi1", "是": "shi4", "不": "bu4", "了": "le5",
    "人": "ren2", "我": "wo3", "在": "zai4", "有": "you3", "他": "ta1",
    "这": "zhe4", "中": "zhong1", "大": "da4", "来": "lai2", "上": "shang4",
    "国": "guo2", "个": "ge4", "到": "dao4", "说": "shuo1", "们": "men5",
    "为": "wei4", "子": "zi3", "和": "he2", "你": "ni3", "地": "di4",
    "出": "chu1", "道": "dao4", "也": "ye3", "时": "shi2", "年": "nian2",
    "得": "de5", "就": "jiu4", "那": "na4", "要": "yao4", "下": "xia4",
    "以": "yi3", "生": "sheng1", "会": "hui4", "自": "zi4", "着": "zhe5",
    "去": "qu4", "之": "zhi1", "过": "guo4", "家": "jia1", "学": "xue2",
    "对": "dui4", "可": "ke3", "她": "ta1", "里": "li3", "后": "hou4",
    "小": "xiao3", "么": "me5", "心": "xin1", "多": "duo1", "天": "tian1",
    "而": "er2", "能": "neng2", "好": "hao3", "都": "dou1", "然": "ran2",
    "没": "mei2", "日": "ri4", "于": "yu2", "起": "qi3", "还": "hai2",
    "发": "fa1", "成": "cheng2", "事": "shi4", "只": "zhi3", "作": "zuo4",
    "当": "dang1", "想": "xiang3", "看": "kan4", "文": "wen2", "无": "wu2",
    "开": "kai1", "手": "shou3", "十": "shi2", "用": "yong4", "主": "zhu3",
    "行": "xing2", "方": "fang1", "又": "you4", "如": "ru2", "前": "qian2",
    "所": "suo3", "本": "ben3", "见": "jian4", "经": "jing1", "头": "tou2",
    "面": "mian4", "公": "gong1", "同": "tong2", "三": "san1", "已": "yi3",
    "老": "lao3", "从": "cong2", "动": "dong4", "两": "liang3", "长": "chang2",
    "知": "zhi1", "民": "min2", "样": "yang4", "现": "xian4", "分": "fen1",
    "将": "jiang1", "外": "wai4", "但": "dan4", "身": "shen1", "些": "xie1",
    "与": "yu3", "高": "gao1", "意": "yi4", "进": "jin4", "把": "ba3",
    "法": "fa3", "此": "ci3", "实": "shi2", "回": "hui2", "二": "er4",
    "理": "li3", "美": "mei3", "点": "dian3", "月": "yue4", "明": "ming2",
    "其": "qi2", "种": "zhong3", "声": "sheng1", "全": "quan2", "工": "gong1",
    "己": "ji3", "话": "hua4", "儿": "er2", "者": "zhe3", "向": "xiang4",
    "情": "qing2", "部": "bu4", "正": "zheng4", "名": "ming2", "定": "ding4",
    "女": "nü3", "问": "wen4", "力": "li4", "机": "ji1", "给": "gei3",
    "等": "deng3", "几": "ji3", "很": "hen3", "业": "ye4", "最": "zui4",
    "间": "jian1", "新": "xin1", "什": "shen2", "打": "da3", "便": "bian4",
    "位": "wei4", "因": "yin1", "重": "zhong4", "被": "bei4", "走": "zou3",
    "电": "dian4", "四": "si4", "第": "di4", "门": "men2", "相": "xiang1",
    "次": "ci4", "东": "dong1", "政": "zheng4", "海": "hai3", "口": "kou3",
    "使": "shi3", "教": "jiao4", "西": "xi1", "再": "zai4", "平": "ping2",
    "真": "zhen1", "听": "ting1", "世": "shi4", "气": "qi4", "信": "xin4",
    "北": "bei3", "少": "shao3", "关": "guan1", "并": "bing4", "内": "nei4",
    "加": "jia1", "化": "hua4", "由": "you2", "却": "que4", "代": "dai4",
    "军": "jun1", "产": "chan3", "入": "ru4", "先": "xian1", "山": "shan1",
    "五": "wu3", "太": "tai4", "水": "shui3", "万": "wan4", "市": "shi4",
    "眼": "yan3", "体": "ti3", "别": "bie2", "处": "chu4", "总": "zong3",
    "才": "cai2", "场": "chang3", "师": "shi1", "书": "shu1", "比": "bi3",
    "住": "zhu4", "员": "yuan2", "九": "jiu3", "笑": "xiao4", "性": "xing4",
    "通": "tong1", "目": "mu4", "华": "hua2", "报": "bao4", "立": "li4",
    "马": "ma3", "命": "ming4", "张": "zhang1", "活": "huo2", "难": "nan2",
    "神": "shen2", "数": "shu4", "件": "jian4", "安": "an1", "表": "biao3",
    "原": "yuan2", "车": "che1", "白": "bai2", "应": "ying1", "路": "lu4",
    "期": "qi1", "叫": "jiao4", "死": "si3", "常": "chang2", "提": "ti2",
    "感": "gan3", "金": "jin1", "何": "he2", "更": "geng4", "反": "fan3",
    "题": "ti2", "必": "bi4", "却": "que4", "论": "lun4", "六": "liu4",
    "七": "qi1", "八": "ba1", "百": "bai3", "千": "qian1", "零": "ling2",
    # the reference smoke sentence (TextFrontend.py:536) + common TTS words
    "复": "fu4", "杂": "za2", "句": "ju4", "它": "ta1", "甚": "shen4",
    "至": "zhi4", "包": "bao1", "含": "han2", "停": "ting2", "顿": "dun4",
    "语": "yu3", "音": "yin1", "合": "he2", "谢": "xie4", "请": "qing3",
    "早": "zao3", "晚": "wan3", "今": "jin1", "昨": "zuo2", "呢": "ne5",
    "吗": "ma5", "吧": "ba5", "啊": "a5", "喜": "xi3", "欢": "huan1",
    "爱": "ai4", "风": "feng1", "雨": "yu3", "雪": "xue3", "花": "hua1",
    "字": "zi4", "读": "du2", "写": "xie3", "听": "ting1", "讲": "jiang3",
    # round-4 expansion: next frequency band + everyday vocabulary
    "让": "rang4", "跟": "gen1", "条": "tiao2", "解": "jie3", "放": "fang4",
    "做": "zuo4", "像": "xiang4", "觉": "jue2", "色": "se4", "光": "guang1",
    "变": "bian4", "接": "jie1", "结": "jie2", "果": "guo3", "怎": "zen3",
    "近": "jin4", "远": "yuan3", "快": "kuai4", "慢": "man4", "热": "re4",
    "冷": "leng3", "南": "nan2", "边": "bian1", "石": "shi2", "火": "huo3",
    "土": "tu3", "木": "mu4", "林": "lin2", "森": "sen1", "田": "tian2",
    "鱼": "yu2", "鸟": "niao3", "虫": "chong2", "牛": "niu2", "羊": "yang2",
    "狗": "gou3", "猫": "mao1", "猪": "zhu1", "鸡": "ji1", "肉": "rou4",
    "睛": "jing1", "啤": "pi2", "镑": "bang4", "摄": "she4",
    "毫": "hao2",
    "饭": "fan4", "菜": "cai4", "茶": "cha2", "酒": "jiu3", "汤": "tang1",
    "糖": "tang2", "盐": "yan2", "油": "you2", "米": "mi3", "蛋": "dan4",
    "奶": "nai3", "瓜": "gua1", "豆": "dou4", "树": "shu4", "叶": "ye4",
    "草": "cao3", "根": "gen1", "春": "chun1", "夏": "xia4", "秋": "qiu1",
    "冬": "dong1", "星": "xing1", "云": "yun2", "空": "kong1",
    "红": "hong2", "黄": "huang2", "蓝": "lan2", "绿": "lü4", "黑": "hei1",
    "紫": "zi3", "灰": "hui1", "窗": "chuang1", "床": "chuang2",
    "桌": "zhuo1", "椅": "yi3", "房": "fang2", "屋": "wu1", "楼": "lou2",
    "城": "cheng2", "村": "cun1", "街": "jie1", "桥": "qiao2", "河": "he2",
    "江": "jiang1", "湖": "hu2", "岛": "dao3", "洋": "yang2", "池": "chi2",
    "船": "chuan2", "飞": "fei1", "票": "piao4", "站": "zhan4",
    "运": "yun4", "送": "song4", "买": "mai3", "卖": "mai4", "钱": "qian2",
    "价": "jia4", "店": "dian4", "货": "huo4", "物": "wu4", "品": "pin3",
    "具": "ju4", "衣": "yi1", "服": "fu2", "鞋": "xie2", "帽": "mao4",
    "裤": "ku4", "袋": "dai4", "纸": "zhi3", "笔": "bi3", "画": "hua4",
    "图": "tu2", "板": "ban3", "课": "ke4", "班": "ban1", "考": "kao3",
    "试": "shi4", "答": "da2", "错": "cuo4", "懂": "dong3", "记": "ji4",
    "忘": "wang4", "念": "nian4", "思": "si1", "顾": "gu4", "愿": "yuan4",
    "望": "wang4", "希": "xi1", "梦": "meng4", "怕": "pa4", "急": "ji2",
    "忙": "mang2", "累": "lei4", "休": "xiu1", "息": "xi1", "睡": "shui4",
    "醒": "xing3", "病": "bing4", "药": "yao4", "医": "yi1", "院": "yuan4",
    "护": "hu4", "康": "kang1", "健": "jian4", "强": "qiang2",
    "弱": "ruo4", "胖": "pang4", "瘦": "shou4", "脸": "lian3",
    "嘴": "zui3", "耳": "er3", "鼻": "bi2", "牙": "ya2", "舌": "she2",
    "脚": "jiao3", "腿": "tui3", "指": "zhi3", "血": "xue4", "骨": "gu3",
    "皮": "pi2", "毛": "mao2", "跑": "pao3", "跳": "tiao4", "坐": "zuo4",
    "找": "zhao3", "丢": "diu1", "拿": "na2", "带": "dai4", "推": "tui1",
    "拉": "la1", "抱": "bao4", "搬": "ban1", "洗": "xi3", "扫": "sao3",
    "切": "qie1", "煮": "zhu3", "烧": "shao1", "炒": "chao3",
    "吃": "chi1", "喝": "he1", "咬": "yao3", "闻": "wen2", "摸": "mo1",
    "穿": "chuan1", "脱": "tuo1", "戴": "dai4", "玩": "wan2",
    "唱": "chang4", "歌": "ge1", "舞": "wu3", "琴": "qin2", "球": "qiu2",
    "赛": "sai4", "赢": "ying2", "输": "shu1", "胜": "sheng4",
    "败": "bai4", "始": "shi3", "终": "zhong1", "完": "wan2", "续": "xu4",
    "连": "lian2", "断": "duan4", "换": "huan4", "修": "xiu1",
    "建": "jian4", "造": "zao4", "制": "zhi4", "办": "ban4",
    "管": "guan3", "治": "zhi4", "收": "shou1", "付": "fu4", "借": "jie4",
    "欠": "qian4", "租": "zu1", "留": "liu2", "寄": "ji4", "取": "qu3",
    "选": "xuan3", "投": "tou2", "求": "qiu2", "帮": "bang1",
    "助": "zhu4", "救": "jiu4", "陪": "pei2", "迎": "ying2", "客": "ke4",
    "朋": "peng2", "友": "you3", "伴": "ban4", "邻": "lin2", "敌": "di2",
    "兵": "bing1", "官": "guan1", "王": "wang2", "皇": "huang2",
    "帝": "di4", "众": "zhong4", "群": "qun2", "队": "dui4",
    "团": "tuan2", "组": "zu3", "厂": "chang3", "司": "si1", "局": "ju2",
    "区": "qu1", "省": "sheng3", "县": "xian4", "乡": "xiang1",
    "镇": "zhen4", "京": "jing1", "州": "zhou1", "港": "gang3",
    "台": "tai2", "湾": "wan1", "陆": "lu4", "界": "jie4", "境": "jing4",
    "洲": "zhou1", "欧": "ou1", "亚": "ya4", "非": "fei1", "俄": "e2",
    "英": "ying1", "德": "de2", "腊": "la4", "印": "yin4", "度": "du4",
    "韩": "han2", "朝": "chao2", "越": "yue4", "泰": "tai4",
    "汉": "han4", "词": "ci2", "典": "dian3", "姐": "jie3", "哥": "ge1",
    "校": "xiao4", "院": "yuan4", "楚": "chu3", "晨": "chen2",
    "弟": "di4", "妹": "mei4", "孩": "hai2", "狮": "shi1", "熊": "xiong2",
    # next frequency band + everyday vocabulary (late round 4)
    "半": "ban4", "差": "cha4", "单": "dan1", "灯": "deng1", "低": "di1",
    "短": "duan3", "段": "duan4", "饿": "e4", "父": "fu4", "干": "gan4",
    "刚": "gang1", "告": "gao4", "故": "gu4", "馆": "guan3", "贵": "gui4",
    "坏": "huai4", "级": "ji2", "计": "ji4", "节": "jie2", "介": "jie4",
    "旧": "jiu4", "渴": "ke3", "哭": "ku1", "块": "kuai4", "离": "li2",
    "礼": "li3", "历": "li4", "亮": "liang4", "旅": "lv3", "妈": "ma1",
    "每": "mei3", "母": "mu3", "哪": "na3", "脑": "nao3", "您": "nin2",
    "旁": "pang2", "妻": "qi1", "汽": "qi4", "青": "qing1", "清": "qing1",
    "认": "ren4", "商": "shang1", "谁": "shei2", "识": "shi2", "室": "shi4",
    "视": "shi4", "诉": "su4", "岁": "sui4", "网": "wang3", "午": "wu3",
    "系": "xi4", "香": "xiang1", "姓": "xing4", "颜": "yan2", "爷": "ye2",
    "夜": "ye4", "银": "yin2", "影": "ying3", "泳": "yong3", "游": "you2",
    "右": "you4", "元": "yuan2", "照": "zhao4", "钟": "zhong1", "准": "zhun3",
    "足": "zu2", "左": "zuo3",

}

# merge the frequency-ranked extension band (single-char keys, validated
# by tests); the curated core band above wins on any conflict
from toucan_tpu_torch.frontend.hanzi_table import HANZI_PINYIN_EXT as _EXT

for _ch, _reading in _EXT.items():
    HANZI_PINYIN.setdefault(_ch, _reading)

# ---------------------------------------------------------------------------
# Word-level readings (longest-match first): neutral-tone suffixes and
# reduplications (桌子 zhuo1 zi5, 妈妈 ma1 ma5) and polyphones whose
# common word reading differs from the char table's default (睡觉
# jiao4).  pypinyin disambiguates these from context; this dictionary
# covers the high-frequency cases first-party.
# ---------------------------------------------------------------------------

HANZI_WORDS = {
    "睡觉": "shui4 jiao4", "觉得": "jue2 de5", "月亮": "yue4 liang5",
    "漂亮": "piao4 liang5", "头发": "tou2 fa5", "窗户": "chuang1 hu5",
    "葡萄": "pu2 tao5", "朋友": "peng2 you5", "星星": "xing1 xing5",
    "耳朵": "er3 duo5", "眼睛": "yan3 jing5", "衣服": "yi1 fu5",
    "喜欢": "xi3 huan5", "知识": "zhi1 shi5", "意思": "yi4 si5",
    "东西": "dong1 xi5", "时候": "shi2 hou5", "地方": "di4 fang5",
    "先生": "xian1 sheng5", "学生": "xue2 sheng5",
    "告诉": "gao4 su5", "名字": "ming2 zi5", "因为": "yin1 wei4",
    "什么": "shen2 me5", "怎么": "zen3 me5", "我们": "wo3 men5",
    "你们": "ni3 men5", "他们": "ta1 men5", "她们": "ta1 men5",
    "还是": "hai2 shi4", "还有": "hai2 you3", "银行": "yin2 hang2",
    "便宜": "pian2 yi5", "快乐": "kuai4 le4", "音乐": "yin1 yue4",
    "长大": "zhang3 da4", "大夫": "dai4 fu5", "干净": "gan1 jing4",
}
# kinship reduplications + -子 suffix nouns: generated neutral tones
for _w, _py in [("爸爸", "ba4"), ("妈妈", "ma1"), ("哥哥", "ge1"),
                ("姐姐", "jie3"), ("弟弟", "di4"), ("妹妹", "mei4"),
                ("爷爷", "ye2"), ("奶奶", "nai3"), ("叔叔", "shu1"),
                ("谢谢", "xie4")]:
    HANZI_WORDS.setdefault(_w, _py + " " + _py[:-1] + "5")
for _w in ["桌子", "椅子", "儿子", "鼻子", "孩子", "房子", "屋子",
           "刀子", "筷子", "杯子", "瓶子", "盒子", "帽子", "袜子",
           "裙子", "裤子", "句子", "样子", "本子", "包子", "饺子"]:
    _head = HANZI_PINYIN.get(_w[0])
    if _head:
        HANZI_WORDS.setdefault(_w, _head + " zi5")

def expand_symbols_cmn(text: str) -> str:
    """Rewrite %, currency, degree and metric-unit symbols into hanzi
    BEFORE the reading table runs (espeak's zh voice reads 50% as
    百分之五十 — percent PREFIXES the number in Chinese; currency names
    follow the amount)."""
    text = re.sub(r"(\d+(?:[.,]\d+)?)\s*%", r"百分之\1", text)
    for sym, word in (("$", "美元"), ("€", "欧元"), ("£", "英镑")):
        text = re.sub(re.escape(sym) + r"\s*(\d+(?:[.,]\d+)?)",
                      r"\1" + word, text)
        text = re.sub(r"(\d+(?:[.,]\d+)?)\s*" + re.escape(sym),
                      r"\1" + word, text)
    text = text.replace("°C", "摄氏度").replace("°F", "华氏度")
    text = re.sub(r"(\d)\s*°", r"\1度", text)
    text = re.sub(r"(\d+(?:[.,]\d+)?)\s*(km|cm|mm|kg|mg|ml)(?![\w])",
                  lambda m: m.group(1) + {"km": "公里", "cm": "厘米",
                                          "mm": "毫米", "kg": "公斤",
                                          "mg": "毫克",
                                          "ml": "毫升"}[m.group(2)], text)
    return text


_HAN_RX = re.compile(r"[一-鿿]")


def has_hanzi(text: str) -> bool:
    return bool(_HAN_RX.search(text))


def hanzi_to_pinyin(text: str, strict: bool = False) -> str:
    """Character-by-character reading via the built-in table, with the
    morphemic 不/一 tone changes applied in place (this path KNOWS which
    syllable is the morpheme: 不 bu4 -> bu2 before tone 4; 一 yi1 -> yi2
    before tone 4 / yi4 before tones 1-3, except ordinal 第一 and final
    position).  Punctuation passes through (the frontend's pause handling
    needs it).

    Unknown hanzi NEVER crash synthesis (the reference reads arbitrary
    hanzi via pypinyin, ``Preprocessing/TextFrontend.py:486-487``; a
    frontend that throws on ordinary input would be a capability
    regression): by default each unknown character is skipped with a
    once-per-character warning.  ``strict=True`` restores the raising
    behaviour for callers that want hard coverage guarantees."""
    chars = []  # (hanzi | None, emitted text)
    i = 0
    while i < len(text):
        # word-level longest match first (neutral tones, polyphones)
        matched = None
        for wlen in (4, 3, 2):
            cand = text[i:i + wlen]
            if cand in HANZI_WORDS:
                matched = cand
                break
        if matched:
            for ch_, syl in zip(matched, HANZI_WORDS[matched].split()):
                chars.append((ch_, syl))
            i += len(matched)
            continue
        ch = text[i]
        i += 1
        if _HAN_RX.match(ch):
            reading = HANZI_PINYIN.get(ch)
            if reading is None:
                msg = (f"no built-in reading for {ch!r} (U+{ord(ch):04X}) — "
                       "install pypinyin for full hanzi coverage, or input "
                       "pinyin (e.g. 'ni3 hao3') or IPA directly")
                if strict:
                    raise KeyError(msg)
                if ch not in _warned_hanzi:
                    _warned_hanzi.add(ch)
                    warnings.warn("skipping unreadable hanzi: " + msg)
                continue  # degrade: drop the character, keep synthesizing
            chars.append((ch, reading))
        else:
            chars.append((None, ch))
    for i, (ch, reading) in enumerate(chars):
        nxt = chars[i + 1] if i + 1 < len(chars) else (None, "")
        nxt_tone = nxt[1][-1] if nxt[0] and nxt[1][-1] in "12345" else None
        prev_ch = chars[i - 1][0] if i else None
        if ch == "不" and nxt_tone == "4":
            chars[i] = (ch, "bu2")
        elif ch == "一" and nxt_tone in ("1", "2", "3", "4") \
                and prev_ch != "第":
            chars[i] = (ch, "yi2" if nxt_tone == "4" else "yi4")
    out = "".join((" " + r + " ") if h else r for h, r in chars)
    return re.sub(r"\s+", " ", out).strip()
