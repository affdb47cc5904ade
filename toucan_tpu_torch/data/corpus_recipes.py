"""Corpus recipes: path -> transcript dictionaries for the supported corpora.

The reference enumerates 58 corpus parsers over a fixed filesystem layout
(``Utility/path_to_transcript_dicts.py``).  Here the same corpora are
described declaratively: a handful of *template parsers* (LJSpeech-style
metadata.csv, per-file txt trees, MLS/LibriTTS layouts, CSS10, Thorsten,
VCTK, ...) plus a registry mapping each reference recipe name to its
template + location.  The corpora root defaults to the reference's
``/mount/resources/speech/corpora`` and can be overridden with the
``TOUCAN_CORPORA_ROOT`` environment variable or per call.
"""

from __future__ import annotations

import os
import random
from functools import partial

def default_root() -> str:
    """Resolved lazily so ``--corpora_root`` (which sets the env var after
    imports) and test monkeypatching both take effect."""
    return os.environ.get("TOUCAN_CORPORA_ROOT",
                          "/mount/resources/speech/corpora")


def limit_to_n(d: dict, n: int = 40000) -> dict:
    if len(d) > n:
        keys = random.sample(list(d.keys()), n)
        return {k: d[k] for k in keys}
    return d


# ------------------------------------------------------------- templates

def metadata_csv(root, wav_dir="wav", transcript_index=1, wav_suffix=".wav",
                 max_lines=None, delimiter="|"):
    """LJSpeech-style metadata.csv: <id>|<transcript>[|...]."""
    out = {}
    with open(os.path.join(root, "metadata.csv"), "r", encoding="utf8") as f:
        lines = f.read().split("\n")
    if max_lines:
        lines = lines[:max_lines]
    for line in lines:
        if line.strip():
            fields = line.split(delimiter)
            wav_path = os.path.join(root, wav_dir, fields[0] + wav_suffix) \
                if wav_dir else os.path.join(root, fields[0])
            if os.path.exists(wav_path):
                out[wav_path] = fields[transcript_index]
    return out


def txt_tree(root, txt_dir="txt", wav_dir="wav", wav_suffix=".wav", nested=False):
    """One .txt transcript file per utterance."""
    out = {}
    txt_root = os.path.join(root, txt_dir)
    dirs = sorted(os.listdir(txt_root)) if nested else ["."]
    for sub in dirs:
        base = os.path.join(txt_root, sub)
        if not os.path.isdir(base):
            continue
        for name in os.listdir(base):
            if not name.endswith(".txt"):
                continue
            with open(os.path.join(base, name), "r", encoding="utf8") as f:
                transcript = f.read()
            stem = name[: -len(".txt")]
            wav_path = os.path.join(root, wav_dir, sub, stem + wav_suffix) \
                if nested else os.path.join(root, wav_dir, stem + wav_suffix)
            if os.path.exists(wav_path):
                out[wav_path] = transcript
    return out


def mls(root):
    """MultiLingLibriSpeech: transcripts.txt with <id>\\t<transcript>."""
    out = {}
    with open(os.path.join(root, "transcripts.txt"), "r", encoding="utf8") as f:
        for line in f.read().split("\n"):
            if line.strip():
                utt_id, transcript = line.split("\t", 1)
                spk, book, _ = utt_id.split("_")
                wav_path = os.path.join(root, "audio", spk, book, utt_id + ".flac")
                if os.path.exists(wav_path):
                    out[wav_path] = transcript
    return out


def libritts(root):
    """LibriTTS: speaker/chapter trees with *.normalized.txt."""
    out = {}
    for speaker in os.listdir(root):
        for chapter in os.listdir(os.path.join(root, speaker)):
            cdir = os.path.join(root, speaker, chapter)
            for name in os.listdir(cdir):
                if name.endswith("normalized.txt"):
                    with open(os.path.join(cdir, name), "r", encoding="utf8") as f:
                        transcript = f.read()
                    wav = os.path.join(cdir, name.split(".")[0] + ".wav")
                    if os.path.exists(wav):
                        out[wav] = transcript
    return out


def css10(root, transcript_index=2):
    """CSS10: transcript.txt with <path>|<raw>|<normalized>."""
    out = {}
    with open(os.path.join(root, "transcript.txt"), "r", encoding="utf8") as f:
        for line in f.read().split("\n"):
            if line.strip():
                fields = line.split("|")
                wav_path = os.path.join(root, fields[0])
                if os.path.exists(wav_path):
                    out[wav_path] = fields[transcript_index]
    return out


def vctk(root):
    out = {}
    txt_root = os.path.join(root, "txt")
    for spk in os.listdir(txt_root):
        for name in os.listdir(os.path.join(txt_root, spk)):
            if name.endswith(".txt"):
                with open(os.path.join(txt_root, spk, name), "r", encoding="utf8") as f:
                    transcript = f.read()
                wav = os.path.join(root, "wav48_silence_trimmed", spk,
                                   name[:-4] + "_mic2.flac")
                if os.path.exists(wav):
                    out[wav] = transcript
    return out


def hui(root, transcript_index=1):
    """HUI German: per-book subdirs each holding metadata.csv + wavs/."""
    out = {}
    for book in os.listdir(root):
        sub = os.path.join(root, book)
        if os.path.isdir(sub) and os.path.exists(os.path.join(sub, "metadata.csv")):
            out.update(metadata_csv(sub, wav_dir="wavs",
                                    transcript_index=transcript_index))
    return out


def hui_others(root):
    out = {}
    for speaker in os.listdir(root):
        out.update(hui(os.path.join(root, speaker)))
    return out


def mailabs(root):
    """M-AILABS: per-book subdirs with metadata.csv (<id>|<raw>|<norm>)."""
    return hui(root, transcript_index=2)


def blizzard2023_tsv(root, max_entries=None):
    """Blizzard 2023 AD/NEB: transcript.tsv with <path>\\t<transcript>."""
    out = {}
    with open(os.path.join(root, "transcript.tsv"), "r", encoding="utf8") as f:
        for line in f.read().split("\n"):
            if line.strip():
                rel, transcript = line.split("\t")[:2]
                wav = os.path.join(root, rel.split("/")[-1])
                if os.path.exists(wav):
                    transcript = (transcript.replace("§", "").replace("#", "")
                                  .replace("~", "").replace(" »", '"')
                                  .replace("« ", '"').replace("»", '"')
                                  .replace("«", '"'))
                    out[wav] = transcript
                if max_entries and len(out) > max_entries:
                    break
    return out


def vivos(root):
    """VIVOS Vietnamese: prompts.txt "<id> <text>", waves/<spk>/<id>.wav."""
    out = {}
    with open(os.path.join(root, "prompts.txt"), "r", encoding="utf8") as f:
        for line in f.read().split("\n"):
            if line.strip():
                fields = line.split(" ")
                wav = os.path.join(root, "waves", fields[0][:10],
                                   fields[0] + ".wav")
                out[wav] = " ".join(fields[1:]).lower()
    return out


def ravdess(root):
    """RAVDESS: two fixed sentences encoded in the 5th filename field."""
    out = {}
    for speaker_dir in os.listdir(root):
        spk = os.path.join(root, speaker_dir)
        if not os.path.isdir(spk):
            continue
        for audio_file in os.listdir(spk):
            if audio_file.split("-")[4] == "01":
                out[os.path.join(spk, audio_file)] = "Kids are talking by the door."
            else:
                out[os.path.join(spk, audio_file)] = "Dogs are sitting by the door."
    return out


def esds(root):
    """Emotional Speech Dataset (Singapore): per-speaker fixed_unicode.txt
    with <file>\\t<text>\\t<emotion-dir>; English speakers are 0011+."""
    out = {}
    for speaker_dir in os.listdir(root):
        if speaker_dir.startswith("00") and int(speaker_dir) > 10:
            with open(os.path.join(root, speaker_dir, "fixed_unicode.txt"),
                      "r", encoding="utf8") as f:
                transcripts = f.read()
            for line in transcripts.replace("\n\n", "\n").replace(",", ", ").split("\n"):
                if line.strip():
                    filename, text, emo_dir = line.split("\t")
                    filename = speaker_dir + "_" + filename.split("_")[1]
                    out[os.path.join(root, speaker_dir, emo_dir,
                                     filename + ".wav")] = text
    return out


def tab_separated(root, text_file, wav_dir="", wav_suffix=".wav"):
    """<id>\\t<transcript> lines (Spanish Blizzard train_text.txt, etc.)."""
    out = {}
    with open(os.path.join(root, text_file), "r", encoding="utf8") as f:
        for line in f.read().split("\n"):
            if line.strip():
                utt_id, transcript = line.split("\t")[:2]
                wav = os.path.join(root, wav_dir, utt_id + wav_suffix)
                if os.path.exists(wav):
                    out[wav] = transcript
    return out


def aishell3(root):
    out = {}
    with open(os.path.join(root, "label_train-set.txt"), encoding="utf8") as f:
        lines = f.read().replace("$", "").replace("%", " ").split("\n")
    for line in lines:
        if line.strip() and not line.startswith("#"):
            fields = line.split("|")
            wav = os.path.join(root, "wav", fields[0][:7], fields[0] + ".wav")
            if os.path.exists(wav):
                out[wav] = fields[2]
    return out


def viet_tts(root):
    out = {}
    with open(os.path.join(root, "meta_data.tsv"), encoding="utf8") as f:
        for line in f.read().split("\n"):
            if line.strip():
                audio, transcript = line.split(".wav")[0], line.split(".wav")[1]
                out[os.path.join(root, audio + ".wav")] = transcript.strip()
    return out


def blizzard2013(root):
    """prompts.gui blocks: id line, transcript line, '||' separators."""
    out = {}
    with open(os.path.join(root, "prompts.gui"), encoding="utf8") as f:
        blocks = f.read().split("||\n")
    for block in blocks:
        lines = block.split("\n")
        if lines[0].strip():
            transcript = (lines[1].replace("@", "").replace("#", ",")
                          .replace("|", "").replace(";", ",").replace(":", ",")
                          .replace(" 's", "'s").replace(", ,", ",")
                          .replace("  ", " ").replace(" ,", ",")
                          .replace(" .", ".").strip())
            wav = os.path.join(root, "wavn", lines[0].strip() + ".wav")
            if os.path.exists(wav):
                out[wav] = transcript
    return out


def synpaflex(root):
    import glob
    out = {}
    for text_path in glob.iglob(os.path.join(root, "**/*_norm.txt"), recursive=True):
        with open(text_path, "r", encoding="utf8") as f:
            transcript = f.read()
        base = os.path.basename(text_path)[:-9]
        wav = os.path.join(os.path.dirname(os.path.dirname(text_path)),
                           base + ".wav")
        if os.path.exists(wav):
            out[wav] = transcript
    return out


def siwis(root, sub_dirs=("part1", "part2", "part3")):
    import glob
    out = {}
    for sd in sub_dirs:
        for text_path in glob.iglob(os.path.join(root, "text", sd, "*.txt")):
            with open(text_path, "r", encoding="utf8") as f:
                transcript = f.read()
            stem = os.path.splitext(os.path.basename(text_path))[0]
            wav = os.path.join(root, "wavs", sd, stem + ".wav")
            if os.path.exists(wav):
                out[wav] = transcript
    return out


# -------------------------------------------------------------- registry

# name -> (template fn taking root, relative corpus dir, language code)
_RECIPES = {
    "nancy": (metadata_csv, "NancyKrebs", "en"),
    "integration_test": (partial(metadata_csv, max_lines=500), "NancyKrebs", "en"),
    "ljspeech": (partial(metadata_csv, wav_dir="wavs", transcript_index=2),
                 "LJSpeech/LJSpeech-1.1", "en"),
    "vctk": (vctk, "VCTK", "en"),
    "libritts": (libritts, "LibriTTS/train-clean-100", "en"),
    "libritts_all_clean": (libritts, "LibriTTS/all_clean", "en"),
    "nvidia_hifitts": (metadata_csv, "hi_fi_tts_v0", "en"),
    "thorsten": (metadata_csv, "Thorsten_DE", "de"),
    "thorsten_2020": (partial(metadata_csv, wav_dir="wavs"), "Thorsten_DE", "de"),
    "karlsson": (hui, "HUI_German/Karlsson", "de"),
    "eva": (hui, "HUI_German/Eva", "de"),
    "bernd": (hui, "HUI_German/Bernd", "de"),
    "friedrich": (hui, "HUI_German/Friedrich", "de"),
    "hokus": (hui, "HUI_German/Hokus", "de"),
    "hokuspokus": (txt_tree, "LibriVox.Hokuspokus", "de"),
    "hui_others": (hui_others, "HUI_German/others", "de"),
    "elizabeth": (mailabs, "MAILabs_british_single_speaker_elizabeth", "en"),
    "fluxsing": (partial(metadata_csv, wav_dir=None, transcript_index=2),
                 "FluxSing", "de"),
    "libritts_other500": (libritts, "../asr-data/LibriTTS/train-other-500", "en"),
    "att_hack": (txt_tree, "FrenchExpressive", "fr"),
    "css10cmn": (css10, "CSS10/chinese", "cmn"),
    "vietTTS": (viet_tts, "VietTTS", "vi"),
    "spanish_blizzard_train": (
        partial(tab_separated, text_file="train_text.txt", wav_dir="train_wav"),
        "Blizzard2021/spanish_blizzard_release_2021_v2/hub", "es"),
    "aishell3": (aishell3, "aishell3/train", "cmn"),
    "blizzard_2013": (blizzard2013, "Blizzard2013/train/segmented", "en"),
    "blizzard2023_ad": (blizzard2023_tsv, "Blizzard2023/AD", "fr"),
    "blizzard2023_ad_silence_removed": (blizzard2023_tsv,
                                        "Blizzard2023/AD_silence_removed", "fr"),
    "blizzard2023_neb": (blizzard2023_tsv, "Blizzard2023/NEB", "fr"),
    "blizzard2023_neb_silence_removed": (blizzard2023_tsv,
                                         "Blizzard2023/NEB_silence_removed", "fr"),
    "blizzard2023_neb_e": (blizzard2023_tsv, "Blizzard2023/enhanced_NEB_subset",
                           "fr"),
    "synpaflex_norm_subset": (synpaflex, "synpaflex-corpus/5/v0.1", "fr"),
    "synpaflex_all": (synpaflex, "synpaflex-corpus/5/v0.1", "fr"),
    "siwis_subset": (siwis, "SiwisFrenchSpeechSynthesisDatabase", "fr"),
    "mls_italian": (mls, "MultiLingLibriSpeech/mls_italian/train", "it"),
    "mls_french": (mls, "MultiLingLibriSpeech/mls_french/train", "fr"),
    "mls_dutch": (mls, "MultiLingLibriSpeech/mls_dutch/train", "nl"),
    "mls_polish": (mls, "MultiLingLibriSpeech/mls_polish/train", "pl"),
    "mls_spanish": (mls, "MultiLingLibriSpeech/mls_spanish/train", "es"),
    "mls_portuguese": (mls, "MultiLingLibriSpeech/mls_portuguese/train", "pt"),
    "css10de": (css10, "CSS10/german", "de"),
    "css10el": (css10, "CSS10/greek", "el"),
    "css10es": (css10, "CSS10/spanish", "es"),
    "css10fi": (css10, "CSS10/finnish", "fi"),
    "css10fr": (css10, "CSS10/french", "fr"),
    "css10hu": (css10, "CSS10/hungarian", "hu"),
    "css10nl": (css10, "CSS10/dutch", "nl"),
    "css10ru": (css10, "CSS10/russian", "ru"),
    "VIVOS_viet": (vivos, "VIVOS_vietnamese/train", "vi"),
    "RAVDESS": (ravdess, "RAVDESS", "en"),
    "ESDS": (esds, "Emotional_Speech_Dataset_Singapore", "en"),
    # long-form / silence-removed Blizzard 2023 variants (some live on a
    # different mount in the reference cluster layout -> absolute paths)
    "blizzard2023_ad_long": (
        blizzard2023_tsv,
        "/mount/arbeitsdaten45/projekte/asr-4/denisopl/Blizzard2023/15sec/output/AD",
        "fr"),
    "blizzard2023_ad_long_silence_removed": (
        blizzard2023_tsv, "Blizzard2023/ad_long_silence_removed", "fr"),
    "blizzard2023_neb_e_silence_removed": (
        blizzard2023_tsv, "Blizzard2023/enhanced_NEB_subset_silence_removed", "fr"),
    "blizzard2023_neb_long": (
        blizzard2023_tsv,
        "/mount/arbeitsdaten45/projekte/asr-4/denisopl/Blizzard2023/15sec/output/NEB",
        "fr"),
    "blizzard2023_neb_long_silence_removed": (
        blizzard2023_tsv, "Blizzard2023/neb_long_silence_removed", "fr"),
    "blizzard2023_neb_tiny_test": (
        partial(blizzard2023_tsv, max_entries=50), "Blizzard2023/NEB", "fr"),
}

# the reference also exposes the raw template parsers under recipe-style
# names (``hui_template``, ``multi_ling_librispeech_template``); they take a
# corpus root directly
build_path_to_transcript_dict_hui_template = hui_others
build_path_to_transcript_dict_multi_ling_librispeech_template = mls


def available_recipes():
    return sorted(_RECIPES)


def recipe_language(name: str) -> str:
    return _RECIPES[name][2]


def build_path_to_transcript_dict(name: str, corpora_root: str = None,
                                  limit: int = 40000) -> dict:
    template, rel, _ = _RECIPES[name]
    root = os.path.join(corpora_root or default_root(), rel)
    return limit_to_n(template(root), n=limit)


def __getattr__(name):
    """Provide the reference-style accessors, e.g.
    ``build_path_to_transcript_dict_nancy()``."""
    prefix = "build_path_to_transcript_dict_"
    if name.startswith(prefix):
        recipe = name[len(prefix):]
        if recipe in _RECIPES:
            return partial(build_path_to_transcript_dict, recipe)
    raise AttributeError(name)
