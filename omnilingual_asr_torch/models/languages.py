"""Language inventory for the LID head.

The PyTorch port's own copy of ``omnilingual_asr_tpu/models/languages.py`` (the port imports nothing
of the JAX package); keep the two in step.

The reference claims 1600+ languages via its citation to the Omnilingual-ASR
paper (reference README.md:96-107) but carries no language table of its own —
language names/codes come back from Gemini free-form (schema,
gemini_pipeline.py:164-175). Locally the LID head emits class ids; this table
maps ids to ``{"name": ..., "code": ...}`` dicts in the exact shape the
schema uses.

Ids 0..258 are curated (ISO 639-1 where one exists, else 639-3; ordering
chosen so common languages get small ids). Ids 259..2047 continue with ISO
639-3 living individual languages (languages_data.py, generated from the
Debian iso-codes table), filling the N_LANGS=2048 head entirely with real
languages — 2048 >= the 1600+ the reference claims (README.md:96-107).
language_for_id therefore never fabricates a name for any id the head can
emit; ids outside the head range still fall back to ("Language <id>",
"und") so the contract can't break.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

# (name, code) — English first: id 0 is the default/fallback language.
KNOWN_LANGUAGES: List[Tuple[str, str]] = [
    ("English", "en"), ("Mandarin Chinese", "zh"), ("Spanish", "es"),
    ("Hindi", "hi"), ("Arabic", "ar"), ("Bengali", "bn"), ("Portuguese", "pt"),
    ("Russian", "ru"), ("Japanese", "ja"), ("Punjabi", "pa"), ("German", "de"),
    ("French", "fr"), ("Javanese", "jv"), ("Korean", "ko"), ("Telugu", "te"),
    ("Vietnamese", "vi"), ("Marathi", "mr"), ("Tamil", "ta"), ("Urdu", "ur"),
    ("Turkish", "tr"), ("Italian", "it"), ("Thai", "th"), ("Gujarati", "gu"),
    ("Persian", "fa"), ("Polish", "pl"), ("Pashto", "ps"), ("Kannada", "kn"),
    ("Malayalam", "ml"), ("Sundanese", "su"), ("Hausa", "ha"), ("Odia", "or"),
    ("Burmese", "my"), ("Ukrainian", "uk"), ("Indonesian", "id"),
    ("Tagalog", "tl"), ("Dutch", "nl"), ("Romanian", "ro"), ("Greek", "el"),
    ("Czech", "cs"), ("Swedish", "sv"), ("Hungarian", "hu"), ("Hebrew", "he"),
    ("Swahili", "sw"), ("Amharic", "am"), ("Yoruba", "yo"), ("Igbo", "ig"),
    ("Zulu", "zu"), ("Xhosa", "xh"), ("Afrikaans", "af"), ("Somali", "so"),
    ("Nepali", "ne"), ("Sinhala", "si"), ("Khmer", "km"), ("Lao", "lo"),
    ("Mongolian", "mn"), ("Kazakh", "kk"), ("Uzbek", "uz"), ("Azerbaijani", "az"),
    ("Georgian", "ka"), ("Armenian", "hy"), ("Albanian", "sq"), ("Serbian", "sr"),
    ("Croatian", "hr"), ("Bosnian", "bs"), ("Slovenian", "sl"), ("Slovak", "sk"),
    ("Bulgarian", "bg"), ("Macedonian", "mk"), ("Lithuanian", "lt"),
    ("Latvian", "lv"), ("Estonian", "et"), ("Finnish", "fi"), ("Danish", "da"),
    ("Norwegian", "no"), ("Icelandic", "is"), ("Irish", "ga"), ("Welsh", "cy"),
    ("Basque", "eu"), ("Catalan", "ca"), ("Galician", "gl"), ("Malay", "ms"),
    ("Cebuano", "ceb"), ("Malagasy", "mg"), ("Haitian Creole", "ht"),
    ("Quechua", "qu"), ("Aymara", "ay"), ("Guarani", "gn"), ("Maori", "mi"),
    ("Samoan", "sm"), ("Tongan", "to"), ("Fijian", "fj"), ("Hawaiian", "haw"),
    ("Tibetan", "bo"), ("Uyghur", "ug"), ("Kyrgyz", "ky"), ("Tajik", "tg"),
    ("Turkmen", "tk"), ("Kurdish", "ku"), ("Sindhi", "sd"), ("Balochi", "bal"),
    ("Dari", "prs"), ("Assamese", "as"), ("Maithili", "mai"), ("Bhojpuri", "bho"),
    ("Santali", "sat"), ("Konkani", "gom"), ("Dogri", "doi"), ("Manipuri", "mni"),
    ("Bodo", "brx"), ("Kashmiri", "ks"), ("Sanskrit", "sa"), ("Dzongkha", "dz"),
    ("Tswana", "tn"), ("Sotho", "st"), ("Shona", "sn"), ("Ndebele", "nd"),
    ("Kinyarwanda", "rw"), ("Kirundi", "rn"), ("Luganda", "lg"), ("Lingala", "ln"),
    ("Kikongo", "kg"), ("Tshiluba", "lua"), ("Wolof", "wo"), ("Fula", "ff"),
    ("Bambara", "bm"), ("Ewe", "ee"), ("Twi", "tw"), ("Ga", "gaa"),
    ("Akan", "ak"), ("Oromo", "om"), ("Tigrinya", "ti"), ("Afar", "aa"),
    ("Luo", "luo"), ("Kikuyu", "ki"), ("Kamba", "kam"), ("Maasai", "mas"),
    ("Lisu", "lis"), ("Lahu", "lhu"), ("Akha", "ahk"), ("Karen", "kar"),
    ("Hmong", "hmn"), ("Mien", "ium"), ("Shan", "shn"), ("Kachin", "kac"),
    ("Chin", "cnh"), ("Naga", "nag"), ("Mizo", "lus"), ("Garo", "grt"),
    ("Khasi", "kha"), ("Esperanto", "eo"), ("Latin", "la"), ("Yiddish", "yi"),
    ("Ladino", "lad"), ("Romani", "rom"), ("Cherokee", "chr"), ("Navajo", "nv"),
    ("Inuktitut", "iu"), ("Greenlandic", "kl"), ("Cree", "cr"), ("Ojibwe", "oj"),
    ("Nahuatl", "nah"), ("Maya", "myn"), ("Mapudungun", "arn"),
    # -- remaining ISO 639-1 codes --
    ("Abkhaz", "ab"), ("Aragonese", "an"), ("Avaric", "av"),
    ("Bashkir", "ba"), ("Belarusian", "be"), ("Bislama", "bi"),
    ("Breton", "br"), ("Chechen", "ce"), ("Chamorro", "ch"),
    ("Corsican", "co"), ("Church Slavonic", "cu"), ("Chuvash", "cv"),
    ("Divehi", "dv"), ("Faroese", "fo"), ("Western Frisian", "fy"),
    ("Scottish Gaelic", "gd"), ("Manx", "gv"), ("Hiri Motu", "ho"),
    ("Interlingua", "ia"), ("Sichuan Yi", "ii"), ("Inupiaq", "ik"),
    ("Ido", "io"), ("Kuanyama", "kj"), ("Kanuri", "kr"), ("Komi", "kv"),
    ("Cornish", "kw"), ("Luxembourgish", "lb"), ("Limburgish", "li"),
    ("Luba-Katanga", "lu"), ("Marshallese", "mh"), ("Maltese", "mt"),
    ("Nauru", "na"), ("Norwegian Bokmal", "nb"), ("Ndonga", "ng"),
    ("Norwegian Nynorsk", "nn"), ("South Ndebele", "nr"),
    ("Chichewa", "ny"), ("Occitan", "oc"), ("Ossetian", "os"),
    ("Pali", "pi"), ("Romansh", "rm"), ("Sardinian", "sc"),
    ("Northern Sami", "se"), ("Sango", "sg"), ("Swati", "ss"),
    ("Tsonga", "ts"), ("Tatar", "tt"), ("Tahitian", "ty"),
    ("Venda", "ve"), ("Volapuk", "vo"), ("Walloon", "wa"),
    ("Zhuang", "za"),
    # -- widely-spoken ISO 639-3 languages --
    ("Cantonese", "yue"), ("Wu Chinese", "wuu"), ("Min Nan", "nan"),
    ("Hakka", "hak"), ("Ilocano", "ilo"), ("Hiligaynon", "hil"),
    ("Waray", "war"), ("Kapampangan", "pam"), ("Pangasinan", "pag"),
    ("Central Bikol", "bcl"), ("Egyptian Arabic", "arz"),
    ("Moroccan Arabic", "ary"), ("Sylheti", "syl"),
    ("Chittagonian", "ctg"), ("Marwari", "mwr"), ("Awadhi", "awa"),
    ("Chhattisgarhi", "hne"), ("Magahi", "mag"), ("Haryanvi", "bgc"),
    ("Rajasthani", "raj"), ("Madurese", "mad"), ("Minangkabau", "min"),
    ("Buginese", "bug"), ("Acehnese", "ace"), ("Balinese", "ban"),
    ("Zazaki", "zza"), ("Sorani Kurdish", "ckb"), ("Tachelhit", "shi"),
    ("Kabyle", "kab"), ("Central Atlas Tamazight", "tzm"),
    ("Serer", "srr"), ("Soninke", "snk"), ("Mossi", "mos"),
    ("Dagbani", "dag"), ("Luhya", "luy"), ("Sukuma", "suk"),
    ("Bemba", "bem"), ("Tumbuka", "tum"), ("Tigre", "tig"),
    ("Sidamo", "sid"), ("Wolaytta", "wal"), ("Gondi", "gon"),
    ("Tulu", "tcy"), ("Newari", "new"),
]

CURATED_COUNT = len(KNOWN_LANGUAGES)

from .languages_data import EXTENDED  # noqa: E402

KNOWN_LANGUAGES = KNOWN_LANGUAGES + EXTENDED


def language_for_id(lang_id: int) -> Dict[str, str]:
    """LID class id -> {"name", "code"} (schema shape,
    reference gemini_pipeline.py:164-175)."""
    if 0 <= lang_id < len(KNOWN_LANGUAGES):
        name, code = KNOWN_LANGUAGES[lang_id]
        return {"name": name, "code": code}
    return {"name": f"Language {lang_id}", "code": "und"}


# First occurrence wins so curated ids take priority over the extended
# table (ISO 639-3 has some duplicate display names).
_BY_CODE: Dict[str, int] = {}
_BY_NAME: Dict[str, int] = {}
for _i, (_name, _code) in enumerate(KNOWN_LANGUAGES):
    _BY_CODE.setdefault(_code, _i)
    _BY_NAME.setdefault(_name.lower(), _i)


def id_for_language(hint: str) -> int:
    """Resolve a user language hint ('en', 'English', ...) to a class id;
    -1 if unknown."""
    if not hint:
        return -1
    h = hint.strip().lower()
    if h in _BY_CODE:
        return _BY_CODE[h]
    return _BY_NAME.get(h, -1)
