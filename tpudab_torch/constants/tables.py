"""Human-label constant tables: programme types, languages, countries.

Reference parity: vendor/DAB-Radio constant tables consumed by
the reference's src/render_formatters.cpp:66-105 (programme type, language,
country, AAC profile, MPEG surround strings). Sources: ETSI TS 101 756
(registered tables).
"""

from __future__ import annotations

# TS 101 756 Table 12: international programme type codes (English set).
PROGRAMME_TYPES = [
    "None", "News", "Current Affairs", "Information", "Sport", "Education",
    "Drama", "Culture", "Science", "Varied", "Pop Music", "Rock Music",
    "Easy Listening Music", "Light Classical", "Serious Classical",
    "Other Music", "Weather/meteorology", "Finance/Business", "Children's programmes",
    "Social Affairs", "Religion", "Phone In", "Travel", "Leisure",
    "Jazz Music", "Country Music", "National Music", "Oldies Music",
    "Folk Music", "Documentary", "Not used", "Not used",
]

# TS 101 756 Table 9: language codes (subset of the 0x00-0x7F range that is
# assigned; unassigned codes render as hex).
LANGUAGES = {
    0x00: "Unknown/not applicable", 0x01: "Albanian", 0x02: "Breton",
    0x03: "Catalan", 0x04: "Croatian", 0x05: "Welsh", 0x06: "Czech",
    0x07: "Danish", 0x08: "German", 0x09: "English", 0x0A: "Spanish",
    0x0B: "Esperanto", 0x0C: "Estonian", 0x0D: "Basque", 0x0E: "Faroese",
    0x0F: "French", 0x10: "Frisian", 0x11: "Irish", 0x12: "Gaelic",
    0x13: "Galician", 0x14: "Icelandic", 0x15: "Italian", 0x16: "Sami",
    0x17: "Latin", 0x18: "Latvian", 0x19: "Luxembourgian", 0x1A: "Lithuanian",
    0x1B: "Hungarian", 0x1C: "Maltese", 0x1D: "Dutch", 0x1E: "Norwegian",
    0x1F: "Occitan", 0x20: "Polish", 0x21: "Portuguese", 0x22: "Romanian",
    0x23: "Romansh", 0x24: "Serbian", 0x25: "Slovak", 0x26: "Slovene",
    0x27: "Finnish", 0x28: "Swedish", 0x29: "Turkish", 0x2A: "Flemish",
    0x2B: "Walloon",
    0x40: "Background sound/clean feed", 0x45: "Zulu", 0x46: "Vietnamese",
    0x47: "Uzbek", 0x48: "Urdu", 0x49: "Ukrainian", 0x4A: "Thai",
    0x4B: "Telugu", 0x4C: "Tatar", 0x4D: "Tamil", 0x4E: "Tadzhik",
    0x4F: "Swahili", 0x50: "Sranan Tongo", 0x51: "Somali", 0x52: "Sinhalese",
    0x53: "Shona", 0x54: "Serbo-Croat", 0x55: "Rusyn", 0x56: "Russian",
    0x57: "Quechua", 0x58: "Pushtu", 0x59: "Punjabi", 0x5A: "Persian",
    0x5B: "Papiamento", 0x5C: "Oriya", 0x5D: "Nepali", 0x5E: "Ndebele",
    0x5F: "Marathi", 0x60: "Moldavian", 0x61: "Malaysian", 0x62: "Malagasay",
    0x63: "Macedonian", 0x64: "Laotian", 0x65: "Korean", 0x66: "Khmer",
    0x67: "Kazakh", 0x68: "Kannada", 0x69: "Japanese", 0x6A: "Indonesian",
    0x6B: "Hindi", 0x6C: "Hebrew", 0x6D: "Hausa", 0x6E: "Gurani",
    0x6F: "Gujurati", 0x70: "Greek", 0x71: "Georgian", 0x72: "Fulani",
    0x73: "Dari", 0x74: "Chuvash", 0x75: "Chinese", 0x76: "Burmese",
    0x77: "Bulgarian", 0x78: "Bengali", 0x79: "Belorussian", 0x7A: "Bambora",
    0x7B: "Azerbaijani", 0x7C: "Assamese", 0x7D: "Armenian", 0x7E: "Arabic",
    0x7F: "Amharic",
}

# TS 101 756 Tables 3-7: country Id + ECC -> country. Key: (ecc, country_id).
# ECC 0xE0-0xE4 = Europe, 0xD0+ = Africa, 0xA0+ = N. America, 0xF0+ = Asia.
COUNTRIES = {
    (0xE0, 0x1): "Germany", (0xE0, 0x2): "Algeria", (0xE0, 0x3): "Andorra",
    (0xE0, 0x4): "Israel", (0xE0, 0x5): "Italy", (0xE0, 0x6): "Belgium",
    (0xE0, 0x7): "Russian Federation", (0xE0, 0x8): "Azores", (0xE0, 0x9): "Albania",
    (0xE0, 0xA): "Austria", (0xE0, 0xB): "Hungary", (0xE0, 0xC): "Malta",
    (0xE0, 0xD): "Germany", (0xE0, 0xF): "Egypt",
    (0xE1, 0x1): "Greece", (0xE1, 0x2): "Cyprus", (0xE1, 0x3): "San Marino",
    (0xE1, 0x4): "Switzerland", (0xE1, 0x5): "Jordan", (0xE1, 0x6): "Finland",
    (0xE1, 0x7): "Luxembourg", (0xE1, 0x8): "Bulgaria", (0xE1, 0x9): "Denmark",
    (0xE1, 0xA): "Gibraltar", (0xE1, 0xB): "Iraq", (0xE1, 0xC): "United Kingdom",
    (0xE1, 0xD): "Libya", (0xE1, 0xE): "Romania", (0xE1, 0xF): "France",
    (0xE2, 0x1): "Morocco", (0xE2, 0x2): "Czech Republic", (0xE2, 0x3): "Poland",
    (0xE2, 0x4): "Vatican", (0xE2, 0x5): "Slovakia", (0xE2, 0x6): "Syria",
    (0xE2, 0x7): "Tunisia", (0xE2, 0x9): "Liechtenstein", (0xE2, 0xA): "Iceland",
    (0xE2, 0xB): "Monaco", (0xE2, 0xC): "Lithuania", (0xE2, 0xD): "Serbia",
    (0xE2, 0xE): "Spain", (0xE2, 0xF): "Norway",
    (0xE3, 0x1): "Montenegro", (0xE3, 0x2): "Ireland", (0xE3, 0x3): "Turkey",
    (0xE3, 0x5): "Tajikistan", (0xE3, 0x8): "Netherlands", (0xE3, 0x9): "Latvia",
    (0xE3, 0xA): "Lebanon", (0xE3, 0xB): "Azerbaijan", (0xE3, 0xC): "Croatia",
    (0xE3, 0xD): "Kazakhstan", (0xE3, 0xE): "Sweden", (0xE3, 0xF): "Belarus",
    (0xE4, 0x1): "Moldova", (0xE4, 0x2): "Estonia", (0xE4, 0x3): "Macedonia",
    (0xE4, 0x6): "Ukraine", (0xE4, 0x7): "Kosovo", (0xE4, 0x9): "Slovenia",
    (0xE4, 0xA): "Armenia", (0xE4, 0xB): "Uzbekistan", (0xE4, 0xC): "Georgia",
    (0xE4, 0xE): "Turkmenistan", (0xE4, 0xF): "Bosnia Herzegovina",
    (0xF0, 0x1): "Australia: Capital Cities", (0xF0, 0x2): "Australia: Regional New South Wales",
    (0xF0, 0x3): "Australia: Capital Cities", (0xF0, 0x4): "Australia: Regional Queensland",
}


def programme_type_str(pty: int) -> str:
    if 0 <= pty < len(PROGRAMME_TYPES):
        return PROGRAMME_TYPES[pty]
    return f"PTY {pty}"


def language_str(code: int) -> str:
    return LANGUAGES.get(code, f"Language 0x{code:02X}")


def country_str(ecc: int, country_id: int) -> str:
    return COUNTRIES.get((ecc, country_id), f"ECC 0x{ecc:02X} Id 0x{country_id:X}")


def aac_profile_str(is_sbr: bool, is_ps: bool) -> str:
    """render_formatters.cpp:78-89 parity."""
    if is_sbr and is_ps:
        return "HE-AACv2"
    if is_sbr:
        return "HE-AACv1"
    return "AAC-LC"


MPEG_SURROUND = {0: "None", 1: "5.1", 2: "7.1", 7: "Other"}


def mpeg_surround_str(code: int) -> str:
    """render_formatters.cpp:91-105 parity."""
    return MPEG_SURROUND.get(code, f"Reserved ({code})")
