"""English text normalizer for WER computation.

Rebuild of ``[pip:whisper] normalizers.english.EnglishTextNormalizer``
(imported at ``scripts/eval/eval.py:50,1817`` and used for every
WER number in the reference's tables). Three stages, matching the original:

  1. ``EnglishNumberNormalizer`` — spelled-out numbers -> digits (handles
     cardinals, ordinals, currency, percent, fractions-as-suffixes, "point"
     decimals, "double/triple" digits, era suffixes like AD/BC).
  2. ``EnglishSpellingNormalizer`` — British -> American spellings. whisper
     ships a ~1.7k-entry json; we combine an embedded high-frequency table with
     rule-generated variants and accept a drop-in json override
     (``OLMOASR_SPELLING_JSON``) for exact parity when the asset is available.
  3. ``EnglishTextNormalizer`` — casing, bracket/parenthesis removal, filler
     words, contractions, symbol cleanup.

Attribution: the ``EnglishNumberNormalizer`` state machine and the
``EnglishTextNormalizer`` contraction/abbreviation rule tables in this file
are ported from openai-whisper (``whisper/normalizers/english.py``),
Copyright (c) 2022 OpenAI, MIT License — see the repository-root ``NOTICES``
file. These rules are the behavioral spec behind every published WER number;
reimplementing them differently would be a parity bug, not an improvement.
The spelling-normalizer section is an original reconstruction
(``build_spelling.py``).

A copy of ``olmoasr_tpu/normalizers/english.py`` that reads the port's own
asset, ``olmoasr_tpu_torch/assets/english.json`` (a copy of the JAX
package's, byte-equal); ``tests/test_torch_eval.py`` pins both.
"""

from __future__ import annotations

import json
import os
import re
from fractions import Fraction
from typing import Iterator, List, Match, Optional, Union

from olmoasr_tpu_torch.normalizers.basic import remove_symbols_and_diacritics


class EnglishNumberNormalizer:
    """Convert spelled-out English numbers into arabic numerals, keeping
    post-processing for currency ("$1.50") and "point" decimals."""

    def __init__(self):
        super().__init__()

        self.zeros = {"o", "oh", "zero"}
        self.ones = {
            name: i
            for i, name in enumerate(
                ["one", "two", "three", "four", "five", "six", "seven", "eight",
                 "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
                 "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"],
                start=1,
            )
        }
        self.ones_plural = {
            "sixes" if name == "six" else name + "s": (value, "s")
            for name, value in self.ones.items()
        }
        self.ones_ordinal = {
            "zeroth": (0, "th"),
            "first": (1, "st"),
            "second": (2, "nd"),
            "third": (3, "rd"),
            "fifth": (5, "th"),
            "twelfth": (12, "th"),
            **{
                name + ("h" if name.endswith("t") else "th"): (value, "th")
                for name, value in self.ones.items()
                if value > 3 and value != 5 and value != 12
            },
        }
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = {
            "twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
            "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90,
        }
        self.tens_plural = {
            name.replace("y", "ies"): (value, "s") for name, value in self.tens.items()
        }
        self.tens_ordinal = {
            name.replace("y", "ieth"): (value, "th")
            for name, value in self.tens.items()
        }
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = {
            "hundred": 100,
            "thousand": 1_000,
            "million": 1_000_000,
            "billion": 1_000_000_000,
            "trillion": 1_000_000_000_000,
            "quadrillion": 1_000_000_000_000_000,
            "quintillion": 1_000_000_000_000_000_000,
            "sextillion": 1_000_000_000_000_000_000_000,
            "septillion": 1_000_000_000_000_000_000_000_000,
            "octillion": 1_000_000_000_000_000_000_000_000_000,
            "nonillion": 1_000_000_000_000_000_000_000_000_000_000,
            "decillion": 1_000_000_000_000_000_000_000_000_000_000_000,
        }
        self.multipliers_plural = {
            name + "s": (value, "s") for name, value in self.multipliers.items()
        }
        self.multipliers_ordinal = {
            name + "th": (value, "th") for name, value in self.multipliers.items()
        }
        self.multipliers_suffixed = {
            **self.multipliers_plural,
            **self.multipliers_ordinal,
        }
        self.decimals = {*self.ones, *self.tens, *self.zeros}

        self.preceding_prefixers = {
            "minus": "-", "negative": "-", "plus": "+", "positive": "+",
        }
        self.following_prefixers = {
            "pound": "£", "pounds": "£", "euro": "€", "euros": "€",
            "dollar": "$", "dollars": "$", "cent": "¢", "cents": "¢",
        }
        self.prefixes = set(self.preceding_prefixers.values()) | set(
            self.following_prefixers.values()
        )
        self.suffixers = {
            "per": {"cent": "%"},
            "percent": "%",
        }
        self.specials = {"and", "double", "triple", "point"}

        self.words = {
            key
            for mapping in [
                self.zeros, self.ones, self.ones_suffixed, self.tens,
                self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
                self.preceding_prefixers, self.following_prefixers,
                self.suffixers, self.specials,
            ]
            for key in mapping
        }
        self.literal_words = {"one", "ones"}

    def process_words(self, words: List[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def to_fraction(s: str):
            try:
                return Fraction(s)
            except ValueError:
                return None

        def output(result: Union[str, int]):
            nonlocal prefix, value
            result = str(result)
            if prefix is not None:
                result = prefix + result
            value = None
            prefix = None
            return result

        if len(words) == 0:
            return

        for i, current in enumerate(words):
            prev = words[i - 1] if i != 0 else None
            next_ = words[i + 1] if i != len(words) - 1 else None
            if skip:
                skip = False
                continue

            next_is_numeric = next_ is not None and re.match(r"^\d+(\.\d+)?$", next_)
            has_prefix = current[0] in self.prefixes
            current_without_prefix = current[1:] if has_prefix else current
            if re.match(r"^\d+(\.\d+)?$", current_without_prefix):
                # arabic numbers (potentially with signs and fractions)
                f = to_fraction(current_without_prefix)
                if f is None:
                    raise ValueError("Converting the fraction failed")
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        # concatenate decimals / ip-address-like
                        value = str(value) + str(current)
                        continue
                    else:
                        yield output(value)

                prefix = current[0] if has_prefix else prefix
                if f.denominator == 1:
                    value = f.numerator  # store integers as int
                else:
                    value = current_without_prefix
            elif current not in self.words:
                # non-numeric words
                if value is not None:
                    yield output(value)
                yield output(current)
            elif current in self.zeros:
                value = str(value or "") + "0"
            elif current in self.ones:
                ones = self.ones[current]

                if value is None:
                    value = ones
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:  # twenty one => 21
                        assert value is not None
                        value = str(value)[:-1] + str(ones)
                    else:
                        value = str(value) + str(ones)
                elif ones < 10:
                    if value % 10 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
                else:  # eleven to nineteen
                    if value % 100 == 0:
                        value += ones
                    else:
                        value = str(value) + str(ones)
            elif current in self.ones_suffixed:
                # ordinal or cardinal; yield the number right away
                ones, suffix = self.ones_suffixed[current]
                if value is None:
                    yield output(str(ones) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and ones < 10:
                        yield output(str(value)[:-1] + str(ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                elif ones < 10:
                    if value % 10 == 0:
                        yield output(str(value + ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                else:  # eleven to nineteen
                    if value % 100 == 0:
                        yield output(str(value + ones) + suffix)
                    else:
                        yield output(str(value) + str(ones) + suffix)
                value = None
            elif current in self.tens:
                tens = self.tens[current]
                if value is None:
                    value = tens
                elif isinstance(value, str):
                    value = str(value) + str(tens)
                else:
                    if value % 100 == 0:
                        value += tens
                    else:
                        value = str(value) + str(tens)
            elif current in self.tens_suffixed:
                tens, suffix = self.tens_suffixed[current]
                if value is None:
                    yield output(str(tens) + suffix)
                elif isinstance(value, str):
                    yield output(str(value) + str(tens) + suffix)
                else:
                    if value % 100 == 0:
                        yield output(str(value + tens) + suffix)
                    else:
                        yield output(str(value) + str(tens) + suffix)
            elif current in self.multipliers:
                multiplier = self.multipliers[current]
                if value is None:
                    value = multiplier
                elif isinstance(value, str) or value == 0:
                    f = to_fraction(str(value))
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield output(value)
                        value = multiplier
                else:
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
            elif current in self.multipliers_suffixed:
                multiplier, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield output(str(multiplier) + suffix)
                elif isinstance(value, str):
                    f = to_fraction(str(value))
                    p = f * multiplier if f is not None else None
                    if f is not None and p.denominator == 1:
                        yield output(str(p.numerator) + suffix)
                    else:
                        yield output(value)
                        yield output(str(multiplier) + suffix)
                else:  # int
                    before = value // 1000 * 1000
                    residual = value % 1000
                    value = before + residual * multiplier
                    yield output(str(value) + suffix)
                value = None
            elif current in self.preceding_prefixers:
                # apply prefix (positive, minus, etc.) if it precedes a number
                if value is not None:
                    yield output(value)
                if next_ in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield output(current)
            elif current in self.following_prefixers:
                # apply prefix (dollars, cents, etc.) only after a number
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield output(value)
                else:
                    yield output(current)
            elif current in self.suffixers:
                # apply suffix symbols (percent -> '%')
                if value is not None:
                    suffix = self.suffixers[current]
                    if isinstance(suffix, dict):
                        if next_ in suffix:
                            yield output(str(value) + suffix[next_])
                            skip = True
                        else:
                            yield output(value)
                            yield output(current)
                    else:
                        yield output(str(value) + suffix)
                else:
                    yield output(current)
            elif current in self.specials:
                if next_ not in self.words and not next_is_numeric:
                    # apply special handling only if the next word can be numeric
                    if value is not None:
                        yield output(value)
                    yield output(current)
                elif current == "and":
                    # ignore "and" after hundreds, thousands, etc.
                    if prev not in self.multipliers:
                        if value is not None:
                            yield output(value)
                        yield output(current)
                elif current == "double" or current == "triple":
                    if next_ in self.ones or next_ in self.zeros:
                        repeats = 2 if current == "double" else 3
                        ones = self.ones.get(next_, 0)
                        value = str(value or "") + str(ones) * repeats
                        skip = True
                    else:
                        if value is not None:
                            yield output(value)
                        yield output(current)
                elif current == "point":
                    if next_ in self.decimals or next_is_numeric:
                        value = str(value or "") + "."
                else:
                    # should all have been covered at this point
                    raise ValueError(f"Unexpected token: {current}")
            else:
                # all should have been covered at this point
                raise ValueError(f"Unexpected token: {current}")

        if value is not None:
            yield output(value)

    def preprocess(self, s: str) -> str:
        # replace "<number> and a half" with "<number> point five"
        results = []
        segments = re.split(r"\band\s+a\s+half\b", s)
        for i, segment in enumerate(segments):
            if len(segment.strip()) == 0:
                continue
            if i == len(segments) - 1:
                results.append(segment)
            else:
                results.append(segment)
                last_word = segment.rsplit(maxsplit=2)[-1]
                if last_word in self.decimals or last_word in self.multipliers:
                    results.append("point five")
                else:
                    results.append("and a half")

        s = " ".join(results)

        # put a space at number/letter boundary
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)

        # but remove spaces which could be a suffix
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def postprocess(self, s: str) -> str:
        def combine_cents(m: Match) -> str:
            try:
                currency = m.group(1)
                integer = m.group(2)
                cents = int(m.group(3))
                return f"{currency}{integer}.{cents:02d}"
            except ValueError:
                return m.string

        def extract_cents(m: Match) -> str:
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        # apply currency postprocessing: "$2 and ¢7" -> "$2.07"
        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", combine_cents, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", extract_cents, s)

        # write "one(s)" instead of "1(s)", just for readability — but not
        # after currency symbols or inside decimals
        s = re.sub(r"(?<![\d.€£$¢])\b1(s?)\b(?!\.\d)", r"one\1", s)

        return s

    def __call__(self, s: str) -> str:
        s = self.preprocess(s)
        s = " ".join(word for word in self.process_words(s.split()) if word is not None)
        s = self.postprocess(s)
        return s


class EnglishSpellingNormalizer:
    """British -> American spellings.

    whisper reads a ~1.7k-entry ``english.json`` asset. We build the mapping
    from (a) an embedded table of the highest-frequency entries, (b)
    rule-generated variants, and (c) an optional drop-in json (exact parity)
    at ``$OLMOASR_SPELLING_JSON`` or ``olmoasr_tpu_torch/assets/english.json``.
    """

    def __init__(self):
        mapping = dict(_BUILTIN_SPELLINGS)
        mapping.update(_generated_spellings())
        for path in (
            os.environ.get("OLMOASR_SPELLING_JSON", ""),
            os.path.join(os.path.dirname(__file__), "..", "assets", "english.json"),
        ):
            if path and os.path.isfile(path):
                with open(path, encoding="utf-8") as f:
                    mapping = json.load(f)
                break
        self.mapping = mapping

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(word, word) for word in s.split())


#: -ise verb stems whose US form takes -ize. Audited: a stem only appears
#: here if <stem>ise is the standard British spelling AND <stem>ize the
#: standard American one. Words spelled -ise in BOTH dialects (advertise,
#: franchise, improvise, supervise, surprise, exercise, ...) must NEVER be
#: listed — mapping them would corrupt correct American text.
_ISE_STEMS = [
    "acclimat", "accessor", "agon", "alphabet", "amort", "anaesthet",
    "anglic", "annual", "antagon", "apolog", "atom", "author", "bapt",
    "bastard", "bowdler", "brutal", "bureaucrat", "burglar", "cannibal",
    "canon", "capital", "capsul", "caramel", "carbon", "categor", "cauter",
    "central", "character", "christian", "circular", "civil", "collectiv",
    "colon", "commercial", "compartmental", "computer",
    "conceptual", "contextual", "criminal", "critic", "crystall", "custom",
    "decarbon", "decentral", "decimal", "decolon", "decriminal",
    "dehuman", "demilitar", "demobil", "democrat", "demon", "demoral",
    "deodor", "depersonal", "deput", "desensit", "destabil", "digit",
    "disorgan", "dramat", "econom", "editorial", "empath", "emphas",
    "energ", "epitom", "equal", "eulog", "evangel", "extempor",
    "external", "factor", "familiar", "fantas", "federal", "femin",
    "fertil", "fictional", "final", "formal", "fossil", "fratern",
    "galvan", "general", "ghetto", "glamor", "global", "harmon", "homogen",
    "hospital", "human", "hybrid", "hypnot", "hypothes", "ideal", "idol",
    "immobil", "immortal", "immun", "incentiv", "individual", "industrial",
    "initial", "institutional", "internal", "international", "ion",
    "italic", "item", "jeopard", "legal", "legitim", "liberal", "lion",
    "liquid", "local", "magnet", "marginal", "material", "maxim", "mechan",
    "memorial", "memor", "mesmer", "metabol", "militar", "mineral",
    "miniatur", "minim", "mobil", "modern", "moistur", "monet", "monopol",
    "moral", "motor", "national", "natural", "neutral", "normal", "notar",
    "optim", "organ", "ostrac", "oxid", "particular", "pasteur", "patron",
    "penal", "personal", "philosoph", "plagiar", "plural", "polar",
    "politic", "popular", "pressur", "priorit", "privat", "professional",
    "public", "pulver", "radical", "random", "rational", "real", "recogn",
    "revolution", "romantic", "sanit", "satir", "scandal", "scrutin",
    "secular", "sensational", "sensit", "sentimental", "serial", "sermon",
    "social", "solemn", "special", "stabil", "standard", "steril",
    "stigmat", "subsid", "summar", "symbol", "sympath", "synchron",
    "synthes", "systemat", "tantal", "temporal", "terror", "theor",
    "traumat", "trivial", "tyrann", "urban", "util", "vandal", "vapor",
    "verbal", "victim", "visual", "vocal", "vulgar", "western", "winter",
]

#: -yse verbs (US -yze)
_YSE_STEMS = [
    "anal", "breathal", "catal", "dial", "electrol", "hydrol", "paral",
    "psychoanal",
]

#: -our nouns (US -or); value = extra derived suffix pairs beyond s/ed/ing
_OUR_WORDS = [
    ("arbour", "arbor"), ("ardour", "ardor"), ("armour", "armor"),
    ("behaviour", "behavior"), ("belabour", "belabor"), ("candour", "candor"),
    ("clamour", "clamor"), ("colour", "color"), ("demeanour", "demeanor"),
    ("discolour", "discolor"), ("dishonour", "dishonor"),
    ("enamour", "enamor"), ("endeavour", "endeavor"), ("favour", "favor"),
    ("fervour", "fervor"), ("flavour", "flavor"), ("glamour", "glamor"),
    ("harbour", "harbor"), ("honour", "honor"), ("humour", "humor"),
    ("labour", "labor"), ("misdemeanour", "misdemeanor"),
    ("neighbour", "neighbor"), ("odour", "odor"), ("parlour", "parlor"),
    ("rancour", "rancor"), ("rigour", "rigor"), ("rumour", "rumor"),
    ("saviour", "savior"), ("savour", "savor"), ("splendour", "splendor"),
    ("succour", "succor"), ("tumour", "tumor"), ("valour", "valor"),
    ("vapour", "vapor"), ("vigour", "vigor"), ("watercolour", "watercolor"),
]

#: -re nouns (US -er)
_RE_WORDS = [
    ("amphitheatre", "amphitheater"), ("calibre", "caliber"),
    ("centimetre", "centimeter"), ("centre", "center"),
    ("epicentre", "epicenter"), ("fibre", "fiber"), ("goitre", "goiter"),
    ("kilometre", "kilometer"), ("litre", "liter"), ("louvre", "louver"),
    ("lustre", "luster"), ("manoeuvre", "maneuver"), ("meagre", "meager"),
    ("metre", "meter"), ("micrometre", "micrometer"),
    ("millilitre", "milliliter"), ("millimetre", "millimeter"),
    ("mitre", "miter"), ("nanometre", "nanometer"), ("nitre", "niter"),
    ("ochre", "ocher"), ("outmanoeuvre", "outmaneuver"),
    ("reconnoitre", "reconnoiter"), ("sabre", "saber"),
    ("saltpetre", "saltpeter"), ("sceptre", "scepter"),
    ("sepulchre", "sepulcher"), ("sombre", "somber"), ("spectre", "specter"),
    ("theatre", "theater"), ("titre", "titer"),
]

#: verbs where British doubles the final L before -ed/-ing (US single L)
_DOUBLE_L_VERBS = [
    "barrel", "bevel", "cancel", "carol", "cavil", "channel", "chisel",
    "counsel", "cudgel", "dial", "drivel", "duel", "enamel", "equal",
    "fuel", "funnel", "gambol", "gravel", "grovel", "imperil", "initial",
    "jewel", "kennel", "label", "laurel", "level", "libel", "marshal",
    "marvel", "medal", "model", "panel", "parcel", "pedal", "pencil",
    "pummel", "quarrel", "ravel", "revel", "rival", "shovel", "shrivel",
    "signal", "snivel", "snorkel", "spiral", "squirrel", "stencil",
    "swivel", "tassel", "towel", "trammel", "travel", "tunnel", "unravel",
    "yodel",
]

#: -ll- agent nouns (British -ller, US -ler)
_DOUBLE_L_AGENTS = [
    "counsel", "grovel", "jewel", "level", "model", "signal", "snivel",
    "travel", "yodel",
]

#: ae/oe digraph words (US drops the a/o)
_AE_OE_WORDS = [
    ("aeon", "eon"), ("aeons", "eons"), ("aetiology", "etiology"),
    ("anaemia", "anemia"), ("anaemic", "anemic"),
    ("anaesthesia", "anesthesia"), ("anaesthetic", "anesthetic"),
    ("anaesthetics", "anesthetics"), ("anaesthetist", "anesthetist"),
    ("archaeological", "archeological"), ("archaeologist", "archeologist"),
    ("archaeologists", "archeologists"), ("archaeology", "archeology"),
    ("caesarean", "cesarean"), ("caesium", "cesium"),
    ("diarrhoea", "diarrhea"), ("encyclopaedia", "encyclopedia"),
    ("encyclopaedias", "encyclopedias"), ("faeces", "feces"),
    ("foetal", "fetal"), ("foetus", "fetus"), ("foetuses", "fetuses"),
    ("gonorrhoea", "gonorrhea"), ("gynaecologist", "gynecologist"),
    ("gynaecology", "gynecology"), ("haematology", "hematology"),
    ("haemoglobin", "hemoglobin"), ("haemophilia", "hemophilia"),
    ("haemorrhage", "hemorrhage"), ("haemorrhoids", "hemorrhoids"),
    ("leukaemia", "leukemia"), ("mediaeval", "medieval"),
    ("oedema", "edema"), ("oesophagus", "esophagus"),
    ("oestrogen", "estrogen"), ("orthopaedic", "orthopedic"),
    ("orthopaedics", "orthopedics"), ("paediatric", "pediatric"),
    ("paediatrician", "pediatrician"), ("paediatricians", "pediatricians"),
    ("paediatrics", "pediatrics"), ("paedophile", "pedophile"),
    ("paedophiles", "pedophiles"), ("palaeontology", "paleontology"),
]


def _generated_spellings() -> dict:
    """Rule-generated British->American variants.

    Reconstruction of the regular families of whisper's ~1.7k-entry
    ``english.json`` asset (used at reference scripts/eval/eval.py:50);
    the irregular tail lives in _BUILTIN_SPELLINGS and a drop-in of the
    real asset always takes priority.
    """
    mapping = {}
    for stem in _ISE_STEMS:
        for suf_gb, suf_us in [
            ("ise", "ize"), ("ised", "ized"), ("ises", "izes"), ("ising", "izing"),
            ("isation", "ization"), ("isations", "izations"), ("iser", "izer"),
            ("isers", "izers"),
        ]:
            mapping[stem + suf_gb] = stem + suf_us
    for stem in _YSE_STEMS:
        for suf_gb, suf_us in [
            ("yse", "yze"), ("ysed", "yzed"), ("yses", "yzes"), ("ysing", "yzing"),
            ("yser", "yzer"), ("ysers", "yzers"),
        ]:
            mapping[stem + suf_gb] = stem + suf_us
    for gb, us in _OUR_WORDS:
        mapping[gb] = us
        mapping[gb + "s"] = us + "s"
        mapping[gb + "ed"] = us + "ed"
        mapping[gb + "ing"] = us + "ing"
    for gb, us in _RE_WORDS:
        mapping[gb] = us
        mapping[gb + "s"] = us + "s"
        mapping[gb + "d"] = us + "ed"
    for verb in _DOUBLE_L_VERBS:
        mapping[verb + "led"] = verb + "ed"
        mapping[verb + "ling"] = verb + "ing"
    for stem in _DOUBLE_L_AGENTS:
        mapping[stem + "ler"] = stem + "er"
        mapping[stem + "lers"] = stem + "ers"
    mapping.update(dict(_AE_OE_WORDS))
    return mapping


# irregular entries (reconstruction of whisper's english.json tail; the
# real asset drops in via OLMOASR_SPELLING_JSON / assets/english.json)
_BUILTIN_SPELLINGS = {
    "appal": "appall", "appals": "appalls",
    "armoury": "armory", "armouries": "armories",
    "behavioural": "behavioral", "behaviourism": "behaviorism",
    "chequebook": "checkbook", "chequebooks": "checkbooks",
    "colourise": "colorize", "colourised": "colorized",
    "colourising": "colorizing",
    "colourful": "colorful", "colourfully": "colorfully",
    "colourless": "colorless", "multicoloured": "multicolored",
    "technicolour": "technicolor",
    "defenceless": "defenseless",
    "distil": "distill", "distils": "distills",
    "draughty": "drafty", "draughtsman": "draftsman",
    "enrols": "enrolls", "enrolments": "enrollments",
    "enthrals": "enthralls", "extol": "extoll",
    "favourable": "favorable", "favourably": "favorably",
    "favoured": "favored", "favouring": "favoring",
    "unfavourable": "unfavorable", "unfavourably": "unfavorably",
    "flavourless": "flavorless", "flavoursome": "flavorsome",
    "fulfils": "fulfills", "fulfilments": "fulfillments",
    "gaols": "jails", "gramme": "gram", "grammes": "grams",
    "greys": "grays", "greyed": "grayed", "greying": "graying",
    "honourable": "honorable", "honourably": "honorably",
    "humourless": "humorless",
    "instalment": "installment", "instalments": "installments",
    "instils": "instills",
    "jeweller": "jeweler", "jewellers": "jewelers", "jewelled": "jeweled",
    "kerbs": "curbs", "kerbside": "curbside",
    "kilogramme": "kilogram", "kilogrammes": "kilograms",
    "labourer": "laborer", "labourers": "laborers",
    "manoeuvrable": "maneuverable", "manoeuvrability": "maneuverability",
    "manoeuvring": "maneuvering", "manoeuvrings": "maneuverings",
    "marvellously": "marvelously",
    "mouldy": "moldy", "moulds": "molds", "mouldings": "moldings",
    "moult": "molt", "moulted": "molted", "moulting": "molting",
    "neighbourhood": "neighborhood", "neighbourhoods": "neighborhoods",
    "neighbouring": "neighboring", "neighbourly": "neighborly",
    "odourless": "odorless",
    "plough": "plow", "ploughed": "plowed", "ploughing": "plowing",
    "ploughs": "plows", "snowplough": "snowplow", "snowploughs": "snowplows",
    "practises": "practices",
    "pretences": "pretenses",
    "pyjama": "pajama",
    "savoury": "savory", "unsavoury": "unsavory",
    "sceptic": "skeptic", "sceptical": "skeptical",
    "sceptically": "skeptically", "scepticism": "skepticism",
    "sceptics": "skeptics",
    "smoulder": "smolder", "smouldered": "smoldered",
    "smouldering": "smoldering", "smoulders": "smolders",
    "speciality": "specialty", "specialities": "specialties",
    "sulphate": "sulfate", "sulphates": "sulfates",
    "sulphide": "sulfide", "sulphides": "sulfides",
    "sulphuric": "sulfuric", "sulphurous": "sulfurous",
    "titbit": "tidbit", "titbits": "tidbits",
    "tranquillise": "tranquilize", "tranquillised": "tranquilized",
    "tranquilliser": "tranquilizer", "tranquillisers": "tranquilizers",
    "tranquillising": "tranquilizing", "tranquillity": "tranquility",
    "unskilful": "unskillful",
    "wilful": "willful", "wilfully": "willfully",
    "wilfulness": "willfulness",
    "accessorise": "accessorize", "aeroplane": "airplane", "ageing": "aging",
    "aluminium": "aluminum", "amortise": "amortize", "anaemia": "anemia",
    "anaemic": "anemic", "anaesthesia": "anesthesia",
    "anaesthetic": "anesthetic", "analogue": "analog", "analogues": "analogs",
    "analyse": "analyze", "analysed": "analyzed", "analyses": "analyses",
    "analysing": "analyzing", "annualised": "annualized",
    "apologise": "apologize", "archaeology": "archeology",
    "artefact": "artifact", "artefacts": "artifacts", "axe": "ax",
    "breathalyse": "breathalyze", "cancelled": "canceled",
    "cancelling": "canceling", "capitalise": "capitalize",
    "carburettor": "carburetor", "catalogue": "catalog",
    "catalogued": "cataloged", "catalogues": "catalogs",
    "catalyse": "catalyze", "channelled": "channeled",
    "channelling": "channeling", "cheque": "check", "chequered": "checkered",
    "cheques": "checks", "chilli": "chili", "chiselled": "chiseled",
    "cosier": "cozier", "cosy": "cozy", "counselled": "counseled",
    "counselling": "counseling", "counsellor": "counselor",
    "counsellors": "counselors", "defence": "defense", "defences": "defenses",
    "dialled": "dialed", "dialling": "dialing", "dialogue": "dialog",
    "dialogues": "dialogs", "diarrhoea": "diarrhea", "disc": "disk",
    "discs": "disks", "draught": "draft", "draughts": "drafts",
    "dreamt": "dreamed", "duelled": "dueled", "duelling": "dueling",
    "encyclopaedia": "encyclopedia", "enquire": "inquire",
    "enquiries": "inquiries", "enquiring": "inquiring", "enquiry": "inquiry",
    "enrol": "enroll", "enrolment": "enrollment", "enthral": "enthrall",
    "equalled": "equaled", "equalling": "equaling", "favourite": "favorite",
    "favourites": "favorites", "fibreglass": "fiberglass",
    "foetal": "fetal", "foetus": "fetus", "fuelled": "fueled",
    "fuelling": "fueling", "fulfil": "fulfill", "fulfilment": "fulfillment",
    "gaol": "jail", "grey": "gray", "greyish": "grayish",
    "gynaecology": "gynecology", "haemoglobin": "hemoglobin",
    "haemorrhage": "hemorrhage", "instil": "instill", "jewellery": "jewelry",
    "judgement": "judgment", "judgements": "judgments", "kerb": "curb",
    "labelled": "labeled", "labelling": "labeling", "leant": "leaned",
    "learnt": "learned", "leukaemia": "leukemia", "levelled": "leveled",
    "levelling": "leveling", "libelled": "libeled", "licence": "license",
    "licences": "licenses", "marvelled": "marveled",
    "marvelling": "marveling", "marvellous": "marvelous",
    "modelled": "modeled", "modelling": "modeling", "mould": "mold",
    "moulded": "molded", "moulding": "molding", "moults": "molts",
    "moustache": "mustache", "offence": "offense", "offences": "offenses",
    "omelette": "omelet", "paediatric": "pediatric",
    "paediatrician": "pediatrician", "paralyse": "paralyze",
    "paralysed": "paralyzed", "pretence": "pretense", "programme": "program",
    "programmes": "programs", "pyjamas": "pajamas", "quarrelled": "quarreled",
    "quarrelling": "quarreling", "signalled": "signaled",
    "signalling": "signaling", "skilful": "skillful", "smelt": "smelled",
    "spelt": "spelled", "spilt": "spilled", "spoilt": "spoiled",
    "storey": "story", "storeys": "stories", "sulphur": "sulfur",
    "travelled": "traveled", "traveller": "traveler",
    "travellers": "travelers", "travelling": "traveling", "tyre": "tire",
    "tyres": "tires", "whisky": "whiskey", "woollen": "woolen",
    "yoghurt": "yogurt", "yoghurts": "yogurts", "practise": "practice",
    "practised": "practiced", "practising": "practicing",
}


class EnglishTextNormalizer:
    def __init__(self):
        self.ignore_patterns = r"\b(hmm|mm|mhm|mmm|uh|um)\b"
        self.replacers = {
            # common contractions
            r"\bwon't\b": "will not",
            r"\bcan't\b": "can not",
            r"\blet's\b": "let us",
            r"\bain't\b": "aint",
            r"\by'all\b": "you all",
            r"\bwanna\b": "want to",
            r"\bgotta\b": "got to",
            r"\bgonna\b": "going to",
            r"\bi'ma\b": "i am going to",
            r"\bimma\b": "i am going to",
            r"\bwoulda\b": "would have",
            r"\bcoulda\b": "could have",
            r"\bshoulda\b": "should have",
            r"\bma'am\b": "madam",
            # contractions in titles/prefixes
            r"\bmr\b": "mister ",
            r"\bmrs\b": "missus ",
            r"\bst\b": "saint ",
            r"\bdr\b": "doctor ",
            r"\bprof\b": "professor ",
            r"\bcapt\b": "captain ",
            r"\bgov\b": "governor ",
            r"\bald\b": "alderman ",
            r"\bgen\b": "general ",
            r"\bsen\b": "senator ",
            r"\brep\b": "representative ",
            r"\bpres\b": "president ",
            r"\brev\b": "reverend ",
            r"\bhon\b": "honorable ",
            r"\basst\b": "assistant ",
            r"\bassoc\b": "associate ",
            r"\blt\b": "lieutenant ",
            r"\bcol\b": "colonel ",
            r"\bjr\b": "junior ",
            r"\bsr\b": "senior ",
            r"\besq\b": "esquire ",
            # prefect tenses, ideally it should be any past participles,
            # but it's harder to convert them to past tense
            r"'d been\b": " had been",
            r"'s been\b": " has been",
            r"'d gone\b": " had gone",
            r"'s gone\b": " has gone",
            r"'d done\b": " had done",  # "'s done" is ambiguous
            r"'s got\b": " has got",
            # general contractions
            r"n't\b": " not",
            r"'re\b": " are",
            r"'s\b": " is",
            r"'d\b": " would",
            r"'ll\b": " will",
            r"'t\b": " not",
            r"'ve\b": " have",
            r"'m\b": " am",
        }
        self.standardize_numbers = EnglishNumberNormalizer()
        self.standardize_spellings = EnglishSpellingNormalizer()

    def __call__(self, s: str) -> str:
        s = s.lower()

        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)  # remove words between brackets
        s = re.sub(r"\(([^)]+?)\)", "", s)  # remove words between parenthesis
        s = re.sub(self.ignore_patterns, "", s)
        s = re.sub(r"\s+'", "'", s)  # space before an apostrophe

        for pattern, replacement in self.replacers.items():
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)  # remove commas between digits
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)  # periods not followed by numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")  # keep numeric symbols

        s = self.standardize_numbers(s)
        s = self.standardize_spellings(s)

        # prefix/suffix symbols not preceded/followed by numbers
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)

        s = re.sub(r"\s+", " ", s)  # successive whitespace -> single space
        return s.strip()
