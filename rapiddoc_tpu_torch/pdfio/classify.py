"""Classify a PDF as 'txt' (native text) or 'ocr' (scanned/garbled).

Signal-parity with the reference classifier (reference:
rapid_doc/utils/pdf_classify.py:17-239): evenly-sampled pages checked for
extreme aspect ratio, chars/page, unicode-map errors, CID fonts without
ToUnicode, abnormal-char quality, cross-script garbling, U+7280-72DF
artifacts and ASCII-punctuation runs (with dot-leader discounting). Image
coverage alone never flips a text-quality-passing document to ocr (same
final behavior as the reference).
"""
from __future__ import annotations

from .document import PdfDocument
from .text import TextExtractor, page_base_ctm

# thresholds per reference pdf_classify.py:17-45
MAX_SAMPLE_PAGES = 10
CHARS_THRESHOLD = 50
TEXT_QUALITY_MIN_CHARS = 300
TEXT_QUALITY_BAD_THRESHOLD = 0.03
UNICODE_MAP_ERROR_RATIO_THRESHOLD = 0.04
CID_FONT_USAGE_RATIO_THRESHOLD = 0.01
CID_FONT_USAGE_COUNT_THRESHOLD = 30
MAX_PAGE_ASPECT_RATIO = 10.0
U72XX_START, U72XX_END = 0x7280, 0x72DF
U72XX_COUNT_THRESHOLD = 30
U72XX_CJK_RATIO_THRESHOLD = 0.026
U72XX_WHITELIST = set("犀犁犄犊犒犟犬犯状犷犹狂狄狈狐狗狙狞")
ASCII_PUNCT = set("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~")
PUNCT_RUN_MIN = 4
DOT_LEADER_RUN_MIN = 8
DOT_LEADER_MIN_NON_PUNCT = 80
PUNCT_MIN_TEXT_CHARS = 100
PUNCT_RATIO_THRESHOLD = 0.25
PUNCT_RUN_RATIO_THRESHOLD = 0.10
XSCRIPT_MIN_TEXT = 300
XSCRIPT_MIN_CJK = 100
XSCRIPT_COUNT = 120
XSCRIPT_RATIO = 0.18
XSCRIPT_MIN_SCRIPTS = 3
XSCRIPT_SCRIPT_MIN_CHARS = 5
XSCRIPT_RANGES = (
    (0x0400, 0x052F, "Cyrillic"),
    (0x0600, 0x06FF, "Arabic"),
    (0x0700, 0x074F, "Syriac"),
    (0x0750, 0x077F, "ArabicSup"),
    (0x0780, 0x07BF, "Thaana"),
    (0x07C0, 0x07FF, "NKo"),
    (0x0800, 0x083F, "Samaritan"),
    (0x0840, 0x085F, "Mandaic"),
    (0x0900, 0x097F, "Devanagari"),
    (0x0980, 0x09FF, "Bengali"),
    (0x0A00, 0x0A7F, "Gurmukhi"),
    (0x0A80, 0x0AFF, "Gujarati"),
    (0x0B00, 0x0B7F, "Oriya"),
    (0x0B80, 0x0BFF, "Tamil"),
    (0x0C00, 0x0C7F, "Telugu"),
    (0x0C80, 0x0CFF, "Kannada"),
    (0x0D00, 0x0D7F, "Malayalam"),
    (0x0E00, 0x0E7F, "Thai"),
    (0x0E80, 0x0EFF, "Lao"),
    (0x0F00, 0x0FFF, "Tibetan"),
    (0x1000, 0x109F, "Myanmar"),
    (0x10A0, 0x10FF, "Georgian"),
    (0x1100, 0x11FF, "Hangul Jamo"),
    (0x1400, 0x167F, "Canadian"),
    (0x1780, 0x17FF, "Khmer"),
)


def sample_page_indices(page_count: int, max_pages: int = MAX_SAMPLE_PAGES):
    """Evenly spread sample (reference: get_sample_page_indices)."""
    if page_count <= 0 or max_pages <= 0:
        return []
    n = min(page_count, max_pages)
    if n == page_count:
        return list(range(page_count))
    if n == 1:
        return [0]
    out = []
    seen = set()
    for i in range(n):
        idx = round(i * (page_count - 1) / (n - 1))
        if idx not in seen:
            seen.add(idx)
            out.append(idx)
    return out


def _cleaned(text: str) -> str:
    return "".join(c for c in text if not c.isspace())


def _is_cjk(ch: str) -> bool:
    return 0x4E00 <= ord(ch) <= 0x9FFF


def _abnormal(ch: str) -> bool:
    o = ord(ch)
    return ch == "�" or 0xE000 <= o <= 0xF8FF  # replacement / PUA


def _script_of(ch: str):
    o = ord(ch)
    for start, end, name in XSCRIPT_RANGES:
        if start <= o <= end:
            return name
    return None


def _run_chars(text: str, members: set, min_len: int) -> int:
    total = run = 0
    for ch in text:
        if ch in members:
            run += 1
            continue
        if run >= min_len:
            total += run
        run = 0
    if run >= min_len:
        total += run
    return total


def classify_pdf(pdf_bytes: bytes) -> str:
    """Return 'txt' or 'ocr' (signal order mirrors the reference)."""
    try:
        doc = PdfDocument(pdf_bytes)
    except Exception:
        return "ocr"
    n = len(doc)
    if n == 0:
        return "ocr"
    samples = []
    for i in sample_page_indices(n):
        try:
            page = doc.get_page(i)
        except Exception:
            continue
        w, h = page.size
        # signal 1: extreme page aspect ratio
        if min(w, h) > 0 and max(w, h) / min(w, h) > MAX_PAGE_ASPECT_RATIO:
            return "ocr"
        try:
            extractor = TextExtractor(page)
            extractor.run(page_base_ctm(page))
            chars = extractor.chars
        except Exception:
            chars = []
        samples.append((page, chars))
    if not samples:
        return "ocr"

    all_chars = [c for _, chars in samples for c in chars]
    cleaned_pages = [
        _cleaned("".join(c["char"] for c in chars)) for _, chars in samples
    ]
    # signal 2: average extractable chars/page
    avg_chars = sum(len(t) for t in cleaned_pages) / len(samples)
    if avg_chars < CHARS_THRESHOLD:
        return "ocr"

    # signal 3: unicode-map errors (codes the font could not map)
    total = len(all_chars)
    unmapped = sum(1 for c in all_chars if not c["char"])
    if total and unmapped / total >= UNICODE_MAP_ERROR_RATIO_THRESHOLD:
        return "ocr"

    # signal 4: CID fonts without ToUnicode, by actual usage
    cid_unmappable = sum(1 for c in all_chars if c.get("no_tounicode_cid"))
    if (
        cid_unmappable >= CID_FONT_USAGE_COUNT_THRESHOLD
        and total
        and cid_unmappable / total >= CID_FONT_USAGE_RATIO_THRESHOLD
    ):
        return "ocr"

    # signal 5: abnormal chars (replacement / private use)
    text_all = "".join(cleaned_pages)
    if (
        len(text_all) >= TEXT_QUALITY_MIN_CHARS
        and sum(_abnormal(c) for c in text_all) / len(text_all)
        >= TEXT_QUALITY_BAD_THRESHOLD
    ):
        return "ocr"

    # signal 6: cross-script garbling in CJK documents
    cjk = sum(1 for c in text_all if _is_cjk(c))
    script_counts: dict[str, int] = {}
    suspicious = 0
    for c in text_all:
        name = _script_of(c)
        if name:
            suspicious += 1
            script_counts[name] = script_counts.get(name, 0) + 1
    dense = sum(
        1 for v in script_counts.values() if v >= XSCRIPT_SCRIPT_MIN_CHARS
    )
    if (
        len(text_all) >= XSCRIPT_MIN_TEXT
        and cjk >= XSCRIPT_MIN_CJK
        and suspicious >= XSCRIPT_COUNT
        and suspicious / len(text_all) >= XSCRIPT_RATIO
        and dense >= XSCRIPT_MIN_SCRIPTS
    ):
        return "ocr"

    # signal 7: U+7280-72DF artifacts from broken CID maps
    u72 = sum(
        1
        for c in text_all
        if U72XX_START <= ord(c) <= U72XX_END and c not in U72XX_WHITELIST
    )
    if (
        u72 >= U72XX_COUNT_THRESHOLD
        and cjk
        and u72 / cjk >= U72XX_CJK_RATIO_THRESHOLD
    ):
        return "ocr"

    # signal 8: dense ASCII punctuation runs (dot leaders discounted)
    for text in cleaned_pages:
        if len(text) < PUNCT_MIN_TEXT_CHARS:
            continue
        punct = sum(1 for c in text if c in ASCII_PUNCT)
        run_chars = _run_chars(text, ASCII_PUNCT, PUNCT_RUN_MIN)
        dot_leaders = _run_chars(text, {"."}, DOT_LEADER_RUN_MIN)
        if len(text) - punct >= DOT_LEADER_MIN_NON_PUNCT:
            punct = max(0, punct - dot_leaders)
            run_chars = max(0, run_chars - dot_leaders)
        if (
            punct / len(text) >= PUNCT_RATIO_THRESHOLD
            and run_chars / len(text) >= PUNCT_RUN_RATIO_THRESHOLD
        ):
            return "ocr"

    # image coverage is logged-not-acted-on once text quality passed
    # (reference: pdf_classify.py:222-231)
    return "txt"
