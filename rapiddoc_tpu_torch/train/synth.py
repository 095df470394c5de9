"""Synthetic document rendering and ground truth for OCR training.

Port of ``rapiddoc_tpu/train/synth.py``: white pages and lines of text in
the system's DejaVu faces and matplotlib's bundled STIXGeneral and DejaVu
variants, with the DB shrink-mask target (shrink offset
``area * (1 - r^2) / perimeter``, as PaddleOCR trains DB). The random
streams are the JAX package's (``random.Random`` and numpy generators
seeded from it, drawn in the same order); PIL, cv2 and matplotlib are
replayed, never imported:

- ``ImageFont.truetype`` / ``getbbox`` / ``ImageDraw.text``:
  ``pdfio/ft_face.Face`` and ``utils/draw.draw_text``;
- ``ImageDraw.rectangle``/``line``, ``Image.paste``: ``pdfio/pil_draw``
  and array writes;
- ``ImageFilter.GaussianBlur``: ``pdfio/pil_filter.gaussian_blur``;
- ``Image.rotate(expand=True, fillcolor=...)`` (NEAREST):
  ``pdfio/pil_resample.rotate_expand``;
- ``cv2.resize`` (INTER_LINEAR): ``models/ocr/pre_post.resize_linear``;
- ``cv2.imencode(".jpg")`` / ``cv2.imdecode``: cv2 takes the RGB array as
  BGR, so libjpeg sees the channels swapped; ``pdfio/jpeg_encode`` (4:2:0,
  standard Huffman tables, quality ``q``) encodes the swapped array and
  ``pdfio/jpeg`` decodes it, pixels equal to cv2's.

FreeType hints every face PIL opens and ``ft_face`` draws the unhinted
outline (ROADMAP item 12e), so a glyph's box can differ from PIL's by a
pixel. ``render_line`` sizes its canvas and ``_fill_line`` its text from
those boxes, and later ``rng.randint`` bounds follow the sizes (Python
draws a different number of bits for a different bound), so the two
packages' streams part after the first such difference: pages and lines
are held to the JAX package's within a band where glyphs decide, and
equal everywhere else.

Faces are found where ``_find_fonts`` finds them (matplotlib's folder
through ``importlib.util.find_spec``); where none is found, drawing text
raises and names the folders searched. ``FONTS`` may be set to other
TrueType files.
"""
from __future__ import annotations

import functools
import importlib.util
import random
import string
from pathlib import Path

import numpy as np

from ..models.ocr.pre_post import rec_resize, resize_linear
from ..pdfio.ft_face import Face, open_program
from ..pdfio.jpeg import decode_jpeg
from ..pdfio.jpeg_encode import encode_jpeg
from ..pdfio.pil_draw import line_spans, write_spans
from ..pdfio.pil_filter import gaussian_blur
from ..pdfio.pil_resample import rotate_expand
from ..utils.draw import draw_text

SYSTEM_FONT_DIR = Path("/usr/share/fonts/truetype/dejavu")


def _matplotlib_font_dir() -> Path | None:
    """matplotlib's ``mpl-data/fonts/ttf``, found without importing it."""
    spec = importlib.util.find_spec("matplotlib")
    if spec is None or not spec.submodule_search_locations:
        return None
    return Path(list(spec.submodule_search_locations)[0]) / "mpl-data" / "fonts" / "ttf"


def _font_dirs() -> list[Path]:
    mpl = _matplotlib_font_dir()
    return [SYSTEM_FONT_DIR] + ([mpl] if mpl is not None else [])


def _find_fonts() -> list[Path]:
    """Text faces: the system's DejaVu, then matplotlib's STIXGeneral and
    DejaVu faces (symbol-only STIXSiz*/STIXNonUni/cm* left out: Computer
    Modern maps ASCII to other glyphs), de-duplicated by file name, in the
    JAX package's order."""
    out: list[Path] = sorted(SYSTEM_FONT_DIR.glob("*.ttf"))
    mpl = _matplotlib_font_dir()
    if mpl is not None:
        for p in sorted(mpl.glob("*.ttf")):
            if p.stem.startswith(("STIXSiz", "STIXNonUni", "cmex", "cmsy", "cmmi")):
                continue
            if p.stem.startswith(("STIXGeneral", "DejaVu")):
                out.append(p)
    seen: set[str] = set()
    uniq = []
    for p in out:
        if p.name not in seen:
            seen.add(p.name)
            uniq.append(p)
    return uniq


FONTS = _find_fonts()

# rec charset: printable ASCII sans space (space is the implicit final
# vocab entry, matching CTCLabelDecoder layout)
DEMO_CHARSET = [c for c in string.printable[:94] if c != " "]

# Cyrillic: digits + common punctuation + а-я А-Я ё Ё
CYRILLIC_CHARSET = (
    list(string.digits)
    + list(".,:;!?()-%№«»")
    + [chr(c) for c in range(0x0430, 0x0450)]  # а-я
    + [chr(c) for c in range(0x0410, 0x0430)]  # А-Я
    + ["ё", "Ё"]
)

LANG_CHARSETS = {"ru": CYRILLIC_CHARSET}

_WORDS_RU = (
    "в и на с по для от до как это документ таблица текст страница "
    "модель формула раздел данные число рисунок ссылка анализ система "
    "процесс энергия поле вода уровень итог площадь размер время вход "
    "выход метод результат значение общий высокий низкий среднее тест "
).split()

_WORDS = (
    "the of and to in is was for that with document table text page image "
    "model layout formula title section results method data value number "
    "figure reference analysis system process energy field water level "
    "rate total area size time high low mean test input output "
).split()


def random_text_lang(rng: random.Random, lang: str, max_words: int = 8) -> str:
    """Language-specific synthetic line text (mirrors random_text)."""
    if lang != "ru":
        return random_text(rng, max_words)
    words = []
    for _ in range(rng.randint(1, max_words)):
        r = rng.random()
        if r < 0.6:
            w = rng.choice(_WORDS_RU)
            if rng.random() < 0.2:
                w = w.capitalize()
        elif r < 0.8:
            w = str(rng.randint(0, 99999))
            if rng.random() < 0.3:
                w += rng.choice(["%", ",00", ".5"])
        else:
            letters = [chr(c) for c in range(0x0430, 0x0450)]
            w = "".join(
                rng.choice(letters + list(string.digits) + [".", ",", "-"])
                for _ in range(rng.randint(2, 8))
            )
        words.append(w)
    return " ".join(words)


def random_text(rng: random.Random, max_words: int = 8) -> str:
    words = []
    for _ in range(rng.randint(1, max_words)):
        r = rng.random()
        if r < 0.55:
            w = rng.choice(_WORDS)
            if rng.random() < 0.2:
                w = w.capitalize()
        elif r < 0.75:
            w = str(rng.randint(0, 99999))
            if rng.random() < 0.3:
                w += rng.choice([".%", "%", ".5", ",00"])
        else:
            w = "".join(
                rng.choice(string.ascii_letters + string.digits + ".,-()")
                for _ in range(rng.randint(2, 8))
            )
        words.append(w)
    return " ".join(words)


@functools.lru_cache(maxsize=None)
def _program(path: str):
    return open_program(Path(path).read_bytes())


@functools.lru_cache(maxsize=None)
def _face(path: str, size: int) -> Face:
    return Face(None, size, parsed=_program(path))


def _font(rng: random.Random, size: int) -> Face:
    if not FONTS:
        raise FileNotFoundError(
            "no text face for the synthetic data: searched "
            + ", ".join(str(d) for d in _font_dirs())
        )
    return _face(str(rng.choice(FONTS)), size)


def _text(img: np.ndarray, xy: tuple[int, int], text: str, fg: int, font: Face) -> None:
    """``ImageDraw.Draw(img).text(xy, text, fill=(fg, fg, fg), font=font)``."""
    draw_text(img, xy, text, (fg, fg, fg), font)


def _line(img: np.ndarray, xy: list[tuple[int, int]], ink: tuple, width: int = 0) -> None:
    """``ImageDraw.Draw(img).line(xy, fill=ink, width=width)``."""
    spans, points = line_spans([xy], width, img.shape[0], False)
    write_spans(img, [spans], [points] if points is not None else [], ink)


def _rectangle(img: np.ndarray, x0: int, y0: int, x1: int, y1: int, fill: tuple,
               outline: tuple) -> None:
    """``ImageDraw.Draw(img).rectangle([x0, y0, x1, y1], fill=, outline=)``
    (width 1): every pixel of the closed box filled, then its border."""
    h, w = img.shape[:2]
    cy0, cy1, cx0, cx1 = max(y0, 0), min(y1, h - 1), max(x0, 0), min(x1, w - 1)
    if cy1 < cy0 or cx1 < cx0:
        return
    img[cy0:cy1 + 1, cx0:cx1 + 1] = fill
    for y in (y0, y1):
        if 0 <= y < h:
            img[y, cx0:cx1 + 1] = outline
    for x in (x0, x1):
        if 0 <= x < w:
            img[cy0:cy1 + 1, x] = outline


def line_canvas(text: str, font: Face, pad: int, bg: int, fg: int) -> np.ndarray:
    """``render_line``'s drawn line before its degradations: the text's box
    plus ``pad`` a side in ``bg``, the text in ``fg``."""
    bbox = font.getbbox(text)
    w = max(bbox[2] - bbox[0], 1) + 2 * pad
    h = max(bbox[3] - bbox[1], 1) + 2 * pad
    arr = np.full((h, w, 3), bg, np.uint8)
    _text(arr, (pad - bbox[0], pad - bbox[1]), text, fg, font)
    return arr


def render_line(text: str, rng: random.Random, height: int = 48) -> np.ndarray:
    """One text line as uint8 RGB, natural width at the given height."""
    size = rng.randint(22, 40)
    font = _font(rng, size)
    pad = rng.randint(2, 8)
    bg = rng.randint(235, 255)
    fg = rng.randint(0, 70)
    arr = line_canvas(text, font, pad, bg, fg)
    if rng.random() < 0.3:
        arr = gaussian_blur(arr, rng.random() * 0.8)
    if rng.random() < 0.3:  # slight skew, like det quad crops
        arr = rotate_expand(arr, rng.uniform(-2.0, 2.0), fillcolor=(bg, bg, bg))
    if rng.random() < 0.4:
        noise = np.random.default_rng(rng.randrange(1 << 30)).normal(
            0, rng.random() * 8, arr.shape
        )
        arr = np.clip(arr.astype(np.float32) + noise, 0, 255).astype(np.uint8)
    if rng.random() < 0.5:
        # DPI round-trip: downscale then upscale
        f = rng.uniform(0.45, 0.95)
        small = resize_linear(arr, max(1, int(arr.shape[1] * f)), max(1, int(arr.shape[0] * f)))
        arr = resize_linear(small, arr.shape[1], arr.shape[0])
    # keep-ratio resize to rec height
    scale = height / arr.shape[0]
    return resize_linear(arr, max(1, int(arr.shape[1] * scale)), height)


def _fill_line(rng: random.Random, font: Face, max_w: int,
               fill_ratio: float) -> tuple[str, tuple[int, int, int, int]]:
    """Text that fills ~fill_ratio of max_w at the given font."""
    text = ""
    bbox = (0, 0, 0, 0)
    while True:
        cand = (text + " " if text else "") + random_text(rng, max_words=3)
        b = font.getbbox(cand)
        if b[2] - b[0] > max_w * fill_ratio:
            if not text:
                text, bbox = cand, b
                while text and bbox[2] - bbox[0] > max_w:
                    text = text.rsplit(" ", 1)[0] if " " in text else text[:-2]
                    bbox = font.getbbox(text) if text else (0, 0, 0, 0)
            break
        text, bbox = cand, b
    return text, bbox


def render_page(rng: random.Random, size: int = 640, with_texts: bool = False):
    """A synthetic page (uint8 RGB size x size) + text-line pixel boxes
    (+ the lines' texts when with_texts): tight-leading body paragraphs,
    headings, sparse isolated lines, and figure blocks, rules and table
    grids the detector must not fire on."""
    bg = rng.randint(240, 255)
    img = np.full((size, size, 3), bg, np.uint8)
    boxes: list[tuple[int, int, int, int]] = []
    texts: list[str] = []
    two_col = rng.random() < 0.35
    cols = (
        [(rng.randint(16, 40), size // 2 - 16),
         (size // 2 + 16, size - rng.randint(16, 40))]
        if two_col
        else [(rng.randint(16, 60), size - rng.randint(16, 60))]
    )

    def put_line(text, bbox, x, y, font, fg):
        tw, th = bbox[2] - bbox[0], bbox[3] - bbox[1]
        if tw < 4 or th < 4:  # degenerate getbbox (e.g. dashes-only text)
            return th
        _text(img, (x - bbox[0], y - bbox[1]), text, fg, font)
        boxes.append((x, y, x + tw, y + th))
        texts.append(text)
        return th

    for x0_col, x1_col in cols:
        max_w = x1_col - x0_col
        y = rng.randint(16, 60)
        while y < size - 60:
            r = rng.random()
            if r < 0.45:  # body paragraph: one face, tight leading
                fsize = rng.randint(11, 22)
                font = _font(rng, fsize)
                fg = rng.randint(0, 80)
                leading = max(2, int(fsize * rng.uniform(0.25, 0.7)))
                n_lines = rng.randint(2, 7)
                for li in range(n_lines):
                    if y >= size - 40:
                        break
                    last = li == n_lines - 1
                    text, bbox = _fill_line(
                        rng, font, max_w,
                        rng.uniform(0.3, 0.8) if last else rng.uniform(0.85, 0.98),
                    )
                    if not text:
                        break
                    th = put_line(text, bbox, x0_col, y, font, fg)
                    y += th + leading
                y += rng.randint(8, 30)  # paragraph gap
            elif r < 0.6:  # heading / caption: short, larger or bold face
                fsize = rng.randint(16, 30)
                font = _font(rng, fsize)
                text = random_text(rng, max_words=6)
                bbox = font.getbbox(text)
                while text and bbox[2] - bbox[0] > max_w:
                    text = text.rsplit(" ", 1)[0] if " " in text else text[:-2]
                    bbox = font.getbbox(text) if text else (0, 0, 0, 0)
                if text:
                    x = x0_col + rng.randint(0, max(0, max_w - (bbox[2] - bbox[0])) // 2)
                    th = put_line(text, bbox, x, y, font, rng.randint(0, 60))
                    y += th + rng.randint(10, 36)
            elif r < 0.8:  # sparse isolated lines (lists, fields, numbers)
                fsize = rng.randint(13, 30)
                font = _font(rng, fsize)
                text = random_text(rng, max_words=10)
                bbox = font.getbbox(text)
                while text and bbox[2] - bbox[0] > max_w:
                    text = text.rsplit(" ", 1)[0] if " " in text else text[:-2]
                    bbox = font.getbbox(text) if text else (0, 0, 0, 0)
                if not text:
                    y += fsize + rng.randint(4, 16)
                    continue
                x = x0_col + rng.randint(0, max(0, max_w - (bbox[2] - bbox[0])) // 2)
                th = put_line(text, bbox, x, y, font, rng.randint(0, 80))
                y += th + rng.randint(6, 28)
            else:  # non-text graphics: figure block / rule / table grid
                gh = rng.randint(24, max(32, size // 5))
                gw = rng.randint(max_w // 3, max_w)
                gx = x0_col + rng.randint(0, max(0, max_w - gw))
                kind = rng.random()
                if kind < 0.45:  # figure: noise or flat gray patch
                    shade = rng.randint(120, 230)
                    if rng.random() < 0.5:
                        patch = np.random.default_rng(
                            rng.randrange(1 << 30)
                        ).integers(60, 220, (gh, gw, 3), np.uint8)
                        cut = patch[: max(0, size - y), : max(0, size - gx)]
                        img[y:y + cut.shape[0], gx:gx + cut.shape[1]] = cut
                    else:
                        _rectangle(img, gx, y, gx + gw, y + gh, (shade,) * 3, (80, 80, 80))
                elif kind < 0.7:  # horizontal rule
                    gh = rng.randint(1, 3)
                    _line(img, [(gx, y), (gx + gw, y)], (60, 60, 60), gh)
                else:  # empty table grid
                    nr, nc = rng.randint(2, 5), rng.randint(2, 5)
                    for ri in range(nr + 1):
                        yy = y + ri * gh // nr
                        _line(img, [(gx, yy), (gx + gw, yy)], (90, 90, 90))
                    for ci in range(nc + 1):
                        xx = gx + ci * gw // nc
                        _line(img, [(xx, y), (xx, y + gh)], (90, 90, 90))
                y += gh + rng.randint(10, 36)
    if with_texts:
        return img, boxes, texts
    return img, boxes


def db_prob_target(boxes: list[tuple[int, int, int, int]], size: int,
                   shrink_ratio: float = 0.4) -> np.ndarray:
    """DB shrink-mask ground truth at input resolution (float32 0/1)."""
    target = np.zeros((size, size), np.float32)
    for x0, y0, x1, y1 in boxes:
        w, h = x1 - x0, y1 - y0
        if w < 4 or h < 4:
            continue
        area = w * h
        perim = 2 * (w + h)
        off = int(area * (1 - shrink_ratio**2) / perim)
        sx0, sy0 = x0 + off, y0 + off
        sx1, sy1 = x1 - off, y1 - off
        if sx1 <= sx0 or sy1 <= sy0:
            cx, cy = (x0 + x1) // 2, (y0 + y1) // 2
            sx0, sy0, sx1, sy1 = cx - 1, cy - 1, cx + 1, cy + 1
        target[max(sy0, 0) : sy1, max(sx0, 0) : sx1] = 1.0
    return target


class PageCropSampler:
    """Rec samples cut from rendered pages: page-resolution glyphs, page
    background, real neighbour lines and det-unclip-style loose margins."""

    def __init__(self, page_size: int = 960, crops_per_page: int = 64):
        self.page_size = page_size
        self.crops_per_page = crops_per_page
        self._queue: list[tuple[np.ndarray, str]] = []

    def _refill(self, rng: random.Random) -> None:
        img, boxes, texts = render_page(rng, self.page_size, with_texts=True)
        order = list(range(len(boxes)))
        rng.shuffle(order)
        for i in order[: self.crops_per_page]:
            x0, y0, x1, y1 = boxes[i]
            h = y1 - y0
            if h < 6 or x1 - x0 < 6:
                continue
            mx0 = x0 - rng.randint(0, int(h * 0.4))
            mx1 = x1 + rng.randint(0, int(h * 0.4))
            my0 = y0 - rng.randint(0, int(h * 0.45))
            my1 = y1 + rng.randint(0, int(h * 0.45))
            mx0, my0 = max(mx0, 0), max(my0, 0)
            mx1 = min(mx1, img.shape[1])
            my1 = min(my1, img.shape[0])
            crop = img[my0:my1, mx0:mx1]
            if crop.size == 0:
                continue
            self._queue.append((crop, texts[i]))

    def sample(self, rng: random.Random) -> tuple[np.ndarray, str]:
        while not self._queue:
            self._refill(rng)
        return self._queue.pop()


_PAGE_CROPS = PageCropSampler()


def _jpeg_round_trip(out: np.ndarray, quality: int) -> np.ndarray:
    """``cv2.imdecode(cv2.imencode(".jpg", out, [QUALITY, q])[1],
    IMREAD_COLOR)`` of an RGB array that cv2 reads as BGR."""
    bgr_as_rgb = np.ascontiguousarray(out[..., ::-1])
    return np.ascontiguousarray(decode_jpeg(encode_jpeg(bgr_as_rgb, quality))[..., ::-1])


def scan_wash(arr: np.ndarray, rng: random.Random) -> np.ndarray:
    """Scan/photo degradations the clean renderer never produces: faded
    ink (low contrast), gamma shifts, JPEG ringing."""
    a = arr.astype(np.float32)
    if rng.random() < 0.5:
        fade = rng.uniform(0.45, 0.9)
        a = 255.0 - (255.0 - a) * fade
    if rng.random() < 0.3:
        g = rng.uniform(0.65, 1.5)
        a = 255.0 * (a / 255.0) ** g
    out = np.clip(a, 0, 255).astype(np.uint8)
    if rng.random() < 0.35:
        out = _jpeg_round_trip(out, rng.randint(25, 80))
    return out


def rec_sample_lang(rng: random.Random, lang: str, width: int = 320, height: int = 48,
                    max_chars: int = 24) -> tuple[np.ndarray, str]:
    """Per-language rec training sample: an isolated rendered line with
    det-crop-like margins."""
    text = random_text_lang(rng, lang, max_words=4)[:max_chars].strip()
    if not text:
        text = rng.choice(_WORDS_RU if lang == "ru" else _WORDS)
    line = render_line(text, rng, height=height)
    out = rec_resize(line, width)
    if out.shape[1] < width:
        out = np.pad(out, ((0, 0), (0, width - out.shape[1]), (0, 0)), constant_values=0)
    return out[:, :width], text


def rec_sample(rng: random.Random, width: int = 320, height: int = 48,
               max_chars: int = 24) -> tuple[np.ndarray, str]:
    """(uint8 (H, W, 3) zero-right-padded crop, text): half crops cut from
    rendered pages, half isolated lines with loose margins and
    neighbour-line bleed."""
    if rng.random() < 0.5:
        # labels must cover the whole crop: drop (don't truncate) crops
        # whose line text exceeds the label budget
        for _ in range(8):
            crop, text = _PAGE_CROPS.sample(rng)
            text = text.strip()
            if text and len(text) <= max_chars:
                if rng.random() < 0.5:
                    crop = scan_wash(crop, rng)
                return rec_resize(crop, width, height), text

    while True:
        text = random_text(rng, max_words=4)[:max_chars].strip()
        if text:
            break
    line = render_line(text, rng, height=height)
    lh, lw = line.shape[:2]
    bg = int(line[0, 0, 0])
    my0 = rng.randint(0, int(lh * 0.45))
    my1 = rng.randint(0, int(lh * 0.45))
    mx0 = rng.randint(0, int(lh * 0.4))
    mx1 = rng.randint(0, int(lh * 0.4))
    canvas = np.full((lh + my0 + my1, lw + mx0 + mx1, 3), bg, np.uint8)
    canvas[my0 : my0 + lh, mx0 : mx0 + lw] = line
    if rng.random() < 0.35 and my0 >= 3:
        other = render_line(random_text(rng, 3) or "x", rng, height=height)
        sl = other[-min(my0, other.shape[0]) :, : canvas.shape[1]]
        canvas[: sl.shape[0], : sl.shape[1]] = np.minimum(
            canvas[: sl.shape[0], : sl.shape[1]], sl
        )
    if rng.random() < 0.35 and my1 >= 3:
        other = render_line(random_text(rng, 3) or "x", rng, height=height)
        sl = other[: min(my1, other.shape[0]), : canvas.shape[1]]
        canvas[-sl.shape[0] :, : sl.shape[1]] = np.minimum(
            canvas[-sl.shape[0] :, : sl.shape[1]], sl
        )
    if rng.random() < 0.5:
        canvas = scan_wash(canvas, rng)
    return rec_resize(canvas, width, height), text


def encode_text(text: str, charset: list[str]) -> list[int]:
    """text -> CTC label ids (blank=0, charset 1.., space=len+1)."""
    idx = {c: i + 1 for i, c in enumerate(charset)}
    space_id = len(charset) + 1
    out = []
    for ch in text:
        if ch == " ":
            out.append(space_id)
        elif ch in idx:
            out.append(idx[ch])
    return out
