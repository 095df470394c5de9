"""Image cropping/saving helpers for pipeline outputs.

Port of ``rapiddoc_tpu/utils/images.py`` on numpy page arrays (H, W, 3).
The crops and their digest names (a sha256 of the RGB pixels) are the
JAX package's; the payload written for a span is the JPEG PIL writes at
quality 90, made by ``pdfio/jpeg_encode.py`` byte for byte. With
``originals`` (``image_config["extract_original_image"]``), an image span
that matches an embedded image keeps that image's decoded pixels.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..pdfio.jpeg_encode import QUALITY, encode_jpeg
from .unported import not_ported


def crop_bbox(page_img: np.ndarray, bbox, scale: float, pad: int = 0) -> np.ndarray:
    """Crop a page-coordinate bbox from a rendered page image."""
    height, width = page_img.shape[:2]
    x0, y0, x1, y1 = (v * scale for v in bbox)
    x0, y0 = max(0, int(x0) - pad), max(0, int(y0) - pad)
    x1 = min(width, int(x1 + 0.999) + pad)
    y1 = min(height, int(y1 + 0.999) + pad)
    if x1 <= x0 or y1 <= y0:
        return np.full((1, 1, 3), 255, np.uint8)
    return page_img[y0:y1, x0:x1]


def image_digest_name(img: np.ndarray, suffix: str = "jpg") -> str:
    h = hashlib.sha256(np.ascontiguousarray(img).tobytes()).hexdigest()[:32]
    return f"{h}.{suffix}"


def encode_image(img: np.ndarray, fmt: str = "JPEG", quality: int = 90) -> bytes:
    """The bytes of ``PIL.Image.save(buf, "JPEG", quality=90)`` of the RGB
    crop; the JAX package writes no other format or quality here."""
    if fmt != "JPEG" or quality != QUALITY:
        raise not_ported(f"{fmt} span images at quality {quality}", "pdfio")
    return encode_jpeg(img)


def cut_span_images(
    page_info: dict,
    page_img: np.ndarray,
    scale: float,
    image_writer,
    image_dir: str = "",
    originals: list | None = None,
    original_iou_thresh: float = 0.9,
) -> None:
    """Crop & save image/table/interline-equation span images, setting
    span['image_path'] in place. image_writer: DataWriter-like with write().

    ``originals`` ((bbox in page units, decoded RGB pixels) pairs):
    an image span whose IoU with an embedded image's bbox is at least
    ``original_iou_thresh`` keeps that image's pixels, not a crop of the
    rendered page."""
    from ..types import ContentType
    from . import boxes as B

    def handle_span(span: dict) -> None:
        if (
            span.get("type") == ContentType.TABLE
            and span.get("html")
            and span.get("fill_images")
        ):
            # in-table image uuid placeholders -> saved crops + <img> tags
            html = span["html"]
            for fill in span["fill_images"]:
                uid = fill.get("uuid")
                if not uid or uid not in html:
                    continue
                crop = crop_bbox(page_img, fill["bbox"], scale)
                name = image_digest_name(crop)
                if image_writer is not None:
                    image_writer.write(name, encode_image(crop))
                src = f"{image_dir or 'images'}/{name}"
                html = html.replace(uid, f'<img src="{src}" alt="Image" />')
            span["html"] = html
        if span.get("type") in (
            ContentType.IMAGE,
            ContentType.TABLE,
            ContentType.INTERLINE_EQUATION,
        ) and not span.get("image_path"):
            crop = None
            if originals and span["type"] == ContentType.IMAGE:
                for obox, oimg in originals:
                    if B.iou(span["bbox"], obox) >= original_iou_thresh:
                        crop = oimg
                        break
            if crop is None:
                crop = crop_bbox(page_img, span["bbox"], scale)
            name = image_digest_name(crop)
            if image_writer is not None:
                image_writer.write(name, encode_image(crop))
            span["image_path"] = name

    def walk_blocks(blocks: list[dict]) -> None:
        for block in blocks:
            if "blocks" in block:
                walk_blocks(block["blocks"])
            for line in block.get("lines", []):
                for span in line.get("spans", []):
                    handle_span(span)
            for span in block.get("spans", []):
                handle_span(span)

    walk_blocks(page_info.get("preproc_blocks", []))
