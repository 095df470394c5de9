"""What the port does not run yet, by its ROADMAP item.

Every part of the JAX package that the port has not ported raises
``NotImplementedError`` through ``not_ported`` where the port would need
it, naming the ROADMAP Queue 1 item that ports it. Nothing is skipped or
left blank in its place.
"""
from __future__ import annotations

# ROADMAP.md, Queue 1: item number and title of each item the port
# raises for
ITEMS = {
    "pdfio": (12, "12f, WEBP, JPX, rare JPEG codings, other filters and image forms"),
    "glyphs": (12, "12c's rest, bitmap-strike faces and complex shaping"),
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error to raise where the port reaches ``what``, which ROADMAP
    Queue 1 item ``item`` (a key of ITEMS) ports."""
    number, title = ITEMS[item]
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {number}: {title})"
    )

