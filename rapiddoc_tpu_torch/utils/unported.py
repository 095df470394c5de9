"""What the port does not run yet, by its ROADMAP item.

Every part of the JAX package that the port has not ported raises
``NotImplementedError`` through ``not_ported`` where the port would need
it, naming the ROADMAP Queue 1 item that ports it. Nothing is skipped or
left blank in its place.
"""
from __future__ import annotations

import os

# ROADMAP.md, Queue 1: item number and title of each item the port
# raises for
ITEMS = {
    "small_resize": (5, "PIL-BILINEAR resize of small placed images"),
    "layout": (8, "layout"),
    "seal": (11, "seal and detect_polys"),
    "pdfio": (12, "the rest of pdfio/ and pipeline/"),
    "sniff": (13, "ONNX interpreter and sniffing"),
    "host_families": (15, "the host-only families"),
    "checkpoints": (17, "checkpoint converters and published checkpoints"),
}


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error to raise where the port reaches ``what``, which ROADMAP
    Queue 1 item ``item`` (a key of ITEMS) ports."""
    number, title = ITEMS[item]
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item {number}: {title})"
    )


def check_knob(name: str, what: str, item: str, default: str | None = None) -> None:
    """Raise ``not_ported`` where the environment moves a knob of the JAX
    package that changes its numbers and that the port runs only at its
    default: ``name`` set to anything but ``default``, or, with no
    default, set to any non-empty value (the JAX package's test)."""
    value = os.environ.get(name)
    if value is None or value == default or (default is None and not value):
        return
    raise not_ported(f"{what} ({name}={value!r})", item)
