"""Frame annotation: draw detection overlays for re-streaming.

Counterpart of ``evam_tpu/publish/annotate.py``: the host-side box and
label painter the RTSP re-stream runs before its JPEG encode. The
reference draws with cv2; the card's machine has none, so the port
paints in numpy:

- **boxes** are the pixels of ``cv2.rectangle(frame, (x, y), (x + w,
  y + h), (64, 220, 64), 2)`` (a 3-pixel band centred on each edge,
  the four outer corner pixels left out), clipped by the frame edge;
- **labels** carry the reference's string (label, `` #id``, up to two
  attributes, the confidence to two places) at the reference's origin,
  drawn in a built-in 3×5 bitmap font. A port note: without cv2 the
  font cannot be Hershey's. Each character advances by its Hershey
  simplex advance at scale 0.45, rounded down, so the label's pixels lie
  inside the box ``cv2.getTextSize(label, FONT_HERSHEY_SIMPLEX, 0.45,
  1)`` gives at that origin.
"""

from __future__ import annotations

import numpy as np

from evam_tpu_torch.stages.context import FrameContext, Region

_BOX = (64, 220, 64)
_TEXT = (255, 255, 255)
#: cv2.putText's scale in the reference
_SCALE = 0.45

#: Hershey simplex advance widths (font units, scale 1) of printable
#: ASCII from 32, as ``cv2.getTextSize`` sums them
_ADVANCE = (
    7, 7, 10, 20, 17, 21, 20, 6, 17, 17, 12, 17, 7, 13, 7, 13,
    17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 7, 7, 14, 16, 14, 15,
    24, 19, 19, 19, 19, 17, 16, 19, 20, 7, 18, 17, 16, 22, 20, 19,
    18, 19, 18, 17, 16, 20, 18, 23, 18, 18, 17, 9, 13, 9, 12, 21,
    9, 15, 17, 15, 17, 16, 11, 17, 17, 6, 7, 14, 7, 25, 17, 16,
    17, 17, 10, 14, 11, 17, 15, 23, 15, 15, 14, 10, 6, 10, 16)

#: 3×5 glyphs (rows top to bottom, "#" ink); narrow characters are
#: narrower; capitals draw as their small letters
_GLYPHS = {
    "0": "###,#.#,#.#,#.#,###", "1": ".#.,##.,.#.,.#.,###",
    "2": "###,..#,###,#..,###", "3": "###,..#,###,..#,###",
    "4": "#.#,#.#,###,..#,..#", "5": "###,#..,###,..#,###",
    "6": "###,#..,###,#.#,###", "7": "###,..#,..#,..#,..#",
    "8": "###,#.#,###,#.#,###", "9": "###,#.#,###,..#,###",
    "a": "###,#.#,###,#.#,#.#", "b": "##.,#.#,##.,#.#,##.",
    "c": "###,#..,#..,#..,###", "d": "##.,#.#,#.#,#.#,##.",
    "e": "###,#..,###,#..,###", "f": "###,#..,##.,#..,#..",
    "g": "###,#..,#.#,#.#,###", "h": "#.#,#.#,###,#.#,#.#",
    "i": "#,.,#,#,#", "j": ".#,..,.#,.#,##",
    "k": "#.#,#.#,##.,#.#,#.#", "l": "#,#,#,#,#",
    "m": "#.#,###,###,#.#,#.#", "n": "##.,#.#,#.#,#.#,#.#",
    "o": "###,#.#,#.#,#.#,###", "p": "###,#.#,###,#..,#..",
    "q": "###,#.#,#.#,###,..#", "r": "###,#.#,##.,#.#,#.#",
    "s": "###,#..,###,..#,###", "t": "###,.#.,.#.,.#.,.#.",
    "u": "#.#,#.#,#.#,#.#,###", "v": "#.#,#.#,#.#,#.#,.#.",
    "w": "#.#,#.#,###,###,#.#", "x": "#.#,#.#,.#.,#.#,#.#",
    "y": "#.#,#.#,###,.#.,.#.", "z": "###,..#,.#.,#..,###",
    " ": "...,...,...,...,...", ".": ".,.,.,.,#", ",": ".,.,.,#,#",
    ":": ".,#,.,#,.", "!": "#,#,#,.,#", "'": "#,#,.,.,.",
    "|": "#,#,#,#,#", "#": "#.#,###,#.#,###,#.#",
    "/": "..#,..#,.#.,#..,#..", "-": "...,...,###,...,...",
    "_": "...,...,...,...,###", "%": "#.#,..#,.#.,#..,#.#",
    "(": ".#,#.,#.,#.,.#", ")": "#.,.#,.#,.#,#.",
    "+": "...,.#.,###,.#.,...", "=": "...,###,...,###,...",
    "?": "###,..#,.##,...,.#.",
}
_MASKS = {c: np.array([[ch == "#" for ch in row] for row in g.split(",")])
          for c, g in _GLYPHS.items()}


def label_text(r: Region) -> str:
    """The reference's label string for one region."""
    label = r.label
    if r.object_id is not None:
        label = f"{label} #{r.object_id}"
    attrs = [t.label for t in r.tensors if not t.is_detection and t.label]
    if attrs:
        label += " " + "/".join(attrs[:2])
    return f"{label} {r.confidence:.2f}"


def draw_box(frame: np.ndarray, x0: int, y0: int, x1: int, y1: int,
             color=_BOX) -> None:
    """``cv2.rectangle(frame, (x0, y0), (x1, y1), color, 2)`` in place."""
    h, w = frame.shape[:2]
    corners = [(cy, cx) for cy in (y0 - 1, y1 + 1) for cx in (x0 - 1, x1 + 1)
               if 0 <= cy < h and 0 <= cx < w]
    kept = [frame[cy, cx].copy() for cy, cx in corners]
    # a 3-pixel band centred on each edge
    for ya, yb, xa, xb in ((y0 - 1, y0 + 2, x0 - 1, x1 + 2),
                           (y1 - 1, y1 + 2, x0 - 1, x1 + 2),
                           (y0 - 1, y1 + 2, x0 - 1, x0 + 2),
                           (y0 - 1, y1 + 2, x1 - 1, x1 + 2)):
        ya, yb, xa, xb = max(ya, 0), min(yb, h), max(xa, 0), min(xb, w)
        if ya < yb and xa < xb:
            frame[ya:yb, xa:xb] = color
    # cv2's round caps leave the four outer corner pixels as they were
    for (cy, cx), px in zip(corners, kept):
        frame[cy, cx] = px


def _advance(c: str) -> int:
    code = ord(c)
    units = _ADVANCE[code - 32] if 32 <= code < 127 else _ADVANCE[ord("?") - 32]
    return int(units * _SCALE)


def draw_label(frame: np.ndarray, text: str, x: int, y: int,
               color=_TEXT) -> None:
    """``text`` with its baseline's left end at (x, y), in place."""
    h, w = frame.shape[:2]
    for c in text:
        adv = _advance(c)
        mask = _MASKS.get(c.lower(), _MASKS["?"])[:, :max(adv - 1, 0)]
        top = y - mask.shape[0]
        ys, xs = np.nonzero(mask)
        ys, xs = ys + top, xs + x
        keep = (ys >= 0) & (ys < h) & (xs >= 0) & (xs < w)
        frame[ys[keep], xs[keep]] = color
        x += adv


def annotate_frame(ctx: FrameContext) -> np.ndarray:
    """BGR copy of ctx.frame with rects + labels painted."""
    frame = ctx.frame.copy()
    h, w = frame.shape[:2]
    for r in ctx.regions:
        x, y, bw, bh = r.rect(w, h)
        draw_box(frame, x, y, x + bw, y + bh)
        draw_label(frame, label_text(r), x, max(12, y - 4))
    return frame
