"""Make ``tod_tpu_torch/utils/hershey_simplex.npz``: the glyphs cv2 draws
for each printable ASCII character with ``cv2.putText(...,
FONT_HERSHEY_SIMPLEX, 0.5, color, 1)``.

OpenCV 5 renders this font anti-aliased from a built-in outline font: each
glyph is a coverage map (0-255) at a whole-pixel position, the cursor
moves by a whole number of pixels a character, and each glyph in turn is
blended into the image, ``(bg * (255 - a) + color * a + 127) // 255`` a
channel. This tool reads each character's coverage (drawn alone in 255 on
black) and its advance (how far it moves a following ``l``), checks that
composing them so gives cv2's pixels on random labels, colours,
backgrounds and origins (borders included), and stores them as (dx, dy,
coverage) from the origin. ``tod_tpu_torch/utils/visualize.py put_text``
composes labels from them.

Run on a host with cv2 (seconds):
  python tools/make_torch_hershey.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os
import string

import cv2
import numpy as np

FONT, SCALE = cv2.FONT_HERSHEY_SIMPLEX, 0.5
ORG = (40, 40)


def _draw(text: str) -> np.ndarray:
    canvas = np.zeros((80, 240), np.uint8)
    cv2.putText(canvas, text, ORG, FONT, SCALE, 255, 1)
    return canvas


def _right(text: str) -> int:
    return int(np.nonzero(_draw(text).any(0))[0].max())


def _compose(img, text, org, color, table):
    """The label from the table, as ``visualize.put_text`` composes it."""
    out = img.astype(np.int64)
    x = org[0]
    for ch in text:
        adv, dx, dy, a = table[ord(ch)]
        X, Y = dx + x, dy + org[1]
        on = (X >= 0) & (X < out.shape[1]) & (Y >= 0) & (Y < out.shape[0])
        bg = out[Y[on], X[on]]
        out[Y[on], X[on]] = (bg * (255 - a[on, None])
                             + np.asarray(color) * a[on, None] + 127) // 255
        x += adv
    return out.astype(np.uint8)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(__file__), "..", "tod_tpu_torch", "utils",
        "hershey_simplex.npz"))
    args = ap.parse_args(argv)
    codes = list(range(32, 127))
    gap = _right("    l") - _right("l")
    table = {}
    for c in codes:
        alpha = _draw(chr(c)).astype(np.int64)
        ys, xs = np.nonzero(alpha)
        adv = _right(chr(c) + "    l") - _right("l") - gap
        table[c] = (adv, xs - ORG[0], ys - ORG[1], alpha[ys, xs])
    rng = np.random.default_rng(0)
    for _ in range(300):
        text = "".join(rng.choice(list(string.printable[:95]),
                                  int(rng.integers(1, 15))))
        h, w = int(rng.integers(10, 60)), int(rng.integers(10, 160))
        img = rng.integers(0, 256, (h, w, 3), np.uint8)
        color = tuple(int(v) for v in rng.integers(0, 256, 3))
        org = (int(rng.integers(-60, w + 5)), int(rng.integers(-10, h + 15)))
        want = img.copy()
        cv2.putText(want, text, org, FONT, SCALE, color, 1)
        if not np.array_equal(want, _compose(img, text, org, color, table)):
            raise SystemExit(f"composed glyphs differ from cv2 on {text!r}")
    starts = np.cumsum([0] + [len(table[c][1]) for c in codes])
    np.savez_compressed(
        args.out, codes=np.asarray(codes, np.int16),
        advance=np.asarray([table[c][0] for c in codes], np.int16),
        offsets=np.concatenate([np.stack(table[c][1:3], 1)
                                for c in codes]).astype(np.int16),
        alpha=np.concatenate([table[c][3] for c in codes]).astype(np.uint8),
        starts=starts.astype(np.int32))
    print(f"wrote {args.out}: {len(codes)} characters, {starts[-1]} pixels")


if __name__ == "__main__":
    main()
