"""Writes supnerf_tpu_torch/utils/glyphs.py: the coverage bitmaps of the
characters that the TTO panels print, as cv2.putText draws them.

    python tests/fixtures/make_glyphs.py

OpenCV 5 draws cv2.FONT_HERSHEY_SIMPLEX with its built-in sans font ("Rubik
for OpenCV", SIL Open Font License 1.1), anti-aliased: fontScale s gives a
font size of round(s * 1000 / 37) pixels and thickness 1 the weight 400,
thickness 2 and more the weight 600. Each glyph is blended on its own, at
a whole-pixel pen position, as out = (bg * (255 - a) + color * a + 127) //
255 with its coverage a, and the pen moves on by the glyph's whole-pixel
advance (no kerning). This script renders each character white on black
with cv2.putText's FontFace form, where the pixel values are the coverage,
and writes them with their advances and their offsets from the text's
origin (the baseline's left end). tests/test_torch_vis.py holds the port's
text to cv2.putText pixel for pixel. Needs OpenCV 5.0 (cv2.FontFace).
"""
import os

import cv2
import numpy as np

CHARS = "0123456789.,:- PSNRDETnaif"
# (font size in pixels, weight): the panels' text at vis_im_sz 64, 128 and 256
FACES = ((5, 400), (9, 400), (19, 600))
OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "supnerf_tpu_torch", "utils", "glyphs.py")

HEADER = '''"""Coverage bitmaps of the characters the TTO panels print (written by
tests/fixtures/make_glyphs.py; do not edit).

They are OpenCV 5.0's renderings of its built-in sans font, "Rubik for
OpenCV": Copyright 2015 The Rubik Project Authors
(https://github.com/googlefonts/rubik), licensed under the SIL Open Font
License, Version 1.1 (https://scripts.sil.org/OFL).

GLYPHS[(size, weight)][char] = (advance, dx, dy, width, hex): the pen
advance in pixels, the bitmap's top-left corner relative to the text origin
(the left end of the baseline), its width, and its rows of 8-bit coverage
as one hex string (empty for a blank glyph).
"""

GLYPHS = {
'''


def glyph(face, c):
    size, weight = face
    h, w, ox, oy = 4 * size + 8, 4 * size + 8, size, 2 * size + 4
    img = np.zeros((h, w, 3), np.uint8)
    (end_x, _), _ = cv2.putText(img, c, (ox, oy), (255, 255, 255), cv2.FontFace("sans"), size,
                                weight)
    a = img[:, :, 0]
    ys, xs = np.nonzero(a)
    if len(ys) == 0:
        return end_x - ox, 0, 0, 0, ""
    crop = a[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    return end_x - ox, int(xs.min() - ox), int(ys.min() - oy), crop.shape[1], crop.tobytes().hex()


def main():
    lines = [HEADER]
    for face in FACES:
        lines.append(f"    {face!r}: {{\n")
        for c in CHARS:
            lines.append(f"        {c!r}: {glyph(face, c)!r},\n")
        lines.append("    },\n")
    lines.append("}\n")
    with open(OUT, "w") as f:
        f.write("".join(lines))


if __name__ == "__main__":
    main()
