"""Writes supnerf_tpu_torch/utils/colormaps.py: the two matplotlib colour
tables the dataset QA images use, as the port's own constants.

    python tests/fixtures/make_colormaps.py

MAGMA_BYTES is matplotlib's magma lookup table as Colormap.__call__(x,
bytes=True) reads it: (lut * 255).astype(uint8) of its 256 colours, RGB
(the JAX package's utils/vis.colorize_depth). HSV_255 is the table that
supnerf_tpu/utils/vis.show_lidar_on_image builds,
plt.get_cmap("hsv")(np.linspace(0, 1, 256))[:, :3] * 255, as float64
values written with repr (exact). tests/test_torch_qa.py holds both to
matplotlib.
"""
import os

import matplotlib
import numpy as np

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                   "supnerf_tpu_torch", "utils", "colormaps.py")

HEADER = '''"""matplotlib's colour tables that the dataset QA images use (written by
tests/fixtures/make_colormaps.py from matplotlib {version}; do not edit).

MAGMA_BYTES: the magma colormap's 256 colours as Colormap.__call__(x,
bytes=True) reads them, (lut * 255).astype(uint8), RGB.
HSV_255: plt.get_cmap("hsv")(np.linspace(0, 1, 256))[:, :3] * 255, the
table of supnerf_tpu/utils/vis.show_lidar_on_image, in float64.

matplotlib is (c) the Matplotlib Development Team, under the Matplotlib
License (PSF-based); magma is by Nathaniel J. Smith and Stefan van der
Walt, CC0.
"""
'''


def main():
    cmap = matplotlib.colormaps["magma"]
    magma = cmap(np.linspace(0, 1, cmap.N), bytes=True)[:, :3]
    # check the read: the table is the lut's bytes, one row an index
    lut = (cmap._lut[:cmap.N, :3] * 255).astype(np.uint8)
    assert np.array_equal(magma, lut)
    hsv = np.asarray(plt.get_cmap("hsv")(np.linspace(0, 1, 256)))[:, :3] * 255
    lines = [HEADER.format(version=matplotlib.__version__), "MAGMA_BYTES = ("]
    lines += [f"    ({r}, {g}, {b})," for r, g, b in magma.tolist()]
    lines += [")", "", "HSV_255 = ("]
    lines += [f"    ({r!r}, {g!r}, {b!r})," for r, g, b in hsv.tolist()]
    lines += [")", ""]
    with open(OUT, "w") as f:
        f.write("\n".join(lines))


if __name__ == "__main__":
    main()
