"""CLI: compare a simulated outlet profile against an experiment photo.

Counterpart of the JAX package's ``apps/compare_images.py`` (numpy and
PIL only), a port of reference NavierStokes/noether_data/compareImages.py:
remove the gray background, auto-crop both images to their content
bounding boxes (ImageChops-diff style), resize to common dimensions, and
save a PNG of three panels side by side under their titles: simulated,
overlay, absolute difference.  The figure is composed with PIL at the
images' own resolution; it runs on the host, no device involved.

    python -m stabilized_navier_stokes_flow_fenicsx_tpu_torch.apps.compare_images \
        <simulated.png> <experiment.png> [out.png]
"""

from __future__ import annotations

import sys

import numpy as np

PAD, TITLE_H = 10, 20            # pixels around and above the panels
TITLES = ("simulated", "overlay", "abs diff")


def remove_gray_background(img: np.ndarray, tol: int = 30) -> np.ndarray:
    """Pixels close to neutral gray -> white (compareImages.py:13-41)."""
    rgb = img[..., :3].astype(int)
    spread = rgb.max(axis=-1) - rgb.min(axis=-1)
    mid = (rgb.mean(axis=-1) > 60) & (rgb.mean(axis=-1) < 210)
    grayish = (spread < tol) & mid
    out = img.copy()
    out[grayish] = 255
    return out


def autocrop(img: np.ndarray, bg: int = 255, margin: int = 2) -> np.ndarray:
    """Crop to the bbox of non-background content (ImageChops.difference
    + getbbox equivalent, compareImages.py:43-70)."""
    content = np.any(img[..., :3] < bg - 5, axis=-1)
    if not content.any():
        return img
    rows = np.nonzero(content.any(axis=1))[0]
    cols = np.nonzero(content.any(axis=0))[0]
    r0 = max(rows[0] - margin, 0)
    r1 = min(rows[-1] + margin + 1, img.shape[0])
    c0 = max(cols[0] - margin, 0)
    c1 = min(cols[-1] + margin + 1, img.shape[1])
    return img[r0:r1, c0:c1]


def panel_boxes(size):
    """(left, top, right, bottom) of the three panels of an image of
    ``size`` = (width, height) in the figure."""
    w, h = size
    return [(PAD + i * (w + PAD), TITLE_H + PAD,
             PAD + i * (w + PAD) + w, TITLE_H + PAD + h) for i in range(3)]


def compare_images(sim_path: str, exp_path: str, out_path: str = "compare.png"):
    from PIL import Image, ImageDraw

    sim = np.asarray(Image.open(sim_path).convert("RGB"))
    exp = np.asarray(Image.open(exp_path).convert("RGB"))
    exp = remove_gray_background(exp)
    sim_c = autocrop(sim)
    exp_c = autocrop(exp)
    size = (max(sim_c.shape[1], exp_c.shape[1]),
            max(sim_c.shape[0], exp_c.shape[0]))
    sim_r = np.asarray(Image.fromarray(sim_c).resize(size))
    exp_r = np.asarray(Image.fromarray(exp_c).resize(size))

    overlay = (0.5 * sim_r.astype(float) + 0.5 * exp_r.astype(float))
    absdiff = np.abs(sim_r.astype(int) - exp_r.astype(int)).astype(np.uint8)

    boxes = panel_boxes(size)
    fig = Image.new("RGB", (boxes[-1][2] + PAD, boxes[-1][3] + PAD), "white")
    draw = ImageDraw.Draw(fig)
    for box, im, title in zip(
            boxes, [sim_r, overlay.astype(np.uint8), absdiff], TITLES):
        fig.paste(Image.fromarray(im), box[:2])
        x = (box[0] + box[2] - draw.textlength(title)) / 2
        draw.text((x, PAD // 2), title, fill="black")
    fig.save(out_path)
    return out_path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) < 2:
        raise ValueError(__doc__)
    out = argv[2] if len(argv) > 2 else "compare.png"
    return compare_images(argv[0], argv[1], out)


if __name__ == "__main__":
    main()
