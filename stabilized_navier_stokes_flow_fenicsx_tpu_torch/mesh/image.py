"""Image -> contour pipeline (native numpy; no scikit-image, no gmsh).

Replicates the behavior of reference NavierStokes/image2inlet.py:42-139 and
image2gmsh3D.py:21-155:

  load_image      PNG -> grayscale in [0, 1] (2/3/4-channel handling)
  find_contours   marching squares at level 0.5 with subpixel interpolation
  get_contours    area filter (fill-holes >= 5% of image), normalize to
                  [-0.5, 0.5]^2 with the reference's axis flips
  optimize_contour  complex-FFT low-pass + Ramer-Douglas-Peucker, returning
                  (contour, mesh_lc)

Input images are annuli: two closed contours; contours[0] (first in scan
order) is the outer boundary of the splitter wall, contours[1] the inner.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
from scipy import ndimage

from ..config import ContourConfig

# luma weights used by skimage.color.rgb2gray (ITU-R BT.709)
_LUMA = np.array([0.2125, 0.7154, 0.0721])


def load_image(path: str) -> np.ndarray:
    """PNG -> grayscale float array in [0, 1].

    Handles 2-channel (gray), 3-channel (RGB) and 4-channel (RGBA blended
    over a white background) images like reference image2inlet.py:42-56.
    """
    from PIL import Image

    img = np.asarray(Image.open(path))
    if img.ndim == 2:
        g = img.astype(np.float64)
        if g.max() > 1.0:
            g = g / 255.0
        return g
    img = img.astype(np.float64) / 255.0
    if img.shape[2] == 4:
        rgb, a = img[..., :3], img[..., 3:4]
        img = rgb * a + (1.0 - a)            # blend over white
    elif img.shape[2] == 2:                   # gray+alpha
        g, a = img[..., 0:1], img[..., 1:2]
        return (g * a + (1.0 - a))[..., 0]
    return img[..., :3] @ _LUMA


# ----------------------------------------------------------------------------
# Marching squares
# ----------------------------------------------------------------------------

# Edge ids within a cell (r, c): points returned as (row, col) floats
#   T: top    (r,     c + ft)
#   B: bottom (r + 1, c + fb)
#   L: left   (r + fl, c)
#   R: right  (r + fr, c + 1)
_T, _B, _L, _R = 0, 1, 2, 3

# segments per case; case bits: ul<<3 | ur<<2 | lr<<1 | ll  (1 = above level)
_CASES: dict = {
    0b0000: [],
    0b1111: [],
    0b1000: [(_L, _T)],
    0b0100: [(_T, _R)],
    0b0010: [(_R, _B)],
    0b0001: [(_B, _L)],
    0b1100: [(_L, _R)],
    0b0110: [(_T, _B)],
    0b0011: [(_R, _L)],
    0b1001: [(_B, _T)],
    0b1110: [(_L, _B)],
    0b1101: [(_B, _R)],
    0b1011: [(_R, _T)],
    0b0111: [(_T, _L)],
    # saddles resolved by cell-center value (like skimage)
    0b1010: None,
    0b0101: None,
}


def find_contours(gray: np.ndarray, level: float = 0.5) -> List[np.ndarray]:
    """Closed/open iso-contours of ``gray`` at ``level``.

    Returns a list of (N, 2) float arrays of (row, col) points, ordered
    along the curve; closed loops do NOT repeat the first point at the end
    (callers append it when needed — the reference deletes it anyway,
    image2inlet.py:123).  Contours are sorted by first-point scan order to
    match skimage's ordering contract used by the reference
    (contours[0]=outer, contours[1]=inner).
    """
    g = np.asarray(gray, dtype=np.float64)
    h, w = g.shape
    ul = g[:-1, :-1]
    ur = g[:-1, 1:]
    ll = g[1:, :-1]
    lr = g[1:, 1:]
    b_ul = (ul > level).astype(np.int8)
    b_ur = (ur > level).astype(np.int8)
    b_lr = (lr > level).astype(np.int8)
    b_ll = (ll > level).astype(np.int8)
    case = (b_ul << 3) | (b_ur << 2) | (b_lr << 1) | b_ll

    with np.errstate(divide="ignore", invalid="ignore"):
        ft = (level - ul) / (ur - ul)    # top edge fraction
        fb = (level - ll) / (lr - ll)
        fl = (level - ul) / (ll - ul)
        fr = (level - ur) / (lr - ur)

    R, C = np.meshgrid(np.arange(h - 1), np.arange(w - 1), indexing="ij")

    def edge_point(edge, r, c):
        if edge == _T:
            return np.stack([r.astype(float), c + ft[r, c]], axis=-1)
        if edge == _B:
            return np.stack([r + 1.0, c + fb[r, c]], axis=-1)
        if edge == _L:
            return np.stack([r + fl[r, c], c.astype(float)], axis=-1)
        return np.stack([r + fr[r, c], c + 1.0], axis=-1)

    segs_a = []   # (n, 2) start points
    segs_b = []   # (n, 2) end points
    for cs, seglist in _CASES.items():
        if seglist == []:
            continue
        m = case == cs
        if not m.any():
            continue
        r, c = R[m], C[m]
        if seglist is None:
            # saddle: disambiguate by center average
            center = (ul[m] + ur[m] + ll[m] + lr[m]) / 4.0 > level
            if cs == 0b1010:
                # ul & lr above
                segsA = [(_L, _T), (_R, _B)]       # center below
                segsB = [(_L, _B), (_R, _T)]       # center above
            else:
                # ur & ll above
                segsA = [(_T, _R), (_B, _L)]
                segsB = [(_T, _L), (_B, _R)]
            for half, segs in ((~center, segsA), (center, segsB)):
                if half.any():
                    rr, cc = r[half], c[half]
                    for e0, e1 in segs:
                        segs_a.append(edge_point(e0, rr, cc))
                        segs_b.append(edge_point(e1, rr, cc))
            continue
        for e0, e1 in seglist:
            segs_a.append(edge_point(e0, r, c))
            segs_b.append(edge_point(e1, r, c))

    if not segs_a:
        return []
    A = np.concatenate(segs_a, axis=0)
    B = np.concatenate(segs_b, axis=0)

    # chain segments into polylines via endpoint hashing
    def key(p):
        return (round(p[0] * 1e6), round(p[1] * 1e6))

    from collections import defaultdict

    point_segs = defaultdict(list)     # endpoint key -> [(seg idx, end)]
    n = A.shape[0]
    for i in range(n):
        point_segs[key(A[i])].append((i, 0))
        point_segs[key(B[i])].append((i, 1))

    used = np.zeros(n, dtype=bool)
    contours = []
    for start in range(n):
        if used[start]:
            continue
        used[start] = True
        chain = [A[start], B[start]]
        # extend forward from B end
        for endsel, append in ((1, True), (0, False)):
            cur = key(chain[-1] if append else chain[0])
            while True:
                nxt = None
                for (j, e) in point_segs.get(cur, ()):
                    if not used[j]:
                        nxt = (j, e)
                        break
                if nxt is None:
                    break
                j, e = nxt
                used[j] = True
                p = B[j] if e == 0 else A[j]
                if append:
                    chain.append(p)
                else:
                    chain.insert(0, p)
                cur = key(p)
        arr = np.array(chain)
        # drop duplicated closing point of closed loops
        if len(arr) > 2 and key(arr[0]) == key(arr[-1]):
            arr = arr[:-1]
        contours.append(arr)

    contours.sort(key=lambda c: (c[:, 0].min(), c[:, 1].min()))
    return contours


def get_contours(gray: np.ndarray, cfg: ContourConfig = ContourConfig()
                 ) -> List[np.ndarray]:
    """Contours filtered by enclosed area and normalized like the reference
    (image2inlet.py:58-91): area(filled mask) >= 5% of the image; columns
    shifted/scaled by height, rows by width with a sign flip."""
    height, width = gray.shape
    raw = find_contours(gray, cfg.level)
    contours = []
    for c in raw:
        mask = np.zeros_like(gray, dtype=np.int8)
        rr = np.clip(np.round(c[:, 0]).astype(int), 0, height - 1)
        cc = np.clip(np.round(c[:, 1]).astype(int), 0, width - 1)
        mask[rr, cc] = 1
        mask = ndimage.binary_fill_holes(mask)
        if float(np.count_nonzero(mask)) / float(height * width) \
                >= cfg.min_area_frac:
            contours.append(c.copy())
    for c in contours:
        c[:, 1] = (c[:, 1] - 0.5 * height) / height
        c[:, 0] = -(c[:, 0] - 0.5 * width) / width
    return contours


# ----------------------------------------------------------------------------
# Contour smoothing: FFT low-pass + RDP
# ----------------------------------------------------------------------------


def rdp(points: np.ndarray, epsilon: float) -> np.ndarray:
    """Ramer-Douglas-Peucker polyline simplification (iterative)."""
    pts = np.asarray(points, dtype=np.float64)
    n = len(pts)
    keep = np.zeros(n, dtype=bool)
    keep[0] = keep[-1] = True
    stack = [(0, n - 1)]
    while stack:
        i0, i1 = stack.pop()
        if i1 <= i0 + 1:
            continue
        p0, p1 = pts[i0], pts[i1]
        d = p1 - p0
        L = np.hypot(*d)
        seg = pts[i0 + 1 : i1]
        if L < 1e-300:
            dist = np.linalg.norm(seg - p0, axis=1)
        else:
            dn = d / L
            rel = seg - p0
            dist = np.abs(dn[0] * rel[:, 1] - dn[1] * rel[:, 0])
        k = int(np.argmax(dist))
        if dist[k] > epsilon:
            keep[i0 + 1 + k] = True
            stack.append((i0, i0 + 1 + k))
            stack.append((i0 + 1 + k, i1))
    return pts[keep]


def optimize_contour(
    contour: np.ndarray,
    cutoff: float = 0.12,
    rdp_epsilon: float = 5e-4,
    mesh_lc_frac: float = 0.05,
) -> Tuple[np.ndarray, float]:
    """FFT low-pass smooth + RDP simplify (image2inlet.py:94-139).

    The closing point (coincident with the first) is dropped, and
    mesh_lc = mesh_lc_frac * min(bbox extents).
    """
    c = np.asarray(contour, dtype=np.float64).copy()
    signal = c[:, 1] + 1j * c[:, 0]
    fft = np.fft.fft(signal)
    freq = np.fft.fftfreq(signal.shape[-1])
    fft[np.abs(freq) > cutoff] = 0
    filt = np.fft.ifft(fft)
    c[:, 1] = filt.real
    c[:, 0] = filt.imag
    # close the loop for RDP (reference relies on skimage's repeated point)
    c = np.vstack([c, c[:1]])
    c = rdp(c, rdp_epsilon)
    c = c[:-1]
    lc = min(c[:, 1].max() - c[:, 1].min(), c[:, 0].max() - c[:, 0].min())
    return c, mesh_lc_frac * lc
