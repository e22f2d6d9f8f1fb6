"""A 3-D view and a painter for the port's drawings, in numpy.

The view is mplot3d's, as matplotlib 3.10 builds it
(`mpl_toolkits/mplot3d/axes3d.py`, `proj3d.py`): a perspective
projection with focal length 1 from a camera 10 units from the middle of
a box of aspect (4, 4, 3), at `elev` and `azim` degrees (roll 0), over
the limits that a scatter of the same data autoscales to (the data's
range, a zero range widened as matplotlib widens it, a 5% margin, then
1/48 more on each side of each axis). `Panel.project` gives
what `proj3d.proj_transform(x, y, z, ax.get_proj())` gives: the 2-D view
coordinates and the depth of each point.

The painter draws on an RGB uint8 canvas: the lines first, far to near,
1 px wide, then the discs far to near (a later disc over an earlier one
at the same depth), each disc of the area of a matplotlib marker of
size `s` points² at the drawing's dpi. Titles are drawn in a 5x7 bitmap
font that holds what the titles need: digits, `t` and `=`.
"""

from __future__ import annotations

import itertools

import numpy as np

COLORS = {"C0": (31, 119, 180), "C3": (214, 39, 40), "red": (255, 0, 0),
          "cyan": (0, 255, 255)}

DIST = 10.0                          # axes3d.py:1147
_BOX = np.array([4.0, 4.0, 3.0])     # the default box aspect, scaled as
_BOX *= 1.8294640721620434 * 25 / 24 / np.linalg.norm(_BOX)  # :387-390
VIEW_MARGIN = 1 / 48                 # axes3d.py:169
MARGIN = 0.05      # rcParams axes.[xy]margin; z's once a scatter is drawn
# the 2-D view limits (set_top_view): -0.95/dist to 0.9/dist on both axes
VIEW_LO, VIEW_HI = -0.95 / DIST, 0.9 / DIST
TITLE_ABOVE = 11   # a title's top row above its view square, px


def _nonsingular(vmin: float, vmax: float, expander: float,
                 tiny: float = 1e-15) -> tuple[float, float]:
    """matplotlib.transforms.nonsingular for finite, ordered limits."""
    maxabs = max(abs(vmin), abs(vmax))
    if maxabs < (1e6 / tiny) * np.finfo(float).tiny:
        return -expander, expander
    if vmax - vmin <= maxabs * tiny:
        if vmax == 0 and vmin == 0:
            return -expander, expander
        return vmin - expander * abs(vmin), vmax + expander * abs(vmax)
    return vmin, vmax


def autoscale(points: np.ndarray) -> np.ndarray:
    """[3, 2] axis limits that a 3-D scatter of `points` [N, 3] gives."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    lims = np.empty((3, 2))
    for k in range(3):
        lo, hi = _nonsingular(float(pts[:, k].min()), float(pts[:, k].max()),
                              0.05)
        delta = (hi - lo) * MARGIN
        lo, hi = _nonsingular(lo - delta, hi + delta, 1e-12, 1e-13)
        delta = (hi - lo) * VIEW_MARGIN
        lims[k] = lo - delta, hi + delta
    return lims


def view_matrices(limits: np.ndarray, elev: float = 30.0,
                  azim: float = -60.0) -> tuple[np.ndarray, np.ndarray]:
    """(view @ world, projection @ view @ world), each [4, 4]: the first
    takes data to the camera's frame (x right, y up, looking down -z),
    the second is `ax.get_proj()`."""
    (x0, x1), (y0, y1), (z0, z1) = limits
    dx, dy, dz = (x1 - x0) / _BOX[0], (y1 - y0) / _BOX[1], (z1 - z0) / _BOX[2]
    world = np.array([[1 / dx, 0, 0, -x0 / dx], [0, 1 / dy, 0, -y0 / dy],
                      [0, 0, 1 / dz, -z0 / dz], [0, 0, 0, 1]])
    middle = 0.5 * _BOX
    e, a = np.deg2rad(elev), np.deg2rad(azim)
    eye = middle + DIST * np.array([np.cos(e) * np.cos(a),
                                    np.cos(e) * np.sin(a), np.sin(e)])
    w = (eye - middle) / np.linalg.norm(eye - middle)
    up = np.array([0.0, 0.0, -1.0 if abs(_norm_angle(elev)) > 90 else 1.0])
    u = np.cross(up, w)
    u = u / np.linalg.norm(u)
    v = np.cross(w, u)
    rot, shift = np.eye(4), np.eye(4)
    rot[:3, :3] = [u, v, w]
    shift[:3, -1] = -eye          # focal length 1: the eye stays put
    view = rot @ shift
    zfront, zback = -DIST, DIST       # proj3d._persp_transformation
    persp = np.array([[1.0, 0, 0, 0], [0, 1.0, 0, 0],
                      [0, 0, (zfront + zback) / (zfront - zback),
                       -2 * (zfront * zback) / (zfront - zback)],
                      [0, 0, -1, 0]])
    m0 = view @ world
    return m0, persp @ m0


def _norm_angle(a: float) -> float:
    """An angle in degrees into (-180, 180] (art3d._norm_angle)."""
    a = (a + 360) % 360
    return a - 360 if a > 180 else a


def transform(points: np.ndarray, m: np.ndarray):
    """(x, y, z) of [N, 3] `points` through [4, 4] `m`, divided by w
    (proj3d.proj_transform)."""
    pts = np.asarray(points, np.float64).reshape(-1, 3)
    vec = np.vstack([pts.T, np.ones(len(pts))])
    out = m @ vec
    return out[0] / out[3], out[1] / out[3], out[2] / out[3]


def view_to_pixels(tx, ty, box):
    """2-D view coordinates -> canvas pixel coordinates (x right, y
    down; pixel (i, j) covers [i, i + 1) x [j, j + 1)) for the view
    square `box` = (left, top, side) in pixels."""
    left, top, side = box
    scale = side / (VIEW_HI - VIEW_LO)
    return (left + (np.asarray(tx) - VIEW_LO) * scale,
            top + (VIEW_HI - np.asarray(ty)) * scale)


def disc_cover(u, v, radius: float, height: int, width: int):
    """(rows, cols) of the pixels that discs of one radius at (u, v)
    paint: those whose centres lie within `radius`, and always the pixel
    holding (u, v)."""
    u, v = np.atleast_1d(u)[:, None], np.atleast_1d(v)[:, None]
    k = int(np.ceil(radius)) + 1
    dj, di = (d.ravel() for d in np.mgrid[-k:k + 1, -k:k + 1])
    ii = np.floor(u).astype(int) + di
    jj = np.floor(v).astype(int) + dj
    hit = (ii + 0.5 - u) ** 2 + (jj + 0.5 - v) ** 2 <= radius * radius
    hit |= (di == 0) & (dj == 0)
    hit &= (ii >= 0) & (ii < width) & (jj >= 0) & (jj < height)
    return jj[hit], ii[hit]


def paint_line(img: np.ndarray, u0, v0, u1, v1, rgb) -> None:
    """A 1-px line: the pixels holding points every half pixel along it,
    its midpoint among them."""
    n = 2 * int(np.ceil(max(abs(u1 - u0), abs(v1 - v0)))) + 2
    t = np.arange(n + 1) / n
    cols = np.floor(u0 * (1 - t) + u1 * t).astype(int)
    rows = np.floor(v0 * (1 - t) + v1 * t).astype(int)
    ok = (cols >= 0) & (cols < img.shape[1]) & (rows >= 0) & \
        (rows < img.shape[0])
    img[rows[ok], cols[ok]] = rgb


def marker_radius(s: float, dpi: float) -> float:
    """The radius in pixels of a matplotlib marker of size `s` points²."""
    return 0.5 * np.sqrt(s) * dpi / 72.0


class Panel:
    """One 3-D axes' worth of drawing: `scatter` and `plot` collect, and
    `draw` autoscales over all that was collected, projects and paints,
    as matplotlib does at savefig."""

    def __init__(self, elev: float = 30.0, azim: float = -60.0):
        self.elev, self.azim = elev, azim
        self.points: list = []      # (xyz [N, 3], s, rgb)
        self.segments: list = []    # (xyz [N, 2, 3], rgb)
        self.title: str | None = None

    def scatter(self, xyz, s: float, color: str) -> None:
        """Discs at [N, 3] `xyz`, `s` points² each, in a `COLORS` name."""
        self.points.append((np.asarray(xyz, np.float64).reshape(-1, 3),
                            float(s), COLORS[color]))

    def plot(self, segments, color: str) -> None:
        """Lines between the point pairs of [N, 2, 3] `segments`."""
        self.segments.append((np.asarray(segments, np.float64)
                              .reshape(-1, 2, 3), COLORS[color]))

    def proj(self) -> np.ndarray:
        """`ax.get_proj()` for what was collected."""
        data = [p for p, _, _ in self.points] + \
            [s.reshape(-1, 3) for s, _ in self.segments]
        return view_matrices(autoscale(np.concatenate(data)), self.elev,
                             self.azim)[1]

    def project(self, xyz):
        """(x, y, depth) of [N, 3] `xyz` in this panel's view."""
        return transform(xyz, self.proj())

    def layout(self, box, dpi: float) -> tuple[list, list]:
        """What `draw` paints in the view square `box` = (left, top,
        side), in paint order and in pixels: (segments (u0, v0, u1, v1,
        rgb), far to near by their midpoints' depth; discs (u, v, radius,
        rgb), far to near, at equal depths in the order added)."""
        m = self.proj()
        segs = []
        for xyz, rgb in self.segments:
            a, b = transform(xyz[:, 0], m), transform(xyz[:, 1], m)
            u0, v0 = view_to_pixels(a[0], a[1], box)
            u1, v1 = view_to_pixels(b[0], b[1], box)
            segs += [(0.5 * (a[2][k] + b[2][k]),
                      (u0[k], v0[k], u1[k], v1[k], rgb))
                     for k in range(len(xyz))]
        discs = []
        for xyz, s, rgb in self.points:
            tx, ty, tz = transform(xyz, m)
            u, v = view_to_pixels(tx, ty, box)
            r = marker_radius(s, dpi)
            discs += [(tz[k], (u[k], v[k], r, rgb)) for k in range(len(xyz))]
        # far to near: mplot3d's depth is larger farther away
        return ([segs[k][1] for k in np.argsort([-d for d, _ in segs],
                                                kind="stable")],
                [discs[k][1] for k in np.argsort([-d for d, _ in discs],
                                                 kind="stable")])

    def draw(self, img: np.ndarray, box, dpi: float) -> None:
        """Paint onto `img` [H, W, 3] uint8 in the view square `box`, the
        title centred above it (its top row TITLE_ABOVE px higher)."""
        segs, discs = self.layout(box, dpi)
        for u0, v0, u1, v1, rgb in segs:
            paint_line(img, u0, v0, u1, v1, rgb)
        # a run of one radius and colour paints the same in any order
        for (r, rgb), run in itertools.groupby(discs, key=lambda d: d[2:]):
            u, v = np.array([d[:2] for d in run]).T
            img[disc_cover(u, v, r, *img.shape[:2])] = rgb
        if self.title:
            left, top, side = box
            paint_text(img, self.title, left + side / 2, top - TITLE_ABOVE)


# the 5x7 glyphs, one a line: the character, then its seven rows
_FONT = """
0 .###. #...# #..## #.#.# ##..# #...# .###.
1 ..#.. .##.. ..#.. ..#.. ..#.. ..#.. .###.
2 .###. #...# ....# ...#. ..#.. .#... #####
3 ##### ...#. ..#.. ...#. ....# #...# .###.
4 ...#. ..##. .#.#. #..#. ##### ...#. ...#.
5 ##### #.... ####. ....# ....# #...# .###.
6 ..##. .#... #.... ####. #...# #...# .###.
7 ##### ....# ...#. ..#.. .#... .#... .#...
8 .###. #...# #...# .###. #...# #...# .###.
9 .###. #...# #...# .#### ....# ...#. .##..
t .#... .#... ###.. .#... .#... .#..# ..##.
= ..... ..... ##### ..... ##### ..... .....
"""
_GLYPHS = {line[0]: np.array([[c == "#" for c in row]
                              for row in line.split()[1:]])
           for line in _FONT.strip().splitlines()}


def paint_text(img: np.ndarray, text: str, center_x: float,
               top: float) -> None:
    """`text` in black in the 5x7 font, 1 px between glyphs, centred on
    `center_x` with its top row at `top`."""
    width = 6 * len(text) - 1
    x = int(round(center_x - width / 2))
    y = int(round(top))
    for ch in text:
        rows, cols = np.nonzero(_GLYPHS[ch])
        rows, cols = rows + y, cols + x
        ok = (rows >= 0) & (rows < img.shape[0]) & (cols >= 0) & \
            (cols < img.shape[1])
        img[rows[ok], cols[ok]] = 0
        x += 6
