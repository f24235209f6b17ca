"""Occupancy-map file I/O — the port's own copy of
``tpu_slam/utils/map_io.py``: the `map_server` companion of the
reference's rviz/`nav_msgs::OccupancyGrid` publishing path.

The reference never saves maps itself (rviz renders the live topic;
`lesson6/src/karto_slam.cc:507-581` republishes the grid every 5 s), but
every ROS user of it persists maps with `map_saver`, which writes the
standard PGM + YAML pair. This module writes/reads that exact format so
maps produced here drop into the existing ecosystem:

  * PGM (P5, maxval 255): 254 = free, 0 = occupied, 205 = unknown —
    map_saver's trinary palette;
  * YAML: image / resolution / origin / negate / occupied_thresh /
    free_thresh.

Input maps are int8 in nav_msgs convention (-1 unknown, 0 free, 100
occupied) as produced by `ops.gridmap.logodds_to_ros`,
`models.karto.occupancy.karto_map`, and `models.gmapping` (the numpy
arrays their ``to_ros_map`` and ``karto_map`` return). Row 0 of the
array is the map's SOUTH edge (grid y=0), which PGM stores last — the same
vertical flip map_saver applies.
"""

from __future__ import annotations

import os

import numpy as np

from tpu_slam_torch.config import GridConfig

FREE_PGM = 254
OCC_PGM = 0
UNKNOWN_PGM = 205


def to_trinary_pgm(ros_map: np.ndarray) -> np.ndarray:
    """int8 nav_msgs map (-1/0..100) → uint8 PGM pixel values."""
    m = np.asarray(ros_map)
    out = np.full(m.shape, UNKNOWN_PGM, np.uint8)
    out[m == 0] = FREE_PGM
    out[m >= 65] = OCC_PGM  # map_saver occupied_thresh 0.65
    return out


def from_trinary_pgm(pix: np.ndarray) -> np.ndarray:
    """uint8 PGM pixels → int8 nav_msgs map."""
    out = np.full(pix.shape, -1, np.int8)
    out[pix >= 250] = 0
    out[pix <= 50] = 100
    return out


def save_map(
    path_base: str, ros_map: np.ndarray, grid: GridConfig
) -> tuple[str, str]:
    """Write `<base>.pgm` + `<base>.yaml` (map_saver format). Returns the
    two paths. ``ros_map`` is (H, W) int8 with row 0 at the map's south
    edge (origin corner)."""
    pgm_path = path_base + ".pgm"
    yaml_path = path_base + ".yaml"
    pix = to_trinary_pgm(ros_map)[::-1]  # PGM row 0 = north edge
    h, w = pix.shape
    with open(pgm_path, "wb") as f:
        f.write(b"P5\n# tpu_slam map\n%d %d\n255\n" % (w, h))
        f.write(pix.tobytes())
    with open(yaml_path, "w") as f:
        f.write(
            "image: {img}\n"
            "resolution: {res}\n"
            "origin: [{ox}, {oy}, 0.0]\n"
            "negate: 0\n"
            "occupied_thresh: 0.65\n"
            "free_thresh: 0.196\n".format(
                img=os.path.basename(pgm_path),
                res=grid.resolution,
                ox=grid.origin_x,
                oy=grid.origin_y,
            )
        )
    return pgm_path, yaml_path


def _read_map_yaml(path: str) -> dict:
    """map_server's YAML: flat ``key: value`` lines, ``origin`` a flow
    list of three numbers. Read without PyYAML, which the port does not
    need: ``image`` as a string, ``origin`` as a list of floats, every
    other value as a float where it is one."""
    meta = {}
    with open(path) as f:
        for line in f:
            key, sep, value = line.split("#", 1)[0].partition(":")
            if not sep:
                continue
            value = value.strip().strip("'\"")
            if value.startswith("["):
                meta[key.strip()] = [float(v) for v in
                                     value.strip("[]").split(",")]
                continue
            try:
                meta[key.strip()] = float(value)
            except ValueError:
                meta[key.strip()] = value
    return meta


def load_map(yaml_path: str) -> tuple[np.ndarray, GridConfig]:
    """Read a map_server YAML + PGM pair → (int8 nav_msgs map, GridConfig)."""
    meta = _read_map_yaml(yaml_path)
    img = str(meta["image"])
    if not os.path.isabs(img):
        img = os.path.join(os.path.dirname(os.path.abspath(yaml_path)), img)
    pix = _read_pgm(img)
    ros_map = from_trinary_pgm(pix[::-1])  # back to south-edge-first rows
    h, w = ros_map.shape
    ox, oy = float(meta["origin"][0]), float(meta["origin"][1])
    grid = GridConfig(
        resolution=float(meta["resolution"]),
        size_x=w, size_y=h, origin_x=ox, origin_y=oy,
    )
    return ros_map, grid


def _read_pgm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # parse P5 header: magic, width, height, maxval with #-comments
    tokens = []
    i = 0
    while len(tokens) < 4:
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i] != 0x0A:
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    if tokens[0] != b"P5":
        raise ValueError(f"not a binary PGM: {path}")
    w, h = int(tokens[1]), int(tokens[2])
    i += 1  # single whitespace after maxval
    return np.frombuffer(data[i : i + w * h], np.uint8).reshape(h, w)


# --- pose-graph visualization ------------------------------------------------
# The reference publishes the pose graph as rviz MarkerArrays for debugging
# bad closures (karto_slam.cc:603-682 publishGraphVisualization;
# g2o_solver.cc:150-260 separates loop edges). Without rviz, the equivalent
# artifact is a color overlay of nodes + typed edges on the occupancy map,
# written as a dependency-free PNG.

GRAPH_COLORS = {
    "sequential": (70, 130, 255),  # consecutive-scan odometry edges
    "chain": (40, 170, 90),  # running/near-chain link edges
    "loop": (230, 40, 40),  # loop-closure edges (drawn last, on top)
    "node": (25, 60, 160),
}


def save_png(path: str, rgb: np.ndarray) -> str:
    """Write (H, W, 3) uint8 (row 0 = TOP of the image) as a PNG.

    Minimal encoder (IHDR + zlib IDAT + IEND) — no imaging dependency."""
    import struct
    import zlib

    rgb = np.ascontiguousarray(rgb, np.uint8)
    h, w, _ = rgb.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = (
        np.concatenate(
            [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1
        )  # filter byte 0 per scanline
        .tobytes()
    )
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))
    return path


def _world_to_cell(grid: GridConfig, xy: np.ndarray) -> np.ndarray:
    """(…, 2) world coords → (…, 2) float (col, row) grid coords."""
    return (
        np.asarray(xy, np.float64)
        - np.array([grid.origin_x, grid.origin_y])
    ) / grid.resolution


def render_graph_overlay(
    ros_map: np.ndarray,
    grid: GridConfig,
    poses: np.ndarray,
    edges,
) -> np.ndarray:
    """RGB (H, W, 3) render of the pose graph over the occupancy map.

    ``ros_map``: (H, W) int8 nav_msgs map, row 0 = south edge.
    ``poses``: (N, 3) world scan poses (the graph nodes).
    ``edges``: iterable of (i, j, kind) with kind ∈ GRAPH_COLORS.
    Output keeps row 0 at the south edge (flip before writing image files).
    """
    rgb = np.repeat(to_trinary_pgm(ros_map)[:, :, None], 3, axis=2)
    h, w = rgb.shape[:2]
    pts = _world_to_cell(grid, np.asarray(poses)[:, :2])

    def draw(cells: np.ndarray, color) -> None:
        c = np.round(cells).astype(np.int64)
        keep = (c[:, 0] >= 0) & (c[:, 0] < w) & (c[:, 1] >= 0) & (c[:, 1] < h)
        c = c[keep]
        rgb[c[:, 1], c[:, 0]] = color

    # edges by kind, loop closures last so they stay visible on top
    order = {"sequential": 0, "chain": 1, "loop": 2}
    for i, j, kind in sorted(edges, key=lambda e: order.get(e[2], 1)):
        a, b = pts[i], pts[j]
        n = int(np.ceil(np.abs(b - a).max() * 2)) + 2
        t = np.linspace(0.0, 1.0, n)[:, None]
        draw(a + t * (b - a), GRAPH_COLORS.get(kind, GRAPH_COLORS["chain"]))
    # nodes as 3×3 squares
    off = np.array(
        [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)], np.float64
    )
    draw((pts[:, None, :] + off[None, :, :]).reshape(-1, 2),
         GRAPH_COLORS["node"])
    return rgb


def save_graph_png(
    path: str,
    ros_map: np.ndarray,
    grid: GridConfig,
    poses: np.ndarray,
    edges,
) -> str:
    """Render the pose graph over the map and write it as `path` (PNG).

    See render_graph_overlay for argument conventions."""
    return save_png(path, render_graph_overlay(ros_map, grid, poses, edges)[::-1])
