"""Camelyon16 annotation geometry: the port's own copy of
``ssl_cr_histo_tpu/data/annotations.py`` (reference util.py:180-347):
polygons with point-in-polygon tests, the internal JSON format, and the
official-XML -> JSON converter.

The JAX package tests points with ``matplotlib.path.Path``; this copy has
its own vectorised even-odd (crossing-number) test in numpy, so that it
runs where matplotlib is not installed.  It is matplotlib's algorithm
(``_path.h::point_in_path_impl``) written over arrays: the polygon is
closed implicitly, a ray runs from the point towards +x, and an edge from
(x0, y0) to (x1, y1) is crossed when ``(y0 >= ty) != (y1 >= ty)`` and
``((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == (y1 >= ty)``, in
float64.  Off the boundary both answer the same by construction.

On a vertex or an edge the answer is whatever those half-open comparisons
give, which is not symmetric: on the axis-aligned square (0, 0)-(100, 100),
the bottom edge y = 0, its corners included, is outside, and the rest of
the boundary (x = 0, x = 100, y = 100 and the corners (0, 100) and
(100, 100)) is inside.  Since the comparisons are matplotlib's, done in
the same order and precision, the answers there are matplotlib's too (with
``radius=0``, the default of ``contains_point(s)``); the tests hold the two
to each other on points off the edges and on the integer points of such a
square, where the arithmetic is exact.
"""

from __future__ import annotations

import json
import xml.etree.ElementTree as ET
from typing import List, Sequence, Tuple

import numpy as np


def points_in_polygon(vertices: np.ndarray, points: np.ndarray) -> np.ndarray:
    """(M,) bool: which of the (M, 2) ``points`` (x, y) lie inside the
    closed polygon of (N, 2) ``vertices``, by the crossing rule of the
    module docstring.  Points outside the polygon's bounding box cannot
    cross an odd number of edges, so only those inside it are tested.
    Non-finite points are outside."""
    v = np.asarray(vertices, np.float64)
    pts = np.asarray(points, np.float64).reshape(-1, 2)
    inside = np.zeros(len(pts), bool)
    if len(v) < 3 or len(pts) == 0:
        return inside
    lo, hi = v.min(0), v.max(0)
    cand = np.flatnonzero(np.all((pts >= lo) & (pts <= hi), axis=1))
    if len(cand) == 0:
        return inside
    tx, ty = pts[cand, 0], pts[cand, 1]
    flag = np.zeros(len(cand), bool)
    x0, y0 = v[-1]
    yflag0 = y0 >= ty
    for x1, y1 in v:
        yflag1 = y1 >= ty
        cross = (yflag0 != yflag1) & (((y1 - ty) * (x0 - x1) >= (x1 - tx) * (y0 - y1)) == yflag1)
        flag ^= cross
        x0, y0, yflag0 = x1, y1, yflag1
    inside[cand] = flag
    return inside


class Polygon:
    """Named polygon as an [N, 2] vertex array (x, y)."""

    def __init__(self, name: str, vertices: np.ndarray):
        self.name = name
        self.vertices = np.asarray(vertices)

    def inside(self, coord: Tuple[float, float]) -> bool:
        return bool(points_in_polygon(self.vertices, np.asarray([coord], np.float64))[0])

    def inside_many(self, coords: np.ndarray) -> np.ndarray:
        """Vectorised point-in-polygon over an [M, 2] coord array."""
        return points_in_polygon(self.vertices, coords)


class Annotation:
    """Positive/negative polygon sets loaded from the internal JSON format
    ({'positive': [{'name', 'vertices'}], 'negative': [...]})."""

    def __init__(self):
        self.json_path = ""
        self.polygons_positive: List[Polygon] = []
        self.polygons_negative: List[Polygon] = []

    def from_json(self, json_path: str) -> "Annotation":
        self.json_path = json_path
        with open(json_path) as f:
            doc = json.load(f)
        for key, store in (("positive", self.polygons_positive), ("negative", self.polygons_negative)):
            for ann in doc.get(key, []):
                store.append(Polygon(ann["name"], np.array(ann["vertices"])))
        return self

    def _polygons(self, is_positive: bool) -> List[Polygon]:
        return self.polygons_positive if is_positive else self.polygons_negative

    def inside_polygons(self, coord, is_positive: bool) -> bool:
        return any(p.inside(coord) for p in self._polygons(is_positive))

    def inside_polygons_many(self, coords: np.ndarray, is_positive: bool) -> np.ndarray:
        """Vectorised membership of [M, 2] coords in any polygon of the set."""
        out = np.zeros(len(coords), bool)
        for p in self._polygons(is_positive):
            out |= p.inside_many(coords)
        return out

    def polygon_vertices(self, is_positive: bool):
        return [p.vertices for p in self._polygons(is_positive)]


def _annotation_doc(positive, negative) -> dict:
    return {key: [{"name": name, "vertices": verts} for name, verts in group]
            for key, group in (("positive", positive), ("negative", negative))}


def _write_json(doc: dict, outjson: str) -> None:
    with open(outjson, "w") as f:
        json.dump(doc, f, indent=1)


def camelyon16xml2json(inxml: str, outjson: str) -> None:
    """Convert official Camelyon16 ASAP XML to the internal JSON format
    (groups Tumor/_0/_1 -> positive, _2 -> negative; reference
    util.py:283-330)."""
    root = ET.parse(inxml).getroot()

    def group(name: str):
        return root.findall(f'./Annotations/Annotation[@PartOfGroup="{name}"]')

    def entries(annotations):
        out = []
        for i, a in enumerate(annotations):
            coords = a.findall("./Coordinates/Coordinate")
            xs = [float(c.get("X")) for c in coords]
            ys = [float(c.get("Y")) for c in coords]
            out.append((a.attrib.get("Name", f"Annotation {i}"),
                        np.round(np.stack([xs, ys], axis=1)).astype(int).tolist()))
        return out

    positive = group("Tumor") + group("_0") + group("_1")
    _write_json(_annotation_doc(entries(positive), entries(group("_2"))), outjson)


def vertices2json(outjson: str, positive_vertices: Sequence = (), negative_vertices: Sequence = ()) -> None:
    """Write raw vertex arrays into the internal JSON format (reference
    util.py:332-347)."""
    named = lambda vs: [(f"Annotation {i}", np.asarray(v).astype(int).tolist()) for i, v in enumerate(vs)]
    _write_json(_annotation_doc(named(positive_vertices), named(negative_vertices)), outjson)
