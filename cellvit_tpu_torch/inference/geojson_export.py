"""QuPath GeoJSON export (copy of `cellvit_tpu/inference/geojson_export.py`;
reference `utils/template_geojson.py:9-52` and `cell_detection.py:538-598`,
COLOR_DICT/TYPE_NUCLEI_DICT :76-90)."""

from __future__ import annotations

from typing import Dict, List

COLOR_DICT = {
    1: [255, 0, 0],
    2: [34, 221, 77],
    3: [35, 92, 236],
    4: [254, 255, 0],
    5: [255, 159, 68],
}

TYPE_NUCLEI_DICT = {
    1: "Neoplastic",
    2: "Inflammatory",
    3: "Connective",
    4: "Dead",
    5: "Epithelial",
}


def get_template_point() -> Dict:
    return {
        "type": "Feature",
        "id": "TODO",
        "geometry": {"type": "MultiPoint", "coordinates": [[]]},
        "properties": {
            "objectType": "annotation",
            "classification": {"name": "TODO", "color": []},
        },
    }


def get_template_segmentation() -> Dict:
    return {
        "type": "Feature",
        "id": "TODO",
        "geometry": {"type": "MultiPolygon", "coordinates": [[]]},
        "properties": {
            "objectType": "annotation",
            "classification": {"name": "TODO", "color": []},
        },
    }


def convert_geojson(
    cell_list: List[dict],
    polygons: bool = False,
    type_names: Dict[int, str] = None,
) -> List[Dict]:
    """Cells → one geojson feature per detected type (MultiPolygon when
    `polygons`, MultiPoint otherwise)."""
    type_names = type_names or TYPE_NUCLEI_DICT
    types = sorted({cell["type"] for cell in cell_list})
    out = []
    for cell_type in types:
        cells = [c for c in cell_list if c["type"] == cell_type]
        if polygons:
            # close every LinearRing (first == last) — RFC 7946 and the
            # reference's convert_geojson (cell_detection.py) both do
            coords = []
            for c in cells:
                ring = [list(map(float, pt)) for pt in c["contour"]]
                if ring and ring[0] != ring[-1]:
                    ring.append(ring[0])
                coords.append([ring])
            obj = get_template_segmentation()
        else:
            coords = [list(map(float, c["centroid"])) for c in cells]
            obj = get_template_point()
        obj["geometry"]["coordinates"] = coords
        obj["id"] = str(cell_type)
        obj["properties"]["classification"]["name"] = type_names.get(
            cell_type, str(cell_type)
        )
        obj["properties"]["classification"]["color"] = COLOR_DICT.get(cell_type, [0, 0, 0])
        out.append(obj)
    return out
