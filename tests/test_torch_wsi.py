"""The port's host WSI pipeline against the JAX package's on the CPU: the PNG
reader against PIL, `yaml_lite` against PyYAML, the contour tracer and the
polygon fill against cv2, dedup and GeoJSON against the JAX modules, and
`process_wsi` and the CLI end to end against JAX's `process_wsi` on one
slide preprocessed by the JAX pipeline and the same weights."""

import io
import json
import math
import struct
import zlib
from pathlib import Path

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from cellvit_tpu.eval.pq_delta import make_gt_tile, model_like_outputs
from cellvit_tpu.inference import dedup as jax_dd
from cellvit_tpu.inference import geojson_export as jax_geojson
from cellvit_tpu.models import CellViT as JaxCellViT
from cellvit_tpu.models.checkpoint_io import convert_state_dict
from cellvit_tpu.ops.hv_postproc import instance_map_batch as jax_instance_map_batch
from cellvit_tpu.ops.instance_stats import contours_from_instance_map as jax_contours
from cellvit_tpu.ops.instance_stats import instance_stats_batch as jax_stats
from cellvit_tpu.ops.instance_stats import relabel_consecutive as jax_relabel
from cellvit_tpu_torch.data import png
from cellvit_tpu_torch.data.wsi import WSI, PatchedWSIInference
from cellvit_tpu_torch.inference import dedup, geojson_export
from cellvit_tpu_torch.models.cellvit import CellViT
from cellvit_tpu_torch.ops.contours import fill_poly, trace_outer_border
from cellvit_tpu_torch.ops.instance_stats import contours_from_instance_map, instance_stats_batch
from cellvit_tpu_torch.synthetic import set_probe_weights
from cellvit_tpu_torch.utils import yaml_lite
from cellvit_tpu_torch.utils.logger import Logger
from cellvit_tpu_torch.utils.tools import Timer, cropping_center, device_trace

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)

KW = dict(num_nuclei_classes=6, num_tissue_classes=19, embed_dim=64, depth=4,
          num_heads=2, extract_layers=(1, 2, 3, 4))
RUN_CONF = {"data": {"num_nuclei_classes": 6, "num_tissue_classes": 19},
            "transformations": {"normalize": {"mean": [0.6, 0.5, 0.4],
                                              "std": [0.3, 0.25, 0.2]}}}
#: relative L2 of the cells' token means against JAX's
#: (`test_torch_inference.TOKENS_L2`, the tiny CellViT's bf16 token bound;
#: these runs are fp32, whose tokens agree within 2e-4 absolute)
TOKENS_L2 = 1e-2
HYPOTHESIS = settings(max_examples=300, deadline=None, derandomize=True, database=None)


# ------------------------------------------------------------------ PNG


def _pil_png(arr: np.ndarray, mode: str, level: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr, mode).save(buf, format="PNG", compress_level=level)
    return buf.getvalue()


def _patch_like(rng, shape, channels) -> np.ndarray:
    """Half noise, half smooth gradients: PIL's adaptive filtering then
    picks every filter type across the rows."""
    noise = rng.integers(0, 256, (*shape, channels), dtype=np.uint8)
    smooth = (np.cumsum(rng.integers(0, 3, (*shape, channels)), axis=1)
              + np.arange(shape[0])[:, None, None]) % 256
    pick = rng.random((shape[0], 1, 1)) < 0.5
    out = np.where(pick, noise, smooth.astype(np.uint8))
    return out[..., 0] if channels == 1 else out


@pytest.mark.parametrize("level", [0, 1, 9])
@pytest.mark.parametrize("shape", [(1, 1), (3, 257), (256, 256), (1024, 1024)])
@pytest.mark.parametrize("mode,channels", [("L", 1), ("RGB", 3), ("RGBA", 4)])
def test_png_decode_matches_pil(mode, channels, shape, level):
    rng = np.random.default_rng(shape[0] * 7 + level)
    arr = _patch_like(rng, shape, channels)
    data = _pil_png(arr, mode, level)
    want = np.array(Image.open(io.BytesIO(data)))
    got = png.decode_png(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_pil_patches_use_several_filter_types():
    """The 1024² case above exercises Sub, Up and Paeth rows as PIL writes
    patches (`preprocessing/patch_extraction.py:495`)."""
    arr = _patch_like(np.random.default_rng(7 * 1024 + 6), (1024, 1024), 3)
    _, raw = png.read_png(_pil_png(arr, "RGB", 6))
    kinds = np.frombuffer(raw, np.uint8).reshape(1024, -1)[:, 0]
    assert len(set(kinds.tolist())) >= 3, np.bincount(kinds)


@pytest.mark.parametrize("filters", [0, 1, 2, 3, 4, "mixed"])
def test_png_encode_round_trips(filters):
    rng = np.random.default_rng(3)
    for shape in ((1, 1, 3), (37, 41, 3), (64, 64, 4), (20, 9, 1)):
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
        kinds = rng.integers(0, 5, shape[0]) if filters == "mixed" else filters
        data = png.encode_png(arr, kinds)
        _, raw = png.read_png(data)
        written = np.frombuffer(raw, np.uint8).reshape(shape[0], -1)[:, 0]
        np.testing.assert_array_equal(written, np.broadcast_to(kinds, shape[:1]))
        want = arr[..., 0] if shape[2] == 1 else arr
        np.testing.assert_array_equal(np.array(Image.open(io.BytesIO(data))), want)
        np.testing.assert_array_equal(png.decode_png(data), want)


def _with_header(data: bytes, depth=None, ctype=None, interlace=None) -> bytes:
    """A copy of a PNG whose IHDR fields are replaced (CRC recomputed)."""
    w, h, d, c, comp, filt, il = struct.unpack(">IIBBBBB", data[16:29])
    body = struct.pack(">IIBBBBB", w, h, depth or d, c if ctype is None else ctype, comp, filt,
                       il if interlace is None else interlace)
    crc = struct.pack(">I", zlib.crc32(b"IHDR" + body))
    return data[:16] + body + crc + data[33:]


def test_png_rejects_bad_files():
    rng = np.random.default_rng(0)
    good = png.encode_png(rng.integers(0, 256, (8, 8, 3), dtype=np.uint8), 1)
    bad_crc = bytearray(good)
    bad_crc[-20] ^= 1  # inside the IDAT chunk's data
    with pytest.raises(png.PNGError, match="CRC"):
        png.decode_png(bytes(bad_crc))
    with pytest.raises(png.PNGError, match="signature"):
        png.decode_png(b"GIF89a" + good[6:])
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 65535, (8, 8), dtype=np.uint16)).save(buf, format="PNG")
    assert struct.unpack(">B", buf.getvalue()[24:25])[0] == 16
    with pytest.raises(png.PNGError, match="16-bit"):
        png.decode_png(buf.getvalue())
    with pytest.raises(png.PNGError, match="interlaced"):
        png.decode_png(_with_header(good, interlace=1))
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 4, (8, 8), dtype=np.uint8), "L").convert("P").save(
        buf, format="PNG")
    with pytest.raises(png.PNGError, match="palette"):
        png.decode_png(buf.getvalue())
    rows = np.zeros((2, 1 + 2 * 3), np.uint8)
    rows[1, 0] = 5  # no such filter type
    data = (png.SIGNATURE + png._chunk(b"IHDR", struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(rows.tobytes())) + png._chunk(b"IEND", b""))
    with pytest.raises(png.PNGError, match="filter type"):
        png.decode_png(data)


def test_decode_png_routes_by_its_argument(monkeypatch):
    """`native` picks the routine; neither is tried as a fallback of the
    other (the compiled one is tested on the card, `test_torch_cuda.py`)."""
    calls = []
    monkeypatch.setattr(png, "unfilter_native",
                        lambda raw, shape: calls.append(shape) or png.unfilter_plain(raw, shape))
    arr = np.random.default_rng(1).integers(0, 256, (5, 6, 3), dtype=np.uint8)
    data = png.encode_png(arr, [0, 1, 2, 3, 4])
    np.testing.assert_array_equal(png.decode_png(data, native=False), arr)
    assert calls == []
    np.testing.assert_array_equal(png.decode_png(data, native=True), arr)
    assert calls == [(5, 6, 3)]


# ------------------------------------------------------------------ YAML


def _same(a, b) -> bool:
    """Equal values and types, NaN equal to NaN."""
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    return a == b


YAML_DOCS = [
    {"orig_n_tiles_cols": 9, "base_magnification": 40.0, "downsampling": 1,
     "label_map": {"background": 0, "tumor": 1}, "magnification": None, "base_mpp": 0.25,
     "stain_normalization": False, "patch_overlap": 64},
    {"tiny": 1e-05, "big": 1.5e300, "neg": -2.5e-8, "inf": math.inf, "ninf": -math.inf,
     "nan": math.nan, "zero": 0.0, "int": -7, "t": True, "n": None},
    {"quote": "it's", "yes": "yes", "num": "123", "float": "1.5", "empty": "", "null": "null",
     "colon": "a: b", "hash": "a #b", "dash": "-x", "lead": " x", "path": "/a/b:c", "q": "'q'"},
    {"lists": [1, 2.5, "a b", None, True, [], {}], "nested": {"a": {"b": [{"c": 1, "d": [1, 2]},
                                                                        {"e": "x"}]}},
     "empty_list": [], "empty_map": {}, "deep": [[1, [2, 3]], {"k": []}], 3: "int key"},
    [1, {"a": 2, "b": [3]}, "x"],
]


@pytest.mark.parametrize("doc", range(len(YAML_DOCS)))
def test_yaml_lite_reads_safe_dump(doc):
    text = yaml.safe_dump(YAML_DOCS[doc])
    assert _same(yaml_lite.load(text), yaml.safe_load(text)), text


@pytest.mark.parametrize("doc", range(len(YAML_DOCS)))
def test_yaml_lite_dump_round_trips(doc):
    text = yaml_lite.dump(YAML_DOCS[doc])
    want = yaml.safe_load(yaml.safe_dump(YAML_DOCS[doc]))
    assert _same(yaml.safe_load(text), want), text
    assert _same(yaml_lite.load(text), want), text


@pytest.mark.parametrize("text", [
    'a: "double"', "a: &anchor 1", "a: *anchor", "a: !!str 1", "a: 0x1f", "a: 012",
    "a: 2020-01-02", "a: 1:30", "a:\n  b\n  c", "---\na: 1\n---\nb: 2", "a: [1, [2]]",
    "a: 'open", "a: 1\na: 2", "a: |\n  block",
])
def test_yaml_lite_raises_outside_its_subset(text):
    with pytest.raises(yaml_lite.YAMLError):
        yaml_lite.load(text)


# ------------------------------------------------------- contours and fill


def _cv2_first_contour(mask: np.ndarray) -> np.ndarray:
    contours, _ = cv2.findContours(mask.astype(np.uint8), cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE)
    return contours[0].reshape(-1, 2).astype(np.int32)


def _assert_same_contours(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == np.int32
        np.testing.assert_array_equal(got[k], want[k], err_msg=f"instance {k}")


def _jax_postprocessed(seed: int, size: int, n_cells: int):
    """An instance map of the JAX postprocessing (its CPU path) of a
    model-like pq_delta tile, relabelled 1..N, and its device statistics."""
    rng = np.random.default_rng(seed)
    inst, _ = make_gt_tile(rng, size, n_cells)
    np_prob, hv = model_like_outputs(rng, inst)
    pred = jax_instance_map_batch(np_prob[None], hv[None], use_pallas=False)
    pred = jax.vmap(lambda m: jax_relabel(m, size * size // 2 + 2))(pred)
    types = np.ones_like(np.asarray(pred))
    stats = jax_stats(pred, types, max_instances=1024)
    return np.asarray(pred)[0], {k: np.asarray(v)[0] for k, v in stats.items()}


@pytest.mark.parametrize("seed,size,n_cells", [(0, 256, 28), (1, 256, 40), (2, 256, 28),
                                               (3, 1024, 450)])
def test_contours_match_cv2_on_postprocessed_tiles(seed, size, n_cells):
    inst, stats = _jax_postprocessed(seed, size, n_cells)
    assert inst.max() >= (300 if size == 1024 else 10)  # the 1024² tile: ≈450
    want = jax_contours(inst)
    _assert_same_contours(contours_from_instance_map(inst), want)
    _assert_same_contours(contours_from_instance_map(inst, bboxes=stats["bbox"]), want)
    ids = np.unique(inst)[1::2]
    _assert_same_contours(contours_from_instance_map(inst, ids, bboxes=stats["bbox"]),
                          jax_contours(inst, ids))
    for contour in want.values():  # the fill of each, as dedup rasterizes them
        origin = contour.min(0)
        shape = tuple((contour.max(0) - origin + 1)[::-1])
        np.testing.assert_array_equal(dedup._poly_mask(contour, origin, shape),
                                      jax_dd._poly_mask(contour, origin, shape))


def _shapes():
    """Masks cv2 treats specially: two parts (the lower one is found last),
    a part with a hole, a hole with an island, 1-px lines, single pixels,
    diagonal-only links, and parts on the crop's edges."""
    m = {}
    two = np.zeros((9, 9), bool)
    two[0:3, 0:3] = two[5:9, 2:7] = True
    m["two parts"] = two
    ring = np.zeros((9, 9), bool)
    ring[1:8, 1:8] = True
    ring[3:6, 3:6] = False
    m["hole"] = ring
    island = ring.copy()
    island[4, 4] = True
    m["hole with island"] = island
    m["row line"] = np.ones((1, 7), bool)
    m["column line"] = np.ones((6, 1), bool)
    m["pixel"] = np.ones((1, 1), bool)
    m["diagonal"] = np.eye(6, dtype=bool)
    m["anti-diagonal"] = np.eye(6, dtype=bool)[::-1]
    chain = np.zeros((6, 6), bool)
    chain[0:2, 0:2] = chain[2:4, 2:4] = chain[4:6, 4:6] = True  # touching at corners only
    m["diagonal links"] = chain
    plus = np.zeros((5, 5), bool)
    plus[2, :] = plus[:, 2] = True
    m["plus"] = plus
    frame = np.ones((6, 8), bool)
    frame[1:-1, 1:-1] = False
    m["frame"] = frame
    loose = np.zeros((7, 7), bool)
    loose[0, 6] = loose[6, 0] = loose[3, 3] = True
    m["three pixels"] = loose
    return m


@pytest.mark.parametrize("name", list(_shapes()))
def test_trace_matches_cv2_on_special_shapes(name):
    mask = _shapes()[name]
    np.testing.assert_array_equal(trace_outer_border(mask), _cv2_first_contour(mask))
    inst = np.zeros((mask.shape[0] + 4, mask.shape[1] + 6), np.int32)
    inst[2:-2, 3:-3] = np.where(mask, 5, 0)
    _assert_same_contours(contours_from_instance_map(inst), jax_contours(inst))


@HYPOTHESIS
@given(st.integers(1, 12), st.integers(1, 12), st.integers(0, 2**32 - 1), st.integers(1, 4))
def test_contours_match_cv2_on_drawn_maps(h, w, seed, labels):
    rng = np.random.default_rng(seed)
    inst = rng.integers(0, labels + 1, (h, w)).astype(np.int32)
    want = jax_contours(inst)
    _assert_same_contours(contours_from_instance_map(inst), want)
    # the port's statistics equal JAX's (`test_torch_inference.py`) and need no
    # compilation a shape
    stats = instance_stats_batch(torch.from_numpy(inst[None]), torch.ones((1, h, w), dtype=torch.int32),
                                 max_instances=labels)
    _assert_same_contours(contours_from_instance_map(inst, bboxes=stats["bbox"][0].numpy()), want)
    for mask_id in range(1, labels + 1):
        mask = inst == mask_id
        if mask.any():
            np.testing.assert_array_equal(trace_outer_border(mask), _cv2_first_contour(mask))


def _cv2_fill(pts, shape) -> np.ndarray:
    canvas = np.zeros(shape, np.uint8)
    cv2.fillPoly(canvas, [np.asarray(pts, np.int32)], 1)
    return canvas


def test_fill_matches_cv2_on_self_touching_contours():
    """Contours that pass through one pixel twice (parts linked at a corner,
    a plus, a frame) and random self-intersecting polygons."""
    for mask in _shapes().values():
        pts = trace_outer_border(mask)
        np.testing.assert_array_equal(fill_poly(np.zeros(mask.shape, np.uint8), pts),
                                      _cv2_fill(pts, mask.shape))
    rng = np.random.default_rng(0)
    for _ in range(400):
        n = int(rng.integers(1, 10))
        h, w = (int(v) for v in rng.integers(2, 60, 2))
        pts = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
        np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), pts),
                                      _cv2_fill(pts, (h, w)), err_msg=str(pts.tolist()))


@HYPOTHESIS
@given(st.integers(1, 14), st.integers(1, 14), st.integers(0, 2**32 - 1))
def test_fill_matches_cv2_on_drawn_contours(h, w, seed):
    mask = np.random.default_rng(seed).random((h, w)) < 0.6
    if not mask.any():
        return
    pts = trace_outer_border(mask)
    np.testing.assert_array_equal(fill_poly(np.zeros((h, w), np.uint8), pts), _cv2_fill(pts, (h, w)))


def test_polygon_areas_match_jax():
    inst, _ = _jax_postprocessed(4, 256, 40)
    contours = list(jax_contours(inst).values())
    rng = np.random.default_rng(0)
    for c in contours:
        assert dedup.polygon_area(c) == jax_dd.polygon_area(c)
    for _ in range(200):
        i, j = rng.integers(0, len(contours), 2)
        a, b = contours[i], contours[j] + rng.integers(-6, 7, 2)
        assert dedup.intersection_area(a, b) == jax_dd.intersection_area(a, b)


def test_geojson_matches_jax():
    cells = [{"type": int(t), "centroid": [float(x), float(y)],
              "contour": [[int(x), int(y)], [int(x) + 3, int(y)], [int(x) + 3, int(y) + 2]]}
             for t, x, y in np.random.default_rng(0).integers(1, 6, (30, 3)) * [1, 37, 41]]
    for polygons in (True, False):
        assert (geojson_export.convert_geojson(cells, polygons)
                == jax_geojson.convert_geojson(cells, polygons))


# ------------------------------------------------------------------ utils


def test_timer_trace_logger_and_crop(tmp_path):
    timer = Timer()
    with timer.lap("a"):
        pass
    timer.start("b")
    timer.stop("b")
    with timer.lap("a"):
        pass
    assert set(timer.summary()) == {"a", "b"}
    with device_trace(str(tmp_path / "trace")):
        torch.ones(3).sum()
    assert json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    with device_trace(None):
        pass
    logger = Logger(level="INFO", log_dir=tmp_path / "logs").create_logger()
    logger.info("hello")
    assert "hello" in (tmp_path / "logs" / "logs.log").read_text()
    x = np.arange(2 * 6 * 8).reshape(2, 6, 8)
    np.testing.assert_array_equal(cropping_center(x[0], (2, 4)), x[0, 2:4, 2:6])
    np.testing.assert_array_equal(cropping_center(x, (2, 4), batch=True), x[:, 2:4, 2:6])


# ------------------------------------------------------------- end to end


def _synth_slide(rng, w: int, h: int, n_cells: int) -> np.ndarray:
    """An H&E-like slide: white margins, pink tissue, dark round nuclei
    (`tests/test_wsi_pipeline.py:synth_slide` at another size)."""
    img = np.full((h, w, 3), 255, np.uint8)
    img[:, w // 8: w - w // 8] = (210, 160, 200)
    yy, xx = np.mgrid[0:h, 0:w]
    for _ in range(n_cells):
        cy = int(rng.integers(20, h - 20))
        cx = int(rng.integers(w // 8 + 20, w - w // 8 - 20))
        r = int(rng.integers(6, 11))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = (80, 40, 120)
    return img


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    """A slide preprocessed by the JAX pipeline: 256² patches, overlap 64."""
    from cellvit_tpu.preprocessing.patch_extraction import PreProcessingConfig, PreProcessor
    from cellvit_tpu.preprocessing.wsi_reader import write_test_pyramid

    root = tmp_path_factory.mktemp("wsi")
    slide_path = root / "slide1.tiff"
    write_test_pyramid(str(slide_path), _synth_slide(np.random.default_rng(7), 800, 440, 40),
                       tile_size=128, n_levels=3, mpp=0.25, magnification=40)
    PreProcessor(PreProcessingConfig(
        wsi_paths=str(slide_path), output_path=str(root / "pre"), patch_size=256,
        patch_overlap=25, min_intersection_ratio=0.05, processes=2, wsi_extension="tiff",
    )).sample_patches_dataset()
    return slide_path, root / "pre" / "slide1"


def _models():
    """The tiny CellViT of `test_torch_inference.py:_probe_model` (seeded
    weights plus the probe weights), and the JAX model with its weights."""
    torch.manual_seed(0)
    model = CellViT(**KW)
    set_probe_weights(model)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, JaxCellViT(encoder_type="histo", **KW), convert_state_dict(sd, False)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """The tiny CellViT of `_models` saved as a reference-format `.pth`."""
    model = _models()[0]
    norm = RUN_CONF["transformations"]["normalize"]
    path = tmp_path_factory.mktemp("ckpt") / "cellvit_tiny.pth"
    torch.save({"arch": "CellViT", "model_state_dict": model.state_dict(), "config": {
        "data.num_nuclei_classes": 6, "data.num_tissue_classes": 19, "model.embed_dim": 64,
        "model.depth": 4, "model.num_heads": 2, "model.extract_layers": [1, 2, 3, 4],
        "transformations.normalize.mean": norm["mean"],
        "transformations.normalize.std": norm["std"]}}, path)
    return path


@pytest.fixture(scope="module")
def runs(slide, ckpt):
    """`process_wsi` of JAX, of the port and of the port's CLI on the slide
    (fp32, batches of 4, with GeoJSON); the port's cell list before dedup."""
    from cellvit_tpu.data.wsi import WSI as JaxWSI
    from cellvit_tpu.inference.cell_detection import CellSegmentationInference as JaxInference
    from cellvit_tpu.models.fused import fused_forward_maps
    from cellvit_tpu.utils.logger import Logger as JaxLogger
    from cellvit_tpu_torch.cli import cell_detection as cli
    from cellvit_tpu_torch.inference import cell_detection as port_cd

    slide_path, patched = slide
    model, jm, variables = _models()
    kw = dict(patch_size=256, overlap=64, geojson=True)

    jax_inf = JaxInference.__new__(JaxInference)  # as tests/test_wsi_pipeline.py builds it
    jax_inf.logger = JaxLogger(level="WARNING").create_logger()
    jax_inf.batch_size, jax_inf.max_instances, jax_inf.mesh = 4, 512, None
    norm = RUN_CONF["transformations"]["normalize"]
    jax_inf.mean = np.asarray(norm["mean"], np.float32)
    jax_inf.std = np.asarray(norm["std"], np.float32)
    jax_inf.num_nuclei_classes, jax_inf.run_conf = 6, RUN_CONF
    jax_inf.model, jax_inf.variables = jm, variables
    jax_inf._forward_maps = jax.jit(lambda v, x: fused_forward_maps(jm, v, x, retrieve_tokens=True))
    jax_wsi = JaxWSI(name="slide1", patient="slide1", slide_path=slide_path,
                     patched_slide_path=patched)
    jax_out = jax_inf.process_wsi(jax_wsi, subdir_name="jax", **kw)

    before_dedup = []

    class Recording(dedup.CellPostProcessor):
        def __init__(self, cells, logger=None):
            before_dedup.append(list(cells))
            super().__init__(cells, logger)

    port = port_cd.CellSegmentationInference(
        model=model, run_conf=RUN_CONF, batch_size=4, max_instances_per_tile=512, device="cpu",
        logger=Logger(level="WARNING").create_logger())
    assert port.native_png is False
    wsi = WSI(name="slide1", patient="slide1", slide_path=slide_path, patched_slide_path=patched)
    port.check_wsi(wsi, magnification=40, patch_size=256, overlap=64)
    original = port_cd.dd.CellPostProcessor
    port_cd.dd.CellPostProcessor = Recording
    try:
        port_out = port.process_wsi(wsi, subdir_name="port", **kw)
    finally:
        port_cd.dd.CellPostProcessor = original

    cli.main(["--model", str(ckpt), "--device", "cpu", "--patch_size", "256", "--batch_size", "4",
              "--outdir_subdir", "cli", "--geojson", "process_wsi", "--wsi_path", str(slide_path),
              "--patched_slide_path", str(patched)])
    return jax_out, port_out, port_out.parent / "cli", before_dedup[0]


def _cells(outdir: Path) -> dict:
    return json.loads((outdir / "cells.json").read_text())


def test_wsi_reader_matches_jax(slide):
    from cellvit_tpu.data.wsi import WSI as JaxWSI
    from cellvit_tpu.data.wsi import PatchedWSIInference as JaxDataset

    slide_path, patched = slide
    assert _same(yaml_lite.load((patched / "metadata.yaml").read_text()),
                 yaml.safe_load((patched / "metadata.yaml").read_text()))
    wsi = WSI(name="slide1", patient="p", slide_path=slide_path, patched_slide_path=patched)
    jax_wsi = JaxWSI(name="slide1", patient="p", slide_path=slide_path, patched_slide_path=patched)
    assert _same(wsi.metadata, jax_wsi.metadata) and wsi.patches_list == jax_wsi.patches_list
    ds, jax_ds = PatchedWSIInference(wsi), JaxDataset(jax_wsi)
    assert len(ds) == len(jax_ds) >= 8
    imgs, meta = PatchedWSIInference.collate_batch([ds[i] for i in range(len(ds))])
    jax_imgs, jax_meta = JaxDataset.collate_batch([jax_ds[i] for i in range(len(jax_ds))])
    np.testing.assert_array_equal(imgs, jax_imgs)
    assert meta == jax_meta


def test_wsi_load_embedding(slide):
    slide_path, patched = slide
    wsi = WSI(name="slide1", patient="p", slide_path=slide_path, patched_slide_path=patched,
              embedding_name="uni")
    with pytest.raises(FileNotFoundError):
        wsi.load_embedding()
    (patched / "embeddings").mkdir(exist_ok=True)
    emb = torch.arange(12.0).reshape(3, 4)
    torch.save(emb, patched / "embeddings" / "uni.pt")
    assert torch.equal(wsi.load_embedding(), emb)


def test_process_wsi_matches_jax(runs):
    jax_out, port_out, _, before = runs
    want, got = _cells(jax_out), _cells(port_out)
    assert got["processed_patches"] == want["processed_patches"]
    assert got["wsi_metadata"] == want["wsi_metadata"] and got["type_map"] == want["type_map"]
    assert len(got["cells"]) == len(want["cells"]) > 10
    assert len(before) > len(got["cells"])  # dedup had duplicates to remove
    for key in ("contour", "bbox", "type", "cell_status", "patch_coordinates", "edge_position",
                "edge_information", "offset_global"):
        assert [c.get(key) for c in got["cells"]] == [c.get(key) for c in want["cells"]], key
    np.testing.assert_allclose([c["centroid"] for c in got["cells"]],
                               [c["centroid"] for c in want["cells"]], rtol=0, atol=1e-3)
    np.testing.assert_allclose([c["type_prob"] for c in got["cells"]],
                               [c["type_prob"] for c in want["cells"]], rtol=0, atol=1e-4)
    det, jax_det = (json.loads((d / "cell_detection.json").read_text()) for d in (port_out, jax_out))
    assert [c["bbox"] for c in det["cells"]] == [c["bbox"] for c in jax_det["cells"]]
    for name in ("cells.geojson", "cell_detection.geojson"):
        a, b = (json.loads((d / name).read_text()) for d in (port_out, jax_out))
        assert [f["geometry"]["type"] for f in a] == [f["geometry"]["type"] for f in b]
        if name == "cells.geojson":
            assert a == b
    graph = torch.load(port_out / "cells.pt", weights_only=False)
    jax_graph = torch.load(jax_out / "cells.pt", weights_only=False)
    assert graph.x.shape == jax_graph.x.shape
    rel = float((graph.x - jax_graph.x).norm() / jax_graph.x.norm())
    assert rel <= TOKENS_L2, rel
    np.testing.assert_allclose(graph.positions.numpy(), jax_graph.positions.numpy(), atol=1e-3)
    assert all((a.numpy() == b.numpy()).all() for a, b in zip(graph.contours, jax_graph.contours))
    stages, jax_stages = (json.loads((d / "timings.json").read_text()) for d in (port_out, jax_out))
    assert stages.keys() == jax_stages.keys()
    assert stages["stages_s"].keys() == jax_stages["stages_s"].keys()
    assert stages["n_patches"] == jax_stages["n_patches"]


def test_cli_matches_process_wsi(runs):
    _, port_out, cli_out, _ = runs
    assert _cells(cli_out) == _cells(port_out)
    assert (cli_out / "cells.geojson").exists() and (cli_out / "timings.json").exists()


@pytest.mark.parametrize("filelist", [True, False])
def test_cli_process_dataset_matches_process_wsi(runs, slide, ckpt, tmp_path, filelist):
    """`process_dataset` finds the slide by the filelist's `Filename` column
    (a row of another extension and an empty row dropped) or by a recursive
    glob, and writes the cells of `process_wsi`; `--profile` writes the
    torch trace."""
    from cellvit_tpu_torch.cli import cell_detection as cli

    _, port_out, _, _ = runs
    slide_path, patched = slide
    sub = "dataset_filelist" if filelist else "dataset_glob"
    extra = []
    if filelist:
        rows = f"Filename,label\n{slide_path.name},1\nother.svs,0\n,2\n"
        (tmp_path / "files.csv").write_text(rows)
        extra = ["--filelist", str(tmp_path / "files.csv")]
    cli.main(["--model", str(ckpt), "--device", "cpu", "--patch_size", "256", "--batch_size", "4",
              "--outdir_subdir", sub, "--profile", str(tmp_path / "prof"), "process_dataset",
              "--wsi_paths", str(slide_path.parent), "--patch_dataset_path", str(patched.parent),
              "--wsi_extension", "tiff", *extra])
    assert _cells(patched / "cell_detection" / sub) == _cells(port_out)
    assert json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]


@pytest.mark.parametrize("argv,device", [([], "cuda:0"), (["--gpu", "1"], "cuda:1"),
                                         (["--gpu", "1", "--device", "cpu"], "cpu")])
def test_cli_device_selection(monkeypatch, tmp_path, argv, device):
    """`--device cuda` (the default) with `--gpu N` hands `cuda:N` to the
    driver, which makes it the current device while its kernels run
    (`tests/test_torch_cuda.py` runs that part on the card)."""
    from cellvit_tpu_torch.cli import cell_detection as cli
    from cellvit_tpu_torch.inference import cell_detection as port_cd

    class Built(Exception):
        pass

    seen = {}

    def driver(**kwargs):
        seen.update(kwargs)
        raise Built

    monkeypatch.setattr(port_cd, "CellSegmentationInference", driver)
    with pytest.raises(Built):
        cli.main(["--model", str(tmp_path / "ckpt.pth"), *argv, "process_wsi",
                  "--wsi_path", "slide.svs", "--patched_slide_path", str(tmp_path)])
    assert seen["device"] == device and seen["model_path"] == tmp_path / "ckpt.pth"


def test_dedup_matches_jax_on_a_run_and_planted_duplicates(runs):
    *_, before = runs
    assert dedup.CellPostProcessor(before).post_process_cells() == \
        jax_dd.CellPostProcessor(before).post_process_cells()
    rng = np.random.default_rng(0)
    planted = [dict(c) for c in before]
    for c in [c for c in before if c["cell_status"] != 0][:20]:
        copy = dict(c)
        shift = rng.integers(-2, 3, 2)
        copy["contour"] = (np.asarray(c["contour"]) + shift).tolist()
        copy["patch_coordinates"] = [c["patch_coordinates"][0] + 1, c["patch_coordinates"][1]]
        copy["edge_position"] = False
        planted.append(copy)
    keep = dedup.CellPostProcessor(planted).post_process_cells()
    assert keep == jax_dd.CellPostProcessor(planted).post_process_cells()
    assert len(keep) < len(planted)
    assert (geojson_export.convert_geojson(planted, True)
            == jax_geojson.convert_geojson(planted, True))
