"""Port's HV postprocessing, watershed, relabelling and per-instance stats
against the JAX package's CPU path (`use_pallas=False`): instance maps
pixel-equal, statistics equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops.hv_postproc import instance_map_batch as jax_imb
from cellvit_tpu.ops.instance_stats import instance_stats_batch as jax_stats
from cellvit_tpu.ops.instance_stats import relabel_consecutive as jax_relabel
from cellvit_tpu.ops.watershed import watershed as jax_watershed
from cellvit_tpu_torch.ops.hv_postproc import instance_map_batch, instance_map_batch_maps
from cellvit_tpu_torch.ops.instance_stats import instance_stats_batch, relabel_consecutive
from cellvit_tpu_torch.ops.watershed import watershed

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


def _fused_inputs():
    """tests/test_fused.py: blobs on uniform-noise HV maps, 2 × 128²."""
    rng = np.random.default_rng(5)
    size = 128
    np_prob = np.zeros((2, size, size), np.float32)
    hv = rng.uniform(-1, 1, (2, size, size, 2)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for b in range(2):
        for _ in range(12):
            cy, cx = rng.integers(8, size - 8, 2)
            r = int(rng.integers(3, 7))
            np_prob[b][(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 0.9
    return np_prob, hv


def _cell_maps(rng, b, size, n, rmin, rmax):
    """HoverNet map model (tests/test_ops.py): per-nucleus centred ±1 HV."""
    np_prob = np.zeros((b, size, size), np.float32)
    hv = np.zeros((b, size, size, 2), np.float32)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(b):
        for _ in range(n):
            cy, cx = rng.integers(rmax, size - rmax, 2)
            r = int(rng.integers(rmin, rmax))
            inside = (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            np_prob[i][inside] = 0.95
            hv[i][inside, 0] = ((xx - cx) / r)[inside]
            hv[i][inside, 1] = ((yy - cy) / r)[inside]
    return np_prob, hv


def _inputs(name):
    rng = np.random.default_rng(0)
    if name == "fused_noise_128":
        return _fused_inputs()
    if name == "ops_cells_96":
        return _cell_maps(rng, 1, 96, 6, 5, 9)
    return _cell_maps(rng, 2, 256, 90, 4, 12)  # dense, touching nuclei


@pytest.mark.parametrize("name,mag", [("fused_noise_128", 40), ("ops_cells_96", 40),
                                      ("dense_256", 40), ("dense_256", 20)])
def test_instance_map_matches_jax_cpu_path(name, mag):
    np_prob, hv = _inputs(name)
    object_size, ksize = (10, 21) if mag == 40 else (3, 11)
    want = np.asarray(jax_imb(jnp.asarray(np_prob), jnp.asarray(hv), object_size=object_size,
                              ksize=ksize, use_pallas=False))
    got = instance_map_batch(torch.from_numpy(np_prob), torch.from_numpy(hv),
                             object_size=object_size, ksize=ksize)
    np.testing.assert_array_equal(got.numpy(), want)
    if name != "fused_noise_128":  # noise HV maps leave no markers
        assert want.max() > 0


def test_maps_entry_and_fixed_pass_ops():
    """The (B, H, W) maps entry equals the (B, H, W, 2) entry, and on these
    nuclei the fixed-pass scan ops (the CUDA default) give the same map."""
    np_prob, hv = _inputs("dense_256")
    p, h0, h1 = (torch.from_numpy(np.ascontiguousarray(a))
                 for a in (np_prob, hv[..., 0], hv[..., 1]))
    base, passes = instance_map_batch_maps(p, h0, h1, return_passes=True)
    np.testing.assert_array_equal(
        base.numpy(), instance_map_batch(torch.from_numpy(np_prob), torch.from_numpy(hv)).numpy())
    np.testing.assert_array_equal(
        instance_map_batch_maps(p, h0, h1, use_kernels=True).numpy(), base.numpy())
    assert passes.shape == (2,) and (passes > 0).all()


@pytest.mark.parametrize("schedule", ["frontier", "sweep"])
def test_watershed_matches_jax(rng, schedule):
    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((2, h, w), np.float32)
    mark = np.zeros((2, h, w), np.int32)
    mask = np.zeros((2, h, w), bool)
    for b in range(2):
        for k in range(1, 11):
            cy, cx = rng.integers(12, h - 12), rng.integers(12, w - 12)
            r = rng.integers(5, 11)
            mask[b] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
            img[b] = np.minimum(img[b], -np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2) / (r * r)))
            mark[b, cy, cx] = k
    want = np.asarray(jax.vmap(lambda i, m, k: jax_watershed(i, m, k, schedule=schedule))(
        jnp.asarray(img), jnp.asarray(mark), jnp.asarray(mask)))
    got = watershed(torch.from_numpy(img), torch.from_numpy(mark), torch.from_numpy(mask),
                    schedule=schedule)
    np.testing.assert_array_equal(got.numpy(), want)


def test_relabel_and_stats_match_jax():
    np_prob, hv = _inputs("dense_256")
    inst = np.asarray(jax_imb(jnp.asarray(np_prob), jnp.asarray(hv), use_pallas=False))
    n = 256 * 256 // 2 + 2
    want_inst = np.asarray(jax.vmap(lambda m: jax_relabel(m, n))(jnp.asarray(inst)))
    got_inst = relabel_consecutive(torch.from_numpy(inst.copy()), n)
    np.testing.assert_array_equal(got_inst.numpy(), want_inst)

    type_map = np.random.default_rng(1).integers(0, 6, inst.shape).astype(np.int32)
    want = jax_stats(jnp.asarray(want_inst), jnp.asarray(type_map), jnp.asarray(np_prob),
                     max_instances=64, num_classes=6)
    got = instance_stats_batch(got_inst, torch.from_numpy(type_map),
                               torch.from_numpy(np_prob), max_instances=64, num_classes=6)
    assert set(got) == set(want)
    for key in ("valid", "area", "bbox", "type"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
    for key in ("centroid", "type_prob", "mean_prob"):
        # fp32 sums of the same values; the port accumulates indices exactly
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-6,
                                   err_msg=key)
    assert int(got["valid"].sum()) > 10


def test_relabel_out_of_range_labels_match_jax():
    """Labels beyond `num_segments` (a fixed-pass compaction can leave
    INT_MAX on shapes its passes do not resolve) take the last id, as the
    JAX scatter (drops) and gather (clamps) give them."""
    inst = np.zeros((2, 16, 16), np.int32)
    inst[0, 0, 0:3] = 5
    inst[0, 2, 2] = np.iinfo(np.int32).max
    inst[1, 5, 5] = 9
    inst[1, 7, 7] = 130
    want = np.asarray(jax.vmap(lambda m: jax_relabel(m, 130))(jnp.asarray(inst)))
    got = relabel_consecutive(torch.from_numpy(inst), 130).numpy()
    np.testing.assert_array_equal(got, want)
