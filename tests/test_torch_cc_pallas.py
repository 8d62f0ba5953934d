"""Plain versions of the port's size filters (B10, B11) and level-sweep
watershed (B9) exactly equal to the JAX package's Pallas kernels in
interpret mode, and the scatter-form size oracles equal to their JAX twins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops import cc as jcc
from cellvit_tpu.ops.cc_pallas import (
    remove_small_objects_bincount_pallas,
    remove_small_objects_pallas,
    watershed_pallas,
)
from cellvit_tpu_torch.ops import cc, cc_cuda
from test_torch_cuda import _size_filter_labels

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)


def _labels(seed, b=2, h=96, w=128, p=0.35):
    """Compacted 4-connected labels of a noisy mask: many components of
    every size, from single pixels to large branching ones."""
    m = np.random.default_rng(seed).random((b, h, w)) < p
    return cc.connected_components(torch.from_numpy(m)).numpy()


def _disc_relief(rng, b, h, w, n, rmin=5, rmax=11):
    """Disc masks, relief −exp(−r²/R²) per disc (min over discs), and the
    disc centres with their 1-based ids."""
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.zeros((b, h, w), np.float32)
    mask = np.zeros((b, h, w), bool)
    centres = []
    for i in range(b):
        for k in range(n):
            cy, cx = int(rng.integers(rmin + 1, h - rmin - 1)), int(rng.integers(rmin + 1, w - rmin - 1))
            r = int(rng.integers(rmin, rmax))
            d2 = (yy - cy) ** 2 + (xx - cx) ** 2
            mask[i] |= d2 <= r * r
            img[i] = np.minimum(img[i], -np.exp(-d2 / (r * r)))
            centres.append((i, cy, cx, r, k + 1))
    return img, mask, centres


def _point_seeded(seed, b=2, h=96, w=128, n=8):
    img, mask, centres = _disc_relief(np.random.default_rng(seed), b, h, w, n)
    mark = np.zeros((b, h, w), np.int32)
    for i, cy, cx, _, k in centres:
        mark[i, cy, cx] = k
    return img, mark, mask


def _pre_grown(seed, b=2, h=96, w=128, n=10):
    """HV-style markers: each disc's core (radius R − 3) already labelled,
    cut by the mask and by later discs, as the postprocessing's markers are."""
    img, mask, centres = _disc_relief(np.random.default_rng(seed), b, h, w, n, rmin=6, rmax=12)
    yy, xx = np.mgrid[0:h, 0:w]
    mark = np.zeros((b, h, w), np.int32)
    for i, cy, cx, r, k in centres:
        mark[i][(yy - cy) ** 2 + (xx - cx) ** 2 <= (r - 3) ** 2] = k
    return img, mark * mask, mask


@pytest.mark.parametrize("min_size", [3, 10])
def test_window_size_filter_matches_pallas(min_size):
    lab = _labels(1)
    want = np.asarray(remove_small_objects_pallas(jnp.asarray(lab), min_size, interpret=True))
    got = cc_cuda.remove_small_objects_cuda(torch.from_numpy(lab), min_size).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < (got > 0).sum() < (lab > 0).sum()  # the filter removed some and kept some


def test_window_size_filter_min_size_one_is_identity():
    lab = torch.from_numpy(_labels(2, b=1, h=16, w=24))
    assert cc_cuda.remove_small_objects_cuda(lab, 1) is lab
    np.testing.assert_array_equal(np.asarray(remove_small_objects_pallas(
        jnp.asarray(lab.numpy()), 1, interpret=True)), lab.numpy())


@pytest.mark.parametrize("min_size,hi_bins,lo_bins", [(3, 64, 128), (10, 64, 128), (4, 4, 8), (12, 4, 8)])
def test_bincount_size_filter_matches_pallas(min_size, hi_bins, lo_bins):
    """64 × 128 bins hold every id exactly; 4 × 8 bins hold ids < 32 of the
    hundreds of components per image, so every id ≥ 31 counts into the top
    bin (inflated: id 31 is kept whatever its size) and ids ≥ 32 are
    always kept."""
    lab = _labels(3, w=256)
    assert lab.max() > 8 * hi_bins * lo_bins if hi_bins == 4 else lab.max() < hi_bins * lo_bins
    want = np.asarray(remove_small_objects_bincount_pallas(
        jnp.asarray(lab), min_size, hi_bins=hi_bins, lo_bins=lo_bins, interpret=True))
    xla = np.asarray(jax.vmap(lambda x: jcc.remove_small_objects_bincount(
        x, min_size, max_labels=hi_bins * lo_bins, hi_bins=hi_bins))(jnp.asarray(lab)))
    np.testing.assert_array_equal(xla, want)
    t = torch.from_numpy(lab)
    got = cc_cuda.remove_small_objects_bincount_cuda(t, min_size, hi_bins, lo_bins).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        cc.remove_small_objects_bincount(t, min_size, hi_bins * lo_bins, hi_bins).numpy(), want)
    if hi_bins == 4:
        assert ((got >= 32) == (lab >= 32)).all()  # overflow ids always kept
        assert ((got == 31) == (lab == 31)).all()  # the inflated top bin
        assert (got[lab == 0] == 0).all()


def test_radix_histogram_counts_clipped_ids():
    lab = _labels(4, w=256)
    lab[0, 0, :4] = [-3, 40000, 8191, 8192]
    hist = cc_cuda.radix_histogram_cuda(torch.from_numpy(lab), 64, 128).numpy()
    for i in range(lab.shape[0]):
        ids = np.clip(lab[i].ravel(), 0, 8191)  # what the clipping of hi and lo amounts to
        np.testing.assert_array_equal(hist[i].ravel(), np.bincount(ids, minlength=8192))
    assert hist.dtype == np.float32 and hist.shape == (2, 64, 128)


def _jax_ws(img, mark, mask, **kw):
    return np.asarray(watershed_pallas(jnp.asarray(img), jnp.asarray(mark), jnp.asarray(mask),
                                       interpret=True, **kw))


@pytest.mark.parametrize("inputs", ["point_seeded", "pre_grown"])
def test_sweep_watershed_matches_pallas(inputs):
    img, mark, mask = (_point_seeded if inputs == "point_seeded" else _pre_grown)(5)
    got, passes = cc_cuda.watershed_cuda(torch.from_numpy(img), torch.from_numpy(mark),
                                         torch.from_numpy(mask), return_passes=True)
    np.testing.assert_array_equal(got.numpy(), _jax_ws(img, mark, mask))
    assert ((got.numpy() > 0) == mask).mean() > 0.99
    assert passes.dtype == torch.int32 and (passes >= 1).all() and (passes < 512).all()


def test_sweep_watershed_pass_cap_decides():
    """Few levels and inner passes leave the flood unfinished after the
    sweep; 3 stabilization passes then stop it short, per image."""
    img, mark, mask = _point_seeded(6)
    kw = dict(levels=4, inner_iters=1, max_final_iters=3)
    got, passes = cc_cuda.watershed_cuda(torch.from_numpy(img), torch.from_numpy(mark),
                                         torch.from_numpy(mask), return_passes=True, **kw)
    np.testing.assert_array_equal(got.numpy(), _jax_ws(img, mark, mask, **kw))
    assert passes.tolist() == [3, 3]
    full = cc_cuda.watershed_cuda(torch.from_numpy(img), torch.from_numpy(mark),
                                  torch.from_numpy(mask), levels=4, inner_iters=1)
    assert (got != full).any()  # the cap changed the labels


def test_component_sizes_and_scatter_filter_match_jax():
    lab = _labels(7, h=48, w=64)
    lab[0, 0, :5] = [-1, -40, 500, 10**6, 3]  # wrapped, dropped and clamped ids
    n = int(lab[1].max()) + 1
    t = torch.from_numpy(lab)
    want = np.asarray(jax.vmap(lambda x: jcc.component_sizes(x, n))(jnp.asarray(lab)))
    np.testing.assert_array_equal(cc.component_sizes(t, n).numpy(), want)
    for ms in (3, 10):
        want = np.asarray(jax.vmap(lambda x: jcc.remove_small_objects(x, ms, n))(jnp.asarray(lab)))
        np.testing.assert_array_equal(cc.remove_small_objects(t, ms, n).numpy(), want)


# ------------------------------------------------- CPU replay of B9's kernel


def _bits(words):
    """uint32 words (…, n) → bool pixels (…, 32 n), bit i of word k = pixel 32 k + i."""
    return np.unpackbits(np.ascontiguousarray(words).view(np.uint8), axis=-1,
                         bitorder="little").astype(bool)


def _words(px):
    """bool pixels (…, 32 n) → uint32 words (…, n)."""
    return np.packbits(px, axis=-1, bitorder="little").view(np.uint32)


def _ws_pass_words(L, P):
    """A pass's word phase on staged tiles (…, SH, SWW): the neighbours'
    labelled bits N, S, W, E (W and E carried across words) and the
    candidate words P ∧ ¬L ∧ (N ∨ S ∨ W ∨ E)."""
    z = np.zeros_like(L[..., :1, :])
    nn = np.concatenate([z, L[..., :-1, :]], axis=-2)
    ss = np.concatenate([L[..., 1:, :], z], axis=-2)
    zc = np.zeros_like(L[..., :1])
    left = np.concatenate([zc, L[..., :-1]], axis=-1)
    right = np.concatenate([L[..., 1:], zc], axis=-1)
    ww = (L << 1) | (left >> 31)
    ee = (L >> 1) | (right << 31)
    return (nn, ss, ww, ee), P & ~L & (nn | ss | ww | ee)


_WS_SHIFT = {0: (-1, 0), 1: (1, 0), 2: (0, -1), 3: (0, 1)}  # N, S, W, E as (dy, dx)


def _emulated_ws_sweep(q, mark, mask, levels, inner, max_final, tile=(8, 32), k=4, fault=None):
    """numpy replay of `csrc/watershed.cu` on (B, H, W) quantized heights q:
    labels in place, the L and P bit planes in 32-pixel row words, tiles of
    `tile` (TW a multiple of 32) staged with a halo of k rows and one word,
    phases of k passes (the last of the sweep and of the stabilization cut
    short), each pass's candidate words from the snapshot L and the admitted
    words P ∧ (q ≤ level), its adoptions recording their direction, the early end of a tile's phase when it has
    no candidate, the chains of directions resolved to the labels at the
    phase's end, and the stabilization masks and pass counts. All tiles of a
    phase are staged from one snapshot of the global planes, as the kernel's
    two L planes give, over random directions (what a block's earlier tile
    leaves in shared memory). `fault` plants one defect: "tie_order" (E, W, S, N),
    "gauss_seidel" (rows read the pass's own new bits), "short_halo" (k − 1
    halo rows) or "count" (pass counts one too high)."""
    b, h, w = q.shape
    th, tw = tile
    halo = k - 1 if fault == "short_halo" else k
    sh, sww = th + 2 * halo, tw // 32 + 2
    ty, tx, nwg = -(-h // th), -(-w // tw), -(-w // 32)
    lab = np.where(mask, mark, 0).astype(np.int32)
    big = np.iinfo(np.int32).max
    # global planes, padded so that every staged window is a slice: image
    # row y at halo + y, image word gw at 1 + gw; heights at column 32 + x
    rows, cols = ty * th + 2 * halo, tx * tw // 32 + 2
    Lg = np.zeros((b, rows, cols), np.uint32)
    Pg = np.zeros((b, rows, cols), np.uint32)
    pad_px = np.zeros((b, h, 32 * nwg), bool)
    pad_px[..., :w] = lab > 0
    Lg[:, halo:halo + h, 1:1 + nwg] = _words(pad_px)
    pad_px[..., :w] = mask & (lab == 0)
    Pg[:, halo:halo + h, 1:1 + nwg] = _words(pad_px)
    qg = np.zeros((b, rows, 32 * cols), np.int64)
    qg[:, halo:halo + h, 32:32 + w] = q
    ri = (np.arange(ty) * th)[:, None] + np.arange(sh)             # (TY, SH)
    wi = (np.arange(tx) * (tw // 32))[:, None] + np.arange(sww)    # (TX, SWW)
    ci = (np.arange(tx) * tw)[:, None] + np.arange(32 * sww)       # (TX, SW)
    stage = lambda g, idx: g[:, ri[:, None, :, None], idx[None, :, None, :]]  # (B, TY, TX, SH, ·)
    P = stage(Pg, wi)
    qs = stage(qg, ci)
    q_nb = [np.roll(qs, (-dy, -dx), axis=(-2, -1)) for dy, dx in _WS_SHIFT.values()]  # neighbours' heights
    owned = np.zeros((sh, 32 * sww), bool)
    owned[halo:halo + th, 32:32 + tw] = True
    order = (3, 2, 1, 0) if fault == "tie_order" else (0, 1, 2, 3)
    sweep = levels * inner
    n_sweep, n_stab = -(-sweep // k), -(-max_final // k)
    flags = np.zeros((b, n_stab), np.int64)
    passes = np.zeros(b, np.int32)
    running = np.ones(b, bool)
    stale = np.random.default_rng(0)

    def status(phi):
        """Per image: 1 runs phase phi, 0 stopped before it (pass count set)."""
        out = np.ones(b, np.int32)
        if phi < n_sweep:
            return out
        t = phi - n_sweep
        for i in range(b):
            for u in range(t):
                n = min(k, max_final - u * k)
                if flags[i, u] != (1 << n) - 1:
                    free = ~int(flags[i, u]) & ((1 << 32) - 1)
                    passes[i] = u * k + (free & -free).bit_length() + (fault == "count")
                    out[i] = 0
                    break
            else:
                if t >= n_stab:
                    passes[i] = max_final + (fault == "count")
                    out[i] = 0
        return out

    def adopt(L, r, lvl):
        """Candidates and adoptions of staged rows r (a slice) from the words L:
        the candidate words, and with them the admitted words P ∧ (q ≤ level)."""
        (nn, ss, ww, ee), pend = _ws_pass_words(L, P)
        cand_px = _bits(pend[..., r, :])
        admitted = P[..., r, :] & _words(qs[..., r, :] <= lvl)
        go = _bits(pend[..., r, :] & admitted)
        best = np.full(go.shape, big, np.int64)
        dirs = np.zeros(go.shape, np.int8)
        for d in order:
            nb = _bits((nn, ss, ww, ee)[d][..., r, :])
            qn = q_nb[d][..., r, :]
            better = nb & (qn < best)
            best = np.where(better, qn, best)
            dirs = np.where(better, d, dirs)
        return cand_px.reshape(cand_px.shape[:3] + (-1,)).any(-1), go, dirs

    for phi in range(n_sweep + n_stab + 1):
        st = status(phi)
        running &= st == 1
        if not running.any():
            break
        stab = phi >= n_sweep
        p0 = (phi - n_sweep) * k if stab else phi * k
        n = min(k, (max_final if stab else sweep) - p0)
        L0 = stage(Lg, wi)
        L = L0.copy()
        # directions left in shared memory by the block's previous tile or
        # phase: any values, since a chain reads only this phase's adoptions
        D = stale.integers(0, 4, qs.shape).astype(np.int8)
        live = np.ones(L.shape[:3], bool) & running[:, None, None]
        changed = np.zeros((b, n), bool)
        for j in range(n):
            lvl = big if stab else (p0 + j) // inner
            if fault == "gauss_seidel":
                any_cand = np.zeros(L.shape[:3], bool)
                new_all = np.zeros(qs.shape, bool)
                for r in range(sh):
                    a, go, dirs = adopt(L, slice(r, r + 1), lvl)
                    go &= live[..., None, None]
                    any_cand |= a
                    D[..., r:r + 1, :] = np.where(go, dirs, D[..., r:r + 1, :])
                    new_all[..., r:r + 1, :] = go
                    L[..., r:r + 1, :] |= _words(go)
                new = new_all
            else:
                any_cand, go, dirs = adopt(L, slice(None), lvl)
                new = go & live[..., None, None]
                D = np.where(new, dirs, D)
                L = L | _words(new)
            changed[:, j] = (new & owned).reshape(b, -1).any(-1)
            live &= any_cand  # a tile without a candidate ends its phase
        # owned words out, new owned labels from their chains
        got = _bits(L & ~L0)
        bi, tyi, txi, r, c = np.nonzero(got & owned)
        rr, cc = r.copy(), c.copy()
        done = np.zeros(len(r), bool)
        l0_px = _bits(L0)
        for _ in range(k + 1):
            d = D[bi, tyi, txi, rr, cc]
            step = np.array([_WS_SHIFT[v] for v in range(4)])[d]
            rr = np.where(done, rr, rr + step[:, 0])
            cc = np.where(done, cc, cc + step[:, 1])
            done |= l0_px[bi, tyi, txi, rr, cc]
        assert done.all(), "a chain longer than the phase"
        y_src, x_src = tyi * th + rr - halo, txi * tw + cc - 32
        lab[bi, tyi * th + r - halo, txi * tw + c - 32] = lab[bi, y_src, x_src]
        own = L[..., halo:halo + th, 1:1 + tw // 32]  # (B, TY, TX, TH, TW/32)
        Lg[:, halo:halo + ty * th, 1:1 + tx * tw // 32] = own.transpose(0, 1, 3, 2, 4).reshape(
            b, ty * th, tx * tw // 32)
        Lg[:, halo + h:, :] = 0
        Lg[:, :, 1 + nwg:] = 0
        if stab:
            t = phi - n_sweep
            for i in np.nonzero(running)[0]:
                flags[i, t] = sum(1 << j for j in range(n) if changed[i, j])
    return lab, passes


def _serpentine(b=1, h=100, w=150):
    """A one-pixel path through the image, row by row (≈ h·w/2 pixels long),
    seeded at its start: the stabilization flood outlasts 512 passes."""
    mask = np.zeros((b, h, w), bool)
    mask[:, ::2, :] = True
    for r in range(1, h, 2):
        mask[:, r, w - 1 if r % 4 == 1 else 0] = True
    mark = np.zeros((b, h, w), np.int32)
    mark[:, 0, 0] = 7
    img = np.random.default_rng(9).random((b, h, w)).astype(np.float32)
    return img, mark, mask


def _race(b=1, h=100, w=150):
    """Two one-pixel-wide corridors crossing, a marker near each of their four
    ends, flat relief: the fronts race, and where they meet decides the
    labels, so a front delayed or hurried by one pass shows."""
    mask = np.zeros((b, h, w), bool)
    mask[:, :, 61] = True
    mask[:, 37, :] = True
    mark = np.zeros((b, h, w), np.int32)
    mark[:, 3, 61], mark[:, h - 1, 61], mark[:, 37, 0], mark[:, 37, w - 1] = 1, 2, 3, 4
    return np.zeros((b, h, w), np.float32), mark, mask


def _ws_case(name):
    if name == "pre_grown_negative":
        img, mark, mask = _pre_grown(5, h=100, w=150)
        mark = mark.copy()
        mark[0, 40:44, :] = np.where(mask[0, 40:44, :], -3, 0)  # a negative band: neither changes nor spreads
        return img, mark, mask
    if name == "empty_mask":
        img, mark, mask = _point_seeded(7, h=100, w=150)
        mask[1] = False
        return img, mark * mask, mask
    if name == "serpentine":
        return _serpentine()
    return _point_seeded(5, h=100, w=150)


def _ws_quantized(img, mask, levels):
    from cellvit_tpu_torch.ops import watershed as tws

    return tws.quantize(torch.from_numpy(img), torch.from_numpy(mask), levels).numpy()


@pytest.mark.parametrize("case,kw,tile,k", [
    ("point_seeded", dict(levels=64, inner=4, max_final=512), (8, 32), 4),
    ("point_seeded", dict(levels=64, inner=4, max_final=512), (16, 64), 16),
    ("point_seeded", dict(levels=5, inner=3, max_final=13), (8, 32), 4),
    ("pre_grown_negative", dict(levels=4, inner=1, max_final=3), (16, 64), 8),
    ("pre_grown_negative", dict(levels=300, inner=1, max_final=512), (8, 32), 5),
    ("empty_mask", dict(levels=64, inner=4, max_final=512), (8, 32), 4),
    ("serpentine", dict(levels=1, inner=1, max_final=512), (32, 64), 32),
])
def test_emulated_watershed_kernel_matches_plain_and_pallas(case, kw, tile, k):
    """The replay of `csrc/watershed.cu`'s schedule (words, phases, halos,
    chains, stabilization masks) on floods that cross many tiles and phases
    equals the plain sweep in labels and pass counts, and the Pallas kernel
    in labels: levels, inner passes and caps as the `gpu` test takes them,
    16-bit heights (300 levels), negative markers, an empty mask, and a
    flood cut by the 512-pass cap."""
    from cellvit_tpu_torch.ops import watershed as tws

    img, mark, mask = _ws_case(case)
    q = _ws_quantized(img, mask, kw["levels"])
    got, passes = _emulated_ws_sweep(q, mark, mask, kw["levels"], kw["inner"], kw["max_final"], tile, k)
    want, want_passes = tws.watershed(torch.from_numpy(img), torch.from_numpy(mark), torch.from_numpy(mask),
                                      kw["levels"], kw["inner"], kw["max_final"], schedule="sweep",
                                      return_passes=True)
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(passes, want_passes.numpy())
    pallas = _jax_ws(img, mark, mask, levels=kw["levels"], inner_iters=kw["inner"],
                     max_final_iters=kw["max_final"])
    np.testing.assert_array_equal(got, pallas)
    if case == "serpentine":
        assert passes.tolist() == [512] and 0 < (got == 7).sum() < mask.sum()  # cut by the cap
    if case == "pre_grown_negative":
        assert (got[mark < 0] == mark[mark < 0]).all()
    if case == "empty_mask":
        assert (got[1] == 0).all() and passes[1] == 1


@pytest.mark.parametrize("fault", ["tie_order", "gauss_seidel", "short_halo", "count"])
def test_emulated_watershed_kernel_fails_planted_faults(fault):
    """Each planted defect of the replay shows against the plain sweep on
    racing fronts: the tie order reversed, Gauss-Seidel reads within a pass,
    a halo one row short of the phase's passes, pass counts one too high."""
    from cellvit_tpu_torch.ops import watershed as tws

    img, mark, mask = _race()
    levels, inner, cap = 1, 1, 512
    q = _ws_quantized(img, mask, levels)
    want, want_passes = tws.watershed(torch.from_numpy(img), torch.from_numpy(mark), torch.from_numpy(mask),
                                      levels, inner, cap, schedule="sweep", return_passes=True)
    ok, ok_passes = _emulated_ws_sweep(q, mark, mask, levels, inner, cap, (8, 32), 4)
    np.testing.assert_array_equal(ok, want.numpy())
    np.testing.assert_array_equal(ok_passes, want_passes.numpy())
    try:
        got, passes = _emulated_ws_sweep(q, mark, mask, levels, inner, cap, (8, 32), 4, fault=fault)
    except AssertionError:  # a chain of directions longer than the phase: the kernel traps
        assert fault == "gauss_seidel"
        return
    assert (got != want.numpy()).any() or (passes != want_passes.numpy()).any()


# ---------------------------------------------------------------------------
# numpy replays of `csrc/rm_small.cu`: B10's tiles and boxes, B11's cluster


def _rm_window_tile(min_size):
    """B10's tile at `min_size`, as `win_geom` in `csrc/rm_small.cu` picks it:
    (TH, TW, halo rows r, halo columns R). TW from 64 down to 32 until the
    box TW + 2R is ≤ 256 (a TMA box's limit), R = r rounded up to 4; then TH
    from 32 down to 8 until the box (TH + 2r ≤ 256 rows) and the tile's
    list of uint16 pixels fit an eighth of an SM, else from 32 down until
    they fit a whole block's shared memory."""
    r = min_size - 1
    big_r = (r + 3) // 4 * 4
    tw = 64
    while tw > 32 and tw + 2 * big_r > 256:
        tw //= 2
    for budget in (233472 // 8 - 1024, 232448):
        th = 32
        while th >= 8:
            words = -(-(th + 2 * r) * (tw + 2 * big_r) // 32) * 32
            if th + 2 * r <= 256 and 128 + words * 4 + th * tw * 2 <= budget:
                return th, tw, r, big_r
            th //= 2
    raise ValueError(f"min_size {min_size}: no tile fits")


def _emulated_rm_window(lab, min_size, tile=None, fault=None):
    """numpy replay of B10 (`rm_window_kernel`) on (B, H, W) int32 labels:
    tiles of `tile` (TH, TW; default the kernel's `_rm_window_tile`), each
    box of TH + 2r rows × TW + 2R columns (R = r rounded up to 4, the box's
    first column a multiple of 4 as TMA needs) loaded row-major into a flat
    slot with 0 off the image (TMA's fill); pass 1 writes every pixel, a
    labelled one with its label, and lists the labelled ones; pass 2 counts
    each listed pixel's window centre-out (rows 0, −1, +1, −2, +2, …), leaves
    it as soon as the count reaches min_size, and writes 0 where the count
    ends below. Returns (labels kept, rows read a pixel). Planted faults:
    "short_halo" (a column halo of r − 1: the window's last column reads the
    next box row's first word, as shared memory would), "exit_gt" (exit and
    keep at count > min_size), "fill_own" (off-image elements match the
    centre label)."""
    b, h, w = lab.shape
    th, tw = tile or _rm_window_tile(min_size)[:2]
    r = min_size - 1
    big_r = r - 1 if fault == "short_halo" else (r + 3) // 4 * 4
    n = 2 * r + 1
    bh, bw = th + 2 * r, tw + 2 * big_r
    order = [0] + [s * d for d in range(1, r + 1) for s in (-1, 1)]
    reached = (lambda c: c > min_size) if fault == "exit_gt" else (lambda c: c >= min_size)
    out = np.full_like(lab, -7)  # the output's memory before the kernel: every pixel must be written
    rows = np.zeros(lab.shape, np.int32)
    ty, cx = np.mgrid[0:th, 0:tw]
    base = (ty + r) * bw + cx + big_r - r  # flat index of each window's centre row start
    for i in range(b):
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                assert fault == "short_halo" or (x0 - big_r) % 4 == 0
                box = np.zeros((bh, bw), np.int32)
                off = np.ones((bh, bw), bool)
                ys, xs = max(y0 - r, 0), max(x0 - big_r, 0)
                ye, xe = min(y0 - r + bh, h), min(x0 - big_r + bw, w)
                box[ys - y0 + r:ye - y0 + r, xs - x0 + big_r:xe - x0 + big_r] = lab[i, ys:ye, xs:xe]
                off[ys - y0 + r:ye - y0 + r, xs - x0 + big_r:xe - x0 + big_r] = False
                flat = np.concatenate([box.ravel(), np.zeros(2 * n, np.int32)])  # the slot and past it
                off_flat = np.concatenate([off.ravel(), np.zeros(2 * n, bool)])
                inside = (y0 + ty < h) & (x0 + cx < w)
                v = flat[base + r]
                tile_out = np.maximum(v, 0)  # pass 1
                listed = inside & (v > 0)
                cnt = np.zeros((th, tw), np.int64)
                nrows = np.zeros((th, tw), np.int32)
                active = listed.copy()
                for dy in order:  # pass 2
                    if not active.any():
                        break
                    idx = base[active][:, None] + dy * bw + np.arange(n)
                    match = flat[idx] == v[active][:, None]
                    if fault == "fill_own":
                        match |= off_flat[idx]
                    cnt[active] += match.sum(1)
                    nrows[active] += 1
                    active &= ~reached(cnt)
                tile_out[listed & ~reached(cnt)] = 0
                ye_o, xe_o = min(y0 + th, h), min(x0 + tw, w)
                out[i, y0:ye_o, x0:xe_o] = tile_out[:ye_o - y0, :xe_o - x0]
                rows[i, y0:ye_o, x0:xe_o] = nrows[:ye_o - y0, :xe_o - x0]
    return out, rows


def _radix_slice(nb, k):
    """B11's slice of bins a block: the least power of two ≥ 32 with k
    slices covering nb."""
    s = 32
    while s * k < nb:
        s *= 2
    return s


def _emulated_radix_filter(lab, min_size, hi_bins, lo_bins, k=8, hist=None, fault=None):
    """numpy replay of B11 (`radix_filter_kernel`) on (B, H, W) int32 ids,
    k blocks an image: each block's share of 4-pixel groups (single pixels
    where H·W is no multiple of 4) counted into its own table of
    nb = hi_bins·lo_bins words by runs of equal bins clamp(v, 0, nb − 1), the
    background apart; the slices of S bins summed across the k tables (or,
    given `hist`, read from it) into fp32 counts and bit words small =
    count < min_size, each slice's words stored into every table at the
    slice's start; then each block's pixels mapped through its table's bit
    words. Returns (kept ids, fp32 histogram). Planted faults: "share"
    (each share's end one group late: a group counted twice), "slice" (the
    first block's slice of words not stored: its bits read from the counts),
    "overflow" (ids ≥ nb looked up in the table instead of always kept)."""
    b, h, w = lab.shape
    nb = hi_bins * lo_bins
    s_len = _radix_slice(nb, k)
    vec = (h * w) % 4 == 0
    group = 4 if vec else 1
    units = h * w // group
    out = np.empty((b, h * w), np.int32)
    hist_out = np.empty((b, nb), np.float32)
    for i in range(b):
        img = lab[i].ravel()
        shares = []
        for rank in range(k):
            u0, u1 = units * rank // k, units * (rank + 1) // k
            if fault == "share" and rank < k - 1:
                u1 += 1
            shares.append((u0 * group, min(u1 * group, h * w)))
        tables = []
        for p0, p1 in shares:
            table = np.zeros(nb, np.int64)
            if hist is None:
                bins = np.clip(img[p0:p1], 0, nb - 1).reshape(-1, group)
                start = np.ones(bins.shape, bool)
                start[:, 1:] = bins[:, 1:] != bins[:, :-1]  # a run of equal bins in a group: one atomic
                run_id = np.cumsum(start.ravel()) - 1
                run_len = np.bincount(run_id)
                run_bin = bins.ravel()[start.ravel()]
                zeros = run_len[run_bin == 0].sum()  # the background, in a register
                np.add.at(table, run_bin[run_bin != 0], run_len[run_bin != 0])
                table[0] += zeros
            tables.append(table)
        totals = np.zeros(nb, np.float32)
        for rank in range(k):
            s0 = rank * s_len
            if s0 >= nb:
                continue
            sl = slice(s0, min(s0 + s_len, nb))
            if hist is None:
                totals[sl] = sum(t[sl] for t in tables).astype(np.float32)
            else:
                totals[sl] = hist[i].ravel()[sl]
            small = np.zeros(s_len, bool)
            small[:sl.stop - s0] = totals[sl] < np.float32(min_size)
            words = _words(small)
            if fault == "slice" and rank == 0:
                continue
            nw = (sl.stop - s0 + 31) // 32
            for t in tables:
                t[s0:s0 + nw] = words[:nw]
        hist_out[i] = totals
        for (p0, p1), t in zip(shares, tables):
            v = img[p0:p1]
            vv = np.clip(v, 0, nb - 1)
            word = t[(vv & ~(s_len - 1)) + ((vv & (s_len - 1)) >> 5)].astype(np.uint32)
            is_small = ((word >> (vv & 31).astype(np.uint32)) & 1).astype(bool)
            keep = (v > 0) & ((v >= nb) | ~is_small) if fault != "overflow" else (v > 0) & ~is_small
            out[i, p0:p1] = np.where(keep, v, 0)
    return out.reshape(lab.shape), hist_out.reshape(b, hi_bins, lo_bins)


def _planted(min_size, h=40, w=70, tw=32):
    """Labels that each B10 fault shows on: a component of exactly min_size
    pixels (a row), one of min_size − 1 in the top-left corner (off-image
    elements around it), and a row of min_size pixels starting at the last
    column of the first tile (its first pixel needs column x + r)."""
    lab = _size_filter_labels(min_size, 1, h, w, max_id=50)
    lab[0, :3, :] = 0
    lab[0, 0, 1:min_size] = 101                       # min_size − 1 pixels at the corner
    lab[0, 2, 1:1 + min_size] = 102                   # exactly min_size
    lab[0, 10:13, tw - 2:tw + min_size + 1] = 0
    lab[0, 11, tw - 1:tw - 1 + min_size] = 103        # across the first tile's right edge
    return lab


@pytest.mark.parametrize("shape,min_size,tile", [
    ((2, 96, 128), 2, None), ((2, 96, 128), 10, None), ((2, 96, 128), 10, (8, 32)),
    ((3, 77, 33), 10, None), ((3, 77, 33), 2, (16, 32)), ((1, 40, 1030), 10, None),
    ((1, 1, 1), 10, None), ((2, 70, 90), cc_cuda.RM_SMALL_MAX_MIN_SIZE, None),
])
def test_emulated_window_filter_matches_plain_and_pallas(shape, min_size, tile):
    """The replay of B10's tiles, boxes, 0 fill and centre-out exit equals the
    plain window filter and `remove_small_objects_pallas` (interpret mode;
    the plain version alone at the limit, whose (2·105 − 1)² window the
    Pallas interpreter takes minutes for) on shapes that no tile or 4
    columns divide, ids −5, 8192 and 2³⁰, min_size 2, 10 and the limit. A
    pixel inside a large disc leaves after its own row."""
    lab = _size_filter_labels(sum(shape) + min_size, *shape)
    if shape == (2, 96, 128):
        lab[1, 40:60, 40:70] = 77  # a 20 × 30 block: its inner pixels stop after one row
    got, rows = _emulated_rm_window(lab, min_size, tile)
    want = cc.remove_small_objects_window(torch.from_numpy(lab), min_size).numpy()
    np.testing.assert_array_equal(got, want)
    if min_size <= 10 and shape[1] * shape[2] <= 96 * 128:
        pallas = np.asarray(remove_small_objects_pallas(jnp.asarray(lab), min_size, interpret=True))
        np.testing.assert_array_equal(got, pallas)
    if shape == (2, 96, 128):
        assert rows[1, 50, 55] == 1 and (rows[lab <= 0] == 0).all()
    assert 0 < (got > 0).sum() < (lab > 0).sum() or lab.size == 1


@pytest.mark.parametrize("fault", ["short_halo", "exit_gt", "fill_own"])
def test_emulated_window_filter_fails_planted_faults(fault):
    """Each planted defect of the B10 replay shows against the plain filter:
    a column halo one short of r, the exit and keep at count > min_size, and
    off-image elements that match the centre label."""
    for min_size in (2, 10):
        lab = _planted(min_size)
        want = cc.remove_small_objects_window(torch.from_numpy(lab), min_size).numpy()
        ok, _ = _emulated_rm_window(lab, min_size, (8, 32))
        np.testing.assert_array_equal(ok, want)
        got, _ = _emulated_rm_window(lab, min_size, (8, 32), fault=fault)
        assert (got != want).any(), (fault, min_size)


@pytest.mark.parametrize("shape,bins,k", [
    ((2, 96, 128), (64, 128), 8), ((2, 96, 128), (4, 8), 8), ((3, 77, 33), (64, 128), 8),
    ((3, 77, 33), (4, 8), 16), ((1, 1, 1), (64, 128), 8), ((2, 64, 96), (64, 128), 12),
])
@pytest.mark.parametrize("min_size", [2, 10])
def test_emulated_radix_filter_matches_plain_and_pallas(shape, bins, k, min_size):
    """The replay of B11's cluster (shares, runs, slices, pushed bit words,
    the lookup) equals the plain radix filter and histogram, and
    `remove_small_objects_bincount_pallas` (interpret mode) where H is a
    multiple of its 8-row groups, on H·W that is no multiple of 4, ids −5, 8192 and 2³⁰, 64 × 128 and 4 × 8 bins and 8,
    12 and 16 blocks an image; its lookup from a given histogram, too."""
    lab = _size_filter_labels(sum(shape) + k, *shape, max_id=700)
    got, hist = _emulated_radix_filter(lab, min_size, *bins, k=k)
    t = torch.from_numpy(lab)
    want_hist = cc.radix_histogram(t, *bins).numpy()
    np.testing.assert_array_equal(hist, want_hist)
    want = cc.remove_small_objects_bincount(t, min_size, bins[0] * bins[1], bins[0]).numpy()
    np.testing.assert_array_equal(got, want)
    if shape[1] % 8 == 0:  # the Pallas kernels take 8-row groups: H a multiple of 8
        pallas = np.asarray(remove_small_objects_bincount_pallas(
            jnp.asarray(lab), min_size, hi_bins=bins[0], lo_bins=bins[1], interpret=True))
        np.testing.assert_array_equal(got, pallas)
    kept, _ = _emulated_radix_filter(lab, min_size, *bins, k=k, hist=want_hist)
    np.testing.assert_array_equal(kept, cc.radix_keep(t, torch.from_numpy(want_hist), min_size).numpy())
    n = min(3, lab.size)
    assert got.reshape(-1)[:n].tolist() == [0, 8192, 2**30][:n]


@pytest.mark.parametrize("fault", ["share", "slice", "overflow"])
def test_emulated_radix_filter_fails_planted_faults(fault):
    """Each planted defect of the B11 replay shows against the plain filter:
    a share boundary one group late, a slice of bit words never stored, and
    an overflow id looked up instead of kept."""
    lab = _size_filter_labels(5, 2, 96, 128, max_id=1000)
    want = cc.remove_small_objects_bincount(torch.from_numpy(lab), 10).numpy()
    ok, _ = _emulated_radix_filter(lab, 10, 64, 128)
    np.testing.assert_array_equal(ok, want)
    got, hist = _emulated_radix_filter(lab, 10, 64, 128, fault=fault)
    want_hist = cc.radix_histogram(torch.from_numpy(lab)).numpy()
    assert (got != want).any() or (hist != want_hist).any()
