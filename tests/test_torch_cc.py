"""Port's scan ops (plain versions on CPU) bit-exact against the Pallas
kernels in interpret mode, and the port's converging CC / hole filling /
morphology / size filter and cv2-parity filters against their JAX twins.
Also the arithmetic of the resident-tile kernel of connected components and
min-propagation (`csrc/seg_min.cu`): a pass as two run-min broadcasts, and a
step-by-step replay of its tiles, chunks and edge summaries, which must fail
planted faults; and the same for the bit-packed flood and hole filling
(`csrc/flood_bits.cu`): words, chunks, bands, edge lines and the bit-reversed
row fill."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cellvit_tpu.ops import cc as jcc
from cellvit_tpu.ops import filters as jfilters
from cellvit_tpu.ops.cc_pallas import (
    compact_root_labels_pallas,
    connected_components_pallas,
    fill_holes_pallas,
    flood_pallas,
    propagate_min_pallas,
)
from cellvit_tpu_torch.ops import cc, cc_cuda, filters

# one intra-op thread each: the suite runs as parallel pytest workers
torch.set_num_threads(1)
INT_MAX = cc_cuda.INT_MAX


def _blobs(rng, b, h, w, n, rmin=2, rmax=7):
    m = np.zeros((b, h, w), bool)
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(b):
        for _ in range(n):
            cy, cx = rng.integers(4, h - 4), rng.integers(4, w - 4)
            r = int(rng.integers(rmin, rmax))
            m[i] |= (yy - cy) ** 2 + (xx - cx) ** 2 <= r * r
    return m


def _spiral(n, gap=2):
    m = np.zeros((n, n), bool)
    y = x = 0
    m[0, 0] = True
    dirs = ((0, 1), (1, 0), (0, -1), (-1, 0))
    s = 0
    while True:
        length = n - 1 - gap * max(0, (s - 1) // 2)
        if length <= 0:
            return m
        dy, dx = dirs[s % 4]
        for _ in range(length):
            y, x = y + dy, x + dx
            m[y, x] = True
        s += 1


def _shapes(rng):
    """Blobs, a U shape and a spiral (the spiral needs far more than 3 passes)."""
    m = _blobs(rng, 3, 64, 96, 14)
    m[0, 5:40, 5:8] = True
    m[0, 37:40, 5:40] = True
    m[0, 5:40, 37:40] = True
    m[1] = False
    m[1, :48, :48] = _spiral(48)
    return m


@pytest.mark.parametrize("n_outer", [1, 2, 3])
def test_connected_components_plain_bitexact(rng, n_outer):
    m = _shapes(rng)
    want = np.asarray(connected_components_pallas(jnp.asarray(m), n_outer=n_outer,
                                                  interpret=True))
    got = cc_cuda.connected_components_cuda(torch.from_numpy(m), n_outer).numpy()
    np.testing.assert_array_equal(got, want)
    if n_outer == 3:  # the spiral is not converged: several root labels remain
        assert len(np.unique(got[1])) > 2


@pytest.mark.parametrize("n_outer", [1, 2, 3])
def test_fill_holes_plain_bitexact(rng, n_outer):
    m = _shapes(rng)
    m[2, 20:40, 20:40] = True
    m[2, 25:35, 25:35] = False
    want = np.asarray(fill_holes_pallas(jnp.asarray(m), n_outer=n_outer, interpret=True))
    got = cc_cuda.fill_holes_cuda(torch.from_numpy(m), n_outer).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_outer", [1, 2, 3])
def test_propagate_min_and_compact_plain_bitexact(rng, n_outer):
    m = _shapes(rng)
    lab = np.asarray(connected_components_pallas(jnp.asarray(m), n_outer=n_outer,
                                                 interpret=True))
    want = np.asarray(compact_root_labels_pallas(jnp.asarray(lab), n_outer=n_outer,
                                                 interpret=True))
    got = cc_cuda.compact_root_labels_cuda(torch.from_numpy(lab.copy()), n_outer).numpy()
    np.testing.assert_array_equal(got, want)
    seed = rng.integers(0, 1000, m.shape).astype(np.int32)
    want = np.asarray(propagate_min_pallas(jnp.asarray(seed), jnp.asarray(m),
                                           n_outer=n_outer, interpret=True))
    got = cc_cuda.propagate_min_cuda(torch.from_numpy(seed), torch.from_numpy(m), n_outer)
    np.testing.assert_array_equal(got.numpy(), want)


def _run_broadcast(v, open_, dim, reduce, ident):
    """Each open pixel ← the `reduce` of its run along `dim` (a maximal
    stretch of open pixels), closed pixels ← `ident`: segment ids from a
    cumsum of the closed pixels, one scatter-reduce."""
    vt, ot = v.movedim(dim, -1), open_.movedim(dim, -1)
    n = vt.shape[-1]
    line = torch.arange(vt.numel() // n).reshape(vt.shape[:-1] + (1,)) * (n + 1)
    key = (torch.cumsum(~ot, -1) + line).reshape(-1)
    src = torch.where(ot, vt, ident).reshape(-1)
    red = torch.full((int(key.max()) + 1,), ident, dtype=v.dtype)
    red = red.scatter_reduce(0, key, src, reduce, include_self=True)
    return torch.where(ot, red[key].reshape(vt.shape), ident).movedim(-1, dim)


@pytest.mark.parametrize("dim", [1, 2])
@pytest.mark.parametrize("op", ["min", "or"])
def test_run_broadcast_equals_scan_pair(rng, op, dim):
    """A forward segmented scan, the re-mask and a reverse one equal a run
    broadcast bit for bit (min and OR are idempotent and associative): the
    identity on which `seg_min.cu` applies a pass as two broadcasts. Any
    int32 for min, INT_MAX and negatives included; the flood's 0/1 for OR."""
    m = rng.random((3, 40, 56)) < 0.6
    m[0, 5], m[0, :, 7] = True, True      # all-open lines along both axes
    m[1, 9], m[1, :, 11] = False, False   # all-closed lines
    m[2] = True
    if op == "min":
        v = rng.integers(-2**31, 2**31, m.shape, dtype=np.int64).astype(np.int32)
        v[:, ::5] = cc_cuda.INT_MAX
        fn, ident, reduce = torch.minimum, cc_cuda.INT_MAX, "amin"
    else:
        v = (rng.random(m.shape) < 0.1).astype(np.int32)
        fn, ident, reduce = torch.bitwise_or, 0, "amax"
    fg = torch.from_numpy(m)
    v = torch.where(fg, torch.from_numpy(v), ident)
    want = v
    for reverse in (False, True):
        want = torch.where(fg, cc_cuda.segmented_scan(want, ~fg, dim, reverse, fn, ident), ident)
    got = _run_broadcast(v, fg, dim, reduce, ident)
    assert torch.equal(got, want)


def _fold(c, edge, full):
    """The minimum leaving a span of a line at its far end: the one that
    entered continues only through an all-open span."""
    return np.minimum(np.where(full, c, INT_MAX), edge)


def _emulated_phase(v, m, axis, tile_len, chunk, fault):
    """One run-min broadcast along `axis` of padded (B, H, W) state `v` and
    mask `m`, as `seg_min.cu` computes it: run minima within each chunk of
    `chunk` pixels of a line (a forward and a reverse walk), each chunk's
    first-run and last-run minima and all-open flag, their folds into the
    tile's summary of the line, folds of the tiles' summaries along the line,
    then the carries folded back into each chunk's first and last runs."""
    if axis == 0:
        v, m = v.transpose(0, 2, 1), m.transpose(0, 2, 1)
    b, nl, n = v.shape
    kt, nt = tile_len // chunk, n // tile_len
    vc, mc = v.reshape(b, nl, n // chunk, chunk).copy(), m.reshape(b, nl, n // chunk, chunk)
    for order in (range(chunk), range(chunk - 1, -1, -1)):
        run = np.full(vc.shape[:-1], INT_MAX, vc.dtype)
        for i in order:
            run = np.where(mc[..., i], np.minimum(run, vc[..., i]), INT_MAX)
            vc[..., i] = np.where(mc[..., i], run, vc[..., i]) if fault == "no_remask" else run
    head, tail, full = (a.reshape(b, nl, nt, kt) for a in (vc[..., 0], vc[..., -1], mc.all(-1)))
    t_head, t_tail = np.full((2, b, nl, nt), INT_MAX, vc.dtype)
    for j in range(kt):
        t_tail = _fold(t_tail, tail[..., j], full[..., j])
        t_head = _fold(t_head, head[..., kt - 1 - j], full[..., kt - 1 - j])
    t_full = full.all(-1)
    cin, cout = np.full((2, b, nl, nt), INT_MAX, vc.dtype)
    for p in range(1, nt):
        q = nt - 1 - p
        if fault == "one_neighbour":  # a run that spans a tile reaches the next one only
            cin[..., p], cout[..., q] = t_tail[..., p - 1], t_head[..., q + 1]
        else:
            cin[..., p] = _fold(cin[..., p - 1], t_tail[..., p - 1], t_full[..., p - 1])
            cout[..., q] = _fold(cout[..., q + 1], t_head[..., q + 1], t_full[..., q + 1])
    cl, cr = np.full((2, b, nl, nt, kt), INT_MAX, vc.dtype)
    cl[..., 0], cr[..., -1] = cin, cout
    for j in range(1, kt):
        q = kt - 1 - j
        cl[..., j] = _fold(cl[..., j - 1], tail[..., j - 1], full[..., j - 1])
        cr[..., q] = _fold(cr[..., q + 1], head[..., q + 1], full[..., q + 1])
    lead = np.cumprod(mc, -1).astype(bool)  # each chunk's first run and last run
    trail = np.cumprod(mc[..., ::-1], -1)[..., ::-1].astype(bool)
    vc = np.minimum(vc, np.where(lead, cl.reshape(b, nl, -1)[..., None], INT_MAX))
    vc = np.minimum(vc, np.where(trail, cr.reshape(b, nl, -1)[..., None], INT_MAX))
    out = vc.reshape(b, nl, n)
    return out.transpose(0, 2, 1) if axis == 0 else out


def _emulated_tiled_runs(v0, open_, n_outer, tile=(128, 256), chunk=32, fault=None):
    """Replay of `seg_min.cu` on (B, H, W) numpy state `v0` (raster index or
    seed) and bool mask: tiles of `tile` pixels, padded past the ragged last
    ones with closed pixels; INT_MAX where closed (the re-mask, at load and in
    every walk); `n_outer` passes of a column phase, then a row phase.
    `fault` plants one bug: "one_neighbour", "open_padding", "rows_first" or
    "no_remask"."""
    b, h, w = v0.shape
    tr, tc = tile
    hp, wp = -(-h // tr) * tr, -(-w // tc) * tc
    m = np.full((b, hp, wp), fault == "open_padding")
    m[:, :h, :w] = open_
    v = np.full((b, hp, wp), INT_MAX, np.int64)
    v[:, :h, :w] = v0 if fault == "no_remask" else np.where(open_, v0, INT_MAX)
    for _ in range(n_outer):
        for axis in ((1, 0) if fault == "rows_first" else (0, 1)):
            v = _emulated_phase(v, m, axis, tr if axis == 0 else tc, chunk, fault)
    return v[:, :h, :w].astype(np.int32)


def _emulated_cc(m, n_outer, **kw):
    b, h, w = m.shape
    lab = _emulated_tiled_runs(np.broadcast_to(np.arange(h * w).reshape(1, h, w), m.shape), m,
                               n_outer, **kw)
    return np.where(m, lab + 1, 0).astype(np.int32)


def _b4_seeds(rng, shape):
    """int32 seeds over the whole range, INT_MAX and negatives included."""
    seed = rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)
    seed[:, ::3, ::4] = INT_MAX
    return seed


@functools.lru_cache(maxsize=None)
def _pallas_b2_b4(n_outer):
    """The Pallas kernels in interpret mode on `_shapes` and `_b4_seeds`."""
    rng = np.random.default_rng(0)
    m = _shapes(rng)
    seed = _b4_seeds(rng, m.shape)
    lab = connected_components_pallas(jnp.asarray(m), n_outer=n_outer, interpret=True)
    pm = propagate_min_pallas(jnp.asarray(seed), jnp.asarray(m), n_outer=n_outer, interpret=True)
    return m, seed, np.asarray(lab), np.asarray(pm)


@pytest.mark.parametrize("tile,chunk", [((128, 256), 32), ((24, 40), 8), ((8, 16), 4)])
@pytest.mark.parametrize("n_outer", [1, 2, 3, 4])
def test_emulated_tiled_runs_match_plain_and_pallas(n_outer, tile, chunk):
    """The replay of `seg_min.cu`, at its own tile and at tiles that leave
    ragged last tiles (64 × 96 in 24 × 40) or put a line across 12 tiles,
    equals the plain versions and the Pallas kernels exactly: B2 on the
    spiral, the U shape and blobs; B4 on seeds over all of int32."""
    m, seed, want_lab, want_pm = _pallas_b2_b4(n_outer)
    lab = _emulated_cc(m, n_outer, tile=tile, chunk=chunk)
    np.testing.assert_array_equal(lab, want_lab)
    np.testing.assert_array_equal(
        lab, cc_cuda.connected_components_plain(torch.from_numpy(m), n_outer).numpy())
    pm = _emulated_tiled_runs(seed, m, n_outer, tile=tile, chunk=chunk)
    np.testing.assert_array_equal(pm, want_pm)
    np.testing.assert_array_equal(
        pm, cc_cuda.propagate_min_plain(torch.from_numpy(seed), torch.from_numpy(m), n_outer).numpy())
    if n_outer == 3:  # the fixed-pass result: the spiral stays split
        assert len(np.unique(lab[1])) > 2


@pytest.mark.parametrize("fault", ["one_neighbour", "open_padding", "rows_first", "no_remask"])
def test_emulated_tiled_runs_fail_planted_faults(rng, fault):
    """Each planted fault changes the result, after one pass or three, on
    shapes that exercise it: a bar across all three 40-column tiles of a row
    (a run carried one tile only: wrong after one pass), separate bars that
    end on the bottom and right edges of ragged tiles (padding treated as
    open joins them, seen from the second pass), the spiral and U shape (rows
    first) and B4's INT_MAX background (the re-mask skipped)."""
    m = _shapes(rng)
    m[2, 40:, :] = False
    m[2, :30, 70:] = False
    m[2, 45, :] = True            # a bar across the whole row
    m[2, 50:, 10] = m[2, 50:, 30] = True
    m[2, 5, 80:] = m[2, 20, 80:] = True
    kw = dict(tile=(24, 40), chunk=8)
    caught = []
    for n_outer in (1, 3):
        want = cc_cuda.connected_components_plain(torch.from_numpy(m), n_outer).numpy()
        np.testing.assert_array_equal(_emulated_cc(m, n_outer, **kw), want)
        seed = _b4_seeds(rng, m.shape)
        want_pm = cc_cuda.propagate_min_plain(torch.from_numpy(seed), torch.from_numpy(m),
                                              n_outer).numpy()
        np.testing.assert_array_equal(_emulated_tiled_runs(seed, m, n_outer, **kw), want_pm)
        if fault == "no_remask":
            bad = _emulated_tiled_runs(seed, m, n_outer, fault=fault, **kw)
            caught.append(bool((bad != want_pm)[~m].any()))
        else:
            caught.append(bool((_emulated_cc(m, n_outer, fault=fault, **kw) != want).any()))
    assert any(caught), caught


U32 = np.uint32
ALL = U32(0xFFFFFFFF)
_LANE = np.arange(32, dtype=np.uint64)


def _brev(x):
    """`__brev` on uint32 arrays."""
    x = x.astype(U32)
    for shift, mask in ((1, 0x55555555), (2, 0x33333333), (4, 0x0F0F0F0F), (8, 0x00FF00FF)):
        x = ((x >> U32(shift)) & U32(mask)) | ((x & U32(mask)) << U32(shift))
    return (x >> U32(16)) | (x << U32(16))


def _fill_up(g, o):
    """`flood_bits.cu`'s fill_up: bits of o reached from g ⊆ o towards higher
    bit index, by one (wrapping) addition."""
    with np.errstate(over="ignore"):
        return (o & ((o + g) ^ o)) | g


def _pack_rows(m, n_words):
    """(B, H, W) bool → (B, H, n_words) uint32 words along the rows, bit i of
    word j = column 32j + i; columns past W are 0."""
    b, h, w = m.shape
    p = np.zeros((b, h, 32 * n_words), bool)
    p[..., :w] = m
    return (p.reshape(b, h, n_words, 32).astype(np.uint64) << _LANE).sum(-1).astype(U32)


def _ballot(bits):
    """(…, 32) lane bits → (…) uint32 masks."""
    return (bits.astype(np.uint64) << _LANE).sum(-1).astype(U32)


def _emulated_row_pass(x, o, fault):
    """Run-OR broadcast along the rows of (…, NWL, 32 lanes) words (word
    32q + l of a row at [q, l]): each stretch of 32 words in turn, the
    words' carries by two ballots and a fill of the lane bits, the carry into
    the stretch through lane 31 of the one before; then the same on
    bit-reversed words for the other direction. "word_carry_dropped": no
    carry crosses a word boundary."""
    nwl = x.shape[-2]
    lane = np.arange(32, dtype=U32)
    one = U32(1)
    x = x.copy()
    for reverse in (False, True):
        if reverse:  # bit-reversed words in reversed order along the row
            x, o = _brev(x[..., ::-1, ::-1]), _brev(o[..., ::-1, ::-1])
        seg = np.zeros(x.shape[:-2], U32)
        for q in range(nwl):
            tm = _ballot(_fill_up(x[..., q, :], o[..., q, :]) >> U32(31))
            fm = _ballot(o[..., q, :] == ALL)
            out = _fill_up(tm | (seg & fm & one), fm | tm)
            c = np.where(lane > 0, (out[..., None] >> np.maximum(lane, 1) - one) & one, seg[..., None])
            if fault == "word_carry_dropped":
                c = np.zeros_like(c)
            x[..., q, :] = _fill_up(x[..., q, :] | (c & o[..., q, :] & one), o[..., q, :])
            seg = out >> U32(31)
        if reverse:
            x, o = _brev(x[..., ::-1, ::-1]), _brev(o[..., ::-1, ::-1])
    return x


def _walk(x, o, run, order, fault):
    """Walk rows `order` of (…, RC, words): run ← x | (o & run), in place."""
    for i in order:
        run = x[..., i, :] | (run if fault == "no_remask" else o[..., i, :] & run)
        x[..., i, :] = run
    return run


def _fold_words(pairs, reverse=False):
    """Exclusive and inclusive folds of (all-open, run value) summaries along
    axis -2: a carry crosses a span only if all of it is open."""
    f, t = pairs
    n = f.shape[-2]
    order = range(n - 1, -1, -1) if reverse else range(n)
    ex_f, ex_t = np.empty_like(f), np.empty_like(t)
    acc_f, acc_t = np.full(f.shape[:-2] + f.shape[-1:], ALL), np.zeros(t.shape[:-2] + t.shape[-1:], U32)
    for k in order:
        ex_f[..., k, :], ex_t[..., k, :] = acc_f, acc_t
        acc_t = t[..., k, :] | (f[..., k, :] & acc_t)
        acc_f = acc_f & f[..., k, :]
    return ex_f, ex_t, acc_f, acc_t


def _emulated_flood_bits(seed, open_, n_outer, bands=8, chunks=32, fault=None):
    """Replay of `flood_bits.cu` on (B, H, W) bool seed and open mask: words
    of 32 pixels along the rows (closed past W, or open with the fault
    "open_padding"), lane l of a warp holding words l and l + 32 (NWL ≤ 2)
    of each of its rows, `chunks` warps of RC rows a band,
    `bands` blocks a cluster, RC the least power of 2 that covers H; a pass
    is a column phase (chunk summaries; the chunks' folds within a band; the
    bands' folds, dropped by the fault "band_edge_dropped"; the chunks walked
    with their carries) and a row phase. "no_remask": the walks ignore the
    mask; "word_carry_dropped": see `_emulated_row_pass`."""
    b, h, w = seed.shape
    ww = -(-w // 32)
    nwl = 1 if ww <= 32 else 2
    rc = 1
    while chunks * rc * bands < h:
        rc *= 2
    hp = bands * chunks * rc
    o = np.zeros((b, hp, 32 * nwl), U32)
    o[:, :h] = _pack_rows(open_, 32 * nwl)
    if fault == "open_padding" and w % 32:
        o[:, :h, ww - 1] |= ALL << U32(w % 32)
    x = np.zeros_like(o)
    x[:, :h] = _pack_rows(seed, 32 * nwl) & o[:, :h]
    shape = (b, bands, chunks, rc, 32 * nwl)
    x, o = x.reshape(shape), o.reshape(shape)
    for _ in range(n_outer):
        t = _walk(x.copy(), o, np.zeros(shape[:3] + shape[4:], U32), range(rc), fault)
        hd = _walk(x.copy(), o, np.zeros_like(t), range(rc - 1, -1, -1), fault)
        f = np.bitwise_and.reduce(o, axis=3)
        pa, pt, band_f, band_t = _fold_words((f, t))
        qa, qh, _, band_h = _fold_words((f, hd), reverse=True)
        _, cin, _, _ = _fold_words((band_f, band_t))
        _, cout, _, _ = _fold_words((band_f, band_h), reverse=True)
        if fault == "band_edge_dropped":
            cin, cout = np.zeros_like(cin), np.zeros_like(cout)
        _walk(x, o, pt | (pa & cin[:, :, None]), range(rc), fault)
        _walk(x, o, qh | (qa & cout[:, :, None]), range(rc - 1, -1, -1), fault)
        rows = x.reshape(b, hp, nwl, 32)
        x = _emulated_row_pass(rows, o.reshape(b, hp, nwl, 32), fault).reshape(shape)
    bits = (x.reshape(b, hp, 32 * nwl, 1) >> _LANE.astype(U32)) & U32(1)
    return bits.reshape(b, hp, -1)[:, :h, :w].astype(bool)


def _border(mask):
    border = np.zeros(mask.shape, bool)
    border[:, [0, -1], :] = border[:, :, [0, -1]] = True
    return border & ~mask


def _flood_masks(w, h=200, seed=0):
    """Masks 45% closed (the background's clusters are finite and winding),
    with a ring and bars across bands and words; and interior seeds."""
    rng = np.random.default_rng(seed + w)
    m = rng.random((2, h, w)) < 0.45
    m[0, 20:180, 10:14] = m[0, 20:180, w - 14:w - 10] = True   # a ring across bands and words
    m[0, 20:24, 10:w - 10] = m[0, 176:180, 10:w - 10] = True
    m[1, :, w // 2] = False                                      # an open column and row
    m[1, h // 3, :] = False
    seeds = rng.random((2, h, w)) < 0.002
    return m, seeds


@functools.lru_cache(maxsize=None)
def _pallas_flood_cases(w, n_outer):
    m, seeds = _flood_masks(w)
    fill = np.asarray(fill_holes_pallas(jnp.asarray(m), n_outer=n_outer, interpret=True))
    reach = np.asarray(flood_pallas(jnp.asarray(seeds), jnp.asarray(~m), n_outer=n_outer, interpret=True))
    return m, seeds, fill, reach


@pytest.mark.parametrize("bands", [2, 4, 8])
@pytest.mark.parametrize("n_outer", [1, 2, 3, 4])
@pytest.mark.parametrize("w", [1024, 1030, 33])
def test_emulated_flood_bits_match_plain_and_pallas(w, n_outer, bands):
    """The replay of `flood_bits.cu` on 200-row images (ragged last bands at
    every cluster width; one word a lane at widths 1024 and 33, two at 1030,
    whose last word holds 6 columns) equals the plain versions and the Pallas
    kernels exactly: hole filling (seed: the border's background) and the
    flood of interior seeds."""
    m, seeds, want_fill, want_reach = _pallas_flood_cases(w, n_outer)
    fill = ~_emulated_flood_bits(_border(m), ~m, n_outer, bands)
    np.testing.assert_array_equal(fill, want_fill)
    np.testing.assert_array_equal(fill, cc_cuda.fill_holes_cuda(torch.from_numpy(m), n_outer).numpy())
    reach = _emulated_flood_bits(seeds, ~m, n_outer, bands)
    np.testing.assert_array_equal(reach, want_reach)
    np.testing.assert_array_equal(
        reach, cc_cuda.flood_plain(torch.from_numpy(seeds), torch.from_numpy(~m), n_outer).numpy())


@pytest.mark.parametrize("fault", ["band_edge_dropped", "word_carry_dropped", "open_padding",
                                   "no_remask"])
def test_emulated_flood_bits_fail_planted_faults(fault):
    """Each planted fault changes the flood, after one pass or three, on a
    1030-wide image that exercises it: an open column across all eight bands
    seeded at its top (band carries), an open row across all 33 words seeded
    at its left end (word carries), two open stretches of the last column,
    split by a closed pixel, one seeded (padding treated as open joins them
    through the padding columns), and an open column split by a closed pixel
    (the walk without the mask crosses it)."""
    h, w = 200, 1030
    open_ = np.zeros((1, h, w), bool)
    seed = np.zeros_like(open_)
    open_[0, :, 5] = True                  # across the bands
    open_[0, 10, 20:] = True               # across the words
    open_[0, :60, w - 1] = open_[0, 70:120, w - 1] = True
    open_[0, 30:100, 300] = True           # split at row 50
    open_[0, 50, 300] = False
    seed[0, 0, 5] = seed[0, 10, 20] = seed[0, 0, w - 1] = seed[0, 30, 300] = True
    caught = []
    for n_outer in (1, 3):
        want = cc_cuda.flood_plain(torch.from_numpy(seed), torch.from_numpy(open_), n_outer).numpy()
        np.testing.assert_array_equal(_emulated_flood_bits(seed, open_, n_outer), want)
        caught.append(bool((_emulated_flood_bits(seed, open_, n_outer, fault=fault) != want).any()))
    assert any(caught), caught


@pytest.mark.parametrize("compact", [False, True])
def test_connected_components_converging(rng, compact):
    m = _shapes(rng)
    m[2] = rng.random((64, 96)) > 0.6
    want = np.asarray(jax.vmap(lambda x: jcc.connected_components(x, compact=compact))(
        jnp.asarray(m)))
    got = cc.connected_components(torch.from_numpy(m), compact=compact).numpy()
    np.testing.assert_array_equal(got, want)


def test_iteration_cap_is_per_image(rng):
    """A capped spiral freezes at its own pass count; the other image
    converges — as a vmapped while_loop does."""
    m = _shapes(rng)[:2]
    want = np.asarray(jax.vmap(lambda x: jcc.connected_components(
        x, max_iters=2, compact=False))(jnp.asarray(m)))
    got = cc.connected_components(torch.from_numpy(m), max_iters=2, compact=False).numpy()
    np.testing.assert_array_equal(got, want)


def test_compact_root_labels_gather(rng):
    m = _shapes(rng)
    lab = np.asarray(connected_components_pallas(jnp.asarray(m), n_outer=3, interpret=True))
    want = np.asarray(jax.vmap(jcc.compact_root_labels)(jnp.asarray(lab)))
    got = cc.compact_root_labels(torch.from_numpy(lab.copy())).numpy()
    np.testing.assert_array_equal(got, want)


def test_fill_holes_converging(rng):
    m = _shapes(rng)
    m[2, 20:40, 20:40] = True
    m[2, 25:35, 25:35] = False
    want = np.asarray(jax.vmap(jcc.fill_holes)(jnp.asarray(m)))
    got = cc.fill_holes(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("min_size", [3, 10])
def test_remove_small_objects_window(rng, min_size):
    m = rng.random((2, 48, 64)) > 0.7
    lab = np.asarray(jax.vmap(jcc.connected_components)(jnp.asarray(m)))
    want = np.asarray(jax.vmap(lambda x: jcc.remove_small_objects_window(x, min_size))(
        jnp.asarray(lab)))
    got = cc.remove_small_objects_window(torch.from_numpy(lab.copy()), min_size).numpy()
    np.testing.assert_array_equal(got, want)


def test_morph_open(rng):
    m = rng.random((2, 48, 48)) > 0.45
    want = np.asarray(jax.vmap(jcc.morph_open)(jnp.asarray(m)))
    got = cc.morph_open(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(cc.ELLIPSE_5, jcc.ELLIPSE_5)


@pytest.mark.parametrize("ksize", [11, 21])
def test_sobel(rng, ksize):
    x = rng.random((2, 40, 56)).astype(np.float32)
    for dx, dy in ((1, 0), (0, 1)):
        want = np.asarray(jfilters.sobel(jnp.asarray(x), dx, dy, ksize))
        got = filters.sobel(torch.from_numpy(x), dx, dy, ksize).numpy()
        # coefficients up to 184756 at k=21: compare relative to the range
        scale = np.abs(want).max()
        np.testing.assert_allclose(got / scale, want / scale, atol=2e-6)


def test_gaussian_and_minmax(rng):
    x = rng.random((2, 32, 48)).astype(np.float32)
    np.testing.assert_allclose(filters.gaussian_blur_3x3(torch.from_numpy(x)).numpy(),
                               np.asarray(jfilters.gaussian_blur_3x3(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    x[1] = 0.25  # constant image: normalises to 0
    np.testing.assert_allclose(filters.minmax_normalize(torch.from_numpy(x)).numpy(),
                               np.asarray(jfilters.minmax_normalize(jnp.asarray(x))),
                               atol=1e-7)
    for k in (11, 21):
        for a, b in zip(filters.sobel_kernels_1d(k), jfilters.sobel_kernels_1d(k)):
            np.testing.assert_array_equal(a, b)
