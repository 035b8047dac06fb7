"""PyTorch port, kernels 4 and 5 and the float mode of kernel 3: the plain
versions of ``ops/shear.py`` (``shear_plain``, ``rotate3_plain``,
``rotate3_fused_plain`` on float input) against the JAX package's Pallas
kernels in interpret mode, at the shapes and slopes of
``tests/test_pallas_shear.py``, and the identities the card checks again.

Every comparison is bit-exact: the shears are integer arithmetic on 8.8
fixed point. The CUDA modes run only on the card (``chip_smoke.py`` phase 2
holds them ``torch.equal`` to these plain versions); here the wrappers must
refuse CPU tensors instead of computing the plain version.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp

from dahpe_tpu.ops.pallas.shear import rotate3_fused_pallas, rotate3_pallas, shear_pallas

from dahpe_tpu_torch.ops import shear


def _u16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.uint16))


def _np(t: torch.Tensor) -> np.ndarray:
    return shear.u16_to_i32(t).numpy()


# tests/test_pallas_shear.py: ShX on (3, 70, 66) with kmax 32, ShY on
# (3, 66, 70) with kmax 28
@pytest.mark.parametrize("axis,slope", [(2, 0.0), (2, 0.3), (2, -0.41422), (2, 0.70711),
                                        (1, 0.0), (1, -0.3), (1, 0.70711)])
def test_shear_plain_matches_pallas_kernel(axis, slope):
    rng = np.random.default_rng(0 if axis == 2 else 1)
    shape, kmax = ((3, 70, 66), 32) if axis == 2 else ((3, 66, 70), 28)
    img = rng.integers(0, 65536, shape)
    ref = shear_pallas(jnp.asarray(img, jnp.uint16), jnp.float32(slope), kmax=kmax, axis=axis,
                       interpret=True)
    got = shear.shear(_u16(img)[None], torch.tensor([slope]), kmax=kmax, axis=axis)
    assert got.dtype == torch.uint16
    np.testing.assert_array_equal(_np(got)[0], np.asarray(ref).astype(np.int32))


def test_shear_per_image_slopes_match_vmapped_kernel():
    """A batch with a slope per image is the JAX package's ``vmap``."""
    rng = np.random.default_rng(2)
    imgs = rng.integers(0, 65536, (4, 3, 70, 66))
    slopes = rng.uniform(-0.4, 0.4, 4).astype(np.float32)
    got = _np(shear.shear(_u16(imgs), torch.from_numpy(slopes), kmax=16, axis=2))
    for i in range(4):
        ref = shear_pallas(jnp.asarray(imgs[i], jnp.uint16), jnp.float32(slopes[i]), kmax=16,
                           axis=2, interpret=True)
        np.testing.assert_array_equal(got[i], np.asarray(ref).astype(np.int32))


@pytest.mark.parametrize("shape", [(3, 70, 70), (3, 70, 66)], ids=["square", "70x66"])
@pytest.mark.parametrize("a,b", [(0.0, 0.0), (-0.2, 0.38), (0.41421, -0.70710)])
def test_rotate3_plain_matches_pallas_kernel(shape, a, b):
    """``rotate3_pallas`` (tests/test_pallas_shear.py:54, kmax 30/51), also on
    a non-square canvas."""
    img = np.random.default_rng(4).integers(0, 65536, shape)
    ref = rotate3_pallas(jnp.asarray(img, jnp.uint16), jnp.float32(a), jnp.float32(b),
                         kmax_a=30, kmax_b=51, interpret=True)
    got = shear.rotate3(_u16(img)[None], torch.tensor([a]), torch.tensor([b]),
                        kmax_a=30, kmax_b=51)
    np.testing.assert_array_equal(_np(got)[0], np.asarray(ref).astype(np.int32))


def test_rotate3_is_three_shears():
    rng = np.random.default_rng(7)
    canvas = _u16(rng.integers(0, 65536, (3, 2, 45, 41)))
    a, b = torch.tensor([0.3, -0.41, 0.05]), torch.tensor([-0.7, 0.2, 0.6])
    three = shear.shear(shear.shear(shear.shear(canvas, a, kmax=12, axis=2), b, kmax=20, axis=1),
                        a, kmax=12, axis=2)
    np.testing.assert_array_equal(_np(shear.rotate3(canvas, a, b, kmax_a=12, kmax_b=20)),
                                  _np(three))


def test_fused_rotation_is_crop_of_padded_rotate3():
    """``crop(rotate3(pad(to_fixed(x)))) / 256 == rotate3_fused(x)`` for a
    quarter-turn of 0 (``shear.py:179-184``)."""
    size = 40
    pad, ka, kb = shear.rotation_geometry(size)
    crops = np.random.default_rng(8).integers(0, 256, (2, size, size, 3), dtype=np.uint8)
    a, b = torch.tensor([0.41, -0.2]), torch.tensor([-0.69, 0.38])
    fixed = F.pad(torch.from_numpy(crops).permute(0, 3, 1, 2).to(torch.int32) * 256, (pad,) * 4)
    rotated = shear.rotate3(shear.i32_to_u16(fixed), a, b, kmax_a=ka, kmax_b=kb)
    composed = shear.u16_to_i32(rotated)[..., pad:pad + size, pad:pad + size].float() / 256.0
    fused = shear.rotate3_fused(torch.from_numpy(crops), a, b, torch.zeros(2, dtype=torch.int32),
                                pad=pad, kmax_a=ka, kmax_b=kb)
    assert torch.equal(composed, fused)


@pytest.mark.parametrize("q", [0, 1, 2, 3])
def test_float_mode_matches_pallas_and_uint8_mode(q):
    """Kernel 3's float32 input: the plain version equals
    ``rotate3_fused_pallas`` on float input (non-integral, so the rounding
    to 8.8 is exercised) and, on integral floats, the uint8 mode."""
    size = 40
    pad, ka, kb = shear.rotation_geometry(size)
    rng = np.random.default_rng(10 + q)
    frac = rng.uniform(-3.0, 258.0, (1, size, size, 3)).astype(np.float32)  # clipped ends too
    crops = rng.integers(0, 256, (1, size, size, 3), dtype=np.uint8)
    a, b = np.float32(-0.3), np.float32(0.55)
    kw = dict(pad=pad, kmax_a=ka, kmax_b=kb)
    args = (torch.tensor([a]), torch.tensor([b]), torch.tensor([q], dtype=torch.int32))
    got = shear.rotate3_fused(torch.from_numpy(frac), *args, **kw)[0].numpy()
    x = jnp.rot90(jnp.asarray(frac[0]).transpose(2, 0, 1), k=q, axes=(1, 2))
    ref = rotate3_fused_pallas(x, a, b, interpret=True, **kw)
    np.testing.assert_array_equal(got, np.asarray(ref))
    as_u8 = shear.rotate3_fused(torch.from_numpy(crops), *args, **kw)
    as_f32 = shear.rotate3_fused(torch.from_numpy(crops.astype(np.float32)), *args, **kw)
    assert torch.equal(as_u8, as_f32)


def test_uint16_helpers_round_trip_the_full_range():
    x = torch.tensor([0, 1, 255, 256, 32767, 32768, 40000, 65535], dtype=torch.int32)
    u = shear.i32_to_u16(x)
    assert u.dtype == torch.uint16
    assert torch.equal(shear.u16_to_i32(u), x)


@pytest.mark.parametrize("call", [
    lambda: shear.shear_cuda(torch.zeros((1, 3, 8, 8), dtype=torch.uint16), torch.zeros(1),
                             kmax=4, axis=2),
    lambda: shear.rotate3_cuda(torch.zeros((1, 3, 8, 8), dtype=torch.uint16), torch.zeros(1),
                               torch.zeros(1), kmax_a=4, kmax_b=6),
    lambda: shear.rotate3_fused_cuda(torch.zeros((1, 8, 8, 3)), torch.zeros(1), torch.zeros(1),
                                     torch.zeros(1, dtype=torch.int32), pad=4, kmax_a=4,
                                     kmax_b=6),
], ids=["shear", "rotate3", "rotate3_fused_f32"])
def test_new_modes_never_fall_back(call):
    """The ``*_cuda`` wrappers refuse CPU tensors instead of computing the
    plain version."""
    with pytest.raises(ValueError, match="CUDA"):
        call()


def test_dispatchers_refuse_other_devices_and_dtypes():
    meta = torch.zeros((1, 3, 8, 8), dtype=torch.uint16, device="meta")
    slope = torch.zeros(1, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        shear.shear(meta, slope, kmax=4)
    with pytest.raises(ValueError, match="no kernel"):
        shear.rotate3(meta, slope, slope, kmax_a=4, kmax_b=6)
    with pytest.raises(ValueError, match="uint16"):
        shear.shear(torch.zeros((1, 3, 8, 8), dtype=torch.int32), torch.zeros(1), kmax=4)


# ---- the one-shear kernels (csrc/rotate3.cu: shear_x_kernel, shear_y_kernel),
# transliterated: their index walk, edge zeros and store split, bit for bit
# against shear_plain

A_MAX, B_MAX = np.float32(np.tan(np.pi / 8)), np.float32(np.sin(np.pi / 4))


def _lines(slope, line, n, kmax):
    """``line_shear`` of lines ``line`` of a sheared axis of ``n`` pixels:
    ``(d, w)``, float32 as the kernel computes them."""
    s = np.float32(slope) * (np.asarray(line, np.float32) - np.float32(0.5) * np.float32(n - 1))
    k = np.floor(s)
    d = np.clip(k.astype(np.int64) + kmax, 0, 2 * kmax) - kmax
    w = np.rint((s - k) * np.float32(256)).astype(np.int64)
    return d, w


def _blend(lo, hi, w):
    return (lo * (256 - w) + hi * w + 128) >> 8


def _funnel_r(lo, hi, sh):
    """``__funnelshift_r``: the low 32 bits of ``(hi:lo) >> sh``."""
    return ((int(hi) << 32 | int(lo)) >> sh) & 0xFFFFFFFF


def _shear_x_blocks(canvas, slopes, kmax, src_phase, dst_phase):
    """``shear_x_kernel`` thread by thread on a flat canvas whose first
    element sits at 2-byte index ``src_phase`` (mod 4) of memory, writing an
    output whose first element sits at ``dst_phase``: per thread (line, group
    j) and plane, ``x0 = 4 j - phase of the output row``; the two aligned
    words behind taps ``x0 + d .. x0 + d + 4`` and the funnel shifts, or the
    taps one by one at the row's edges; one aligned 4-pixel store, or
    pixel stores. Memory outside the canvas holds a sentinel that must
    never reach a result. Returns the output and each pixel's store count."""
    b_, c_, h, w = canvas.shape
    flat = canvas.reshape(-1).astype(np.int64)
    sentinel = 0xBEEF
    padded = np.concatenate([np.full(8, sentinel), flat, np.full(8, sentinel)])
    out = np.full(flat.shape, -1, np.int64)
    stores = np.zeros(flat.shape, np.int64)
    groups = shear.shear_x_groups(w)
    d_all, w_all = _lines(slopes[:, None], np.arange(h)[None, :], h, kmax)  # (B, H)
    for g in range(b_ * h * groups):
        j, line = g % groups, g // groups
        y, b = line % h, line // h
        d, wt = int(d_all[b, y]), int(w_all[b, y])
        for c in range(c_):
            row = ((b * c_ + c) * h + y) * w
            x0 = 4 * j - (dst_phase + row) % 4
            if x0 >= w:
                continue
            s0 = x0 + d
            if s0 >= 0 and s0 + 4 < w:
                r = (src_phase + row + s0) % 4
                e = padded[8 + row + s0 - r: 8 + row + s0 - r + 8]
                words = [int(e[2 * i]) | int(e[2 * i + 1]) << 16 for i in range(4)]
                upper, sh = r >= 2, (r & 1) * 16
                w0, w1, w2 = (words[1], words[2], words[3]) if upper else words[:3]
                e01, e23 = _funnel_r(w0, w1, sh), _funnel_r(w1, w2, sh)
                v = [e01 & 0xFFFF, e01 >> 16, e23 & 0xFFFF, e23 >> 16, (w2 >> sh) & 0xFFFF]
                assert sentinel not in v or (flat[row + s0: row + s0 + 5] == sentinel).any()
            else:
                v = [int(flat[row + s0 + i]) if 0 <= s0 + i < w else 0 for i in range(5)]
            o = [_blend(v[i], v[i + 1], wt) for i in range(4)]
            if x0 >= 0 and x0 + 4 <= w:
                assert (dst_phase + row + x0) % 4 == 0  # the 8-byte store is aligned
                out[row + x0: row + x0 + 4] = o
                stores[row + x0: row + x0 + 4] += 1
            else:
                for i in range(4):
                    if 0 <= x0 + i < w:
                        out[row + x0 + i] = o[i]
                        stores[row + x0 + i] += 1
    return out.reshape(canvas.shape), stores.reshape(canvas.shape)


def _shear_y_blocks(canvas, slopes, kmax, pairs=None):
    """``shear_y_kernel`` block by block (a block per tile of one plane),
    vectorized over a block's threads: the window of input rows ``[lo, hi]``
    from the tile's end columns, cut to ``[-1, H]``, staged with zeros
    outside the canvas (a thread ``per`` adjacent columns), then each
    thread's columns sliding down their taps over its run of ``rows / 8``
    consecutive rows (rows clamped to ``[-1, H]``); a tile whose window
    exceeds the plan's capacity reads its taps from the canvas. Returns the
    output, each pixel's store count and the tiles on the direct walk."""
    b_, c_, h, w = canvas.shape
    plan = shear.shear_y_plan(h, w, kmax, pairs)
    rows, capacity, cols = plan["rows"], plan["capacity"], plan["cols"]
    per_thread, run = cols // shear.SHEAR_COLS, rows // shear.SHEAR_ROW_STEP
    out = np.full(canvas.shape, -1, np.int64)
    stores = np.zeros(canvas.shape, np.int64)
    direct = 0
    tiles_x, tiles_y = plan["tiles"]
    lane = np.arange(cols)  # the window's columns: thread lane // per_thread
    for z in range(b_ * c_):
        b, c = divmod(z, c_)
        plane = canvas[b, c].astype(np.int64)
        for by in range(tiles_y):
            for bx in range(tiles_x):
                x0, y0 = bx * cols, by * rows
                y_end = min(y0 + rows, h)
                xs = x0 + lane
                valid = xs < w
                d, wt = _lines(slopes[b], xs, w, kmax)
                ends, _ = _lines(slopes[b], [x0, min(x0 + cols, w) - 1], w, kmax)
                lo = min(max(y0 + int(ends.min()), -1), h)
                hi = max(min(y_end + int(ends.max()), h), -1)
                span = hi - lo + 1
                if span > capacity:
                    direct += 1
                else:
                    rws = lo + np.arange(span)
                    inside = (rws >= 0) & (rws < h)
                    window = np.zeros((span, cols), np.int64)
                    window[np.ix_(inside, valid)] = plane[np.ix_(rws[inside], xs[valid])]
                for ty in range(shear.SHEAR_ROW_STEP):
                    ys, ye = y0 + ty * run, min(y0 + ty * run + run, y_end)
                    if ys >= ye:
                        continue
                    r = ys + d
                    if span <= capacity:  # columns past the canvas compute nothing
                        i0 = np.where(valid, np.clip(r, -1, h) - lo, 0)
                        assert (i0 >= 0).all() and (i0 < span).all()
                        u = window[i0, lane]
                    for y in range(ys, ye):
                        if span > capacity:
                            ok0, ok1 = (r >= 0) & (r < h), (r + 1 >= 0) & (r + 1 < h)
                            col = np.minimum(xs, w - 1)
                            u = np.where(ok0, plane[np.clip(r, 0, h - 1), col], 0)
                            v = np.where(ok1, plane[np.clip(r + 1, 0, h - 1), col], 0)
                        else:
                            i1 = np.where(valid, np.clip(r + 1, -1, h) - lo, 0)
                            assert (i1 >= 0).all() and (i1 < span).all()
                            v = window[i1, lane]
                        out[b, c, y, xs[valid]] = _blend(u, v, wt)[valid]
                        stores[b, c, y, xs[valid]] += 1
                        u, r = v, r + 1
    return out, stores, direct


SHEAR_CASES = {  # (B, C, H, W), kmax, slopes
    "path extremes": ((2, 3, 23, 37), 9, [A_MAX, -B_MAX]),
    "beyond the caps": ((2, 3, 23, 37), 9, [1.7, -2.6]),
    "odd W, 1 channel": ((3, 1, 17, 31), 12, [0.3, -0.7, 0.05]),
    "5 channels": ((1, 5, 12, 20), 6, [-0.41]),
    "kmax > canvas": ((2, 2, 9, 14), 40, [5.0, -9.5]),
    "W < 4": ((2, 2, 6, 3), 4, [0.9, -0.4]),
}


@pytest.mark.parametrize("phases", [(0, 0), (1, 3), (2, 1), (3, 2)],
                         ids=["aligned", "src 1 dst 3", "src 2 dst 1", "src 3 dst 2"])
@pytest.mark.parametrize("name", list(SHEAR_CASES))
def test_shear_x_blocks_match_plain(name, phases):
    """The ShX kernel's walk stores each output pixel once and gives
    ``shear_plain``'s canvas bit for bit, for rows at every phase of the
    input and output words (W not a multiple of 4 shifts the phase from row
    to row), at the path's slopes and beyond, with kmax above the canvas."""
    shape, kmax, slopes = SHEAR_CASES[name]
    canvas = np.random.default_rng(len(name)).integers(0, 65536, shape)
    slopes = np.asarray(slopes, np.float32)
    got, stores = _shear_x_blocks(canvas, slopes, kmax, *phases)
    ref = shear.shear_plain(_u16(canvas), torch.from_numpy(slopes), kmax=kmax, axis=2)
    assert (stores == 1).all()
    np.testing.assert_array_equal(got, _np(ref))


@pytest.mark.parametrize("name", list(SHEAR_CASES) + ["direct walk"])
def test_shear_y_blocks_match_plain(name):
    """The ShY kernel's tiles store each output pixel once and give
    ``shear_plain``'s canvas bit for bit, with two columns a thread (even
    widths) and one; every tap lies in the tile's window; only a tile whose
    window passes the capacity (here a canvas of 1100 rows at kmax 700 and
    slope ±300) takes the direct walk."""
    if name == "direct walk":
        shape, kmax, slopes = (2, 1, 1100, 6), 700, [300.0, -300.0]
    else:
        shape, kmax, slopes = SHEAR_CASES[name]
    canvas = np.random.default_rng(len(name) + 1).integers(0, 65536, shape)
    slopes = np.asarray(slopes, np.float32)
    ref = shear.shear_plain(_u16(canvas), torch.from_numpy(slopes), kmax=kmax, axis=1)
    for pairs in (True, False) if shape[-1] % 2 == 0 else (False,):
        got, stores, direct = _shear_y_blocks(canvas, slopes, kmax, pairs)
        assert (stores == 1).all()
        np.testing.assert_array_equal(got, _np(ref))
        assert (direct > 0) == (name == "direct walk")


@pytest.mark.parametrize("height,width,kmax", [(412, 412, 147), (412, 412, 87), (300, 412, 147),
                                               (257, 301, 147), (257, 301, 600), (40, 9, 300)],
                         ids=["412² kmax_b", "412² kmax_a", "300x412", "257x301",
                              "257x301 kmax 600", "kmax > H"])
def test_shear_y_plan_covers_every_tap(height, width, kmax):
    """The ShY plan's window, a numpy copy of the kernel's, holds every tap
    ``shear_plain`` reads for every tile, within the capacity the plan
    allocates, at the path's slopes and beyond the caps (|slope| <= 2, no
    tile on the direct walk) and beyond the canvas (a steeper slope may send
    a tile on the direct walk only where the plan cuts the capacity); the
    capacity stays within ``SHEAR_WINDOW_BYTES`` for every kmax."""
    plan = shear.shear_y_plan(height, width, kmax)
    rows, cols = plan["rows"], plan["cols"]
    assert plan["pairs"] == (width % 2 == 0) and cols == shear.SHEAR_COLS * (1 + plan["pairs"])
    assert rows % shear.SHEAR_ROW_STEP == 0 and rows <= shear.SHEAR_ROWS
    assert plan["tiles"][1] == -(-height // rows) and plan["tiles"][1] * rows - height < rows
    for slope in (A_MAX, -A_MAX, B_MAX, -B_MAX, 1.4, -2.0, 7.5, -30.0):
        d_all, _ = _lines(slope, np.arange(width), width, kmax)
        for x0 in range(0, width, cols):
            d = d_all[x0:x0 + cols]
            assert (np.diff(d) * np.sign(slope) >= 0).all()  # monotone along the columns
            for y0 in range(0, height, rows):
                y = np.arange(y0, min(y0 + rows, height))[:, None]
                lo = min(max(y0 + min(d[0], d[-1]), -1), height)
                hi = max(min(y[-1, 0] + 1 + max(d[0], d[-1]), height), -1)
                taps = np.clip(np.concatenate([y + d, y + d + 1]), -1, height)
                assert (taps >= lo).all() and (taps <= hi).all()
                fits = hi - lo + 1 <= plan["capacity"]
                assert fits or (plan["direct_possible"] and abs(slope) > 2.0)
    for k in range(0, 4000, 7):
        p = shear.shear_y_plan(height, width, k)
        assert p["shared_bytes"] == 2 * p["cols"] * p["capacity"] <= shear.SHEAR_WINDOW_BYTES
