"""Port parity for the correlative matcher: tpu_slam_torch's host helpers,
grid build, response numerators (the plain version of the
correlative_response kernel), FindValidPoints, correlate pass and the
matcher's entry points, against tpu_slam's on the same seeded inputs. The
JAX side runs compiled (``jax.jit``), as the reference's matcher does, so
that both sides compute in the same float32 arithmetic; its Pallas kernel
runs in interpret mode, as test_correlative.py runs it."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_slam.ops import correlative as J
from tpu_slam.ops.pallas.correlative_response import responses_sliced_pallas
from tpu_slam_torch import _dispatch
from tpu_slam_torch.ops import correlative as T
from tpu_slam_torch.ops.cuda import correlative_response as K

from test_correlative import match_setup, params  # noqa: F401  (fixture)

POSE_ATOL = 1e-5
RESP_ATOL = 1e-6
COV_RTOL = 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _port_params(p):
    return T.CorrelativeParams(**dataclasses.asdict(p))


def _cells(rng, n, r_max, res):
    r = rng.uniform(0.3, r_max, n)
    th = rng.uniform(-np.pi, np.pi, n)
    return (np.stack([r * np.cos(th), r * np.sin(th)], -1) / res).astype(
        np.float32)


@pytest.mark.parametrize("p", [params(), params(search=8.0, res=0.05),
                               params(search=0.3, res=0.01, rng_th=12.0)])
def test_params_and_smear_tables_are_the_same(p):
    tp = _port_params(p)
    for name in ("n_search", "margin", "half_kernel", "grid_size",
                 "row_stride", "center_cell"):
        assert getattr(tp, name) == getattr(p, name), name
    np.testing.assert_array_equal(T.smear_kernel(tp), J.smear_kernel(p))
    np.testing.assert_array_equal(T.smear_lut(tp), J.smear_lut(p))
    assert T._pyround(-2.5) == J._pyround(-2.5) == -3
    assert T._align8(13) == J._align8(13) == 16


def test_reference_float32_arithmetic_is_bit_equal():
    """sincosf and atan2f give the bits of XLA's sin, cos and atan2 on the
    CPU (glibc's sinf, cosf and atan2f)."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(-4.5, 4.5, 40_000),
                        rng.uniform(-1e-3, 1e-3, 2_000),
                        [0.0, -0.0, 2.0**-13, np.pi / 2]]).astype(np.float32)
    s, c = T.sincosf(_t(x))
    np.testing.assert_array_equal(s.numpy(), np.asarray(jax.jit(jnp.sin)(x)))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jax.jit(jnp.cos)(x)))
    y = np.concatenate([rng.uniform(-1, 1, 40_000), [0.0, -0.0, 1.0, 0.0],
                        rng.uniform(-1e-4, 1e-4, 2_000)]).astype(np.float32)
    xx = np.concatenate([rng.uniform(-1, 1, 40_000), [-1.0, -1.0, 0.0, 1.0],
                         rng.uniform(-1, 1, 2_000)]).astype(np.float32)
    np.testing.assert_array_equal(
        T.atan2f(_t(y), _t(xx)).numpy(),
        np.asarray(jax.jit(jnp.arctan2)(y, xx)))


def test_build_correlation_grid_is_int_equal():
    rng = np.random.default_rng(1)
    for p, k in ((params(), 3000), (params(search=4.0, res=0.05), 1500)):
        tp = _port_params(p)
        build = jax.jit(J.build_correlation_grid, static_argnums=0)
        lanes = []
        for lane in range(3):
            pts = rng.uniform(-6, 6, (k, 2)).astype(np.float32)
            valid = rng.random(k) > 0.1
            center = rng.uniform(-1, 1, 2).astype(np.float32)
            ref = np.asarray(build(p, center, pts, valid))
            got = T.build_correlation_grid(tp, _t(center), _t(pts),
                                           _t(valid)).numpy()
            np.testing.assert_array_equal(got, ref)
            lanes.append((pts, valid, center, ref))
        # lanes share the grid centre in the matcher: a (C, K) batch
        pts = np.stack([lv[0] for lv in lanes])
        valid = np.stack([lv[1] for lv in lanes])
        center = lanes[0][2]
        got = T.build_correlation_grid(tp, _t(center), _t(pts), _t(valid))
        for c in range(3):
            ref = np.asarray(build(p, center, pts[c], valid[c]))
            np.testing.assert_array_equal(got[c].numpy(), ref)


def _response_case(rng, lanes, edge):
    """A grid (C, g, w8) of random values 0..100, 10% invalid beams, 9
    headings per lane, and first candidates by ``edge``: by the centre with
    points out to 4.5 m (every window inside the grid), or by every high
    edge ("high") or every low edge, starts below 0 included ("low"), with
    points out to 5.8 m, past the 5 m threshold, so windows leave the
    grid."""
    p = params()
    g, w8 = p.grid_size, p.row_stride
    grid = np.zeros((lanes, g, w8), np.int32)
    grid[:, :, :g] = rng.integers(0, 101, (lanes, g, g))
    n = 97
    pc = _cells(rng, n, 4.5 if edge == "centre" else 5.8, p.resolution)
    valid = rng.random(n) > 0.1
    angles = (rng.uniform(-np.pi, np.pi, (lanes, 1))
              + np.linspace(-0.3, 0.3, 9)).astype(np.float32)
    if edge == "centre":
        cand0 = np.full((lanes, 2), p.center_cell - 16, np.int32)
    elif edge == "high":
        cand0 = np.stack([np.full(lanes, w8 - 20), np.full(lanes, g - 12)],
                         -1).astype(np.int32)
    else:
        cand0 = rng.integers(-6, 6, (lanes, 2)).astype(np.int32)
    return grid, pc, valid, angles, cand0


@pytest.mark.parametrize("lanes", [1, 8])
@pytest.mark.parametrize("edge", ["centre", "high", "low"])
@pytest.mark.parametrize("lattice", [(16, 16, 2), (3, 3, 1), (11, 7, 3)])
def test_responses_sliced_is_int_equal(lanes, edge, lattice):
    """Against the reference's XLA ``_responses_sliced`` lane by lane, and
    against its Pallas kernel in interpret mode wherever no window start is
    negative (see test_negative_starts_wrap_as_the_xla_path_does)."""
    n_x, n_y, stride = lattice
    rng = np.random.default_rng([lanes, len(edge), *lattice])
    grid, pc, valid, angles, cand0 = _response_case(rng, lanes, edge)
    got = T._responses_sliced(_t(grid), _t(pc), _t(valid), _t(angles),
                              _t(cand0), n_x, n_y, stride).numpy()
    assert got.shape == (lanes, angles.shape[1], n_x * n_y)
    single = T._responses_sliced(_t(grid[0]), _t(pc), _t(valid),
                                 _t(angles[0]), _t(cand0[0]), n_x, n_y,
                                 stride).numpy()
    np.testing.assert_array_equal(single, got[0])
    for c in range(lanes if lanes == 1 else 3):
        args = (jnp.asarray(grid[c]), jnp.asarray(pc), jnp.asarray(valid),
                jnp.asarray(angles[c]), jnp.asarray(cand0[c]))
        ref = np.asarray(J._responses_sliced(*args, n_x, n_y, stride))
        np.testing.assert_array_equal(got[c], ref)
        if edge != "low":
            pal = np.asarray(responses_sliced_pallas(
                *args, n_x, n_y, stride, interpret=True))
            np.testing.assert_array_equal(got[c], pal)


def test_gather_path_is_int_equal():
    """The random-gather numerators of candidates that are not a lattice
    (``_responses_for_angles``) against the reference's, lane by lane, and
    against the window path on a lattice, as test_correlative.py holds the
    reference's two paths to each other."""
    p = params(search=1.6, res=0.05, rng_th=3.0)
    g, w8 = p.grid_size, p.row_stride
    rng = np.random.default_rng(7)
    grid = np.zeros((2, g, w8), np.int32)
    grid[:, :, :g] = rng.integers(0, 101, (2, g, g))
    n = 96
    pc = _cells(rng, n, 2.9, p.resolution)
    valid = rng.random(n) > 0.1
    angles = np.stack([np.linspace(-0.3, 0.3, 9)] * 2).astype(np.float32)
    n_xy, stride = p.n_search // 2, 2
    cand0 = np.full((2, 2), p.center_cell - (n_xy // 2) * stride, np.int32)
    cells = np.arange(n_xy) * stride + int(cand0[0, 0])
    flat = (cells[:, None] * w8 + cells[None, :]).reshape(-1)
    flat = np.stack([flat, flat + 3 * w8 - 40])  # lane 1 runs off the rows
    got = T._responses_for_angles(_t(grid).reshape(2, -1), g, w8, _t(pc),
                                  _t(valid), _t(angles), _t(flat))
    for c in range(2):
        ref = J._responses_for_angles(
            jnp.asarray(grid[c]).reshape(-1), g, w8, jnp.asarray(pc),
            jnp.asarray(valid), jnp.asarray(angles[c]), jnp.asarray(flat[c]))
        np.testing.assert_array_equal(got[c].numpy(), np.asarray(ref))
    sliced = T._responses_sliced(_t(grid[:1]), _t(pc), _t(valid),
                                 _t(angles[:1]), _t(cand0[:1]), n_xy, n_xy,
                                 stride)
    np.testing.assert_array_equal(got[0].numpy(), sliced[0].numpy())


def test_negative_starts_wrap_as_the_xla_path_does():
    """A window start below 0 counts from the end of the axis in the
    reference's ``_responses_sliced`` (``jax.lax.dynamic_slice`` wraps a
    negative index, then clamps), while its Pallas kernel clamps it to 0.
    The port follows ``_responses_sliced``; the two reference paths differ
    here, and only here."""
    p = params()
    g, w8 = p.grid_size, p.row_stride
    rng = np.random.default_rng(5)
    grid = np.zeros((g, w8), np.int32)
    grid[:, :g] = rng.integers(0, 101, (g, g))
    pc = np.array([[-30.0, -40.0], [10.0, 12.0]], np.float32)
    valid = np.array([True, True])
    angles = np.zeros(1, np.float32)
    cand0 = np.array([5, 5], np.int32)  # beam 0 starts at (-25, -35)
    args = (jnp.asarray(grid), jnp.asarray(pc), jnp.asarray(valid),
            jnp.asarray(angles), jnp.asarray(cand0))
    ref = np.asarray(J._responses_sliced(*args, 4, 4, 2))
    pal = np.asarray(responses_sliced_pallas(*args, 4, 4, 2, interpret=True))
    got = T._responses_sliced(_t(grid), _t(pc), _t(valid), _t(angles),
                              _t(cand0), 4, 4, 2).numpy()
    np.testing.assert_array_equal(got, ref)
    ys, xs = T.window_starts(_t(pc), _t(valid), _t(angles)[None],
                             _t(cand0)[None], g, w8, 4, 4, 2)
    assert (int(ys[0, 0, 0]), int(xs[0, 0, 0])) == (g - 35, w8 - 25)
    win = grid[g - 35:g - 28:2, w8 - 25:w8 - 18:2] + grid[17:24:2, 15:22:2]
    np.testing.assert_array_equal(got[0], win.reshape(-1))
    assert not np.array_equal(pal, ref)


def test_kernel_wrapper_runs_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(3)
    grid, pc, valid, angles, cand0 = _response_case(rng, 2, "low")
    g8 = _t(grid).to(torch.uint8)
    ys, xs = T.window_starts(_t(pc), _t(valid), _t(angles), _t(cand0),
                             grid.shape[1], grid.shape[2], 16, 16, 2)
    before = dict(_dispatch.LAUNCHES)
    got = K.responses_sliced(g8, ys, xs, _t(valid), 16, 16, 2)
    assert _dispatch.LAUNCHES == before
    np.testing.assert_array_equal(
        got.numpy(), T.sum_windows(_t(grid), ys, xs, _t(valid), 16, 16,
                                   2).numpy())
    # no valid beam: every numerator is 0
    none = torch.zeros_like(_t(valid))
    assert not K.responses_sliced(g8, ys, xs, none, 16, 16, 2).any()
    with pytest.raises(ValueError):
        K.responses_sliced(g8.to("meta"), ys, xs, _t(valid), 16, 16, 2)


# --- the redesigned kernel's launch geometry and arithmetic ----------------
#
# The pass shapes (lanes, headings, nx = ny, stride, beams, grid width)
# that the main
# paths give the kernel: the Karto recipe's front coarse and fine and loop
# coarse passes, a 16² coarse pass of 8 lanes, a 4,000-beam one, and the
# outdoor mission's long and short anchor passes, coarse and fine.
PASS_SHAPES = [(1, 21, 16, 2, 359, 2448), (1, 11, 3, 1, 359, 2448),
               (8, 21, 81, 2, 359, 648), (8, 21, 16, 2, 359, 648),
               (1, 81, 16, 2, 4000, 2448), (8, 21, 41, 2, 360, 5096),
               (8, 11, 3, 1, 360, 5096), (8, 21, 4, 2, 360, 2016),
               (8, 11, 3, 1, 1500, 2016)]


def _block_outputs(geo, C, A, nx, ny, stride):
    """Every output index each block's threads write, as the kernel's
    write-out picks them: (block, flat output) pairs. The row path writes
    its tile's whole rows, the byte path each strip's candidates inside
    its row."""
    srow = geo.strips_row(nx, stride)
    tiles = -(-ny * srow // geo.strips)
    b = np.arange(C * A * tiles)
    tile, ca = b % tiles, b // tiles
    if geo.R == 0:
        rows = geo.strips // srow
        y = tile[:, None] * rows + np.arange(rows)  # (blocks, rows)
        flat = (ca[:, None, None] * nx * ny + y[..., None] * nx
                + np.arange(nx))
        own = np.broadcast_to((y < ny)[..., None], flat.shape)
    else:
        e = np.arange(geo.strips * geo.R)
        st = tile[:, None] * geo.strips + e // geo.R  # (blocks, outputs)
        y, x = st // srow, st % srow * geo.R + e % geo.R
        own = (y < ny) & (x < nx)
        flat = ca[:, None] * nx * ny + y * nx + x
    blk = np.broadcast_to(b.reshape((-1,) + (1,) * (flat.ndim - 1)),
                          flat.shape)
    return blk[own], flat[own]


def _stage_slots(flags, geo):
    """The valid beams of one staged round, slot by slot, as the kernel
    stages them: the row path by class (bucketed after; here in raw
    order), the byte path by thread t taking beams t, t + threads, ...
    and a block-wide scan of the threads' counts."""
    n = np.flatnonzero(flags)
    if geo.R == 0:
        return n
    t, i = n % geo.threads, n // geo.threads
    return n[np.lexsort((i, t))]


@pytest.mark.parametrize("sms", [132, 16])
@pytest.mark.parametrize("shape", PASS_SHAPES)
def test_response_geometry_covers_every_output_and_beam_once(shape, sms):
    """Every (lane, heading, candidate) is written by exactly one block,
    and every valid beam of a round is staged in one slot and summed by
    exactly one slice of each strip; one launch a pass, so each output is
    written once and nothing needs zeroing."""
    from tpu_slam_torch import _build

    C, A, n, stride, N, W = shape
    geo = K.response_geometry(C, A, W, n, n, stride, N, sms)
    assert geo.threads % 32 == 0 and geo.smem(stride) <= (
        _build.SMEM_PER_BLOCK)
    assert geo.strips * geo.slices <= geo.threads <= K.MAX_THREADS
    if geo.R == 0:  # whole rows of chunks, one slice, strides 1 and 2
        assert stride in (1, 2) and stride * W % 8 == 0 and geo.slices == 1
        assert geo.strips % geo.strips_row(n, stride) == 0
    else:
        assert geo.R in K.BYTES
    blk, flat = _block_outputs(geo, C, A, n, n, stride)
    counts = np.bincount(flat, minlength=C * A * n * n)
    assert counts.min() == 1 and counts.max() == 1
    # one block writes one (lane, heading): the lane-major order
    tiles = geo.blocks(C, A, n, n, stride) // (C * A)
    assert np.array_equal(blk // tiles, flat // (n * n))
    # every valid beam of a round in one slot, summed by one slice
    rng = np.random.default_rng(N)
    for n0 in range(0, N, K.STAGE):
        flags = rng.random(min(N, n0 + K.STAGE) - n0) > 0.1
        beams = _stage_slots(flags, geo)
        assert np.array_equal(np.sort(beams), np.flatnonzero(flags))
        count = len(beams)
        bounds = [k * count // geo.slices for k in range(geo.slices + 1)]
        summed = np.concatenate([np.arange(bounds[k], bounds[k + 1])
                                 for k in range(geo.slices)])
        assert np.array_equal(summed, np.arange(count))


def _prmt(lo, hi, sel):
    """PTX ``prmt.b32`` in its default mode: byte i of the result is byte
    (sel nibble i & 7) of {hi:lo}, or that byte's sign replicated where
    the nibble's bit 3 is set."""
    src = torch.stack([(w >> (8 * b)) & 255 for w in (lo, hi)
                       for b in range(4)])
    out = torch.zeros_like(lo)
    for i in range(4):
        nib = (sel >> (4 * i)) & 15
        byte = torch.gather(src, 0, (nib & 7)[None])[0]
        byte = torch.where((nib & 8) != 0,
                           torch.where(byte >= 128, 255, 0), byte)
        out |= byte << (8 * i)
    return out


def _pair_sel(b0, b1):
    return b0 | (8 | b0) << 4 | b1 << 8 | (8 | b1) << 12


def kernel_model(grid, ys, xs, valid, nx, ny, stride, geo, mis=0):
    """A plain torch model of ``csrc/correlative_response.cu``'s
    arithmetic, thread by thread: the lane grids as one byte buffer that
    starts ``mis`` bytes past an 8-byte boundary, the staged origins of
    the valid beams (invalid ones compacted away), and each path's sums.
    The row path: each thread's aligned 8-byte chunk of its row (loaded
    only where it holds bytes of the beam's window), its bytes taken in
    pairs by PRMT into the 16-bit halves of the sums of the beam's class
    (the window's start in its first chunk), the halves flushed at the
    end of each round of STAGE staged beams, and each candidate's sum over
    the classes. The byte path: a byte load a candidate inside the
    lattice, pairs in 16-bit halves, the beam slices and their sum.
    Checks that every chunk loaded holds a byte of the grid and that every
    output is written once."""
    C, H, W = grid.shape
    A, N = ys.shape[1:]
    R, G, Ks, T = geo.R, geo.strips, geo.slices, geo.threads
    mem = torch.cat([torch.zeros(mis, dtype=torch.int64),
                     grid.reshape(-1).to(torch.int64),
                     torch.zeros(64, dtype=torch.int64)])
    end = mis + C * H * W  # one past the grid's last byte

    def chunk(addr):
        """The 2 words of the 8-byte chunk at ``addr``: (P,) each."""
        assert int((addr % 8).abs().max()) == 0
        assert int(addr.min()) + 7 >= mis and int(addr.max()) < end, \
            "an 8-byte chunk that holds no byte of the grid"
        return [sum(mem[addr + 4 * w + b] << (8 * b) for b in range(4))
                for w in range(2)]

    srow = geo.strips_row(nx, stride)
    tiles = -(-ny * srow // G)
    blocks = C * A * tiles
    b, t = torch.meshgrid(torch.arange(blocks), torch.arange(T),
                          indexing="ij")
    b, t = b.reshape(-1), t.reshape(-1)
    ca, tile = b // tiles, b % tiles
    c, a = ca // A, ca % A
    s, k = t % G, t // G
    strip = tile * G + s
    work = (k < Ks) & (strip < ny * srow)
    y = torch.where(work, strip // srow, 0)
    j = torch.where(work, strip % srow, 0)
    base = mis + c * H * W
    gb = base & ~7
    rel = (base & 7) + y * stride * W + (j * R * stride if R else 0)
    ymax, xmax = H - ((ny - 1) * stride + 1), W - ((nx - 1) * stride + 1)
    origin_all = (ys.to(torch.int64).clamp(0, ymax) * W
                  + xs.to(torch.int64).clamp(0, xmax))  # (C, A, N)
    slots = 8 // stride if R == 0 else 1
    rows_p = torch.arange(len(b))

    def thread_sums():
        """Each thread's sums: (P, CLASSES, slots) on the row path, (P,
        R) on the byte path."""
        sums = torch.zeros((len(b), K.CLASSES, slots), dtype=torch.int64)
        acc = torch.zeros((len(b), max(R, 1)), dtype=torch.int64)
        for n0 in range(0, N, K.STAGE):
            n1 = min(N, n0 + K.STAGE)
            lists = [torch.as_tensor(_stage_slots(valid[cc, n0:n1].numpy(),
                                                  geo) + n0)
                     for cc in range(C)]
            count = torch.tensor([len(x) for x in lists])[c]
            table = torch.zeros((C, max(1, int(count.max()))),
                                dtype=torch.int64)
            for cc, x in enumerate(lists):
                table[cc, :len(x)] = x
            lo, hi = k * count // Ks, (k + 1) * count // Ks
            lo, hi = torch.where(work, lo, 0), torch.where(work, hi, 0)
            pk = torch.zeros((len(b), K.CLASSES if R == 0 else 1,
                              max(slots, R) // 2), dtype=torch.int64)
            for i in range(int((hi - lo).max())):
                on = i < hi - lo
                n = table[c, torch.where(on, lo + i, 0)]
                off = origin_all[c, a, n] + rel
                if R == 0:
                    cls = off & 7
                    # a chunk is loaded only where it holds window bytes
                    on = on & (8 * j <= cls + stride * (nx - 1))
                    addr = gb + (off & ~7) + 8 * j
                    lo_w, hi_w = chunk(torch.where(on, addr, mis & ~7))
                    for q in range(slots // 2):
                        if stride == 2:
                            p0 = (cls & 1) + 4 * q
                            sel = _pair_sel(p0, p0 + 2)
                        else:
                            sel = torch.full_like(
                                cls, _pair_sel(2 * q, 2 * q + 1))
                        pair = _prmt(lo_w, hi_w, sel)
                        pk[rows_p, cls, q] += torch.where(on, pair, 0)
                else:
                    left = nx - j * R
                    for q in range(R // 2):
                        for h in range(2):
                            i_c = 2 * q + h
                            inside = on & (i_c < left)
                            addr = torch.where(
                                inside, gb + off + i_c * stride, mis)
                            pk[:, 0, q] += torch.where(
                                inside, mem[addr], 0) << (16 * h)
                pk &= 0xFFFFFFFF  # a 32-bit register
            # the halves flushed into int32 at the end of the round
            if R == 0:
                sums[..., 0::2] += pk & 0xFFFF
                sums[..., 1::2] += pk >> 16
            else:
                acc[:, 0::2] += pk[:, 0] & 0xFFFF
                acc[:, 1::2] += pk[:, 0] >> 16
        return sums if R == 0 else acc

    per_thread = thread_sums()
    out = torch.zeros(C * A * ny * nx, dtype=torch.int64)
    written = torch.zeros_like(out)

    def write(idx, val):
        out.index_put_((idx,), val, accumulate=True)
        written.index_put_((idx,), torch.ones_like(idx), accumulate=True)

    if R == 0:
        # candidate i of row y: byte O + stride * i of the row's chunks, in
        # class O's sums of the chunk's thread
        sums = per_thread
        rows = G // srow
        bb = torch.arange(blocks)[:, None, None]
        yl = torch.arange(rows)[None, :, None]
        i = torch.arange(nx)[None, None, :]
        yy = (bb % tiles) * rows + yl
        total = torch.zeros(yy.shape[0], rows, nx, dtype=torch.int64)
        for o in range(K.CLASSES):
            byte = o + stride * i
            th = bb * T + yl * srow + (byte >> 3)
            total += sums[th, o, (byte & 7) >> (stride - 1)]
        inside = (yy < ny).expand_as(total)
        idx = ((bb // tiles) * ny * nx + yy * nx + i).expand_as(total)
        write(idx[inside], total[inside])
    else:
        # the slices' sums; each candidate inside its row written once
        part = torch.zeros((blocks * G, R), dtype=torch.int64)
        part.index_add_(0, (b * G + s)[work], per_thread[work])
        part = part.view(blocks, G * R)  # (block, e = strip * R + i)
        e = torch.arange(G * R)
        st = (torch.arange(blocks) % tiles)[:, None] * G + e // R
        yy, xx = st // srow, st % srow * R + e % R
        own = (yy < ny) & (xx < nx)
        idx = (torch.arange(blocks) // tiles)[:, None] * ny * nx \
            + yy * nx + xx
        write(idx[own], part[own])
    assert int(written.min()) == 1 and int(written.max()) == 1
    return out.to(torch.int32).view(C, A, ny * nx)


# the seven pass shapes scaled down (lanes, headings, nx, ny, stride, grid
# side), each at some of the beam counts and lane strides, strides 1-3 and
# lattices that R does not divide
MODEL_CASES = [
    # (C, A, nx, ny, stride, side, N, lane stride N?, warps, R, sms, every
    # beam at one window?); R 0: the row path (grids side + 3 wide)
    (1, 3, 16, 16, 2, 61, 359, False, 8, 2, 4, False),  # front coarse
    (1, 3, 16, 16, 2, 61, 359, False, 2, 0, 4, False),  # the same, rows
    (1, 3, 3, 3, 1, 40, 359, False, 8, 2, 4, False),  # front fine
    (3, 2, 21, 21, 2, 69, 1, True, 8, 0, 8, False),  # loop coarse, 1 beam
    (2, 3, 11, 11, 2, 89, 655, True, 4, 0, 8, False),  # long anchor coarse
    (2, 2, 3, 3, 1, 50, 656, True, 2, 2, 4, False),  # anchor fine, 2 rounds
    (2, 3, 4, 4, 2, 40, 1500, False, 8, 2, 4, False),  # short anchor coarse
    (2, 2, 7, 5, 1, 29, 4000, True, 2, 0, 2, False),  # 4,000 beams
    (1, 2, 9, 4, 2, 33, 300, False, 4, 2, 4, False),  # odd nx, stride 2
    (2, 2, 5, 3, 3, 35, 200, True, 2, 2, 4, False),  # stride 3
    (1, 2, 1, 1, 1, 17, 100, False, 2, 2, 4, False),  # a 1 x 1 lattice
    (1, 2, 1, 1, 1, 13, 100, False, 2, 0, 4, False),  # the same, rows
    (2, 2, 19, 6, 1, 45, 700, False, 4, 0, 2, False),  # odd nx, stride 1
    (1, 1, 24, 24, 2, 61, 1500, False, 2, 0, 1, True),  # one class, 3 rounds
]


@pytest.mark.parametrize("mis", [0, 13])
@pytest.mark.parametrize("case", MODEL_CASES,
                         ids=[f"{c[0]}x{c[1]}x{c[3]}x{c[2]}s{c[4]}n{c[6]}"
                              for c in MODEL_CASES])
def test_kernel_model_equals_sum_windows(case, mis):
    """The kernel's arithmetic, modelled thread by thread, gives
    ``sum_windows``' int32 numerators bit for bit: starts below 0 and past
    the far edge (clamped), 10% of the beams invalid (lane stride N: a
    lane with none valid), grids of values 0..100 and all 100 (the 16-bit
    halves at their flush bound)."""
    C, A, nx, ny, stride, side, N, own, warps, R, sms, one = case
    rng = np.random.default_rng([C, A, nx, stride, N])
    span_x, span_y = (nx - 1) * stride + 1, (ny - 1) * stride + 1
    H, W = side, side + 3
    grid = rng.integers(0, 101, (C, H, W)).astype(np.uint8)
    if N > K.STAGE:
        grid[0] = 100  # lane 0's halves at their bound every round
    ys = rng.integers(-5, H - span_y + 6, (C, A, N)).astype(np.int32)
    xs = rng.integers(-5, W - span_x + 6, (C, A, N)).astype(np.int32)
    ys[..., :3], xs[..., :3] = H - span_y, W - span_x  # at the far edge
    if one:  # every beam in one class of the row path: its halves' bound
        ys[:], xs[:] = ys[..., :1], xs[..., :1]
    if own:
        valid = rng.random((C, N)) > 0.1
        if C > 1:
            valid[-1] = False  # a lane with no valid beam
        flags = torch.as_tensor(valid)
    else:
        flags = torch.as_tensor(rng.random(N) > 0.1).expand(C, N)
    geo = K.shape_at(C, A, W, nx, ny, stride, N, sms, R, warps)
    args = (torch.as_tensor(grid), torch.as_tensor(ys), torch.as_tensor(xs),
            flags, nx, ny, stride)
    got = kernel_model(*args[:4], nx, ny, stride, geo, mis)
    want = T.sum_windows(*args)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    if own and C > 1:
        assert not got[-1].any()


def test_kernel_constants_mirror_the_source():
    """The limits the wrapper mirrors from csrc/correlative_response.cu,
    the C entry's argument count, a pass in one launch: no atomics, and an
    output the kernel writes whole (``torch.empty``, no zeroing)."""
    import inspect
    import re

    from tpu_slam_torch import _build

    src = (_build.CSRC / "correlative_response.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("STAGE") == K.STAGE
    assert K.STAGE * 100 <= 0xFFFF  # the 16-bit halves' flush bound
    assert const("MAX_THREADS") == K.MAX_THREADS
    assert const("MIN_THREADS") == K.MIN_THREADS
    assert const("CLASSES") == K.CLASSES
    assert tuple(int(r) for r in re.findall(
        r"if \(R == (\d+)\) return launch<\1, 0>", src)) == K.BYTES
    assert re.search(r"if \(!rows && R != 2\)", src)
    assert re.search(r"\batomic\w*\s*\(", src) is None
    entry = re.search(r'extern "C" int correlative_response_launch\((.*?)\)'
                      r' \{', src, re.S)[1]
    assert len(entry.split(",")) == len(
        _build.SIGNATURES["correlative_response"][1]) == 19
    body = inspect.getsource(K.responses_sliced)
    assert "torch.empty(" in body and "zeros" not in body


def test_find_valid_points_flags_are_equal():
    """NaN points are never anchors, ±inf points are, and a NaN
    determinant keeps its run; rows of NaN padding keep nothing."""
    rng = np.random.default_rng(2)
    B, N = 7, 60
    th = np.sort(rng.uniform(-2.5, 2.5, (B, N)), axis=1)
    r = rng.uniform(0.5, 4.0, (B, N))
    pts = np.stack([r * np.cos(th), r * np.sin(th)], -1).astype(np.float32)
    pts[0, 3] = np.nan
    pts[1, 5] = np.inf
    pts[1, 6, 0] = -np.inf
    pts[2, :4] = np.nan
    pts[3, 10:20] = pts[3, 10]  # a run with no anchor step
    pts[4] = np.nan  # NaN padding of an empty store row
    pts[5, ::7] = np.inf
    valid = np.isfinite(pts).all(-1) & (rng.random((B, N)) > 0.05)
    vp = np.array([0.1, -0.2], np.float32)
    ref = np.asarray(jax.jit(jax.vmap(J.find_valid_points,
                                      in_axes=(0, 0, None)))(pts, valid, vp))
    got = T.find_valid_points(_t(pts), _t(valid), _t(vp)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[4].any() and got.any()
    # leading axes: (2, B/…) batches and a single scan
    got2 = T.find_valid_points(_t(pts[:6]).view(2, 3, N, 2),
                               _t(valid[:6]).view(2, 3, N), _t(vp))
    np.testing.assert_array_equal(got2.reshape(6, N).numpy(), ref[:6])
    np.testing.assert_array_equal(
        T.find_valid_points(_t(pts[1]), _t(valid[1]), _t(vp)).numpy(),
        ref[1])


def _scan_inputs(match_setup, guess_offset):  # noqa: F811
    from tpu_slam.data.scan import index_scan, world_points

    _cfg, scans, pose_a, pose_b = match_setup
    p = params()
    sa, sb = index_scan(scans, 0), index_scan(scans, 1)
    base_pts = world_points(sa, jnp.asarray(pose_a, jnp.float32))
    base_valid = sa.valid & (sa.ranges <= p.range_threshold)
    beam_valid = sb.valid & (sb.ranges <= p.range_threshold)
    pts_l = jnp.where(beam_valid[..., None], sb.points(), 0.0)
    guess = jnp.asarray(pose_b + np.asarray(guess_offset), jnp.float32)
    return p, base_pts, base_valid, pts_l, beam_valid, guess


@pytest.mark.parametrize("penalize", [True, False])
def test_correlate_scan_and_covariances_are_equal(
        match_setup, penalize):  # noqa: F811
    p, base_pts, base_valid, pts_l, beam_valid, guess = _scan_inputs(
        match_setup, [0.05, -0.04, 0.04])
    tp = _port_params(p)
    m = J.CorrelativeMatcher(p, pallas_responses=None)
    grid = jax.jit(J.build_correlation_grid, static_argnums=0)(
        p, guess[:2], base_pts, base_valid)

    def ref_pass(center, xo, yo, n, ao, ar, pen):
        return jax.jit(lambda g, gc, sc, pts, bv: J.correlate_scan(
            g, p, gc, sc, pts, bv, xo, yo, n, ao, ar, pen))(
                grid, guess[:2], center, pts_l, beam_valid)

    def port_pass(center, xo, yo, n, ao, ar, pen):
        return T.correlate_scan(_t(grid), tp, _t(guess[:2]), _t(center),
                                _t(pts_l), _t(beam_valid), xo, yo, n, ao, ar,
                                pen)

    coarse = (m.coarse_x, m.coarse_y, m.n_angles_coarse, p.angle_offset,
              p.angle_res, penalize)
    rc, tc = ref_pass(guess, *coarse), port_pass(guess, *coarse)
    fine = (m.fine_x, m.fine_y, m.n_angles_fine, m.fine_angle_offset,
            p.fine_angle_offset, True)
    rf = ref_pass(rc.best_pose, *fine)
    tf = port_pass(tc.best_pose, *fine)
    for r, t in ((rc, tc), (rf, tf)):
        np.testing.assert_allclose(t.best_pose.numpy(), np.asarray(
            r.best_pose), atol=POSE_ATOL, rtol=0)
        np.testing.assert_allclose(float(t.best_response),
                                   float(r.best_response), atol=RESP_ATOL)
        np.testing.assert_allclose(t.search_probs.numpy(), np.asarray(
            r.search_probs), atol=RESP_ATOL, rtol=0)
        np.testing.assert_allclose(t.angle_responses.numpy(), np.asarray(
            r.angle_responses), atol=RESP_ATOL, rtol=0)
    rcov = J.positional_covariance(p, rc.best_pose, rc.best_response, guess,
                                   m.coarse_x, m.coarse_y, p.angle_res,
                                   rc.search_probs)
    tcov = T.positional_covariance(tp, tc.best_pose, tc.best_response,
                                   _t(guess), m.coarse_x, m.coarse_y,
                                   p.angle_res, tc.search_probs)
    np.testing.assert_allclose(tcov.numpy(), np.asarray(rcov), rtol=COV_RTOL,
                               atol=1e-9)
    racov = J.angular_covariance(rf.best_pose, rf.best_response,
                                 rc.best_pose, m.fine_angle_offset,
                                 p.fine_angle_offset, rf.angle_responses,
                                 rcov)
    tacov = T.angular_covariance(tf.best_pose, tf.best_response,
                                 tc.best_pose, m.fine_angle_offset,
                                 p.fine_angle_offset, tf.angle_responses,
                                 tcov)
    np.testing.assert_allclose(tacov.numpy(), np.asarray(racov),
                               rtol=COV_RTOL, atol=1e-9)


def test_correlate_scan_off_the_lattice_is_equal(match_setup):  # noqa: F811
    """Offsets that are no lattice take the random-gather numerators."""
    p, base_pts, base_valid, pts_l, beam_valid, guess = _scan_inputs(
        match_setup, [0.05, -0.04, 0.04])
    xo = np.asarray([-0.06, -0.01, 0.0, 0.03, 0.07], np.float32)
    yo = np.asarray([-0.04, 0.0, 0.05], np.float32)
    assert J._lattice_stride(xo, yo, p.resolution) is None
    grid = jax.jit(J.build_correlation_grid, static_argnums=0)(
        p, guess[:2], base_pts, base_valid)
    args = (xo, yo, 11, math.radians(10.0), math.radians(2.0), True)
    ref = jax.jit(lambda g, gc, sc, pts, bv: J.correlate_scan(
        g, p, gc, sc, pts, bv, *args))(grid, guess[:2], guess, pts_l,
                                       beam_valid)
    got = T.correlate_scan(_t(grid), _port_params(p), _t(guess[:2]),
                           _t(guess), _t(pts_l), _t(beam_valid), *args)
    np.testing.assert_allclose(got.best_pose.numpy(),
                               np.asarray(ref.best_pose), atol=POSE_ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.search_probs.numpy(),
                               np.asarray(ref.search_probs), atol=RESP_ATOL,
                               rtol=0)


def _assert_same_match(got, ref):
    np.testing.assert_allclose(np.asarray(got.pose, np.float64),
                               np.asarray(ref.pose, np.float64),
                               atol=POSE_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(got.response, np.float64),
                               np.asarray(ref.response, np.float64),
                               atol=RESP_ATOL, rtol=0)
    np.testing.assert_allclose(np.asarray(got.covariance, np.float64),
                               np.asarray(ref.covariance, np.float64),
                               rtol=COV_RTOL, atol=1e-9)


@pytest.mark.parametrize("offset", [[0.05, -0.04, 0.04],
                                    [0.0, 0.0, math.radians(35.0)]],
                         ids=["near", "expansion"])
@pytest.mark.parametrize("mode", [None, "interpret"])
def test_match_is_equal(match_setup, offset, mode):  # noqa: F811
    """The whole MatchScan, the 35° start taking the ±20°..60° response
    expansion, against both response paths of the reference."""
    p, base_pts, base_valid, pts_l, beam_valid, guess = _scan_inputs(
        match_setup, offset)
    ref = J.CorrelativeMatcher(p, pallas_responses=mode).match(
        base_pts, base_valid, pts_l, beam_valid, guess)
    got = T.CorrelativeMatcher(_port_params(p), device="cpu").match(
        _t(base_pts), _t(base_valid), _t(pts_l), _t(beam_valid), _t(guess))
    _assert_same_match(got, ref)
    assert float(got.response) > 0.0


def _chain_inputs(match_setup):  # noqa: F811
    """test_correlative's chain lanes: scan a, scan b at a nearby pose, the
    two together, one padded lane, and two lanes whose scans see nothing
    of the query (zero response: the expansion path, for both at once)."""
    from tpu_slam.data.scan import index_scan

    _cfg, scans, pose_a, pose_b = match_setup
    p = params()
    sa, sb = index_scan(scans, 0), index_scan(scans, 1)
    vb = np.asarray(sb.valid & (sb.ranges <= p.range_threshold))
    pb = np.where(vb[..., None], np.asarray(sb.points()), 0.0).astype(
        np.float32)
    va = np.asarray(sa.valid & (sa.ranges <= p.range_threshold))
    pa = np.where(va[..., None], np.asarray(sa.points()), 0.0).astype(
        np.float32)
    n = pa.shape[0]
    C, S = 6, 2
    poses = np.zeros((C, S, 3), np.float32)
    pts = np.full((C, S, n, 2), np.nan, np.float32)
    valid = np.zeros((C, S, n), bool)
    poses[0, 0] = pose_a
    pts[0, 0], valid[0, 0] = pa, va
    poses[1, 0] = pose_b + np.array([0.03, 0.02, 0.01])
    pts[1, 0], valid[1, 0] = pb, vb
    poses[2, 0], poses[2, 1] = poses[0, 0], poses[1, 0]
    pts[2, 0], pts[2, 1] = pa, pb
    valid[2, 0], valid[2, 1] = va, vb
    poses[4, 0] = pose_a + np.array([40.0, 40.0, 0.0])
    pts[4, 0], valid[4, 0] = pa, va
    poses[5, 0] = pose_a + np.array([-40.0, 40.0, 0.0])
    pts[5, 0], valid[5, 0] = pa, va
    lane_valid = np.array([True, True, True, False, True, True])
    guess = np.asarray(pose_b + np.array([0.05, -0.04, 0.04]), np.float32)
    return p, poses, pts, valid, pb, vb, guess, lane_valid


def test_match_chains_is_equal(match_setup):  # noqa: F811
    p, poses, pts, valid, pb, vb, guess, lane_valid = _chain_inputs(
        match_setup)
    ref = J.CorrelativeMatcher(p, pallas_responses=None).match_chains(
        poses, pts, valid, pb, vb, guess, do_penalize=False,
        lane_valid=lane_valid)
    got = T.CorrelativeMatcher(_port_params(p), device="cpu").match_chains(
        poses, pts, valid, pb, vb, guess, do_penalize=False,
        lane_valid=lane_valid)
    _assert_same_match(got, ref)
    assert (got.response[3:] == 0.0).all()


def test_match_chains_store_is_equal(match_setup):  # noqa: F811
    """Index-addressed lanes over a store with empty rows past its count,
    a padded member (index −1) and the async form resolved later."""
    p, poses, pts, valid, pb, vb, guess, lane_valid = _chain_inputs(
        match_setup)
    n = pts.shape[2]
    store_pts = np.zeros((8, n, 2), np.float32)
    store_valid = np.zeros((8, n), bool)
    store_pts[0], store_valid[0] = pts[0, 0], valid[0, 0]
    store_pts[1], store_valid[1] = pts[1, 0], valid[1, 0]
    idx = np.array([[0, -1], [1, -1], [0, 1], [-1, -1], [0, -1], [0, -1]],
                   np.int32)
    ref = J.CorrelativeMatcher(p, pallas_responses=None).match_chains_store(
        jnp.asarray(store_pts), jnp.asarray(store_valid), idx, poses, pb, vb,
        guess, do_penalize=False, lane_valid=lane_valid)
    tm = T.CorrelativeMatcher(_port_params(p), device="cpu")
    pend = tm.match_chains_store_async(
        _t(store_pts), _t(store_valid), idx, poses, pb, vb, guess,
        do_penalize=False, lane_valid=lane_valid)
    got = pend.resolve()
    _assert_same_match(got, ref)
    assert (got.response[3:] == 0.0).all()
    # the multi-query form, every lane's query the store row of scan b at
    # the same centre, answers as the shared-query form, bit for bit
    anchors = T.to_host(tm.match_anchors_store_async(
        _t(store_pts), _t(store_valid), idx, poses, np.ones(6),
        np.repeat(np.asarray(guess)[None], 6, 0), do_penalize=False))
    np.testing.assert_array_equal(anchors[:3], T.to_host(pend._out)[:3])
