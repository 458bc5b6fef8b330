"""The launch plans of the decode_aff tail (K2), of the constant-affinity
loop (K6) and of its backward (K6b), and the input cases on which the card
checks and times them.

The plans are plain Python that the CUDA wrappers follow, so they are held
here: K2's 8x16 tiles and its cluster's channel stages cover every cell of
the base grid and every channel exactly once, and the wrapper picks each
cluster size at the shapes ``chip_smoke.py`` checks; K6's strips of 4
cells give every cell of every step's region exactly one owner thread, live
at that step, whose taps lie in the block's buffer, and its launches fit the
registers, threads and shared memory they state; K6b's launches fit a
block's shared memory, keep the model's loop (3x3, 12 steps) to one launch
and split 5x5 and long loops. K2's plain version, which the card holds the
kernel against, is held against the JAX package's TPU kernel
(``_fwd_pallas`` in interpret mode) at a ragged grid and K = 24, and the
intermediate y1 that training saves against the JAX model's deconv1 + ReLU
(1e-5: f32 sums of up to 2,304 products in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nlspn_eccv20_tpu.ops.pallas.dec_aff_tail as jax_dat
from nlspn_eccv20_tpu_torch.ops.kernels.dec_aff_tail import (
    SPLITS, STAGE, TILE, decode_aff_tail_case, decode_aff_tail_fwd_y1,
    decode_aff_tail_plain, tail_plan, tail_stages)
from nlspn_eccv20_tpu_torch.ops.kernels.prop_loop import (
    REGISTERS, SMEM_BYTES, _bwd_floats, loop_max_threads, loop_smem_bytes, loop_strips,
    loop_threads, plan, prop_loop_bwd, prop_loop_bwd_case, prop_loop_case, prop_loop_plain,
    strip_registers)
from nlspn_eccv20_tpu_torch.utils.weights import _convt_w

H100_SMS = 132


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


@pytest.mark.parametrize("c", [30, 40, 256])
@pytest.mark.parametrize("hg,wg", [(64, 80), (58, 76), (60, 304), (57, 75), (5, 3)])
def test_tail_plan_covers_every_cell_and_channel_once(hg, wg, c):
    for b in (1, 2, 4, 12):
        rows, cols, s = tail_plan(b, hg, wg, c, H100_SMS)
        assert s in SPLITS
        # the tiles cover the grid, and the last row and column of tiles
        # start inside it
        assert rows * TILE[0] >= hg > (rows - 1) * TILE[0]
        assert cols * TILE[1] >= wg > (cols - 1) * TILE[1]
        stages = tail_stages(c, s)
        assert len(stages) == s and all(k0 < k1 for k0, k1 in stages)
        assert stages[0][0] == 0 and all(a[1] == n[0] for a, n in zip(stages, stages[1:]))
        covered = [ch for k0, k1 in stages
                   for ch in range(k0 * STAGE, min(k1 * STAGE, c))]
        assert covered == list(range(c))


@pytest.mark.parametrize("b,hg,wg,c,split", [
    (1, 64, 80, 256, 8),       # serving b=1: 40 tiles
    (2, 64, 80, 256, 4),
    (4, 64, 80, 256, 2),
    (12, 58, 76, 256, 1),      # the train step: 480 tiles
    (1, 60, 304, 256, 2),      # KITTI
    (1, 64, 80, 30, 2),        # two channel stages: at most two CTAs
])
def test_tail_plan_picks_the_cluster_size(b, hg, wg, c, split):
    assert tail_plan(b, hg, wg, c, H100_SMS)[2] == split


@pytest.mark.parametrize("steps,kernel,shape,clip,tile,launches", [
    (12, 3, (12, 228, 304), False, 32, 1),   # the model's loop: one launch
    (12, 3, (1, 228, 304), False, 32, 1),
    (12, 3, (12, 228, 304), True, 32, 1),
    (12, 5, (1, 228, 304), True, 16, 3),     # 5x5 splits
    (18, 3, (12, 228, 304), False, 32, 2),
    (100, 3, (1, 228, 304), False, 32, 8),   # long loops split
])
def test_loop_bwd_plan_fits_the_new_budget(steps, kernel, shape, clip, tile, launches):
    got_tile, chunks = plan(steps, kernel, shape, H100_SMS, backward=True, clip=clip)
    assert (got_tile, len(chunks)) == (tile, launches)
    for k0, k1 in chunks:
        assert 4 * _bwd_floats(tile, k1 - k0, kernel, clip) <= SMEM_BYTES


# (tile, steps, kernel) of the K6 launches the plan makes at the shapes
# chip_smoke.py checks (3x3: 12 steps, 9 of 18, 11 and 12 of 100; 5x5: 2),
# at a kernel of 1 and 7, and on smaller tiles and other lengths
LOOP_LAUNCHES = [(32, 12, 3), (32, 4, 3), (32, 9, 3), (32, 11, 3), (32, 2, 5),
                 (32, 1, 3), (8, 4, 3), (16, 6, 5), (32, 12, 1), (32, 6, 7)]


@pytest.mark.parametrize("tile,steps,kernel", LOOP_LAUNCHES)
def test_loop_strips_own_every_cell_of_every_step_once(tile, steps, kernel):
    r = kernel // 2
    threads = loop_threads(tile, steps, kernel)
    strips = loop_strips(tile, steps, kernel)
    assert threads <= loop_max_threads(kernel) and threads % 32 == 0
    assert len(strips) <= threads and len({t for t, *_ in strips}) == len(strips)
    assert all(x % 4 == 0 for _, _, x, _ in strips)   # float4-aligned in the buffer
    # the buffer: the tile grown by steps r rows, round4((steps-1) r) +
    # round4(r) columns
    hy = steps * r
    hx = -(-((steps - 1) * r) // 4) * 4 + -(-r // 4) * 4
    for s in range(1, steps + 1):
        e = (steps - s) * r          # step s's region: the tile grown by e
        live = [(y, x) for _, y, x, last in strips if last >= s]
        cells = [(y, x + c) for y, x in live for c in range(4)]
        want = {(y, x) for y in range(-e, tile + e) for x in range(-e, tile + e)}
        assert len(set(cells)) == len(cells) and want <= set(cells)
        # a live strip's taps lie in the buffer
        assert all(-hy <= y - r and y + r < tile + hy and -hx <= x - r
                   and x + 3 + r < tile + hx for y, x in live)
        # its cells past the region are garbage that no region cell of a
        # later step reads: the strip reaches the region
        assert all(max(-y, y - tile + 1, -(x + 3), x - tile + 1, 0) <= e for y, x in live)


@pytest.mark.parametrize("steps,kernel,shape,tile,launches", [
    (12, 3, (1, 256, 320), 32, 1),       # serving b=1: 80 blocks of 768 threads
    (12, 3, (12, 228, 304), 32, 1),      # the loop's train step: one launch
    (12, 3, (4, 256, 320), 32, 1),
    (12, 3, (1, 240, 1216), 32, 1),      # KITTI
    (12, 5, (1, 256, 320), 32, 6),       # 25 affinities a cell: 2 steps a launch
    (18, 3, (1, 256, 320), 32, 2),
    (100, 3, (1, 256, 320), 32, 9),
    (12, 7, (1, 256, 320), 32, 2),       # the affinities read from L2
    (12, 1, (1, 256, 320), 32, 1),
])
def test_loop_plan_fits_registers_threads_and_shared_memory(steps, kernel, shape, tile,
                                                             launches):
    got_tile, chunks = plan(steps, kernel, shape, H100_SMS)
    assert (got_tile, len(chunks)) == (tile, launches)
    for k0, k1 in chunks:
        threads = loop_threads(tile, k1 - k0, kernel)
        assert threads <= loop_max_threads(kernel)
        assert loop_smem_bytes(tile, k1 - k0, kernel) <= SMEM_BYTES
        # the strip's constants and 32 registers for the step fit a thread's
        # share of the SM's registers
        assert strip_registers(kernel) + 32 <= REGISTERS // loop_max_threads(kernel)


@pytest.mark.parametrize("kernel,steps,save", [(3, 12, False), (5, 4, True)])
def test_prop_loop_case_is_seeded(kernel, steps, save):
    h, w = 30, 41
    args, kw, library = prop_loop_case(torch.Generator().manual_seed(7), "cpu", 2, h, w,
                                       kernel, steps, save)
    again, kw2, _ = prop_loop_case(torch.Generator().manual_seed(7), "cpu", 2, h, w,
                                   kernel, steps, save)
    assert kw == kw2 == dict(steps=steps, kernel=kernel, preserve=True, clip=False,
                             pre_blend=False, save=save)
    assert all(torch.equal(u, v) for u, v in zip(args, again))
    pred, aff, conf, dep = args
    assert aff.shape == (2, kernel * kernel, h, w)
    # the yardstick, steps launches of K1 (their plain version on the
    # CPU), is the plain loop bit for bit
    opts = {k: v for k, v in kw.items() if k != "save"}
    assert torch.equal(library(), prop_loop_plain(*args, **opts))


@pytest.fixture
def highest_precision(monkeypatch):
    monkeypatch.setattr(jax_dat, "MATMUL_PRECISION", "highest")
    monkeypatch.setattr(jax_dat, "FORCE_PALLAS_INTERPRET", True)


def _tail_inputs(rng, b, hg, wg, c, k, m=16):
    x = np.maximum(rng.standard_normal((b, hg, wg, c)), 0).astype(np.float32)
    w1 = (rng.standard_normal((3, 3, c, m)) * (c * 9 / 4) ** -0.5).astype(np.float32)
    b1 = (rng.standard_normal(m) * 0.1).astype(np.float32)
    w2 = (rng.standard_normal((3, 3, m, k)) * (m * 9 / 4) ** -0.5).astype(np.float32)
    b2 = (rng.standard_normal(k) * 0.1).astype(np.float32)
    return x, w1, b1, w2, b2


@pytest.mark.parametrize("b,hg,wg,c,k", [
    (1, 9, 17, 40, 24),        # a ragged grid past one 8x16 tile, K = 24
    (2, 5, 7, 30, 8),          # C not a multiple of a channel stage nor of 4
])
def test_decode_aff_tail_plain_matches_the_tpu_kernel(highest_precision, b, hg, wg, c, k):
    x, w1, b1, w2, b2 = _tail_inputs(np.random.default_rng(10), b, hg, wg, c, k)
    ref = jax_dat._fwd_pallas(*map(jnp.asarray, (x, w1, b1, w2, b2)))
    out = decode_aff_tail_plain(t(x), _convt_w(w1), t(b1), _convt_w(w2), t(b2))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("b,hg,wg,c", [(1, 9, 17, 40), (3, 4, 5, 16)])
def test_saved_intermediate_is_the_jax_models_deconv1(b, hg, wg, c):
    x, w1, b1, w2, b2 = _tail_inputs(np.random.default_rng(11), b, hg, wg, c, 8)
    ref = jnp.moveaxis(jax_dat.jax.nn.relu(jax_dat._deconv(
        jnp.asarray(x), jnp.asarray(w1), jnp.asarray(b1))), -1, 1)
    out, y1 = decode_aff_tail_fwd_y1(t(x), _convt_w(w1), t(b1), _convt_w(w2), t(b2))
    assert y1.shape == (b, 16, 2 * hg, 2 * wg)
    np.testing.assert_allclose(y1.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    assert torch.equal(out, decode_aff_tail_plain(t(x), _convt_w(w1), t(b1),
                                                  _convt_w(w2), t(b2)))


@pytest.mark.parametrize("k,c", [(8, 256), (24, 40)])
def test_decode_aff_tail_case_is_seeded_and_its_yardstick_agrees(k, c):
    a, lib_a = decode_aff_tail_case(torch.Generator().manual_seed(3), "cpu", 2, 5, 7, k, c)
    b, _ = decode_aff_tail_case(torch.Generator().manual_seed(3), "cpu", 2, 5, 7, k, c)
    assert [tuple(v.shape) for v in a] == [(2, 5, 7, c), (c, 16, 3, 3), (16,), (16, k, 3, 3), (k,)]
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert bool((a[0] >= 0).all())  # ReLU'd, as deconv0's output is
    np.testing.assert_allclose(lib_a().numpy(), decode_aff_tail_plain(*a).numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kernel,ties", [(3, False), (5, True)])
def test_prop_loop_bwd_case_is_seeded(kernel, ties):
    h, w = 70, 80
    (g, pred, aff, conf, dep, saved), kw, _ = prop_loop_bwd_case(
        torch.Generator().manual_seed(5), "cpu", 2, h, w, kernel, 12, ties)
    again, kw2, _ = prop_loop_bwd_case(
        torch.Generator().manual_seed(5), "cpu", 2, h, w, kernel, 12, ties)
    assert kw == kw2 == dict(steps=12, kernel=kernel, preserve=True, clip=ties,
                             pre_blend=ties)
    assert aff.shape == (2, kernel * kernel, h, w) and saved is None
    assert all(torch.equal(u, v) for u, v in zip((g, pred, aff, conf, dep), again))
    assert bool((pred[:, :64, :64] == 0).all()) == ties
    # the CPU path of the wrapper (the plain VJP) takes these arguments
    d_pred, d_aff, d_conf = prop_loop_bwd(g, pred, aff, conf, dep, saved, **kw)
    assert d_pred.shape == pred.shape and d_aff.shape == aff.shape
    assert bool(torch.isfinite(d_aff).all() and torch.isfinite(d_conf).all())
