"""The grid plans of kernel H (``ops.fused_ce``), on the CPU.

``split_plan`` deals the forward's vocabulary tiles to splits, ``chunk_plan``
cuts the bfloat16 backward's vocabulary into chunks whose coefficient scratch
stays in L2, and ``dh_cols`` picks the bfloat16 dh tile width; the CUDA
kernels trust all three. Here every vocabulary tile must belong to exactly one
split, the chunks must cover V in whole tiles, and the grids must fill the
H100's 132 SMs in whole waves at the 7B and bench training shapes. The
kernels themselves are held to the plain version on the card
(``tests/test_torch_kernels.py``, ``gpu`` marker).
"""

import pytest

from prosody_control_french_tts_tpu_torch.ops import fused_ce

SMS = 132
SHAPES = [
    (2044, 3584, 152064),  # the 7B training step: B 4, L 512 less one
    (4088, 896, 32768),  # the bench training geometry: B 8
    (1, 128, 512),
    (63, 128, 1024),
    (65, 256, 2048),
    (2044, 128, 512),
    (300, 256, 1024),
    (515, 384, 9216),
    (2044, 128, 65536),
]
ROUTES = [(fused_ce.TILE_BF16, SMS), (fused_ce.TILE, SMS)]  # bfloat16, float32: one block per SM


def cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize("tile, slots", ROUTES)
@pytest.mark.parametrize("n, d, v", SHAPES)
def test_split_plan_deals_every_tile_to_one_split(n, d, v, tile, slots):
    """Replays the forward kernel's walk: split s takes tiles
    [s * per, min(tiles, (s + 1) * per)); none is empty."""
    splits, per = fused_ce.split_plan(n, v, tile, slots)
    tiles = v // tile
    owners = [0] * tiles
    for s in range(splits):
        walk = range(s * per, min(tiles, (s + 1) * per))
        assert len(walk) >= 1
        for t in walk:
            owners[t] += 1
    assert owners == [1] * tiles
    assert 1 <= splits <= 65535


@pytest.mark.parametrize("tile, slots", ROUTES)
@pytest.mark.parametrize("n, v", [(2044, 152064), (4088, 32768)])
def test_split_plan_reaches_the_least_critical_path(n, v, tile, slots):
    """Waves of resident blocks times tiles per block equals its lower
    bound, all tile-rows over the slots: no wave is wasted."""
    splits, per = fused_ce.split_plan(n, v, tile, slots)
    row_tiles = cdiv(n, fused_ce.ROWS)
    assert cdiv(splits * row_tiles, slots) * per == cdiv(v // tile * row_tiles, slots)


def test_split_plan_gives_whole_waves_at_the_7b_shape():
    """594 tiles of 256 = 33 splits x 18 tiles; x 16 row tiles = 528
    blocks, 4 full waves of 132."""
    splits, per = fused_ce.split_plan(2044, 152064, fused_ce.TILE_BF16, SMS)
    assert (splits, per) == (33, 18)
    assert splits * cdiv(2044, fused_ce.ROWS) == 4 * SMS


def test_split_plan_fills_one_wave_at_the_bench_shape():
    """128 tiles x 32 row tiles cannot fill whole waves of 132; the plan
    takes one wave of 128 blocks of 32 tiles each."""
    splits, per = fused_ce.split_plan(4088, 32768, fused_ce.TILE_BF16, SMS)
    assert splits * per == 128 and splits * cdiv(4088, fused_ce.ROWS) <= SMS


@pytest.mark.parametrize("n, d, v", SHAPES)
def test_chunk_plan_covers_the_vocabulary_in_whole_tiles(n, d, v):
    chunk = fused_ce.chunk_plan(n, v, SMS)
    widths = [min(chunk, v - v0) for v0 in range(0, v, chunk)]
    assert chunk % fused_ce.TILE_BF16 == 0
    assert sum(widths) == v
    assert all(w > 0 and w % fused_ce.TILE_BF16 == 0 for w in widths)
    assert n * chunk * 2 <= fused_ce.SCRATCH_L2_BYTES or chunk == fused_ce.TILE_BF16


def test_chunk_plan_gives_whole_waves_at_the_7b_shape():
    """18 chunks of 8,448 columns (33 tiles): each coefficient grid is
    33 x 16 = 528 blocks, 4 full waves; the scratch is 34.5 MB."""
    chunk = fused_ce.chunk_plan(2044, 152064, SMS)
    assert chunk == 8448 and 152064 % chunk == 0 and 152064 // chunk == 18
    assert chunk // fused_ce.TILE_BF16 * 16 == 4 * SMS
    assert 2044 * chunk * 2 < 50e6


def test_chunk_plan_keeps_the_bench_scratch_in_l2():
    """N 4,088: 8 chunks of 4,096 columns (33.5 MB of scratch, where 8,192
    columns would be 67 MB, more than L2); 512 blocks a chunk."""
    chunk = fused_ce.chunk_plan(4088, 32768, SMS)
    assert chunk == 4096
    assert 4088 * chunk * 2 <= fused_ce.SCRATCH_L2_BYTES


@pytest.mark.parametrize("n, d, v", SHAPES)
def test_dh_cols_is_a_kernel_width_dividing_d(n, d, v):
    cols = fused_ce.dh_cols(n, d, SMS)
    assert cols in fused_ce.DH_COLS_BF16 and d % cols == 0


@pytest.mark.parametrize("n, d, blocks", [(2044, 3584, 256), (4088, 896, 128)])
def test_dh_cols_fills_the_waves_at_the_training_shapes(n, d, blocks):
    """224 columns: 16 x 16 = 256 blocks at 7B (2 waves, 97 % full; 128
    columns would give 448 blocks, 85 % of 4 waves), 4 x 32 = 128 at the
    bench shape (one wave)."""
    cols = fused_ce.dh_cols(n, d, SMS)
    assert cols == 224
    assert d // cols * cdiv(n, fused_ce.ROWS) == blocks
