"""The bf16 flash attention kernels' work order (``ops/flash_attention.py:
tile_plan``), checked on the CPU: each block of the forward, the dq and the
dk/dv kernels takes one (b, h, tile) of the plan. Every (b, h, tile) must be
there exactly once, the longest tiles first (the forward's and dq's last query
tiles, dk/dv's first key tiles: they walk the most tiles of the other kind),
and the heads of one KV group next to each other within a tile, so that their
blocks run together and read the same K/V tiles from L2."""

import pytest

from prosody_control_french_tts_tpu_torch.ops import flash_attention as fa

# (B, H, KV heads, L): the 7B cell, the bench cell, the model's GQA test shapes, odd ones
SHAPES = [(2, 28, 4, 1024), (8, 14, 2, 768), (1, 7, 1, 256), (1, 4, 2, 128), (3, 5, 5, 384), (1, 4, 2, 2048)]


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("B,H,KVH,L", SHAPES)
def test_plan_covers_every_tile_once(B, H, KVH, L, descending):
    tiles = L // fa.BLOCK
    plan = fa.tile_plan(B, H, tiles, descending)
    assert len(plan) == B * H * tiles
    assert sorted(plan) == sorted((b, h, t) for b in range(B) for h in range(H) for t in range(tiles))


@pytest.mark.parametrize("descending", [True, False])
@pytest.mark.parametrize("B,H,KVH,L", SHAPES)
def test_plan_runs_longest_first_with_groups_adjacent(B, H, KVH, L, descending):
    tiles = L // fa.BLOCK
    group = H // KVH
    plan = fa.tile_plan(B, H, tiles, descending)
    # the tiles a block walks: query tile t meets t + 1 key tiles; key tile t
    # meets the query tiles from t to the end
    work = [t + 1 if descending else tiles - t for _, _, t in plan]
    assert work == sorted(work, reverse=True)
    for i in range(0, len(plan), group):  # each run of `group` blocks is one KV group of one (b, tile)
        run = plan[i : i + group]
        assert len({(b, t, h // group) for b, h, t in run}) == 1
        assert [h for _, h, _ in run] == list(range(run[0][1], run[0][1] + group))
