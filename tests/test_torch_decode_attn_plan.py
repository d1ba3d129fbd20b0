"""The launch plan of kernel F (decode attention), on the CPU.

``ops.decode_attn.split_plan`` decides how many blocks of a thread-block
cluster share one (batch row, KV head), and ``block_rows`` which live cache
rows each block takes; the CUDA kernel computes the same split. Here every
live row must be taken by exactly one block for every pos, the plan must not
depend on pos, and the serving shapes must get the planned block counts. The
kernel itself is held to the plain version on the card
(``tests/test_torch_kernels.py``, ``gpu`` marker).
"""

import pytest

from prosody_control_french_tts_tpu_torch.ops import decode_attn

SHAPES = [  # B, kv_heads, S
    (16, 4, 192),  # the 7B serving shape
    (64, 2, 320),  # the bench serving shape
    (1, 1, 33),
    (2, 2, 700),
    (4, 2, 96),
    (1, 8, 5),
]


@pytest.mark.parametrize("B,kv_heads,S", SHAPES)
def test_every_live_row_is_taken_by_exactly_one_block(B, kv_heads, S):
    C = decode_attn.split_plan(B, kv_heads, S)
    for pos in range(S):
        n = pos + 1
        seen = [0] * n
        for rank in range(C):
            rows = decode_attn.block_rows(rank, n, C)
            assert rows.start >= 0 and rows.stop <= n
            for t in rows:
                seen[t] += 1
        assert seen == [1] * n, (pos, C)


@pytest.mark.parametrize("B,kv_heads,S", SHAPES)
def test_plan_is_a_power_of_two_cluster_within_the_portable_size(B, kv_heads, S):
    C = decode_attn.split_plan(B, kv_heads, S)
    assert 1 <= C <= decode_attn.MAX_CLUSTER == 8
    assert C & (C - 1) == 0
    grid = C * kv_heads * B
    assert grid % C == 0
    assert -(-S // C) <= decode_attn.MAX_BLOCK_ROWS


def test_plan_takes_no_pos():
    """C and the grid come from the shapes alone: the plan has no pos
    argument, so a decode step keeps one launch over a whole generation."""
    import inspect

    assert list(inspect.signature(decode_attn.split_plan).parameters) == ["B", "kv_heads", "S", "sms"]


@pytest.mark.parametrize("B,kv_heads,S,C,blocks", [(16, 4, 192, 2, 128), (64, 2, 320, 2, 256)])
def test_serving_shapes_get_the_planned_block_counts(B, kv_heads, S, C, blocks):
    """7B (q [16, 28, 128], caches [16, 192, 512]) and bench (q [64, 14, 64],
    caches [64, 320, 128]): at least one block for every two SMs of the H100,
    at most 192 rows (three 64-row tiles) a block."""
    assert decode_attn.split_plan(B, kv_heads, S) == C
    assert C * kv_heads * B == blocks >= decode_attn.H100_SMS // 2
    assert -(-S // C) <= decode_attn.PLAN_BLOCK_ROWS


def test_blocks_with_no_rows_at_small_pos():
    """pos below C - 1 leaves blocks with no rows; they still exist (and take
    part in every cluster barrier with max -inf and sum 0)."""
    C = decode_attn.split_plan(1, 1, 33)
    assert C == decode_attn.MAX_CLUSTER
    assert [len(decode_attn.block_rows(r, 1, C)) for r in range(C)] == [1] + [0] * (C - 1)
    assert sum(len(decode_attn.block_rows(r, 3, C)) for r in range(C)) == 3


def test_long_caches_split_further_and_too_long_ones_are_refused():
    assert decode_attn.split_plan(64, 8, 192) == 1  # enough blocks, three tiles each
    assert decode_attn.split_plan(64, 8, 4096) == 8  # the cluster stops growing at 8
    assert -(-4096 // 8) <= decode_attn.MAX_BLOCK_ROWS
    with pytest.raises(ValueError, match="exceeds"):
        decode_attn.split_plan(1, 1, decode_attn.MAX_CLUSTER * decode_attn.MAX_BLOCK_ROWS + 1)
