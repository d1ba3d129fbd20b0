"""The work plan of kernel G's bfloat16 dk/dv kernel, on the CPU.

``ops.vmem_attn.dkv_plan`` decides which block covers which (query head, key
tile, query tiles); the CUDA kernel trusts it. Here every (head, key tile,
query tile at or below the diagonal) must be covered exactly once, and no
block may do more than twice the mean block's work. The kernels themselves
are held to the plain version on the card (``tests/test_torch_kernels.py``,
``gpu`` marker).
"""

import pytest
import torch

from prosody_control_french_tts_tpu_torch.ops import vmem_attn

T = vmem_attn.BF16_TILE


def coverage(L, H):
    n = -(-L // T)
    seen, work = {}, []
    for h, a, b in vmem_attn.dkv_plan(L, H).tolist():
        w = 0
        for j in (a, b):
            if j < 0:
                continue
            for i in range(j, n):
                seen[(h, j, i)] = seen.get((h, j, i), 0) + 1
                w += 1
        work.append(w)
    return n, seen, work


@pytest.mark.parametrize("group", [1, 7, 8])
@pytest.mark.parametrize("L", [32, 64, 96, 128, 192, 512])
def test_dkv_plan_covers_each_tile_pair_once_and_balances(L, group):
    H = 2 * group
    n, seen, work = coverage(L, H)
    want = {(h, j, i) for h in range(H) for j in range(n) for i in range(j, n)}
    assert set(seen) == want
    assert all(c == 1 for c in seen.values())
    assert max(work) <= 2 * (sum(work) / len(work))


def test_dkv_plan_fills_the_card_at_the_7b_shape():
    """B 4, L 512, H 28: at least three blocks for each of the H100's 132 SMs;
    every block walks n + 1 = 9 query tiles."""
    plan = vmem_attn.dkv_plan(512, 28)
    assert plan.dtype == torch.int32 and plan.shape == (28 * 4, 3)
    assert 4 * plan.shape[0] >= 3 * 132
    assert set(coverage(512, 28)[2]) == {9}
