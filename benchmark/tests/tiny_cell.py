"""A cell cut to a size the CPU tests hold, on the same code paths: the
stage's settings, two layers, two heads (one KV head), L 128, and a
vocabulary of 512 so that the fused loss still takes the head."""

from benchmark import harness


def tiny(workload: str = "cascade_a.train", hidden: int = 128, **stage) -> dict:
    cell = harness.find_cell(workload)
    c = dict(cell["config"], hidden_size=hidden, num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=1,
             intermediate_size=256, vocab_size=512)
    c["stage"] = dict(c["stage"], seq_len=128, **stage)
    t = dict(cell["traffic"], micro_batch=2, accum=2, seq_len=128, ring=8)
    return dict(cell, config=c, traffic=t)
