"""Tier 1: the pair table, eps-CC and the k-means splits, in ms per image of the window (stage timers,
`utils/timing.py stage_report`): `.batch` over `encode_many`'s stages,
`.single` over `encode`'s."""

from portbench.harness import stage_ms_per_image

STAGES = {"batch": ("t1.pairs_dev", "s.tier1"), "single": ("tier1",)}


def read(ctx, suffix):
    return stage_ms_per_image(ctx, STAGES[suffix]) if suffix in STAGES else None
