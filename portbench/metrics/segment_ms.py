"""Segment: split scores and SLIC, in ms per image of the window (stage timers,
`utils/timing.py stage_report`): `.batch` over `encode_many`'s stages,
`.single` over `encode`'s."""

from portbench.harness import stage_ms_per_image

STAGES = {"batch": ("s.segment",), "single": ("segment",)}


def read(ctx, suffix):
    return stage_ms_per_image(ctx, STAGES[suffix]) if suffix in STAGES else None
