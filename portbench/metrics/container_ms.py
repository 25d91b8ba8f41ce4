"""Container: DEFLATE packing, in ms per image of the window (stage timers,
`utils/timing.py stage_report`): `.batch` over `encode_many`'s stages,
`.single` over `encode`'s."""

from portbench.harness import stage_ms_per_image

STAGES = {"batch": ("s.container",), "single": ("container",)}


def read(ctx, suffix):
    return stage_ms_per_image(ctx, STAGES[suffix]) if suffix in STAGES else None
