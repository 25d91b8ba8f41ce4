"""Frontend: Canny thresholds, ROI masks and region extraction, in ms per image of the window (stage timers,
`utils/timing.py stage_report`): `.batch` over `encode_many`'s stages,
`.single` over `encode`'s."""

from portbench.harness import stage_ms_per_image

STAGES = {"batch": ("s.thresholds", "s.roi_masks", "s.extract"), "single": ("roi",)}


def read(ctx, suffix):
    return stage_ms_per_image(ctx, STAGES[suffix]) if suffix in STAGES else None
