"""The >= 10k-colour k-means of tiers 1-3 (`epscc.kmeans`: the timer wraps
the k-means of tier 1's segments and of tiers 2/3's cluster pairs alike), in
ms per image of the window (stage timers, `utils/timing.py stage_report`):
`.batch` over `encode_many`'s stages, `.single` over `encode`'s."""

from portbench.harness import stage_ms_per_image

STAGES = {"batch": ("epscc.kmeans",), "single": ("epscc.kmeans",)}


def read(ctx, suffix):
    return stage_ms_per_image(ctx, STAGES[suffix]) if suffix in STAGES else None
