"""Kernel B3's share of its roofline: the counted least time of one
farthest-point sampling (8 operations per distance over the rows'
compacted points at the f32 peak, or its bytes at the HBM peak) over its
profiler device time per launch, in %."""

KERNEL = "fps_kernel"


def read(run):
    p, least = run.profile, run.work.get("b3")
    if p is None or least is None or p.launches(KERNEL) == 0:
        return None
    return 100.0 * least["s"] / (p.device_s(KERNEL) / p.launches(KERNEL))
