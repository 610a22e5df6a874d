"""msm_ms_p95: the 95th percentile of the window's calls, nearest rank,
in ms. Silent under 200 calls, where fewer than ten calls lie beyond
it."""

MIN_CALLS = 200


def read(run):
    if len(run.call_s) < MIN_CALLS:
        return None
    times = sorted(run.call_s)
    return times[-(-95 * len(times) // 100) - 1] * 1e3
