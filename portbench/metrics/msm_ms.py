"""msm_ms: the window's seconds over the calls it completed, in ms: the
mean time of one MSM, stalls included."""


def read(run):
    if not run.call_s:
        return None
    return run.window_s / len(run.call_s) * 1e3
