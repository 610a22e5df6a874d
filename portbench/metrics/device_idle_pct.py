"""device_idle_pct: the share of the traced stretch, from the first
traced call's start to the last one's end, in which no kernel, copy or
memset ran on the card, in %."""


def read(run):
    if not run.trace or not run.trace.calls:
        return None
    window = run.trace.window_us()
    if window <= 0 or run.trace.busy_us() <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_us() / window)
