"""kernels_roofline: the least time of one call's work (`work.py`: the
bucket method's adds at the config the call ran, over the derived int32
peak, or its bytes over HBM, whichever is longer) over the device's
busy time a traced call (the union of its kernels, copies and memsets),
in %."""


def read(run):
    if not run.trace or not run.trace.calls:
        return None
    busy_ms = run.trace.busy_us() * 1e-3 / len(run.trace.calls)
    if busy_ms <= 0:
        return None
    return 100.0 * run.bound_ms / busy_ms
