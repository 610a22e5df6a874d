"""host_tail_ms: per traced call, from the end of its last device
operation to the end of `bench.msm` (decode, the passes' adds, Horner);
the mean, in ms."""


def read(run):
    tails = [c.tail_us for c in run.trace.calls if c.ops] if run.trace else []
    return sum(tails) / len(tails) * 1e-3 if tails else None
