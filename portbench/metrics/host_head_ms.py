"""host_head_ms: per traced call, from the start of the harness's
`bench.msm` span to the start of the call's first device operation
(staging and launch, before the card works); the mean, in ms."""


def read(run):
    heads = [c.head_us for c in run.trace.calls if c.ops] if run.trace else []
    return sum(heads) / len(heads) * 1e-3 if heads else None
