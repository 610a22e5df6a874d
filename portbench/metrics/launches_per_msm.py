"""launches_per_msm: the program's own count of kernel launches,
`tpu_msm_torch.cuzk.kernels.LAUNCHES` summed over the wrappers, over the
window's calls, a call. Silent where no kernel launched (the plain
versions on the CPU)."""


def read(run):
    if not run.call_s or run.launches == 0:
        return None
    return run.launches / len(run.call_s)
