"""Seconds to load the kernel libraries the configuration runs (host clock
around ``tpinn_torch.kernels.build.library``); a checkout's first run
compiles them there."""


def read(run):
    return run.kernel_load_s
