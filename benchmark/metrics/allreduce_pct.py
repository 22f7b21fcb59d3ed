"""NCCL kernels' device time over rank 0's traced window, in percent."""


def read(run):
    if not run.traces or run.chips < 2:
        return None
    nccl = run.traces[0].kernels(r"(?i)nccl")
    if not nccl:
        return None
    return 100.0 * sum(b - a for _, a, b in nccl) / 1e6 / run.traces[0].window_s
