"""Device kernels in the traced window over its epochs, on rank 0."""


def read(run):
    if not run.traces or not run.traces[0].device or run.unit != "epoch":
        return None
    return len(run.traces[0].kernels()) / run.steps
