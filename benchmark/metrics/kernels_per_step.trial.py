"""Device kernels counted in the trace per episode step."""


def read(trace):
    return trace.count() / trace.steps
