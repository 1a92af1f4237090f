"""Device busy time of the traced episodes per episode step (ms)."""


def read(trace):
    return trace.busy_s() * 1e3 / trace.steps
