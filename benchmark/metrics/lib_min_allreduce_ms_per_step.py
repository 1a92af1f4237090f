"""Device time of the NCCL all-reduce kernels (the step's library MIN,
``agent.lib_pmin``) per episode step on rank 0 (ms)."""

ALLREDUCE = r"(?i)nccl.*all_?reduce"


def read(trace):
    t = trace.time_s(ALLREDUCE)
    return t * 1e3 / trace.steps if t else None
