"""CUDA graph launches per traced episode: the host's ``cudaGraphLaunch``
calls inside the harness's spans over the spans. A whole-episode graph
launches once; the early-exit run (``agent.make_navigate_batch(...,
early_exit=True)``) launches its graph of ``agent.EXIT_CHUNK`` steps once a
chunk, and reads on the host after each whether every agent is done: at
``max_steps`` 66 and chunks of 4, from 1 to ceil(66 / 4) = 17."""


def read(trace):
    n = sum(map(len, trace.span_launches()))
    return n / len(trace.spans) if n else None
