"""``render_kernel`` (``navdv_torch/csrc/render.cu``) against its roofline
(%): the bytes each launch must move at the cell's batch
(:func:`harness.work.render_bytes`) over 3.35 TB/s, over its traced time."""

from harness import work

KERNEL = r"render_kernel"


def read(trace):
    launches = trace.count(KERNEL)
    if not launches:
        return None
    ctx = trace.context
    least = launches * work.render_bytes(ctx["batch"], ctx["sensor"]) / work.HBM_BYTES_PER_S
    return 100.0 * least / trace.time_s(KERNEL)
