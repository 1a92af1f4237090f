"""A captured episode reads its inputs afresh at every call (ROADMAP C.14).

``make_navigate_batch`` copies its states, statics and ``aux`` into the
graph's buffers on every call. A statics tensor edited in place between two
calls (the same tensor, a new ``_version``) must reach the next call, whose
result equals the eager episode's on the edited statics bit for bit. On the
CPU the same copy-in runs around a direct call (``capture.py``), so this
holds the copy-in's bookkeeping here; the graphs phase of ``chip_smoke.py``
holds the replays on the card.
"""

import pytest
import torch

from navdv_torch import graft_entry as ge
from navdv_torch.agent import make_navigate_batch, make_navigate_batch_fn
from navdv_torch.routes import make_route
from navdv_torch.training import train_library

STEPS = 12


def _edit(st, what: str, cfg) -> None:
    """Edit ``st`` in place: the landscape's values, or the library's
    tensors replaced by those of a library trained on another landscape."""
    land = st.landscape
    other = 1.0 - land  # the same world with its contrast inverted
    if what == "landscape":
        land.copy_(other)
        return
    route = make_route("line", size=(96, 96), margin=24.0, length=30.0)  # _tiny_setup's
    lib = train_library(other.numpy(), route, cfg, device="cpu")
    for dst, src in zip(st.lib, lib):
        dst.copy_(src)


@pytest.mark.parametrize("early_exit", [False, True])
@pytest.mark.parametrize("what", ["landscape", "library"])
@pytest.mark.parametrize("fam_impl", ["kernel", "fft"])
def test_in_place_statics_edit_reaches_the_next_call(fam_impl, what, early_exit):
    cfg, st, pts, headings = ge._tiny_setup(max_steps=STEPS, device="cpu")
    states0 = ge._starts(pts, headings, ge.BATCH, "cpu")
    run = make_navigate_batch(cfg, fam_impl, early_exit=early_exit, device="cpu")
    eager = make_navigate_batch_fn(cfg, fam_impl, early_exit=early_exit, device="cpu")
    before = run(states0, st)
    _edit(st, what, cfg)
    after = run(states0, st)
    want = eager(states0, st)
    for got, ref in zip((*after[0], *after[1]), (*want[0], *want[1])):
        assert torch.equal(got, ref)
    assert not torch.equal(after[1].fam, before[1].fam)  # the edit changed the result
