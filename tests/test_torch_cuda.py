"""The port's CUDA kernels against their plain PyTorch versions on the card,
at small ragged shapes (the full-size checks are in chip_smoke.py). Marked
``cuda``; each test skips where no CUDA device is present. On a machine with
an NVIDIA H100:

    python -m pytest tests/test_torch_cuda.py -m cuda -p no:cacheprovider
"""

import numpy as np
import pytest
import torch

from navdv_torch import ops
from navdv_torch.familiarity import zscore
from navdv_torch.ops.familiarity import min_distance_rows, min_distance_rows_plain
from navdv_torch.ops.render import render_windows, render_windows_plain
from navdv_torch.ops.window import window_gather, window_gather_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_window_gather_on_card(dev):
    rng = np.random.default_rng(0)
    land = torch.from_numpy(rng.uniform(size=(70, 90)).astype(np.float32)).to(dev)
    by = torch.from_numpy(rng.integers(-10, 70, size=37).astype(np.int32)).to(dev)
    bx = torch.from_numpy(rng.integers(-10, 90, size=37).astype(np.int32)).to(dev)
    before = window_gather.launches
    got = window_gather(land, by, bx, 20, 22)
    torch.cuda.synchronize()
    assert window_gather.launches == before + 1
    assert torch.equal(got, window_gather_plain(land, by, bx, 20, 22))


@pytest.mark.parametrize("hat_bf16,atol", [(False, 1e-4), (True, 2e-3)])
def test_render_on_card(dev, hat_bf16, atol):
    rng = np.random.default_rng(1)
    b, wsz, r, a = 5, 20, 3, 50
    win = torch.from_numpy(rng.uniform(size=(b, wsz, wsz)).astype(np.float32)).to(dev)
    theta = rng.uniform(-4, 4, size=b)
    fxy = np.stack([rng.uniform(-3, wsz + 3, b), rng.uniform(-3, wsz + 3, b),
                    np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    fxy = torch.from_numpy(fxy).to(dev)
    dx0 = torch.from_numpy(rng.uniform(-9, 9, size=(r, a)).astype(np.float32)).to(dev)
    dy0 = torch.from_numpy(rng.uniform(-9, 9, size=(r, a)).astype(np.float32)).to(dev)
    got = render_windows(win, fxy, dx0, dy0, hat_bf16)
    want = render_windows_plain(win, fxy, dx0, dy0, hat_bf16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, atol=atol, rtol=0)


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_min_distance_on_card(dev, metric):
    """Ragged everywhere: rows not a multiple of the row tile, a library of
    two tiles with a ragged second, pixels not a multiple of the stage."""
    rng = np.random.default_rng(2)
    rows, nl, p = 130, 70, 300
    a = torch.from_numpy(rng.uniform(size=(rows, p)).astype(np.float32)).to(dev)
    b = torch.from_numpy(rng.uniform(size=(nl, p)).astype(np.float32)).to(dev)
    if metric == "ssd":
        args = (a, b, torch.sum(b * b, dim=1), -2.0, True)
    else:
        args = (zscore(a), zscore(b), torch.zeros(nl, device=dev), -1.0 / p, False)
    got = min_distance_rows(*args)
    want = min_distance_rows_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_wrappers_count_launches_and_refuse_mixed_devices(dev):
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(size=(65, 17)).astype(np.float32)).to(dev)
    min_distance_rows(a, a[:3], torch.zeros(3, device=dev), -2.0, True)
    assert ops.launch_counts()["min_distance"] == 1
    with pytest.raises(ValueError, match="different devices"):
        min_distance_rows(a, a[:3].cpu(), torch.zeros(3), -2.0, True)
