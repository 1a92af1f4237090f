"""The port's window-gather module against the JAX Pallas window kernel
(interpret mode) on the CPU, where the wrapper runs its plain PyTorch
version; the CUDA kernel itself runs only on the card
(tests/test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from navdv_torch import ops
from navdv_torch.config import SensorConfig
from navdv_torch.ops.familiarity import min_distance_rows
from navdv_torch.ops.lag import lag_lib_min
from navdv_torch.ops.window import window_gather
from navdv_tpu.ops.window_pallas import make_window_gather_pallas


@pytest.mark.parametrize("corners", ["in_range", "out_of_range"])
def test_window_gather_matches_pallas(corners):
    """B=512 windows, exactly as the Pallas kernel (interpret mode) cuts
    them; corners outside the landscape clamp into it."""
    rng = np.random.default_rng(3)
    h, w, wy, wx, b = 96, 384, 24, 24, 512
    land = rng.uniform(size=(h, w)).astype(np.float32)
    land = np.concatenate([land, np.tile(land[-1:], (8, 1))], axis=0)  # Pallas contract
    base_y = rng.integers(0, h - wy, size=b).astype(np.int32)
    base_x = rng.integers(0, w - wx, size=b).astype(np.int32)
    if corners == "in_range":
        want = np.asarray(make_window_gather_pallas(wy, wx, interpret=True)(
            jnp.asarray(land), jnp.asarray(base_y), jnp.asarray(base_x)))
        gy, gx = base_y, base_x
    else:
        gy = base_y + rng.integers(-300, 300, size=b).astype(np.int32)
        gx = base_x + rng.integers(-600, 600, size=b).astype(np.int32)
        cy = np.clip(gy, 0, land.shape[0] - wy)
        cx = np.clip(gx, 0, w - wx)
        want = np.stack([land[y:y + wy, x:x + wx] for y, x in zip(cy, cx)])
    got = window_gather(torch.from_numpy(land), torch.from_numpy(gy), torch.from_numpy(gx), wy, wx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrappers_take_plain_path_on_cpu_only(small_world):
    """On CPU tensors the wrappers run their plain versions and launch
    nothing; a device that is neither CPU nor CUDA is refused."""
    land, _ = small_world
    ops.reset_launch_counts()
    by = torch.tensor([3, 40], dtype=torch.int32)
    window_gather(torch.from_numpy(land), by, by, 20, 20)
    a = torch.from_numpy(np.random.default_rng(4).uniform(size=(8, 12)).astype(np.float32))
    min_distance_rows(a, a[:3], torch.zeros(3), -2.0, True)
    sensor = SensorConfig(n_radial=2, n_azimuth=6, az_upsample=2)
    lag_lib_min(a.reshape(4, 2, 12), a[:3], torch.zeros(3), sensor,
                torch.arange(-2, 3, dtype=torch.int32))
    assert ops.launch_counts() == {"window_gather": 0, "render": 0, "min_distance": 0,
                                   "lag_fam": 0}
    meta = torch.empty(8, 12, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        min_distance_rows(meta, meta[:3], torch.empty(3, device="meta"), -2.0, True)


def test_window_gather_refuses_landscapes_past_32_bit_offsets():
    """The kernel indexes the landscape with 32-bit offsets; the wrapper
    refuses a landscape of 2^31 cells or more on every device."""
    land = torch.zeros(1).expand(46341, 46341)  # 2,147,488,281 cells, no storage
    by = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="2\\^31 cells"):
        window_gather(land, by, by, 24, 24)
