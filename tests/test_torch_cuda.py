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
from navdv_torch.config import ScanConfig, SensorConfig
from navdv_torch.familiarity import LibraryPack, pack_library, zscore
from navdv_torch.ops.familiarity import min_distance_rows, min_distance_rows_plain
from navdv_torch.ops.lag import lag_lib_min, lag_lib_min_plain, make_lag_fam
from navdv_torch.ops.render import render_windows, render_windows_plain
from navdv_torch.ops.window import window_gather, window_gather_plain
from navdv_torch.sensor import scan_lag_sets

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("wy,wx", [(20, 22), (24, 24), (7, 9)])
@pytest.mark.parametrize("b", [1, 37])
def test_window_gather_on_card(dev, b, wy, wx):
    """Agent tiles full and short, windows with wy * wx % 4 == 0 (float4
    stores) and not (7 x 9), corners outside the landscape on every side."""
    rng = np.random.default_rng(0)
    land = torch.from_numpy(rng.uniform(size=(70, 90)).astype(np.float32)).to(dev)
    by = torch.from_numpy(rng.integers(-10, 70, size=b).astype(np.int32)).to(dev)
    bx = torch.from_numpy(rng.integers(-10, 90, size=b).astype(np.int32)).to(dev)
    before = window_gather.launches
    got = window_gather(land, by, bx, wy, wx)
    torch.cuda.synchronize()
    assert window_gather.launches == before + 1
    assert torch.equal(got, window_gather_plain(land, by, bx, wy, wx))


def _render_inputs(rng, b, wsz, r, a, dev):
    win = torch.from_numpy(rng.uniform(size=(b, wsz, wsz)).astype(np.float32)).to(dev)
    theta = rng.uniform(-4, 4, size=b)
    fxy = np.stack([rng.uniform(-3, wsz + 3, b), rng.uniform(-3, wsz + 3, b),
                    np.cos(theta), np.sin(theta)], axis=1).astype(np.float32)
    fxy = torch.from_numpy(fxy).to(dev)
    dx0 = torch.from_numpy(rng.uniform(-9, 9, size=(r, a)).astype(np.float32)).to(dev)
    dy0 = torch.from_numpy(rng.uniform(-9, 9, size=(r, a)).astype(np.float32)).to(dev)
    return win, fxy, dx0, dy0


@pytest.mark.parametrize("wsz", [7, 20, 24])
@pytest.mark.parametrize("r,a", [(3, 50), (16, 360)])
@pytest.mark.parametrize("b", [1, 5, 33])
@pytest.mark.parametrize("hat_bf16", [False, True])
def test_render_on_card(dev, hat_bf16, b, r, a, wsz):
    """Bit for bit the plain version: R*A % 4 != 0 (3 x 50, per-sample loads
    and stores) and == 0 (16 x 360), W^2 % 4 != 0 (7, 4-byte staging tail),
    B short of the agent tile (1, 5) and past it (33); poses partly outside
    the window, so both clamps fire."""
    win, fxy, dx0, dy0 = _render_inputs(np.random.default_rng(1), b, wsz, r, a, dev)
    before = render_windows.launches
    got = render_windows(win, fxy, dx0, dy0, hat_bf16)
    want = render_windows_plain(win, fxy, dx0, dy0, hat_bf16)
    torch.cuda.synchronize()
    assert render_windows.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("hat_bf16", [False, True])
def test_render_on_card_misaligned(dev, hat_bf16):
    """Windows and offsets that start 4 bytes past a 16-byte boundary take
    the 4-byte staging and per-sample paths, bit for bit the plain version."""
    win, fxy, dx0, dy0 = _render_inputs(np.random.default_rng(2), 9, 24, 16, 360, dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    args = (shifted(win), fxy, shifted(dx0), shifted(dy0), hat_bf16)
    got = render_windows(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, render_windows_plain(*args))


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("p", [75, 300, 1152])
@pytest.mark.parametrize("nl", [1, 7, 8, 50, 57, 130])
@pytest.mark.parametrize("rows", [1, 130])
@pytest.mark.parametrize("metric", ["ssd", "ncc"])
def test_min_distance_on_card(dev, metric, rows, nl, p, aligned):
    """Ragged edges of the DMMA tile: rows not a multiple of the row tile,
    libraries under, at and over one 56-entry tile and not a multiple of the
    8-entry n-tile, pixels not a multiple of the 16-pixel chunk. P = 75 and a
    4-byte-misaligned ``a`` take the 4-byte staging path."""
    rng = np.random.default_rng(2)
    buf = torch.from_numpy(rng.uniform(size=rows * p + 1).astype(np.float32)).to(dev)
    a = (buf[:-1] if aligned else buf[1:]).view(rows, p)
    b = torch.from_numpy(rng.uniform(size=(nl, p)).astype(np.float32)).to(dev)
    if metric == "ssd":
        args = (a, b, torch.sum(b * b, dim=1), -2.0, True)
    else:
        args = (zscore(a), zscore(b), torch.zeros(nl, device=dev), -1.0 / p, False)
        if not aligned:  # zscore allocates anew: misalign its result too
            za = torch.empty(rows * p + 1, device=dev)
            za[1:].view(rows, p).copy_(args[0])
            args = (za[1:].view(rows, p), *args[1:])
    got = min_distance_rows(*args)
    want = min_distance_rows_plain(*args)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_lag_fam_on_card(dev):
    """Ragged everywhere: B = 5, L = 72 lags (two lag tiles, negative lags),
    a library of 70 entries, P = 75 pixels, tol_bins = 1; the kernel against
    its plain version, and the whole familiarity against the CPU's."""
    rng = np.random.default_rng(4)
    sensor = SensorConfig(n_radial=3, n_azimuth=25, az_upsample=3)
    scan = ScanConfig(n_headings=70, scan_step_bins=1, tol_bins=1)
    lags, _ = scan_lag_sets(scan)
    assert len(lags) > 64
    pano = torch.from_numpy(
        rng.uniform(size=(5, sensor.n_radial, sensor.n_fine)).astype(np.float32))
    views = rng.uniform(size=(70, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    lib = pack_library(torch.from_numpy(views).to(dev))
    lags_t = torch.from_numpy(lags.astype(np.int32)).to(dev)
    before = lag_lib_min.launches
    got = lag_lib_min(pano.to(dev), lib.flat, lib.sq, sensor, lags_t)
    want = lag_lib_min_plain(pano.to(dev), lib.flat, lib.sq, sensor, lags_t)
    torch.cuda.synchronize()
    assert lag_lib_min.launches == before + 1
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    fam_card = make_lag_fam(sensor, scan, device=dev)(pano.to(dev), lib)
    fam_cpu = make_lag_fam(sensor, scan, device="cpu")(pano, LibraryPack(*(t.cpu() for t in lib)))
    torch.testing.assert_close(fam_card.cpu(), fam_cpu, rtol=1e-6, atol=1e-6)


def test_lag_kernel_equals_min_distance_kernel(dev):
    """The two kernels share one DMMA tile and so one summation order: on the
    same candidates, pooled in fp32 as the lag kernel pools them, their
    minima are equal bit for bit (config-4 sensor, 60 scan lags, Nl = 50)."""
    rng = np.random.default_rng(6)
    sensor = SensorConfig(n_radial=16, n_azimuth=72, az_upsample=5)
    scan = ScanConfig(n_headings=60)
    lags, _ = scan_lag_sets(scan)
    b = 33
    pano = torch.from_numpy(
        rng.uniform(size=(b, sensor.n_radial, sensor.n_fine)).astype(np.float32)).to(dev)
    views = rng.uniform(size=(50, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    lib = pack_library(torch.from_numpy(views).to(dev))
    lags_t = torch.from_numpy(lags.astype(np.int32)).to(dev)
    u, w, a = sensor.az_upsample, sensor.n_azimuth, sensor.n_fine
    s = pano
    for j in range(1, u):
        s = s + torch.roll(pano, -j, dims=2)
    cols = torch.remainder(torch.arange(w, device=dev)[None, :] * u + lags_t.long()[:, None], a)
    cand = (s * float(np.float32(1.0 / u))).index_select(2, cols.reshape(-1))
    cand = cand.reshape(b, sensor.n_radial, len(lags), w).permute(0, 2, 1, 3)
    cand = cand.reshape(b * len(lags), sensor.n_pixels).contiguous()
    lag = lag_lib_min(pano, lib.flat, lib.sq, sensor, lags_t)
    md = min_distance_rows(cand, lib.flat, lib.sq, -2.0, True).clamp_min(0.0)
    torch.cuda.synchronize()
    assert torch.equal(lag.reshape(-1), md)


def test_wrappers_count_launches_and_refuse_mixed_devices(dev):
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.uniform(size=(65, 17)).astype(np.float32)).to(dev)
    min_distance_rows(a, a[:3], torch.zeros(3, device=dev), -2.0, True)
    assert ops.launch_counts()["min_distance"] == 1
    with pytest.raises(ValueError, match="different devices"):
        min_distance_rows(a, a[:3].cpu(), torch.zeros(3), -2.0, True)


@pytest.mark.parametrize("b", [1, 7])
@pytest.mark.parametrize(
    "impl,scan_kw",
    [("roll", {}), ("roll", {"fixed_point_bits": 8}), ("roll", {"roll_rank": 4}),
     ("fft", {}), ("fft", {"spectral_cutoff": 9})],
    ids=["roll", "roll_fixed_point", "roll_rank", "fft", "fft_cutoff"],
)
def test_extraction_free_paths_on_card(dev, impl, scan_kw, b):
    """The rolled-library and spectral paths on the card against the CPU at
    ragged shapes: P = 75 and |Q|*Nl = 7 * 25 not multiples of 8 and
    B*u <= 16 rows (the int8 product's padding), negative lags. Fixed point
    equals the CPU bit for bit; the fp64 paths up to summation order; the
    low-rank split within its bf16 residual's bound."""
    from navdv_torch.familiarity_fft import make_lib_min_fft
    from navdv_torch.familiarity_roll import make_lib_min_roll
    from navdv_torch.sensor import make_lag_stats

    rng = np.random.default_rng(7)
    sensor = SensorConfig(n_radial=3, n_azimuth=25, az_upsample=3)
    scan = ScanConfig(n_headings=12, scan_step_bins=1, tol_bins=1, **scan_kw)
    lags, _ = scan_lag_sets(scan)
    s = torch.from_numpy(rng.uniform(size=(b, 3, sensor.n_fine)).astype(np.float32))
    lib = pack_library(torch.from_numpy(rng.uniform(size=(7, 3, 25)).astype(np.float32)))
    make = make_lib_min_fft if impl == "fft" else make_lib_min_roll
    out = {}
    for d in ("cpu", dev):
        s_d, lib_d = s.to(d), LibraryPack(*(t.to(d) for t in lib))
        stats = make_lag_stats(sensor, lags, d)(s_d.double())
        out[str(d)] = make(sensor, scan, lags, d)(s_d, lib_d, *stats).cpu()
    torch.cuda.synchronize()
    got, want = out[str(dev)], out["cpu"]
    if scan_kw.get("fixed_point_bits"):
        assert torch.equal(got, want)
    elif scan_kw.get("roll_rank"):
        scale = float(lib.sq.max())
        torch.testing.assert_close(got, want, rtol=4e-3, atol=4e-3 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=1e-9, atol=1e-9)
