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
from navdv_torch.ops.familiarity import (
    min_distance_pooled,
    min_distance_pooled_plain,
    min_distance_rows,
    min_distance_rows_plain,
)
from navdv_torch.ops.lag import lag_lib_min, lag_lib_min_plain, make_lag_fam
from navdv_torch.ops.render import (
    render_pooled,
    render_pooled_plain,
    render_pooled_smem_bytes,
    render_windows,
    render_windows_plain,
)
from navdv_torch.ops.window import window_gather, window_gather_plain
from navdv_torch.sensor import make_views_from_pooled, scan_lag_sets

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


@pytest.mark.parametrize("hat_bf16", [False, True])
@pytest.mark.parametrize("b,r,a,u,wsz", [
    (1, 16, 360, 5, 24), (9, 16, 360, 5, 24), (1024, 16, 360, 5, 24),
    (5, 3, 50, 2, 7), (9, 17, 360, 5, 24), (3, 2, 4096, 3, 20), (9, 4, 21, 21, 7),
    (9, 16, 360, 1, 24),
], ids=["config4_b1", "config4_b9", "config4_b1024", "r3a50_u2_w7", "r17_short_chunk",
        "a4096_ring_a_block", "u_equals_a21", "u1"])
def test_render_pooled_on_card(dev, b, r, a, u, wsz, hat_bf16):
    """The pooled entry bit for bit its plain version (render, bf16 round
    in the bf16 class, left-to-right u-tap sum): configs 1, 2 and 4's shape
    (16 x 360, u = 5) at B = 1, 9 (a short agent tile) and 1024; one chunk
    with W^2 % 4 != 0; 17 rings, so the last chunk holds fewer; a ring of
    4096 samples, one a chunk; u = A < 32; u = 1."""
    win, fxy, dx0, dy0 = _render_inputs(np.random.default_rng(b + r + u), b, wsz, r, a, dev)
    before = render_pooled.launches
    got = render_pooled(win, fxy, dx0, dy0, u, hat_bf16)
    want = render_pooled_plain(win, fxy, dx0, dy0, u, hat_bf16)
    torch.cuda.synchronize()
    assert render_pooled.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("hat_bf16", [False, True])
def test_render_pooled_on_card_misaligned(dev, hat_bf16):
    """Windows and offsets 4 bytes past a 16-byte boundary: the 4-byte
    staging path, bit for bit the plain version; and the launcher's shared
    memory equals the wrapper's budget."""
    import ctypes

    from navdv_torch import _build

    win, fxy, dx0, dy0 = _render_inputs(np.random.default_rng(3), 9, 24, 16, 360, dev)

    def shifted(t):
        buf = torch.empty(t.numel() + 1, device=dev)
        buf[1:].copy_(t.reshape(-1))
        return buf[1:].view(t.shape)

    args = (shifted(win), fxy, shifted(dx0), shifted(dy0), 5, hat_bf16)
    got = render_pooled(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, render_pooled_plain(*args))
    smem = _build.load_function("render", "navdv_render_pooled_smem_bytes", [ctypes.c_int] * 4)
    assert smem(24, 16, 360, 5) == render_pooled_smem_bytes(24, 16, 360, 5)


@pytest.mark.parametrize("config", [4, 3])
def test_episode_renders_pooled_panorama_on_card(dev, monkeypatch, config):
    """Over one captured episode of the bench world, config 4 on exact
    ``kernel`` launches the pooled render once a step and the plain render
    never, and equals bit for bit the episode that renders the panorama and
    pools it apart (``make_pooled_panorama``); config 3's sector path (u =
    1) takes the plain render and never the pooled one."""
    from chip_smoke import bench_config, slice_config
    from navdv_torch import agent
    from navdv_torch.agent import (AgentState, StepRecord, init_state, make_navigate_batch,
                                   make_statics)
    from navdv_torch.sensor import make_pooled_panorama, make_render_batch
    from navdv_torch.training import train_library
    from navdv_torch.trials import make_trials

    cfg, land, route = slice_config() if config == 4 else bench_config(3, 50)
    fam_impl, batch = ("kernel", 1024) if config == 4 else ("fft", 256)
    st = make_statics(land, train_library(land, route, cfg, device=dev), route, dev)
    states = init_state(*make_trials(route, cfg, batch, seed=0), dev)
    run = make_navigate_batch(cfg, fam_impl, device=dev)
    aux = None if run.prepare is None else run.prepare(st)
    run(states, st, aux)  # capture
    ops.reset_launch_counts()
    got = run(states, st, aux)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    if config == 3:
        assert counts["render_pooled"] == 0 and counts["render"] == 66
        return
    assert counts["render_pooled"] == cfg.agent.max_steps == 66 and counts["render"] == 0

    def render_then_pool(sensor, device=None, pooled=False):
        render = make_render_batch(sensor, device)
        if not pooled:
            return render
        pool = make_pooled_panorama(sensor)
        return lambda *args: pool(render(*args))

    monkeypatch.setattr(agent, "make_render_batch", render_then_pool)
    ops.reset_launch_counts()
    want = make_navigate_batch(cfg, fam_impl, device=dev)(states, st, aux)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["render"] > 0 and counts["render_pooled"] == 0
    for name, g, w in zip(AgentState._fields + StepRecord._fields, [*got[0], *got[1]],
                          [*want[0], *want[1]]):
        assert torch.equal(g, w), name


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


CONFIG4_SENSOR = SensorConfig(n_radial=16, n_azimuth=72, az_upsample=5)
CONFIG4_LAGS = scan_lag_sets(ScanConfig(n_headings=60))[0]
WRAPPING_LAGS = np.array([-40, -36, -7, -1, 0, 3, 11, 35, 36, 70, 71])
R3W7_U1 = SensorConfig(n_radial=3, n_azimuth=7, az_upsample=1)
R3W7_U5 = SensorConfig(n_radial=3, n_azimuth=7, az_upsample=5)


@pytest.mark.parametrize("sensor,lags,b,nl,layout,with_rowsq", [
    (CONFIG4_SENSOR, CONFIG4_LAGS, 37, 50, "contiguous", True),
    (CONFIG4_SENSOR, CONFIG4_LAGS, 37, 57, "contiguous", True),
    (CONFIG4_SENSOR, CONFIG4_LAGS, 37, 120, "offset", True),
    (CONFIG4_SENSOR, CONFIG4_LAGS[::7], 9, 50, "strided", True),
    (CONFIG4_SENSOR, CONFIG4_LAGS, 3, 50, "contiguous", False),
    (R3W7_U1, WRAPPING_LAGS, 37, 50, "contiguous", True),
    (R3W7_U1, WRAPPING_LAGS[::2], 130, 57, "offset", True),
    (R3W7_U5, WRAPPING_LAGS, 37, 120, "strided", True),
    (R3W7_U5, np.arange(-200, 200), 1, 9, "contiguous", True),
], ids=["config4", "config4_nl57", "config4_nl120_offset", "config4_subset_strided",
        "config4_no_rowsq", "r3w7_u1_wrap", "r3w7_u1_offset", "r3w7_u5_strided",
        "r3w7_u5_400_lags"])
def test_min_distance_pooled_on_card(dev, sensor, lags, b, nl, layout, with_rowsq):
    """The pooled entry against the rows entry on the candidates that
    ``make_views_from_pooled`` gathers, bit for bit: config 4's shape at B
    = 37 (B L not a multiple of the 128-row tile), one and several library
    tiles, u = 1 and 5, P = 21 (P % 4 != 0), lags that wrap past A in both
    directions, a subset of lags, S contiguous, one float off 16-byte
    alignment, or strided; its plain version within rounding."""
    rng = np.random.default_rng(b + nl + len(lags))
    shape = (b, sensor.n_radial, sensor.n_fine)
    if layout == "contiguous":
        s = torch.from_numpy(rng.uniform(size=shape).astype(np.float32)).to(dev)
    elif layout == "offset":
        buf = torch.from_numpy(rng.uniform(size=int(np.prod(shape)) + 1).astype(np.float32))
        s = buf.to(dev)[1:].view(shape)
    else:
        wide = rng.uniform(size=(*shape[:2], 2 * shape[2])).astype(np.float32)
        s = torch.from_numpy(wide).to(dev)[:, :, 1::2]
    views = rng.uniform(size=(nl, sensor.n_radial, sensor.n_azimuth)).astype(np.float32)
    lib = pack_library(torch.from_numpy(views).to(dev))
    lags_t = torch.from_numpy(lags.astype(np.int32)).to(dev)
    alpha = -2.0 if with_rowsq else -1.0 / sensor.n_pixels
    before = min_distance_pooled.launches
    got = min_distance_pooled(s, lags_t, lib.flat, lib.sq, sensor, alpha, with_rowsq)
    rows = make_views_from_pooled(sensor, lags, dev)(s).reshape(-1, sensor.n_pixels)
    want = min_distance_rows(rows, lib.flat, lib.sq, alpha, with_rowsq).reshape(b, len(lags))
    plain = min_distance_pooled_plain(s, lags_t, lib.flat, lib.sq, sensor, alpha, with_rowsq)
    torch.cuda.synchronize()
    assert min_distance_pooled.launches == before + 1
    assert torch.equal(got, want)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("bad", ["lags_on_cpu", "lib_on_cpu", "s_dtype", "s_shape"])
def test_min_distance_pooled_refuses_bad_inputs_on_card(dev, bad):
    s = torch.zeros(4, 3, 35, device=dev)
    lags = torch.arange(-2, 3, dtype=torch.int32, device=dev)
    b, gamma = torch.zeros(3, 21, device=dev), torch.zeros(3, device=dev)
    if bad == "lags_on_cpu":
        lags = lags.cpu()
    elif bad == "lib_on_cpu":
        b = b.cpu()
    elif bad == "s_dtype":
        s = s.double()
    else:
        s = torch.zeros(4, 3, 21, device=dev)
    before = min_distance_pooled.launches
    with pytest.raises(ValueError, match="min_distance_pooled"):
        min_distance_pooled(s, lags, b, gamma, R3W7_U5, -2.0, True)
    assert min_distance_pooled.launches == before


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


@pytest.mark.parametrize("metric", ["ssd", "ncc"])
@pytest.mark.parametrize("b", [1, 7])
def test_conv_fam_on_card(dev, metric, b):
    """The conv path's fp64 convolution on the card against the CPU at ragged
    shapes (P = 75, negative lags, a tolerance window): the per-lag minima
    of the pooled panorama, RIDF-pooled here as the step pools them, equal
    up to fp64 summation order."""
    from navdv_torch.familiarity_conv import make_lib_min_conv
    from navdv_torch.sensor import make_lag_stats, make_pooled_panorama

    rng = np.random.default_rng(11)
    sensor = SensorConfig(n_radial=3, n_azimuth=25, az_upsample=3)
    scan = ScanConfig(n_headings=12, scan_step_bins=1, tol_bins=1, metric=metric)
    pano = torch.from_numpy(rng.uniform(size=(b, 3, sensor.n_fine)).astype(np.float32))
    lib = pack_library(torch.from_numpy(rng.uniform(size=(7, 3, 25)).astype(np.float32)))
    lags, window_idx = scan_lag_sets(scan)

    def fam(d):
        s = make_pooled_panorama(sensor, d)(pano.to(d))
        lag_sum = lag_sq = None
        if metric == "ncc":
            lag_sum, lag_sq = make_lag_stats(sensor, lags, d)(s.double())
        m = make_lib_min_conv(sensor, scan, d)(s, LibraryPack(*(t.to(d) for t in lib)),
                                               lag_sum, lag_sq)
        assert m.dtype == torch.float32 and m.shape == (b, len(lags))
        return torch.min(m[:, torch.as_tensor(window_idx.astype(np.int64), device=d)],
                         dim=2).values.cpu()

    out = {str(d): fam(d) for d in ("cpu", dev)}
    torch.testing.assert_close(out[str(dev)], out["cpu"], rtol=1e-9, atol=1e-9)


def test_infomax_on_card(dev):
    """Infomax training on the card from the CPU's initial weights equals the
    CPU's within f32 reassociation, and scores the same candidates alike."""
    from navdv_torch.familiarity_infomax import make_lib_min_infomax, train_infomax

    rng = np.random.default_rng(12)
    lib = pack_library(torch.from_numpy(rng.uniform(size=(9, 3, 25)).astype(np.float32)))
    lib_d = LibraryPack(*(t.to(dev) for t in lib))
    got = train_infomax(lib_d, n_units=20, eta=0.1, epochs=4, seed=5)
    want = train_infomax(lib, n_units=20, eta=0.1, epochs=4, seed=5)
    assert got.w.device.type == "cuda"
    torch.testing.assert_close(got.w.cpu(), want.w, rtol=1e-5, atol=1e-6)
    sensor, scan = SensorConfig(n_radial=3, n_azimuth=25, az_upsample=3), ScanConfig()
    cand = torch.from_numpy(rng.uniform(size=(2, 5, 75)).astype(np.float32))
    c64 = cand.double()
    score = make_lib_min_infomax(sensor, scan)
    on_card = score(cand.to(dev), lib_d, c64.sum(2).to(dev), (c64 * c64).sum(2).to(dev), got)
    on_cpu = score(cand, lib, c64.sum(2), (c64 * c64).sum(2), want)
    torch.testing.assert_close(on_card.cpu(), on_cpu, rtol=1e-5, atol=1e-6)
