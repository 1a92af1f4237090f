"""The step's decision (``navdv_torch/ops/decide.py``): on the CPU the
wrapper runs its plain version, which must equal the step's decision as it
was written before the kernel (kept below as ``_reference_decide``); on the
card the kernel must equal the plain version bit for bit, alone and inside
captured episodes of configs 1 and 2. The card cases are marked ``cuda`` and
skip where no CUDA device is present:

    python -m pytest tests/test_torch_decide.py -m cuda -p no:cacheprovider
"""

import dataclasses

import numpy as np
import pytest
import torch

from navdv_torch import agent, ops
from navdv_torch.agent import AgentState, EpisodeStatics, StepRecord, init_state, make_statics
from navdv_torch.config import SimConfig
from navdv_torch.convert import config_from
from navdv_torch.familiarity import PAD_PENALTY
from navdv_torch.ops.decide import Route, decide, decide_constants, decide_plain
from navdv_torch.sensor import scan_shift_sets

LAND = (200, 240)  # (Hl, Wl) of the generated cases
MARGIN = 8.0


def _bits(t: torch.Tensor) -> torch.Tensor:
    """A tensor's bits, so that NaNs compare equal to themselves."""
    if t.dtype == torch.float32:
        return t.view(torch.int32)
    return t


def _assert_bit_equal(got, want, names):
    for name, g, w in zip(names, got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        assert torch.equal(_bits(g), _bits(w)), name


def _route(n_seg: int, dev) -> Route:
    """A sine route across the world of ``n_seg`` segments, as
    ``agent.make_statics`` builds its fields."""
    xs = np.linspace(12.0, 226.0, n_seg + 1)
    ys = 100.0 + 25.0 * np.sin(xs / 23.0)
    pts = torch.as_tensor(np.stack([xs, ys], axis=1), dtype=torch.float32, device=dev)
    st = make_statics(torch.zeros(LAND), _empty_lib(dev), pts, dev)
    return Route(st.route_a, st.route_ab, st.route_denom, st.goal)


def _empty_lib(dev):
    from navdv_torch.familiarity import LibraryPack

    return LibraryPack(*(torch.zeros(1, device=dev) for _ in LibraryPack._fields))


def _inputs(b: int, nh: int, n_seg: int, dev, seed: int = 0):
    """Agents near the route, at the goal, far from the route, at the edge
    of the world and anywhere; a third already done with a stop status;
    familiarity rows of few distinct values (exact ties at several
    headings), with +-0, inf, PAD_PENALTY and NaN entries and rows that
    are all inf or all NaN."""
    rng = np.random.default_rng(seed)
    route = _route(n_seg, dev)
    pts = route.a.cpu().numpy()
    goal = route.goal.cpu().numpy()
    kind = rng.integers(0, 5, b)
    xy = np.empty((b, 2))
    near = pts[rng.integers(0, len(pts), b)] + rng.normal(0.0, 2.0, (b, 2))
    xy[kind == 0] = near[kind == 0]
    xy[kind == 1] = goal + rng.normal(0.0, 1.5, (b, 2))[kind == 1]
    xy[kind == 2] = near[kind == 2] + [0.0, 40.0]
    edge = np.stack([rng.choice([rng.uniform(0, 10), rng.uniform(230, 240)], b),
                     rng.uniform(90, 110, b)], axis=1)
    xy[kind == 3] = edge[kind == 3]
    xy[kind == 4] = np.stack([rng.uniform(0, LAND[1], b), rng.uniform(0, LAND[0], b)], 1)[kind == 4]
    theta = rng.uniform(-np.pi, np.pi, b)
    done = rng.uniform(size=b) < 0.3
    status = np.where(done, rng.integers(1, 4, b), 0)
    fam = (1.0 + 0.5 * rng.integers(0, 4, (b, nh))).astype(np.float32)
    special = rng.uniform(size=(b, nh))
    for value, lo, hi in ((np.inf, 0.0, 0.02), (PAD_PENALTY, 0.02, 0.04), (np.nan, 0.04, 0.042),
                          (0.0, 0.042, 0.047), (-0.0, 0.047, 0.052)):
        fam[(special >= lo) & (special < hi)] = value
    if b > 2:
        fam[1] = np.inf
        fam[2] = np.nan
    t = dict(dtype=torch.float32, device=dev)
    return (torch.as_tensor(xy, **t), torch.as_tensor(theta, **t),
            torch.as_tensor(done, device=dev),
            torch.as_tensor(status, dtype=torch.int32, device=dev),
            torch.as_tensor(fam, device=dev), route, LAND, decide_constants(_config(nh), dev))


def _reference_decide(cfg: SimConfig, state: AgentState, fam: torch.Tensor, st: EpisodeStatics):
    """``agent._make_decide``'s decision as written before the kernel."""
    sensor, ag = cfg.sensor, cfg.agent
    shifts, _ = scan_shift_sets(cfg.scan)
    shifts_dev = torch.as_tensor(shifts, dtype=torch.float32)
    tie_order = torch.as_tensor(cfg.scan.tie_order(), dtype=torch.long)
    binw = sensor.bin_width
    k = tie_order[torch.argmin(fam[:, tie_order], dim=1)]
    theta_new = state.theta + shifts_dev[k] * binw
    xy_new = state.xy + ag.step_size * torch.stack(
        [torch.cos(theta_new), torch.sin(theta_new)], dim=1)
    reached = torch.sum((xy_new - st.goal) ** 2, dim=1) <= ag.goal_radius**2
    p = xy_new
    rel = p[:, None, :] - st.route_a
    t = (torch.sum(rel * st.route_ab, dim=2) / st.route_denom).clamp(0.0, 1.0)
    proj = st.route_a + t[:, :, None] * st.route_ab
    dist_route = torch.sqrt(torch.min(torch.sum((p[:, None, :] - proj) ** 2, dim=2),
                                      dim=1).values)
    diverged = dist_route > ag.corridor
    hl, wl = st.landscape.shape
    margin = sensor.r_max
    x, y = xy_new[:, 0], xy_new[:, 1]
    off = ~((x >= margin) & (x <= wl - 1 - margin) & (y >= margin) & (y <= hl - 1 - margin))
    new_status = torch.where(reached, 1, torch.where(diverged, 2, torch.where(off, 3, 0))
                             ).to(torch.int32)
    was_done = state.done
    out = AgentState(
        xy=torch.where(was_done[:, None], state.xy, xy_new),
        theta=torch.where(was_done, state.theta, theta_new),
        done=was_done | (new_status != 0),
        status=torch.where(was_done, state.status, new_status),
    )
    rec = StepRecord(xy=out.xy, theta=out.theta, fam=torch.gather(fam, 1, k[:, None])[:, 0],
                     k=k.to(torch.int32), dist_route=dist_route, done=was_done)
    return out, rec


def _config(nh: int) -> SimConfig:
    cfg = SimConfig()
    return dataclasses.replace(
        cfg, scan=dataclasses.replace(cfg.scan, n_headings=nh),
        sensor=dataclasses.replace(cfg.sensor, r_max=MARGIN),
        agent=dataclasses.replace(cfg.agent, step_size=2.0, goal_radius=3.0, corridor=15.0))


@pytest.mark.parametrize("n_seg", [40, 320])
@pytest.mark.parametrize("nh", [60, 120])
@pytest.mark.parametrize("b", [1, 7, 1024])
def test_decide_equals_the_step_before_the_kernel(b, nh, n_seg):
    """On CPU tensors ``agent._make_decide`` takes the plain version and
    gives what the step gave before, bit for bit: ties, +-0, inf,
    PAD_PENALTY and NaN familiarity, done and running agents, every status."""
    xy, theta, done, status, fam, route, land, _ = _inputs(b, nh, n_seg, "cpu")
    cfg = _config(nh)
    st = EpisodeStatics(torch.zeros(land), None, *route)
    state = AgentState(xy, theta, done, status)
    before = ops.launch_counts()["decide"]
    got = agent._make_decide(cfg, "cpu")(state, fam, st)
    want = _reference_decide(cfg, state, fam, st)
    assert ops.launch_counts()["decide"] == before
    _assert_bit_equal([*got[0], *got[1]], [*want[0], *want[1]],
                      AgentState._fields + StepRecord._fields)
    assert got[1].xy is got[0].xy and got[1].theta is got[0].theta and got[1].done is done
    if b == 1024:  # every stop status arises, from running agents too
        new = got[0].status[~done]
        assert set(new.tolist()) == {0, 1, 2, 3}
        k_ties = (fam == fam.gather(1, got[1].k.long()[:, None])).sum(dim=1)
        assert int((k_ties > 1).sum()) > b // 4
        assert 0 < int(got[1].fam.isnan().sum()) < b // 4


def test_decide_plain_follows_the_tie_order_and_nan():
    """The first minimum in tie order wins (smallest |shift|, then lowest
    index), a NaN before any number, the first NaN in tie order."""
    c = decide_constants(_config(6), "cpu")  # shifts -6 -4 -2 0 2 4; tie order 3 2 4 1 5 0
    nan, inf = float("nan"), float("inf")
    fam = torch.tensor([[1.0, 1.0, 2.0, 3.0, 2.0, 1.0],
                        [5.0, 4.0, 3.0, 3.0, 3.0, 4.0],
                        [nan, 1.0, nan, 0.0, 1.0, 1.0],
                        [inf, inf, inf, inf, inf, inf],
                        [0.0, -0.0, 1.0, 1.0, -0.0, 0.0]])
    b = fam.shape[0]
    xy = torch.full((b, 2), 100.0)
    d = decide(xy, torch.zeros(b), torch.zeros(b, dtype=torch.bool),
               torch.zeros(b, dtype=torch.int32), fam, _route(40, "cpu"), LAND, c)
    assert d.k.tolist() == [1, 3, 2, 3, 4]
    assert d.fam.isnan().tolist() == [False, False, True, False, False]


def _bad(case):
    xy, theta, done, status, fam, route, land, c = _inputs(5, 60, 40, "cpu")
    args = dict(xy=xy, theta=theta, done=done, status=status, fam=fam, route=route)
    if case == "xy_f64":
        args["xy"] = xy.double()
    elif case == "xy_shape":
        args["xy"] = torch.zeros(5, 3)
    elif case == "theta_batch":
        args["theta"] = theta[:4]
    elif case == "done_u8":
        args["done"] = done.to(torch.uint8)
    elif case == "status_i64":
        args["status"] = status.long()
    elif case == "fam_f64":
        args["fam"] = fam.double()
    elif case == "fam_headings":
        args["fam"] = fam[:, :59]
    elif case == "route_f64":
        args["route"] = route._replace(denom=route.denom.double())
    elif case == "no_segment":
        args["route"] = Route(route.a[:0], route.ab[:0], route.denom[:0], route.goal)
    elif case == "device_mix":
        args["fam"] = torch.empty(fam.shape, device="meta")
    elif case == "meta":
        args = {k: (v.to("meta") if isinstance(v, torch.Tensor)
                    else type(v)(*(t.to("meta") for t in v))) for k, v in args.items()}
        c = c._replace(shifts=c.shifts.to("meta"), tie_order=c.tie_order.to("meta"))
    return args, land, c


@pytest.mark.parametrize("case,match", [
    ("xy_f64", "xy must be"), ("xy_shape", "xy must be"), ("theta_batch", "xy must be"),
    ("done_u8", "done must be"), ("status_i64", "status must be"), ("fam_f64", "fam must be"),
    ("fam_headings", "fam must be"), ("route_f64", "route_denom must be"),
    ("no_segment", "no segment"), ("device_mix", "different devices"),
    ("meta", "unsupported device"),
])
def test_decide_refuses_what_the_kernel_does_not_take(case, match):
    args, land, c = _bad(case)
    with pytest.raises(ValueError, match=match):
        decide(args["xy"], args["theta"], args["done"], args["status"], args["fam"],
               args["route"], land, c)


def test_launch_counts_name_decide(small_cfg, small_world):
    """``ops.launch_counts()`` has the decision's counter; a CPU episode
    leaves it at 0."""
    from navdv_torch.agent import make_navigate_batch_fn
    from navdv_torch.oracle import resample_route
    from navdv_torch.training import train_library

    land, route = small_world
    cfg = config_from(small_cfg)
    st = make_statics(land, train_library(land, route, cfg, device="cpu"), route, "cpu")
    pts, hd = resample_route(route, cfg.capture_spacing)
    ops.reset_launch_counts()
    make_navigate_batch_fn(cfg, "fft", device="cpu")(init_state(pts[:3], hd[:3], "cpu"), st)
    assert ops.launch_counts()["decide"] == 0


# --- on the card ---------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_seg", [40, 320])
@pytest.mark.parametrize("nh", [60, 120])
@pytest.mark.parametrize("b", [1, 7, 1024])
def test_decide_kernel_equals_plain_on_card(dev, b, nh, n_seg):
    """One launch, bit for bit ``decide_plain`` on the card, on the CPU
    cases' inputs."""
    args = _inputs(b, nh, n_seg, dev)
    before = decide.launches
    got = decide(*args)
    want = decide_plain(*args)
    torch.cuda.synchronize()
    assert decide.launches == before + 1
    _assert_bit_equal(got, want, got._fields)


@pytest.mark.cuda
@pytest.mark.parametrize("config,fam_impl,batch,views", [(1, "fft", 1024, 50),
                                                         (2, "roll", 512, 500)])
def test_captured_episode_decides_as_plain_on_card(dev, monkeypatch, config, fam_impl, batch,
                                                   views):
    """A captured episode of a benchmark cell's configuration on the bench
    world launches the kernel once a step and equals, bit for bit, the
    episode whose decision is the plain version (the step before the
    kernel)."""
    from chip_smoke import bench_config
    from navdv_torch.agent import make_navigate_batch
    from navdv_torch.training import train_library
    from navdv_torch.trials import make_trials

    cfg, land, route = bench_config(config, views)
    st = make_statics(land, train_library(land, route, cfg, device=dev), route, dev)
    states = init_state(*make_trials(route, cfg, batch, seed=0), dev)
    run = make_navigate_batch(cfg, fam_impl, device=dev)
    aux = run.prepare(st)
    run(states, st, aux)  # capture
    ops.reset_launch_counts()
    got = run(states, st, aux)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decide"] == cfg.agent.max_steps == 66
    monkeypatch.setattr(agent, "ops_decide", decide_plain)
    plain = make_navigate_batch(cfg, fam_impl, device=dev)
    want = plain(states, st, aux)
    torch.cuda.synchronize()
    assert ops.launch_counts()["decide"] == 66  # no launch in the plain episode
    _assert_bit_equal([*got[0], *got[1]], [*want[0], *want[1]],
                      AgentState._fields + StepRecord._fields)
