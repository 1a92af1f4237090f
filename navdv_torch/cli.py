"""Command-line interface: ``python -m navdv_torch.cli <command>``
(counterpart of the JAX package's ``cli.py``).

Commands:
  demo     train on a route and run batched recall, writing plots (+ movie)
  sweep    run the BASELINE config-5 parameter grid with on-disk resume
  analyze  RIDF curve + familiarity/catchment map for a trained route
  bench    the benchmark harness (navdv_torch.bench: the same parser and body)

Every command runs on the card unless ``--device cpu`` is given. The plots
need matplotlib, which only the commands that plot import.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from navdv_torch import bench
from navdv_torch.agent import FAM_IMPLS


def _add_world_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--landscape", default="blobs",
                   choices=["blobs", "noise", "fractal", "checker", "flat"])
    p.add_argument("--landscape-file", default=None,
                   help="image (PNG/JPEG) or .npy texture; overrides --landscape")
    p.add_argument("--size", type=int, default=512)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--route", default="sine", choices=["line", "sine"])
    p.add_argument("--route-length", type=float, default=200.0)
    p.add_argument("--impl", default="auto", choices=("auto",) + FAM_IMPLS,
                   help="familiarity path; auto = the JAX package's per-workload "
                        "choice (agent.resolve_fam_impl), kernel = exact numerics")
    p.add_argument("--device", default=None,
                   help="torch device, 'cuda' (the default) or 'cpu'")


def _cli_route(args, size):
    """Route for the CLI commands. The edge margin scales down on small
    worlds (a fixed 60 would leave a 128-px world 8 px of route whatever
    --route-length asks for), and a truncated --route-length warns."""
    from navdv_torch.routes import make_route

    _, w = size
    margin = min(60.0, w / 4.0)
    avail = w - 2.0 * margin
    if args.route_length > avail + 1e-9:
        print(
            f"warning: --route-length {args.route_length:g} does not fit "
            f"world width {w} at margin {margin:g}; truncated to {avail:g}",
            file=sys.stderr,
        )
    return make_route(args.route, size=size, margin=margin, length=args.route_length)


def _load_world(args, size):
    from navdv_torch.landscape import load_landscape, make_landscape

    if getattr(args, "landscape_file", None):
        return load_landscape(args.landscape_file)
    return make_landscape(args.landscape, size=size, seed=args.seed)


def _arc_steps(route, step_size: float) -> int:
    """A step budget of 1.3x the route's arc length."""
    return int(np.hypot(*np.diff(route, axis=0).T).sum() / step_size * 1.3)


def cmd_demo(args) -> None:
    from navdv_torch import viz
    from navdv_torch.agent import StepRecord, init_state, make_navigate_batch, make_statics
    from navdv_torch.config import baseline_config
    from navdv_torch.device import resolve_device
    from navdv_torch.metrics import episode_metrics, success_rate
    from navdv_torch.training import train_library
    from navdv_torch.trials import make_trials

    dev = resolve_device(args.device)
    cfg = baseline_config(args.config)
    landscape = _load_world(args, (args.size, args.size))
    route = _cli_route(args, landscape.shape)
    steps = args.steps or _arc_steps(route, cfg.agent.step_size)
    cfg = dataclasses.replace(cfg, agent=dataclasses.replace(cfg.agent, max_steps=steps))
    lib = train_library(landscape, route, cfg, device=dev)
    st = make_statics(landscape, lib, route, dev)
    starts, thetas = make_trials(route, cfg, args.trials, seed=args.seed)
    final, rec = make_navigate_batch(cfg, fam_impl=args.impl, device=dev)(
        init_state(starts, thetas, dev), st)
    rate = float(success_rate(final))
    print(f"library: {lib.views.shape[0]} views | trials: {args.trials} | "
          f"success_rate: {rate:.3f}")
    os.makedirs(args.out, exist_ok=True)
    print("wrote", viz.plot_trajectory(landscape, route, rec,
                                       os.path.join(args.out, "trajectories.png")))
    print("wrote", viz.plot_familiarity_trace(rec, os.path.join(args.out, "familiarity.png")))
    if args.movie:
        one = StepRecord(*(x[0] for x in rec))
        print("wrote", viz.animate_episode(landscape, route, one,
                                           os.path.join(args.out, "episode.mp4")))
    m = episode_metrics(final, rec)
    with open(os.path.join(args.out, "metrics.json"), "w") as f:
        json.dump(
            {
                "success_rate": rate,
                "mean_steps": float(m["n_steps"].float().mean()),
                "mean_path_error": float(m["mean_path_error"].mean()),
            },
            f,
            indent=2,
        )


def cmd_bench(args) -> None:
    """The bench's own defended body on the arguments its parser gave."""
    bench.run_defended(args, bench.build_parser())


def cmd_sweep(args) -> None:
    """The grid in this process, or with ``--cells-mesh N`` its cells spread
    over N ranks (one process each, under torchrun), where rank 0 writes the
    files and the kernel recall check is off, as in the JAX package."""
    if not args.cells_mesh:
        _sweep(args)
        return
    import torch.distributed as dist

    from navdv_torch.parallel import init_distributed, make_mesh

    owned = not dist.is_initialized()
    dev = init_distributed(device=args.device, backend=args.backend)
    try:
        world = dist.get_world_size()
        if world != args.cells_mesh:
            print(f"--cells-mesh {args.cells_mesh} needs one process per rank and this world "
                  f"has {world}: run it as torchrun --nproc-per-node {args.cells_mesh} "
                  "-m navdv_torch.cli sweep ...", file=sys.stderr)
            raise SystemExit(2)
        _sweep(args, make_mesh(args.cells_mesh, 1, device=dev))
    finally:
        if owned:
            dist.destroy_process_group()


def _sweep(args, cells_mesh=None) -> None:
    from navdv_torch import viz
    from navdv_torch.config import SimConfig
    from navdv_torch.sweep import SweepSpec, run_sweep

    landscape = _load_world(args, (args.size, args.size))
    route = _cli_route(args, landscape.shape)
    # budget in steps: arc length / step size (the cells run the spec's
    # default kinematics)
    steps = args.steps or _arc_steps(route, SimConfig().agent.step_size)
    trial_seed = args.trial_seed if args.trial_seed is not None else args.seed
    if args.spec:
        # the JSON spec is authoritative; --steps still overrides its budget
        spec = SweepSpec.from_json(args.spec)
        if args.steps:
            spec = dataclasses.replace(spec, max_steps=args.steps)
    else:
        spec = SweepSpec(n_trials=args.trials, max_steps=steps, seed=trial_seed,
                         start_anywhere=args.start_anywhere, lib_bucket=args.lib_bucket)
    shard = None
    if args.shard:
        i, n = args.shard.split("/")
        shard = (int(i), int(n))
    results = run_sweep(landscape, route, spec, args.out, fam_impl=args.impl, shard=shard,
                        cells_mesh=cells_mesh,
                        recall_check_trials=0 if cells_mesh is not None else args.recall_check,
                        device=args.device)
    if cells_mesh is not None and cells_mesh.data_index != 0:
        return
    viz.plot_sweep_heatmap(results, "scan", "px", os.path.join(args.out, "success_heatmap.png"))
    print(f"sweep complete: {len(results)} cells -> {args.out}/summary.json")


def cmd_analyze(args) -> None:
    """RIDF + catchment-map diagnostics for a trained route (analysis.py)."""
    from navdv_torch import viz
    from navdv_torch.analysis import familiarity_map, ridf
    from navdv_torch.config import SimConfig
    from navdv_torch.device import as_tensor, resolve_device
    from navdv_torch.oracle import resample_route
    from navdv_torch.training import train_library

    dev = resolve_device(args.device)
    landscape = _load_world(args, (args.size, args.size))
    route = _cli_route(args, landscape.shape)
    cfg = SimConfig()
    land_dev = as_tensor(landscape, torch.float32, dev)
    lib = train_library(land_dev, route, cfg, device=dev)
    pts, headings = resample_route(route, cfg.capture_spacing)
    i = (min(max(args.pose_index, 0), len(pts) - 1) if args.pose_index >= 0
         else len(pts) // 2)
    os.makedirs(args.out, exist_ok=True)

    angles, fam = ridf(land_dev, lib, pts[i], headings[i], cfg, fam_impl=args.impl, device=dev)
    k = int(np.argmin(fam))
    print("wrote", viz.plot_ridf(
        angles, fam, os.path.join(args.out, "ridf.png"),
        title=f"RIDF at capture pose {i} (valley {np.degrees(angles[k]):+.1f} deg)"))

    fmap = familiarity_map(land_dev, lib, cfg, stride=args.stride, fam_impl=args.impl,
                           batch=args.batch, device=dev)
    print("wrote", viz.plot_familiarity_map(landscape, route, fmap,
                                            os.path.join(args.out, "familiarity_map.png")))
    with open(os.path.join(args.out, "analysis.json"), "w") as f:
        json.dump(
            {
                "ridf_pose": [float(pts[i][0]), float(pts[i][1]), float(headings[i])],
                "ridf_valley_deg": float(np.degrees(angles[k])),
                "ridf_depth": float(fam[k]) / max(float(np.max(fam)), 1e-30),
                "map_grid": [len(fmap["y"]), len(fmap["x"])],
                "map_stride": args.stride,
                "fam_min": float(fmap["fam"].min()),
                "fam_max": float(fmap["fam"].max()),
            },
            f,
            indent=2,
        )
    print(f"analysis complete -> {args.out}/analysis.json")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="navdv_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    d = sub.add_parser("demo", help="train + batched recall + plots")
    _add_world_args(d)
    d.add_argument("--config", type=int, default=1)
    d.add_argument("--steps", type=int, default=None, help="override max_steps")
    d.add_argument("--trials", type=int, default=256)
    d.add_argument("--movie", action="store_true")
    d.add_argument("--out", default="out/demo")
    d.set_defaults(fn=cmd_demo)

    b = sub.add_parser("bench", parents=[bench.build_parser(add_help=False)],
                       help="throughput harness with its recall and parity gates")
    b.set_defaults(fn=cmd_bench)

    s = sub.add_parser("sweep", help="BASELINE config-5 grid with resume")
    _add_world_args(s)
    s.add_argument("--trials", type=int, default=256)
    s.add_argument("--steps", type=int, default=None, help="default: route arc length * 1.3")
    s.add_argument("--out", default="out/sweep")
    s.add_argument("--shard", default=None, metavar="I/N",
                   help="run every N-th cell starting at I (array-job pattern)")
    s.add_argument("--spec", default=None, help="SweepSpec JSON file")
    s.add_argument("--start-anywhere", action="store_true",
                   help="start trials uniformly along the route (harder task)")
    s.add_argument("--recall-check", type=int, default=64,
                   help="per cell, re-run this many trials on the exact kernel "
                        "path and record success_rate_jnp (0 = off)")
    s.add_argument("--trial-seed", type=int, default=None,
                   help="trial-randomization seed (default: --seed, which also "
                        "seeds the landscape)")
    s.add_argument("--cells-mesh", type=int, default=0, metavar="N",
                   help="spread the cells over N ranks, one process each: run under "
                        "torchrun --nproc-per-node N (0 = this process alone)")
    s.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="process-group backend for --cells-mesh (default: NCCL with a "
                        "card per rank, gloo on --device cpu; gloo lets ranks share a card)")
    s.add_argument("--lib-bucket", type=int, default=0,
                   help="pad libraries to a multiple of this many views so "
                        "spacing-only cells share one navigate function "
                        "(0 = off; padded views never win the minimum)")
    s.set_defaults(fn=cmd_sweep)

    a = sub.add_parser("analyze", help="RIDF curve + familiarity/catchment map figures")
    _add_world_args(a)
    a.add_argument("--stride", type=float, default=8.0, help="map grid spacing in px")
    a.add_argument("--batch", type=int, default=1024, help="map positions per probe batch")
    a.add_argument("--pose-index", type=int, default=-1,
                   help="capture-pose index for the RIDF (-1 = mid-route)")
    a.add_argument("--out", default="out/analysis")
    a.set_defaults(fn=cmd_analyze)
    return ap


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
