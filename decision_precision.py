"""How often does rounding decide the first heading on the config-4 slice?

    python3 decision_precision.py [--device cpu|cuda] [--batch 1024]

Builds the step-0 candidate views of the ``chip_smoke.py`` slice (BASELINE
config 4, 512^2 blobs world, 50 views, trials from ``make_trials(seed=0)``)
and scores them against the library six ways:

- ``fp32_kernel_form``: |c|^2 + |l|^2 - 2 c.l with fp32 sums, |c|^2 summed
  over the candidate (the TPU Pallas kernel's arithmetic);
- ``fp32_jnp_form``: the same with |c|^2 taken from the pooled panorama's
  per-lag statistics (the JAX ``jnp`` path's arithmetic);
- ``fp64_port``: the port's arithmetic, fp64 sums of the fp32 inputs with
  the fp32 library norms (``ops.familiarity.min_distance_rows_plain``);
- ``fp64_jnp_form``: the JAX ``jnp`` form in fp64, |c|^2 from the per-lag
  statistics of the pooled panorama;
- ``port_wrapper``: the same through ``ops.familiarity.min_distance_rows``,
  which on the card is the CUDA kernel (another summation order);
- ``exact``: the same decomposition entirely in fp64, library norms too.

For each it prints the share of agents whose tie-ordered first heading
equals the exact one, the pairwise agreements, and quantiles of the exact
gap between the best two headings. One JSON line.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from chip_smoke import slice_config
from navdv_torch.agent import init_state, make_statics
from navdv_torch.device import resolve_device
from navdv_torch.ops.familiarity import min_distance_rows, min_distance_rows_plain
from navdv_torch.sensor import (
    make_lag_stats,
    make_pooled_panorama,
    make_render_batch,
    make_views_from_pooled,
    scan_lag_sets,
)
from navdv_torch.training import train_library
from navdv_torch.trials import make_trials


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args()
    dev = resolve_device(args.device)

    cfg, land, route = slice_config()
    lib = train_library(land, route, cfg, device=dev)
    st = make_statics(land, lib, route, device=dev)
    starts, thetas = make_trials(route, cfg, args.batch, seed=0)
    s0 = init_state(starts, thetas, device=dev)
    pano = make_render_batch(cfg.sensor, dev)(st.landscape, s0.xy, s0.theta)
    pooled = make_pooled_panorama(cfg.sensor, dev)(pano)
    lags, window_idx = scan_lag_sets(cfg.scan)
    cand = make_views_from_pooled(cfg.sensor, lags, dev)(pooled)  # [B, L, P]
    b, n_lags, p = cand.shape
    rows = cand.reshape(-1, p)
    flat, sq = lib.flat, lib.sq

    def lag_min(d):  # [B*L, Nl] or [B, L, Nl] distances -> [B, L]
        return d.reshape(b, n_lags, -1).clamp_min(0).min(dim=2).values

    cross32 = rows @ flat.T
    _, lag_sq = make_lag_stats(cfg.sensor, lags, dev)(pooled)
    flat64 = flat.double()
    cross64 = rows.double() @ flat64.T
    _, lag_sq64 = make_lag_stats(cfg.sensor, lags, dev)(pooled.double())
    variants = {
        "fp32_kernel_form": lag_min(torch.sum(rows * rows, 1, keepdim=True) + sq - 2 * cross32),
        "fp32_jnp_form": lag_min(lag_sq.reshape(-1, 1) + sq - 2 * cross32),
        "fp64_port": min_distance_rows_plain(rows, flat, sq, -2.0, True)
        .clamp_min(0).reshape(b, n_lags),
        "fp64_jnp_form": lag_min(lag_sq64.reshape(-1, 1) + sq.double() - 2 * cross64),
        "port_wrapper": min_distance_rows(rows, flat, sq, -2.0, True)
        .clamp_min(0).reshape(b, n_lags),
        "exact": lag_min(torch.sum(rows.double() ** 2, 1, keepdim=True)
                         + torch.sum(flat64 * flat64, 1) - 2 * cross64),
    }
    widx = torch.as_tensor(window_idx.astype(np.int64), device=dev)
    tie = torch.as_tensor(cfg.scan.tie_order(), device=dev)
    picks, fams = {}, {}
    for name, m in variants.items():
        fam = m.double()[:, widx].min(dim=2).values  # [B, Nh]
        picks[name] = tie[torch.argmin(fam[:, tie], dim=1)]
        fams[name] = fam

    def agree(x, y):
        return float((picks[x] == picks[y]).double().mean())

    best2 = torch.sort(fams["exact"], dim=1).values[:, :2]
    gap = (best2[:, 1] - best2[:, 0]).cpu().numpy()
    print(json.dumps({
        "device": str(dev), "batch": b,
        "agree_with_exact": {n: agree(n, "exact") for n in variants if n != "exact"},
        "kernel_form_vs_jnp_form": agree("fp32_kernel_form", "fp32_jnp_form"),
        "port_wrapper_vs_fp64_port": agree("port_wrapper", "fp64_port"),
        "fp64_jnp_form_vs_fp64_port": agree("fp64_jnp_form", "fp64_port"),
        "max_abs_err_vs_exact": {n: float((fams[n] - fams["exact"]).abs().max())
                                 for n in variants if n != "exact"},
        "exact_best_two_gap_quantiles": {q: float(np.quantile(gap, q))
                                         for q in (0.01, 0.05, 0.1, 0.5)},
        "exact_best_fam_median": float(best2[:, 0].median()),
    }), flush=True)


if __name__ == "__main__":
    main()
