#!/usr/bin/env python3
"""Spread a parameter sweep's cells over ranks with the PyTorch port.

A grid sweep is embarrassingly parallel at cell granularity. With
``run_sweep(cells_mesh=...)`` the cells that share a navigate function (the
same sensor and scan; library shapes matched by ``lib_bucket``) run as one
group, each rank its share of the group's cells, and each cell's
aggregates are gathered to every rank. Rank 0 writes the per-cell result
files, and resume works as in the serial sweep.

One process per rank, for example one per card::

    torchrun --nproc-per-node 4 examples/mesh_sweep_torch.py [--out DIR]

or on the CPU with gloo::

    torchrun --nproc-per-node 2 examples/mesh_sweep_torch.py --device cpu

or with more ranks than cards, sharing them over gloo::

    torchrun --nproc-per-node 2 examples/mesh_sweep_torch.py --backend gloo

``--out`` defaults to ``navdv_torch_mesh_sweep`` in the system's temporary
directory.
"""

import argparse
import os
import sys
import tempfile

# runnable from anywhere: torchrun path/to/examples/mesh_sweep_torch.py
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch.distributed as dist  # noqa: E402

import navdv_torch as nt  # noqa: E402
from navdv_torch.parallel import global_mesh, init_distributed  # noqa: E402
from navdv_torch.sweep import SweepSpec, run_sweep  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "navdv_torch_mesh_sweep"))
    ap.add_argument("--device", default=None, help="'cuda' (the default, a card per rank) or 'cpu'")
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="default: NCCL with a card per rank, gloo on the CPU; "
                         "gloo lets more ranks than cards share them")
    args = ap.parse_args()

    device = init_distributed(device=args.device, backend=args.backend)
    try:
        mesh = global_mesh(n_lib=1, device=device)
        rank0 = dist.get_rank() == 0
        if rank0:
            print(f"ranks: {dist.get_world_size()} ({dist.get_backend()}, {device.type}); "
                  f"cell mesh: data={mesh.shape['data']}")
        landscape = nt.make_landscape("blobs", size=(256, 256), seed=7, n_features=80)
        route = nt.make_route("sine", size=(256, 256), margin=50.0, length=60.0, amplitude=8.0)
        # one sensor and scan x a 4-point capture-density axis: lib_bucket
        # matches the library shapes, so the four cells form one group
        spec = SweepSpec(
            sensor_px=((72, 16, 5),),
            scan_granularity=((60, 2),),
            capture_spacing=(0.8, 1.2, 1.6, 2.0),
            n_trials=64,
            max_steps=96,
            lib_bucket=128,
        )
        results = run_sweep(landscape, route, spec, args.out, cells_mesh=mesh,
                            tensorboard=False, verbose=rank0)
        if rank0:
            print(f"\n{len(results)} cells -> {args.out}")
            for key in sorted(results):
                r = results[key]
                print(f"  {key}: success={float(r['success_rate']):.3f} "
                      f"views={int(r['n_library_views'])} group={int(r['group_size'])}")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
