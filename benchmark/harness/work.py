"""Work counted from a configuration's shapes, and the card's peaks.

The peaks are NVIDIA's H100 SXM data sheet: HBM3 at 3.35 TB/s, and 67
TFLOP/s, which is the fp64 tensor-core rate. A roofline share is the least
time these allow for the work, over the time the trace gives the kernels
that do it.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
FP64_FLOP_PER_S = 67e12


def render_bytes(batch: int, sensor: dict) -> int:
    """Bytes one render launch must move: each agent's square window read
    once (``ceil(2 r_max) + 4`` on a side, f32) and its pose (a float4),
    the two f32[R, A] offset tables, and the f32[B, R, A] panorama written."""
    wsz = int(math.ceil(2 * sensor["r_max"])) + 4
    r, a = sensor["n_radial"], sensor["n_azimuth"] * sensor["az_upsample"]
    return batch * wsz * wsz * 4 + batch * 16 + 2 * r * a * 4 + batch * r * a * 4


def roll_product_flops(batch: int, sensor: dict, scan: dict, views: int) -> float:
    """Operations of one step's rolled-library product: 2 B P Nl L, every
    candidate's P pixels against ``views`` stored views at each of the L
    lags the scan needs."""
    p = sensor["n_radial"] * sensor["n_azimuth"]
    lags = len({(k - scan["n_headings"] // 2) * scan["scan_step_bins"] + d
                for k in range(scan["n_headings"])
                for d in range(-scan["tol_bins"], scan["tol_bins"] + 1)})
    return 2.0 * batch * p * views * lags
