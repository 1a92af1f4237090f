"""Static configuration dataclasses.

A copy of the JAX package's configuration: field names and defaults are
identical, so a config built in one package carries to the other field by
field (``convert.config_from``). Comments are trimmed to what the port
honours; fields that select implementations the port does not have yet
(conv, infomax) are kept so that the dataclasses stay equal; the port
raises where such a path is asked for and warns where such a knob is set.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class SensorConfig:
    """Polar-panorama sensor.

    The sensor view is ``(n_radial, n_azimuth)`` px; the fine panorama has
    ``n_azimuth * az_upsample`` azimuth bins so candidate headings land on
    integer fine-bin shifts (rotation == cyclic shift, exact).
    """

    n_radial: int = 16
    n_azimuth: int = 72
    az_upsample: int = 5
    r_min: float = 2.0
    r_max: float = 10.0
    # rounding class of the batched renderer's bilinear weights:
    # "float32" (exact bilinear) or "bfloat16" (window values and weights
    # rounded to bf16, products accumulated in f32). "bfloat16" also rounds
    # the panorama to bf16 before the box filter of
    # sensor.make_pooled_panorama.
    hat_dtype: str = "float32"
    # "full" or "sector": heading = k*bin_width + phi, the panorama rendered
    # in the phi frame and its k roll absorbed in the spectra; takes effect
    # only with fam_impl="fft" (other paths render "full", numerically
    # equivalent). n_sectors / ring_blocks are validated as in the JAX
    # package and change nothing in the port's output (sensor.py). phi_bins:
    # the JAX package's approximate phi-quantized variant, 0 = off.
    render_mode: str = "full"
    n_sectors: int = 8
    ring_blocks: int = 1
    phi_bins: int = 0

    @property
    def n_fine(self) -> int:
        return self.n_azimuth * self.az_upsample

    @property
    def bin_width(self) -> float:
        return 2.0 * math.pi / self.n_fine

    @property
    def n_pixels(self) -> int:
        return self.n_radial * self.n_azimuth


@dataclasses.dataclass(frozen=True)
class ScanConfig:
    """Heading scan + familiarity scoring mode."""

    n_headings: int = 60
    scan_step_bins: int = 2
    metric: str = "ssd"  # "ssd" | "ncc"
    tol_bins: int = 0  # RIDF rotation tolerance (fine bins), 0 = off
    # JAX matmul pass count for the distance cross term. The port ignores
    # it: its distances sum fp32 products in fp64, because the SSD
    # decomposition cancels (ops/familiarity.py).
    matmul_precision: str = "high"
    # fft_product_precision: a JAX pass count too, ignored likewise.
    # fused_dft_precision: sector + "fft" + az_upsample == 1 only; "off"
    # takes the unfused sector branch, any other value the fused front end,
    # whose DFT contraction the port forms in fp64 whatever pass count the
    # value names (ROADMAP C.10).
    # spectral_cutoff: "fft" only, the first bins of the azimuth DFT kept
    # (0 = all, exact). fixed_point_bits / roll_rank: "roll" + SSD only
    # (8-bit exact SSD; low-rank split with a bf16 residual product).
    fft_product_precision: str = "inherit"
    fused_dft_precision: str = "off"
    spectral_cutoff: int = 0
    fixed_point_bits: int = 0
    roll_rank: int = 0
    infomax_units: int = 0
    infomax_eta: float = 0.1
    infomax_epochs: int = 0
    infomax_seed: int = 0

    def shifts(self) -> list[int]:
        """Candidate fine-bin shifts relative to the current heading."""
        half = self.n_headings // 2
        return [(k - half) * self.scan_step_bins for k in range(self.n_headings)]

    def tie_order(self) -> list[int]:
        """Candidate evaluation order for argmin tie-breaking: smallest
        |shift| first, then lowest index. Taking the argmin over candidates
        permuted by this order implements the rule exactly."""
        s = self.shifts()
        return sorted(range(self.n_headings), key=lambda k: (abs(s[k]), k))


@dataclasses.dataclass(frozen=True)
class AgentConfig:
    """Kinematics and stop conditions."""

    step_size: float = 1.0
    goal_radius: float = 2.0
    corridor: float = 20.0
    max_steps: int = 256  # must cover the route length in steps


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Bundle of everything static for one simulation setup."""

    sensor: SensorConfig = SensorConfig()
    scan: ScanConfig = ScanConfig()
    agent: AgentConfig = AgentConfig()
    capture_spacing: float = 1.0  # world units between stored training views


def baseline_config(n: int) -> SimConfig:
    """The five benchmark configurations of BASELINE.md.

    Configs 1-4 run the bfloat16 weight renderer. Config 4 is config 1's
    workload over 1024 agents (the batch is set by the caller).
    ``spectral_cutoff`` applies to the spectral path only ("fft"); the
    exact paths run with it cleared.
    """
    if n == 1:  # ~50 stored 72x16 views, 60-heading SSD scan
        return SimConfig(
            sensor=SensorConfig(hat_dtype="bfloat16"),
            scan=ScanConfig(spectral_cutoff=72),
        )
    if n == 2:  # dense library: 500 views, 1-degree scan steps
        return SimConfig(
            sensor=SensorConfig(hat_dtype="bfloat16"),
            scan=ScanConfig(n_headings=120, scan_step_bins=1),
            capture_spacing=0.2,
        )
    if n == 3:  # high-res sensors: 360x64 px, NCC + rotation tolerance
        return SimConfig(
            sensor=SensorConfig(
                n_radial=64,
                n_azimuth=360,
                az_upsample=1,
                hat_dtype="bfloat16",
                render_mode="sector",
            ),
            scan=ScanConfig(n_headings=60, scan_step_bins=2, metric="ncc",
                            tol_bins=3, fused_dft_precision="default",
                            spectral_cutoff=30),
        )
    if n == 4:  # batched trials: 1024 agents (batching set by caller)
        return SimConfig(
            sensor=SensorConfig(hat_dtype="bfloat16"),
            scan=ScanConfig(spectral_cutoff=72),
        )
    if n == 5:  # sweep grid
        return SimConfig()
    raise ValueError(f"unknown baseline config {n}")


def baseline_fam_impl(n: int) -> str:
    """The JAX package's familiarity implementation per benchmark config,
    in its names. The port runs each of them under the same names (config
    3's "fft" through the sector renderer); ``agent.resolve_fam_impl`` maps
    "auto", which config 5's sweep resolves per cell."""
    return {1: "fft", 2: "roll", 3: "fft", 4: "fft", 5: "auto"}[n]


def choose_fam_impl(cfg: SimConfig) -> str:
    """The JAX package's ``fam_impl="auto"`` rule: small sensors (fewer than
    512 pixels) take the extract-then-matmul path, NCC takes the spectral
    path, dense SSD libraries (capture_spacing <= 0.5) the rolled library,
    everything else the spectral path."""
    if cfg.sensor.n_pixels < 512:
        return "jnp"
    if cfg.scan.metric == "ncc":
        return "fft"
    if cfg.capture_spacing <= 0.5:
        return "roll"
    return "fft"
