"""Plain reference of the Infomax learned memory (Baddeley, Graham, Husbands
& Philippides 2012, PLoS Comput Biol 8:e1002336; the training rule of Lulham
et al. 2009), in PyTorch, for judging what the program produced.

It imports neither the program nor JAX and takes nothing the program has
made. Like :mod:`reference.sector_ncc`, it re-exports
:mod:`reference.navref`'s route, library, candidate panorama, kinematics,
decision and stop rules, and replaces the familiarity:

- the network W f32[M, P], ``M = infomax_units`` (0: P, the literature's
  shape), drawn as ``torch.randn((M, P), generator=torch.Generator()
  .manual_seed(infomax_seed), dtype=torch.float32) / sqrt(P)`` on the CPU;
- training input: each stored view z-scored over its P pixels in float32
  with epsilon 1e-8 (:func:`reference.sector_ncc.zscored`);
- the dose (``infomax_epochs = 0``, AUTO): ``0.8 P spacing Nl`` updates,
  ``spacing`` the library's capture spacing, as whole epochs of the views
  in library order and then a fractional epoch of ``n`` views, every
  ``max(1, Nl // n)``-th from the first (:func:`dose`); a stated
  ``infomax_epochs`` presents that many whole epochs;
- training, one update per presented view x in float32 with TF32 off, in
  SEMANTICS.md §9's order: ``h = W x``, ``g = h^T W``, then
  ``W + eta / P (W - (tanh h + h) g^T)``, each product and sum rounded as
  the plain expression rounds it (float32 is the rounding class the
  configuration states for training);
- novelty at shift s: the candidate x, the pooled panorama's pixels
  ``fl32(S / u)`` at the columns ``w u + s`` as navref takes them, z-scored
  over its P pixels and multiplied by W, both in float64 from those float32
  values: ``mean_i |(W z(x))_i|``; smaller is more familiar, and the
  tie-ordered argmin over the headings decides (navref's ``choose``);
- the scale of ``fam_err`` and ``decision_gap`` (:func:`scale`): the
  pose's least novelty, that of its best heading, so that both read as
  shares of the novelties compared there.

The precision the configuration states is float32, for W and for the
novelty: W is trained in float32, and two float32 trainings of the dose
differ by about 7e-5 (relative, Frobenius), so a novelty scored in float64
from a float32 W is known no better than float32 knows it. The reference
computed in float32 (``novelty(..., "float32")``: its own W, scored in
float32 with TF32 off) therefore meets every limit of the cell, and the
cell cannot tell a float64 product from a float32 one. The control, the
reference in the nearest precision below the configuration's, scores its
own W with the product's inputs rounded to TF32's 10-bit mantissa
(``"tf32"``, :data:`CONTROL`): ``check.judge`` asks for it as
``dtype=torch.float32``, the class below navref's float64. A further fault,
``"bf16_w"``, trains W rounded to bfloat16 after every update and scores it
in float32.

Departures from SEMANTICS.md §9:

- the candidate is z-scored directly, where §9 folds its z-score into the
  product, ``W z(x) = (W x - mu_x W 1) / sigma_x``: equal in exact
  arithmetic, and the direct form does not cancel;
- the AUTO dose is the exact ``0.8 P spacing Nl`` updates that both
  packages' ``dose_schedule`` trains (the port's
  ``navdv_torch.familiarity_infomax`` states it), where §9's "Defaults"
  give ``ceil(0.8 P spacing)`` whole epochs;
- no padded views: the reference's library has none, so the zero-masked
  update of a ``valid = 0`` view never arises;
- the spacing is not in the configuration file: :func:`train_library`
  keeps the spacing it was given beside the library it returns, and the
  network of that library is trained with it.

The network is trained once for each library and spec (and once more for
the ``"bf16_w"`` fault) and kept for every block of poses that
:func:`familiarity_blocked` scores.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from reference import navref
from reference.navref import (  # noqa: F401  (the route, kinematics, decision and stop rules)
    STATUS_DIVERGED,
    STATUS_OFF,
    STATUS_REACHED,
    STATUS_RUNNING,
    advance,
    candidate_panorama,
    choose,
    polyline_dist,
    resample_route,
    stop_status,
)
from reference.sector_ncc import NCC_EPS, zscored

KEEP = 4  # libraries, and networks, kept for the calls that follow
PRECISIONS = ("float64", "float32", "tf32", "bf16_w")
CONTROL = "tf32"  # what familiarity(dtype=torch.float32), the harness's control, computes


@dataclasses.dataclass(frozen=True)
class Spec(navref.Spec):
    """navref's spec with the network's knobs."""

    units: int  # M
    eta: float
    epochs: int  # 0: AUTO
    seed: int


def spec_from_config(config: dict) -> Spec:
    base = navref.read_spec(config)
    if base.familiarity != "infomax":
        raise ValueError("the infomax reference covers familiarity 'infomax'")
    scan = config["sim"]["scan"]
    return Spec(**dataclasses.asdict(base), units=scan["infomax_units"] or base.n_pixels,
                eta=scan["infomax_eta"], epochs=scan["infomax_epochs"], seed=scan["infomax_seed"])


_SPACINGS: list = []  # (library, its capture spacing), newest last
_NETWORKS: list = []  # (library, spec, bf16_w, W)


def _keep(store: list, item: tuple) -> None:
    store.append(item)
    del store[:-KEEP]


def train_library(landscape: torch.Tensor, route: np.ndarray, spacing: float,
                  spec: Spec, pool_dtype: torch.dtype | None = None) -> torch.Tensor:
    """navref's library f64[Nl, R, W], its capture spacing kept for the
    network trained on it."""
    lib = navref.train_library(landscape, route, spacing, spec, pool_dtype)
    _keep(_SPACINGS, (lib, spacing))
    return lib


def spacing_of(lib: torch.Tensor) -> float:
    for kept, spacing in reversed(_SPACINGS):
        if kept is lib:
            return spacing
    raise ValueError("no capture spacing for this library: make it with train_library")


def dose(n_views: int, n_pixels: int, epochs: int, spacing: float) -> tuple[int, list[int]]:
    """(whole epochs, the views of the fractional epoch) presented for
    ``epochs`` (0: AUTO, ``0.8 P spacing Nl`` updates)."""
    if epochs:
        return epochs, []
    target = 0.8 * n_pixels * spacing * n_views
    whole = int(target // n_views)
    frac = min(n_views, int(round(target - whole * n_views)))
    if whole == 0 and frac == 0:
        frac = 1
    rows = list(range(0, n_views, max(1, n_views // frac)))[:frac] if frac else []
    return whole, rows


def initial_weights(units: int, n_pixels: int, seed: int) -> torch.Tensor:
    gen = torch.Generator().manual_seed(seed)
    return torch.randn((units, n_pixels), generator=gen, dtype=torch.float32) / math.sqrt(n_pixels)


def train(lib: torch.Tensor, spec: Spec, spacing: float, epochs: int | None = None,
          bf16_w: bool = False) -> torch.Tensor:
    """W f32[M, P] trained on ``lib`` (f64[Nl, R, W]) on its device: the
    dose of ``spec`` (``epochs`` whole epochs where given); ``bf16_w``
    rounds W to bfloat16 after every update."""
    z = zscored(lib)  # f32[Nl, P]
    nl, p = z.shape
    whole, rows = dose(nl, p, spec.epochs if epochs is None else epochs, spacing)
    w = initial_weights(spec.units, p, spec.seed).to(z.device)
    rate = spec.eta / p
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for i in list(range(nl)) * whole + rows:
            h = w @ z[i]
            g = h @ w
            w = w + rate * (w - torch.outer(torch.tanh(h) + h, g))
            if bf16_w:
                w = w.bfloat16().float()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return w


def network(lib: torch.Tensor, spec: Spec, bf16_w: bool = False) -> torch.Tensor:
    """The trained W of ``lib`` (the ``"bf16_w"`` fault's with ``bf16_w``),
    trained at its first call and kept."""
    for kept, s, b, w in reversed(_NETWORKS):
        if kept is lib and s == spec and b == bf16_w:
            return w
    w = train(lib, spec, spacing_of(lib), bf16_w=bf16_w)
    _keep(_NETWORKS, (lib, spec, bf16_w, w))
    return w


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32's 10-bit mantissa, to nearest, ties to
    even: what a TF32 tensor-core product takes of its inputs at best."""
    i = x.contiguous().view(torch.int32)
    i = (i + (0xFFF + ((i >> 13) & 1))) & ~0x1FFF
    return i.view(torch.float32)


def candidates(s: torch.Tensor, spec: Spec) -> torch.Tensor:
    """f32[N, Nh, P]: each heading's candidate view from the pooled
    panoramas S f64[N, R, A], the pixels ``fl32(S / u)`` at the pooled
    columns ``w u + s``, flattened ring by ring."""
    u, w, a = spec.az_upsample, spec.n_azimuth, spec.n_fine
    x = s.float() * (1.0 / u)
    shifts = torch.as_tensor(spec.shifts(), device=s.device)
    cols = (torch.arange(w, device=s.device)[None, :] * u + shifts[:, None]) % a  # [Nh, W]
    return x[:, :, cols].permute(0, 2, 1, 3).reshape(s.shape[0], spec.n_headings, -1)


def scale(s: torch.Tensor, lib: torch.Tensor, spec: Spec) -> torch.Tensor:
    """The least float64 novelty over the headings at each pose. A novelty
    has no units, but its size is W's: the dose multiplies W by about e^4,
    and the novelties range over twentyfold (0.49 to 10.3 in four worlds at
    config 1's widths), so the float rounding and W's drift in training
    read as a share of the novelty, the way the program's float32 result
    rounds."""
    return familiarity_blocked(s, lib, spec).min(dim=1).values


def novelty(s: torch.Tensor, lib: torch.Tensor, spec: Spec,
            precision: str = "float64") -> torch.Tensor:
    """Novelty f[N, Nh] of every candidate heading from the pooled panoramas
    S f64[N, R, A] against the network trained on ``lib``, in ``precision``:
    ``"float64"``, the reference; ``"float32"``, the same W scored in
    float32; ``"tf32"``, that with the product's inputs rounded to TF32;
    ``"bf16_w"``, the network trained rounded to bfloat16, scored in
    float32. Every float32 product runs with TF32 off."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    dtype = torch.float64 if precision == "float64" else torch.float32
    w = network(lib, spec, bf16_w=precision == "bf16_w").to(dtype)
    x = candidates(s, spec).to(dtype)
    mu = x.mean(dim=2, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=2, keepdim=True)
    z = (x - mu) / torch.sqrt(var + NCC_EPS)
    if precision == "tf32":
        z, w = to_tf32(z), to_tf32(w)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return (z @ w.T).abs().mean(dim=2)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def familiarity(s: torch.Tensor, lib: torch.Tensor, spec: Spec,
                dtype: torch.dtype = torch.float64) -> torch.Tensor:
    """:func:`novelty` for the harness: float64, the reference; float32,
    its control, in :data:`CONTROL`'s precision."""
    return novelty(s, lib, spec, "float64" if dtype == torch.float64 else CONTROL)


def familiarity_blocked(s: torch.Tensor, lib: torch.Tensor, spec: Spec,
                        dtype: torch.dtype = torch.float64, block: int = 256) -> torch.Tensor:
    """:func:`familiarity` in blocks of ``block`` panoramas (bounded memory)."""
    return torch.cat([familiarity(s[i:i + block], lib, spec, dtype)
                      for i in range(0, s.shape[0], block)])
