"""Learned familiarity: the Infomax novelty network (``fam_impl="infomax"``;
opt-in, never picked by ``"auto"``). Counterpart of the JAX package's
``familiarity_infomax.py``; the semantics are SEMANTICS.md §9.

- Training, once per library (the step's prepare stage): each z-scored
  library view x is presented to W[M, P]; with h = Wx, y = tanh(h), the
  Infomax update is ``dW = eta / P * (W - (y + h) (h^T W))``, presented once
  per epoch in library order. It is sequential by construction: f32
  matrix-vector products on the device that never wait for the host, one
  epoch of them captured as a CUDA graph and replayed per epoch.
- Scoring, every step: novelty ``mean_i |h_i|`` over the M units with the
  candidate's z-score folded in, ``h = (Wx - mu_x * W1) / sigma_x``, formed
  in fp64 from the fp32 candidates and the fp32 W (the cancellation is
  NCC's; ROADMAP C.1).

The initial weights come from a ``torch.Generator`` seeded with
``infomax_seed``, drawn on the CPU so that every device starts from the
same W; the same seed gives another network than the JAX package's
threefry draw (ROADMAP C.11). ``train_infomax(..., w0=...)`` takes the
initial weights from the caller instead.

Tracing (:mod:`navdv_torch.utils.profiling`): :func:`train_infomax` runs in
the span ``infomax_train``, and :func:`infomax_counts` counts, since the last
:func:`reset_infomax_counts`, the trainings and the updates they applied.
Both are bookkept once a training; the scoring keeps the step's
``candidates`` and ``familiarity`` stages.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from navdv_torch.capture import Captured
from navdv_torch.device import as_tensor
from navdv_torch.familiarity import NCC_EPS, LibraryPack
from navdv_torch.utils.profiling import span

_COUNTS = {"trainings": 0, "updates": 0}


def infomax_counts() -> dict[str, int]:
    """Since the last reset: :func:`train_infomax` calls (``"trainings"``)
    and the updates they applied (``"updates"``, :func:`applied_updates`
    summed)."""
    return dict(_COUNTS)


def reset_infomax_counts() -> None:
    for name in _COUNTS:
        _COUNTS[name] = 0


class InfomaxPack(NamedTuple):
    """The trained network, the prepare-once aux of ``fam_impl="infomax"``.

    w:    f32[M, P] trained weights
    wsum: f32[M]    per-unit weight sums (fold the candidate z-score into
                    the scoring product)
    """

    w: torch.Tensor
    wsum: torch.Tensor


def auto_epochs(n_views: int, n_pixels: int, capture_spacing: float | None = None) -> int:
    """Epochs for ``infomax_epochs=0``: ``round(0.8 * P * capture_spacing)``,
    i.e. ~0.8·P updates per arc pixel of route (the optimum of the JAX
    package's measured dose-response, invariant to capture density).
    Without ``capture_spacing``, 40·P total updates.
    :func:`train_infomax`'s ``epochs=0`` hits the dose exactly through a
    fractional final epoch; prefer it over this rounded helper."""
    if capture_spacing is not None:
        return max(1, round(0.8 * n_pixels * capture_spacing))
    return max(1, -(-40 * n_pixels // max(1, n_views)))


def dose_schedule(n_views: int, n_pixels: int, epochs: int,
                  capture_spacing: float | None = None) -> tuple[int, list[int]]:
    """What :func:`train_infomax` presents: ``(whole epochs, the views of the
    fractional final epoch)``. ``epochs=0`` is AUTO: with ``capture_spacing``
    the dose ``0.8 * P * spacing * Nl`` updates is hit exactly, the last
    epoch an evenly strided subset that spans the whole route instead of
    biasing the extra dose toward its start; without it, whole epochs of
    :func:`auto_epochs`'s 40·P fallback."""
    frac_n = 0
    if epochs == 0:
        if capture_spacing is not None:
            target = 0.8 * n_pixels * capture_spacing * n_views  # updates
            epochs = int(target // n_views)
            frac_n = min(n_views, int(round(target - epochs * n_views)))
            if epochs == 0 and frac_n == 0:
                frac_n = 1
        else:
            epochs = auto_epochs(n_views, n_pixels, None)
    frac_rows = list(range(0, n_views, max(1, n_views // frac_n)))[:frac_n] if frac_n else []
    return epochs, frac_rows


def applied_updates(lib: LibraryPack, epochs: int, capture_spacing: float | None = None) -> int:
    """The updates :func:`train_infomax` applies to ``lib`` with these
    arguments: every presented view but the padded ones (valid = 0)."""
    valid = [float(v) != 0.0 for v in lib.valid.cpu()]
    whole, frac_rows = dose_schedule(len(valid), int(lib.z.shape[1]), epochs, capture_spacing)
    return whole * sum(valid) + sum(valid[i] for i in frac_rows)


def initial_weights(n_units: int, n_pixels: int, seed: int) -> torch.Tensor:
    """``normal(0, 1/P)`` initial weights f32[M, P] on the CPU, from a
    ``torch.Generator`` seeded with ``seed`` (ROADMAP C.11)."""
    gen = torch.Generator().manual_seed(seed)
    w0 = torch.randn((n_units, n_pixels), generator=gen, dtype=torch.float32)
    return w0 / torch.sqrt(torch.tensor(float(n_pixels), dtype=torch.float32))


def train_infomax(lib: LibraryPack, n_units: int, eta: float, epochs: int, seed: int,
                  capture_spacing: float | None = None, w0=None, captured: bool = True
                  ) -> InfomaxPack:
    """Train W on the library's z-scored views, on the library's device.

    Padded views (valid = 0) take no update, so bucketed libraries train
    identically to unpadded ones. ``epochs=0`` is AUTO (:func:`dose_schedule`;
    :func:`applied_updates` counts the updates). ``w0`` (f32[M, P], any
    device) replaces :func:`initial_weights`.

    The whole epochs run as one epoch of updates captured as a CUDA graph
    (:mod:`navdv_torch.capture`; the JAX package's ``lax.scan``), replayed
    ``epochs`` times on a static W into which ``w0`` is copied: the
    capture's warm-up trains that buffer, never the caller's ``w0``. The
    fractional epoch (at most one pass over the views) runs eagerly after
    them. ``captured=False`` runs every update from the host instead, the
    loop the graph replays; W is the same bit for bit."""
    with span("infomax_train"):
        z = lib.z.float()  # [Nl, P]
        nl, p = z.shape
        epochs, frac_rows = dose_schedule(nl, p, epochs, capture_spacing)
        if w0 is None:
            w0 = initial_weights(n_units, p, seed)
        w = as_tensor(w0, torch.float32, z.device).clone()  # trained in place
        scale = eta / p
        # the one host read before the loop: which views update, and by how much
        valid = [float(v) for v in lib.valid.cpu()]
        per_epoch = sum(v != 0.0 for v in valid)  # updates an epoch applies
        frac = sum(valid[i] != 0.0 for i in frac_rows)

        def present(w, z, rows):
            for i in rows:
                if valid[i] == 0.0:
                    continue  # w + 0 * dW == w
                h = torch.mv(w, z[i])  # [M]
                hw = torch.mv(w.t(), h)  # [P] == h^T W
                dw = torch.addr(w, torch.tanh(h).add_(h), hw, alpha=-1.0)  # W - (y + h) (h^T W)
                w.add_(dw, alpha=scale * valid[i])
            return w

        if captured and epochs > 0:
            epoch = Captured(lambda w, z: present(w, z, range(nl)), z.device, "infomax epoch")
            g = epoch.graph(w, z)
            g.load(w, z)
            for _ in range(epochs):
                g.replay()
            w = g.args[0].clone()
        else:
            for _ in range(epochs):
                present(w, z, range(nl))
        present(w, z, frac_rows)
        _COUNTS["trainings"] += 1
        _COUNTS["updates"] += epochs * per_epoch + frac
        return InfomaxPack(w=w, wsum=torch.sum(w, dim=1))


def make_lib_min_infomax(sensor_cfg, scan_cfg, capture_spacing=None):
    """Scorer with the extraction path's signature ``lib_min(cand f32[B, L, P],
    lib, lag_sum f64[B, L], lag_sq f64[B, L], aux: InfomaxPack) -> novelty
    f32[B, L]``, plus ``lib_min.prepare(lib) -> InfomaxPack``, which trains.
    ``capture_spacing`` sets the AUTO dose when ``infomax_epochs=0``."""
    p = float(sensor_cfg.n_pixels)
    m_units = scan_cfg.infomax_units or sensor_cfg.n_pixels

    def prepare(lib: LibraryPack) -> InfomaxPack:
        return train_infomax(lib, n_units=m_units, eta=scan_cfg.infomax_eta,
                             epochs=scan_cfg.infomax_epochs, seed=scan_cfg.infomax_seed,
                             capture_spacing=capture_spacing)

    def lib_min(cand, lib, lag_sum, lag_sq, aux: InfomaxPack | None = None):
        if aux is None:
            raise ValueError(
                "fam_impl='infomax' needs its trained network: call "
                "step.lib_prepare(statics) (or run.prepare) once per library and "
                "pass the result as aux; make_navigate_batch and make_navigate do "
                "this themselves"
            )
        mu = lag_sum / p  # [B, L]
        sigma = torch.sqrt((lag_sq / p - mu * mu).clamp_min(0.0) + NCC_EPS)
        wx = torch.einsum("blp,mp->blm", cand.double(), aux.w.double())
        h = (wx - mu[:, :, None] * aux.wsum.double()) / sigma[:, :, None]
        return torch.mean(torch.abs(h), dim=2).float()

    lib_min.prepare = prepare
    return lib_min
