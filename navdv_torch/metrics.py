"""Route-recall metrics over the stacked StepRecord tensors (single [T] or
batched [B, T] records: reductions are over the last, time axis)."""

from __future__ import annotations

import torch

from navdv_torch.agent import STATUS_REACHED, AgentState, StepRecord


def episode_metrics(final: AgentState, rec: StepRecord) -> dict:
    """Per-episode summary. ``active`` masks steps taken before termination
    (rec.done is the *pre-step* done flag, so ~done marks real steps)."""
    active = ~rec.done  # [.., T]
    n_steps = torch.sum(active, dim=-1)
    denom = n_steps.clamp_min(1)  # avoid 0/0 on immediately-done episodes
    err = torch.where(active, rec.dist_route, torch.zeros_like(rec.dist_route))
    mean_err = torch.sum(err, dim=-1) / denom
    max_err = torch.amax(err, dim=-1)
    # familiarity at the last step actually taken (early-exit runs zero-pad
    # the tail, so [..., -1] would be wrong there)
    last_idx = (n_steps - 1).clamp_min(0)
    final_fam = torch.take_along_dim(rec.fam, last_idx[..., None], dim=-1)[..., 0]
    return {
        "success": final.status == STATUS_REACHED,
        "status": final.status,
        "n_steps": n_steps,
        "mean_path_error": mean_err,
        "max_path_error": max_err,
        "final_fam": final_fam,
    }


def success_rate(final: AgentState) -> torch.Tensor:
    """Route-recall success rate over a batch of trials."""
    return torch.mean((final.status == STATUS_REACHED).to(torch.float32))
