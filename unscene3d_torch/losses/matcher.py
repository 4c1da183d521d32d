"""Hungarian matcher: batched cost matrices and an on-device LSAP solver
(counterpart of unscene3d_tpu/losses/matcher.py).

All L x B cost matrices are computed in one batched pass,

    C = cost_mask * BCE + cost_class * (-prob[target]) + cost_dice * dice,

with padded target columns pushed to a huge constant, and solved together
by the Jacobi auction algorithm on the device (`solve_lsap_auction`, the
JAX solver step for step). `solver="scipy"` solves each matrix on the host
with scipy's linear_sum_assignment instead.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from unscene3d_torch.data.batch import Targets

_BIG = 1e8
# the auction's loop body is a fixed point once every target is assigned,
# so convergence is read back from the device only every few iterations
_CHECK_EVERY = 8
# eps of the auction = this x each matrix's cost range
_EPS_SCALE = 1e-3


@dataclasses.dataclass
class HungarianMatcher:
    cost_class: float = 2.0
    cost_mask: float = 5.0
    cost_dice: float = 2.0
    num_points: int = -1     # every mask column, the reference's default
    ignore_label: int = 253
    solver: str = "auction"

    def __post_init__(self):
        if self.num_points != -1:
            raise NotImplementedError(
                "point subsampling in the matcher is not ported "
                "(conf/matcher/hungarian_matcher.yaml sets num_points: -1)")

    def cost_matrix(self, pred_logits, pred_masks, tgt_labels, tgt_masks,
                    tgt_valid, col_valid):
        """pred_logits (..., Q, C), pred_masks (..., M, Q) mask logits over M
        columns, tgt_labels (..., T), tgt_masks (..., T, M) {0, 1},
        tgt_valid (..., T), col_valid (..., M). Returns (..., Q, T) f32."""
        out_prob = torch.softmax(pred_logits.float(), dim=-1)
        ignore = tgt_labels == self.ignore_label
        ids = torch.where(ignore, torch.zeros_like(tgt_labels), tgt_labels)
        cost_class = -torch.take_along_dim(out_prob, ids[..., None, :].long(),
                                           dim=-1)               # (..., Q, T)
        cost_class = torch.where(ignore[..., None, :],
                                 torch.full_like(cost_class, -1.0),
                                 cost_class)

        x = pred_masks.float()                                  # (..., M, Q)
        t = tgt_masks.float()                                   # (..., T, M)
        w = col_valid.float()                                   # (..., M)
        pos = F.softplus(-x) * w[..., None]                     # BCE(x, 1)
        neg = F.softplus(x) * w[..., None]                      # BCE(x, 0)
        n_cols = torch.clamp_min(w.sum(-1), 1.0)
        cost_bce = (
            torch.einsum("...mq,...tm->...qt", pos, t)
            + torch.einsum("...mq,...tm->...qt", neg,
                           (1.0 - t) * w[..., None, :])
        ) / n_cols[..., None, None]

        sig = torch.sigmoid(x) * w[..., None]
        numerator = 2.0 * torch.einsum("...mq,...tm->...qt", sig, t)
        denominator = (sig.sum(-2)[..., :, None]
                       + (t * w[..., None, :]).sum(-1)[..., None, :])
        cost_dice = 1.0 - (numerator + 1.0) / (denominator + 1.0)

        cost = (self.cost_mask * cost_bce + self.cost_class * cost_class
                + self.cost_dice * cost_dice)
        return torch.where(tgt_valid[..., None, :], cost,
                           torch.full_like(cost, _BIG))

    @torch.no_grad()
    def __call__(self, pred_logits, pred_masks, targets: Targets,
                 col_valid) -> torch.Tensor:
        """pred_logits (L,B,Q,C), pred_masks (L,B,S,Q) segment mask logits.
        Returns the matched query per target, (L, B, T) int64, -1 where the
        target is padding."""
        L = pred_logits.shape[0]
        rep = (L,) + (1,) * targets.labels.dim()
        cost = self.cost_matrix(
            pred_logits, pred_masks, targets.labels[None].repeat(rep),
            targets.seg_masks[None].float().repeat(rep + (1,)),
            targets.valid[None].repeat(rep), col_valid[None].repeat(rep))
        if self.solver == "scipy":
            matched = solve_lsap(cost)
        elif self.solver == "auction":
            matched = solve_lsap_auction(cost,
                                         targets.valid[None].repeat(rep))
        else:
            raise ValueError(f"unknown solver {self.solver!r}")
        return torch.where(targets.valid[None], matched,
                           torch.full_like(matched, -1))


def solve_lsap_auction(cost: torch.Tensor,
                       valid: torch.Tensor | None = None) -> torch.Tensor:
    """Rectangular LSAP by the Jacobi auction algorithm, all matrices at
    once on cost's device (unscene3d_tpu/losses/matcher.py:103-205).

    cost (..., Q, T) with Q >= #valid targets; valid (..., T) marks real
    targets (padded ones are born assigned and never bid). Returns (..., T)
    int64 query per target, -1 for invalid targets. eps = 1e-3 x each
    matrix's cost range; at most max(3000, 4 T / sqrt(1e-3)) rounds, then a greedy pass gives every unassigned target its cheapest free
    query."""
    q, t = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    c = cost.reshape(-1, q, t).float()
    nb = c.shape[0]
    v = (torch.ones(nb, t, dtype=torch.bool, device=dev) if valid is None
         else valid.reshape(nb, t).bool())
    cap = max(3000, int(4 * t / _EPS_SCALE ** 0.5))

    benefit = -c.transpose(1, 2)                                  # (nb, T, Q)
    rng = torch.clamp_min(c.amax(dim=(1, 2)) - c.amin(dim=(1, 2)), 1e-6)
    eps = (_EPS_SCALE * rng + 1e-9)[:, None]
    neg_inf = torch.tensor(float("-inf"), device=dev)
    t_ids = torch.arange(t, device=dev)
    q_ids = torch.arange(q, device=dev).expand(nb, q)
    price = torch.zeros(nb, q, device=dev)
    owner_q = torch.full((nb, q), -1, dtype=torch.long, device=dev)
    assign_t = torch.where(v, -1, q).long()

    for it in range(cap):
        if it % _CHECK_EVERY == 0 and bool((assign_t >= 0).all()):
            break
        unassigned = assign_t < 0
        value = benefit - price[:, None, :]                       # (nb, T, Q)
        best_q = value.argmax(dim=2)           # first maximum, as jnp.argmax
        best_v = value.amax(dim=2)
        second_v = torch.where(F.one_hot(best_q, q).bool(), neg_inf,
                               value).amax(dim=2)
        bid = best_v - torch.where(torch.isfinite(second_v), second_v,
                                   best_v) + eps
        bid = torch.where(unassigned, bid, neg_inf)
        bid_matrix = torch.full((nb, t, q), float("-inf"), device=dev)
        bid_matrix.scatter_(2, best_q[..., None], bid[..., None])
        win_bid = bid_matrix.amax(dim=1)                          # (nb, Q)
        win_t = bid_matrix.argmax(dim=1)
        has_bid = torch.isfinite(win_bid) & (win_bid > float("-inf"))
        # displace the previous owners of re-auctioned queries
        displaced = torch.where(has_bid & (owner_q >= 0), owner_q, -1)
        lost = (t_ids[None, :, None] == displaced[:, None, :]).any(dim=2)
        assign_t = torch.where(lost, -1, assign_t)
        # record the new assignments; non-bids land in a dropped column
        slot = torch.where(has_bid, win_t, t)
        wide = torch.cat([assign_t, assign_t.new_zeros(nb, 1)], dim=1)
        wide.scatter_(1, slot, torch.where(has_bid, q_ids, -1))
        assign_t = wide[:, :t]
        owner_q = torch.where(has_bid, win_t, owner_q)
        price = torch.where(has_bid, price + win_bid, price)

    # greedy completion: every still-unassigned target takes its cheapest
    # free query, in target order
    used = torch.zeros(nb, q + 1, dtype=torch.bool, device=dev)
    used.scatter_(1, torch.where(assign_t >= 0, assign_t, q), True)
    used = used[:, :q].clone()
    rows = torch.arange(nb, device=dev)
    for i in range(t):
        c_i = torch.where(used, float("inf"), c[:, :, i])
        pick = c_i.argmin(dim=1)
        take = assign_t[:, i] < 0
        assign_t[:, i] = torch.where(take, pick, assign_t[:, i])
        used[rows, pick] |= take
    return torch.where(v, assign_t, -1).reshape(*lead, t)


def solve_lsap(cost: torch.Tensor) -> torch.Tensor:
    """Exact batched LSAP on the host (scipy linear_sum_assignment per
    matrix). cost (..., Q, T) -> (..., T) int64 query index per target."""
    from scipy.optimize import linear_sum_assignment

    c = cost.detach().cpu().double().numpy()
    lead = c.shape[:-2]
    q, t = c.shape[-2:]
    flat = c.reshape(-1, q, t)
    out = np.zeros((flat.shape[0], t), np.int64)
    for i in range(flat.shape[0]):
        m = np.nan_to_num(flat[i], nan=_BIG, posinf=_BIG, neginf=-_BIG)
        rows, cols = linear_sum_assignment(m)
        out[i][cols] = rows
    return torch.from_numpy(out.reshape(*lead, t)).to(cost.device)
