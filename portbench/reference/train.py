"""Plain PyTorch training steps of Mask3D: the Hungarian matching (the
Jacobi auction, as `conf/loss/set_criterion.yaml` solves it), the set
criterion (weighted CE, mask BCE and dice over segments), the backward and
optax-style AdamW under the onecycle schedule (`conf/optimizer/adamw.yaml`,
`conf/scheduler/onecycle.yaml`).

`follow` runs the steps from a state dict and raw scene batches and returns
what the benchmark compares. A frozen copy of the port's plain code,
trimmed to this configuration; it imports nothing of the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.collate import collate
from portbench.reference.model import Mask3D, SparseBatchNorm

_BIG = 1e8
_CHECK_EVERY = 8
_EPS_SCALE = 1e-3


def cost_matrix(pred_logits, pred_masks, labels, seg_masks, t_valid,
                col_valid, w_class=2.0, w_mask=5.0, w_dice=2.0):
    """(..., Q, T) matching costs: mask BCE, -prob of the class, dice."""
    prob = torch.softmax(pred_logits, dim=-1)
    cost_class = -torch.take_along_dim(prob, labels[..., None, :].long(),
                                       dim=-1)
    x, t, w = pred_masks, seg_masks.float(), col_valid.float()
    pos = F.softplus(-x) * w[..., None]
    neg = F.softplus(x) * w[..., None]
    n_cols = torch.clamp_min(w.sum(-1), 1.0)
    cost_bce = (torch.einsum("...mq,...tm->...qt", pos, t)
                + torch.einsum("...mq,...tm->...qt", neg,
                               (1.0 - t) * w[..., None, :])
                ) / n_cols[..., None, None]
    sig = torch.sigmoid(x) * w[..., None]
    num = 2.0 * torch.einsum("...mq,...tm->...qt", sig, t)
    den = sig.sum(-2)[..., :, None] + (t * w[..., None, :]).sum(-1)[..., None, :]
    cost_dice = 1.0 - (num + 1.0) / (den + 1.0)
    cost = w_mask * cost_bce + w_class * cost_class + w_dice * cost_dice
    return torch.where(t_valid[..., None, :], cost, torch.full_like(cost, _BIG))


def auction(cost, valid):
    """Rectangular assignment of every valid target (column) to a query
    (row) by the Jacobi auction, eps = 1e-3 x each matrix's cost range,
    then a greedy pass for any target still unassigned. (..., T) int64."""
    q, t = cost.shape[-2:]
    lead = cost.shape[:-2]
    dev = cost.device
    c = cost.reshape(-1, q, t)
    nb = c.shape[0]
    v = valid.reshape(nb, t).bool()
    cap = max(3000, int(4 * t / _EPS_SCALE ** 0.5))
    benefit = -c.transpose(1, 2)
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
        value = benefit - price[:, None, :]
        best_q = value.argmax(dim=2)
        best_v = value.amax(dim=2)
        second_v = torch.where(F.one_hot(best_q, q).bool(), neg_inf,
                               value).amax(dim=2)
        bid = best_v - torch.where(torch.isfinite(second_v), second_v,
                                   best_v) + eps
        bid = torch.where(unassigned, bid, neg_inf)
        bids = torch.full((nb, t, q), float("-inf"), device=dev)
        bids.scatter_(2, best_q[..., None], bid[..., None])
        win_bid = bids.amax(dim=1)
        win_t = bids.argmax(dim=1)
        has_bid = torch.isfinite(win_bid)
        displaced = torch.where(has_bid & (owner_q >= 0), owner_q, -1)
        lost = (t_ids[None, :, None] == displaced[:, None, :]).any(dim=2)
        assign_t = torch.where(lost, -1, assign_t)
        slot = torch.where(has_bid, win_t, t)
        wide = torch.cat([assign_t, assign_t.new_zeros(nb, 1)], dim=1)
        wide.scatter_(1, slot, torch.where(has_bid, q_ids, -1))
        assign_t = wide[:, :t]
        owner_q = torch.where(has_bid, win_t, owner_q)
        price = torch.where(has_bid, price + win_bid, price)
    used = torch.zeros(nb, q + 1, dtype=torch.bool, device=dev)
    used.scatter_(1, torch.where(assign_t >= 0, assign_t, q), True)
    used = used[:, :q].clone()
    rows = torch.arange(nb, device=dev)
    for i in range(t):
        pick = torch.where(used, float("inf"), c[:, :, i]).argmin(dim=1)
        take = assign_t[:, i] < 0
        assign_t[:, i] = torch.where(take, pick, assign_t[:, i])
        used[rows, pick] |= take
    return torch.where(v, assign_t, -1).reshape(*lead, t)


class Decisions:
    """The discrete decisions of a train step, recorded or replayed: each
    round's block mask (sigmoid of the readout < 0.5) and the matching.

    Rounding can tip a readout that lies at 0, or an auction bid that ties,
    and either changes the losses by far more than rounding. So the
    reference replays the decisions that the run in the program's place
    made (`replay`), and checks them by themselves: `mask_flip_share` is
    the share of block-mask entries where the replayed mask differs from
    the reference's own, `flip_depth` the largest |readout| at such an
    entry over the RMS of that round's readouts (rounding flips only
    readouts next to 0; `flip_depth_first` in the first step, which starts
    from the same state on both sides), and `match_cost_gap` the largest
    excess of the
    replayed matching's cost over the reference's own auction's, in units
    of the auction's eps x the matrix's valid targets (an eps-optimal
    matching reads at most about 1; one that is no matching reads inf).
    With nothing to replay the decisions are the reference's own and are
    recorded (`steps`)."""

    def __init__(self, replay=None):
        self.replay = replay          # [dict(masks=[...], match=...)]
        self.steps = []
        self.flips = self.entries = 0
        self.flip_depth = self.flip_depth_first = 0.0
        self.match_cost_gap = 0.0

    def begin_step(self):
        self.steps.append(dict(masks=[], match=None))

    def block(self, blk):
        own = torch.sigmoid(blk) < 0.5
        step = self.steps[-1]
        if self.replay is None:
            step["masks"].append(own.cpu())
            return own
        got = self.replay[len(self.steps) - 1]["masks"][len(step["masks"])]
        got = got.to(own.device)
        step["masks"].append(None)
        if got.shape != own.shape:     # not this batch's decision at all
            self.flip_depth = self.flip_depth_first = float("inf")
            return own
        flip = got != own
        self.flips += int(flip.sum())
        self.entries += own.numel()
        if bool(flip.any()):
            rms = blk.square().mean().sqrt().clamp_min(1e-30)
            depth = float(blk.abs()[flip].max() / rms)
            self.flip_depth = max(self.flip_depth, depth)
            if len(self.steps) == 1:
                self.flip_depth_first = max(self.flip_depth_first, depth)
        return got

    def match(self, cost, valid):
        own = auction(cost, valid)
        if self.replay is None:
            self.steps[-1]["match"] = own.cpu()
            return own
        got = self.replay[len(self.steps) - 1]["match"].to(own.device)
        if got.shape != own.shape:
            self.match_cost_gap = float("inf")
            return own
        self.match_cost_gap = max(self.match_cost_gap,
                                  _excess_cost(cost, valid, got, own))
        return got

    @property
    def mask_flip_share(self):
        return self.flips / max(self.entries, 1)


def _excess_cost(cost, valid, got, own):
    """max over matrices of (cost(got) - cost(own)) / (eps x valid
    targets); inf where `got` is no matching of the valid targets."""
    q = cost.shape[-2]
    c = cost.reshape(-1, q, cost.shape[-1])
    v = valid.reshape(c.shape[0], -1)
    g, o = got.reshape(v.shape), own.reshape(v.shape)
    if bool(((g < 0) & v).any()) or bool((g >= q).any()):
        return float("inf")
    for row_g, row_v in zip(g, v):
        picked = row_g[row_v]
        if picked.unique().numel() != picked.numel():
            return float("inf")

    def total(a):
        sel = torch.where(v, a, 0)
        return (torch.take_along_dim(c, sel[:, None, :], dim=1)[:, 0]
                * v).sum(-1)
    rng = torch.clamp_min(c.amax(dim=(1, 2)) - c.amin(dim=(1, 2)), 1e-6)
    eps = _EPS_SCALE * rng + 1e-9
    excess = (total(g) - total(o)) / (eps * v.sum(-1).clamp_min(1))
    return float(excess.max())


def criterion(pred_logits, pred_masks, batch, decisions=None, eos_coef=0.1,
              w_ce=2.0, w_mask=5.0, w_dice=2.0):
    """(the weighted loss summed over all L prediction sets, the matched
    query of each target (L, B, T), -1 for padding)."""
    L, B, Q, C = pred_logits.shape
    S = pred_masks.shape[2]
    T = batch.labels.shape[1]
    dev = pred_logits.device
    rep = (L, 1, 1)
    with torch.no_grad():
        cost = cost_matrix(pred_logits, pred_masks,
                           batch.labels[None].repeat(rep),
                           batch.seg_masks[None].repeat(rep + (1,)),
                           batch.t_valid[None].repeat(rep),
                           batch.seg_valid[None].repeat(rep))
        valid = batch.t_valid[None].repeat(rep)
        mq = (auction(cost, valid) if decisions is None
              else decisions.match(cost, valid))
        mq = torch.where(batch.t_valid[None], mq, torch.full_like(mq, -1))

    # labels: matched queries take their target's class, the rest no-object
    t_valid = batch.t_valid[None] & (mq >= 0)
    classes = torch.full((L, B, Q), C - 1, dtype=torch.long, device=dev)
    lb = (torch.arange(L, device=dev)[:, None, None],
          torch.arange(B, device=dev)[None, :, None].expand(L, B, T),
          torch.clamp_min(mq, 0))
    lab = batch.labels[None].long().expand(L, B, T)
    sel = t_valid.reshape(-1)
    flat = (lb[0].expand(L, B, T) * B * Q + lb[1] * Q + lb[2]).reshape(-1)
    classes = classes.reshape(-1)
    classes[flat[sel]] = lab.reshape(-1)[sel]
    classes = classes.reshape(L, B, Q)
    weight = torch.ones(C, device=dev)
    weight[-1] = eos_coef
    logp = F.log_softmax(pred_logits, dim=-1)
    nll = -torch.take_along_dim(logp, classes[..., None], dim=-1)[..., 0]
    w = weight[classes]
    loss_ce = (nll * w).reshape(L, -1).sum(-1) / w.reshape(L, -1).sum(-1)

    # masks of the matched queries against their targets, per segment
    x = torch.take_along_dim(pred_masks.transpose(2, 3),
                             torch.clamp_min(mq, 0)[..., None], dim=2)
    t = batch.seg_masks[None].float().expand(L, B, T, S)
    sv = batch.seg_valid.float()[None, :, None, :]
    tv = t_valid.float()
    num_masks = torch.clamp_min(tv.sum(-1), 1.0)
    n_seg = torch.clamp_min(batch.seg_valid.float().sum(-1), 1.0)[None, :, None]
    bce = (F.softplus(-x) * t + F.softplus(x) * (1.0 - t)) * sv
    loss_mask = (((bce.sum(-1) / n_seg) * tv).sum(-1) / num_masks).sum(-1)
    sig = torch.sigmoid(x) * sv
    dice = tv * (1.0 - (2.0 * (sig * t).sum(-1) + 1.0)
                 / (sig.sum(-1) + (t * sv).sum(-1) + 1.0))
    loss_dice = (dice.sum(-1) / num_masks).sum(-1)
    total = (w_ce * loss_ce + w_mask * loss_mask + w_dice * loss_dice).sum()
    return total, mq


def onecycle(peak, steps, pct_start=0.3, div=25.0, final_div=1e4):
    """optax.cosine_onecycle_schedule."""
    bounds = (0, int(pct_start * steps), int(steps))
    init = peak / div
    values = (init, peak, peak / (div * final_div))

    def schedule(count):
        for b0, b1, v0, v1 in zip(bounds[:-1], bounds[1:], values[:-1],
                                  values[1:]):
            if b0 <= count < b1:
                pct = (count - b0) / (b1 - b0)
                return v1 + (v0 - v1) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1]
    return schedule


@torch.no_grad()
def adamw(params, grads, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8,
          wd=1e-2):
    """One optax.adamw step in place (decay on every parameter)."""
    c = count + 1
    for p, g, m, v in zip(params, grads, mu, nu):
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(g * g * (1 - b2))
        u = (m / (1 - b1 ** c)) / (torch.sqrt(v / (1 - b2 ** c)) + eps)
        p.add_(-lr * (u + wd * p))


def collate_all(scene_batches, opt, device="cpu"):
    """The reference's own collate of each batch of raw scenes (its
    neighbour maps and FPS on `device`)."""
    return [collate(s, opt["voxel_size"], opt["fps_queries"], device=device)
            for s in scene_batches]


def follow(state_dict, batches, generator_seed, device, opt,
           decisions=None):
    """Train the reference Mask3D from `state_dict` for one step per batch
    (`collate_all`'s, on the host). `opt` holds lr, total_steps,
    weight_decay. Returns dict(losses [per step], grad_norms [first step's
    per parameter], change_norms [per parameter, after the last step],
    names, decisions). `decisions` (a `Decisions`) replays or records each
    step's block masks and matching."""
    decisions = Decisions() if decisions is None else decisions
    model = Mask3D().to(device)
    model.load_state_dict(state_dict, strict=True)
    model.train()
    names = [n for n, _ in model.named_parameters()]
    params = [p for _, p in model.named_parameters()]
    start = [p.detach().clone() for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    bns = [m for m in model.modules() if isinstance(m, SparseBatchNorm)]
    sched = onecycle(opt["lr"], max(opt["total_steps"], 10))
    gen = torch.Generator(device=device).manual_seed(generator_seed)
    losses, grad_norms = [], None
    for step, host in enumerate(batches):
        batch = host.to(device)
        decisions.begin_step()
        logits, masks = model(batch, gen, decisions)
        total, _ = criterion(logits, masks, batch, decisions)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(params, grads)]
        for bn in bns:
            bn.update_running_stats()
        adamw(params, grads, mu, nu, step, sched(step),
              wd=opt["weight_decay"])
        losses.append(float(total.detach()))
        if grad_norms is None:
            grad_norms = torch.stack([g.norm() for g in grads]).cpu()
        del batch, logits, masks, total, grads
    change = torch.stack([(p.detach() - s).norm()
                          for p, s in zip(params, start)]).cpu()
    return dict(losses=losses, grad_norms=grad_norms, change_norms=change,
                names=names, decisions=decisions)
