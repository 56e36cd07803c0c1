"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``reference/lm.py``), at the timed sizes.

The reference follows two stretches of the program's training, each
through the program's own call (``Trainer.run_epoch``, its captured
blocks replayed):

- the start: the first ``START_STEPS`` train steps of epoch 0, from the
  seed's weights and a zero AdamW state;
- the window's first epoch, from device copies of the program's
  parameters and AdamW state taken before it (the program's own state:
  the epochs between are the same call), at the LR times the reference's
  own Eq. 8 factor, on the reference's own plan of the epoch; then the
  refresh of its hidden samples at the reference's parameters.

Each number passes when it is at most its limit (``limits/<cell>.json``);
a cell compares those its traffic's ``checks`` name (``train``, ``obs``,
``plan``):

- ``loss_gap`` (``train``): the largest relative gap of a step's loss
  (the start's steps and the epoch's);
- ``change_gap`` (``train``): the worst leaf's gap between the program's
  norm of its change over the epoch and the reference's, over the
  reference's norm of that leaf or of the median leaf, whichever is
  larger.  Leaves whose reference gradient at the epoch's first step is
  under a thousandth of the median leaf's move by round-off alone and are
  left out;
- ``obs_gap`` (``obs``): the largest relative gap of a loss or a PC that
  the epoch wrote into the sample state, against the reference's: the
  visible samples' by the train steps (a sample trained twice keeps its
  last), the hidden ones' by the refresh.  PA is a threshold on a count
  of tokens and is not compared;
- ``plan_mismatch`` (``plan``): the reference's plan from the sample state
  and permutation the program's plan started from; it counts the hidden
  samples, visible positions and LR factor that differ, and the samples
  whose last-seen epoch is not the epoch's after it.
"""
from __future__ import annotations

import numpy as np
import torch

from h100_bench import weights
from h100_bench.reference import lm as ref

#: The train steps of epoch 0 that the reference follows from the seed.
START_STEPS = 3


def leaf_gaps(program: dict, reference: dict, keep=None) -> np.ndarray:
    """Each kept leaf's |program - reference| / max(reference, median)."""
    names = [k for k in reference if keep is None or keep[k]]
    med = float(np.median([reference[k] for k in reference]))
    return np.array([abs(program[k] - reference[k])
                     / max(reference[k], med, 1e-30) for k in names])


def rel_gaps(program, reference) -> np.ndarray:
    a, b = np.asarray(program, np.float64), np.asarray(reference, np.float64)
    return np.abs(a - b) / np.abs(b)


def alter_token(batch: dict, vocab: int) -> dict:
    """The batch with each row's first label changed (a planted fault)."""
    labels = batch["labels"].clone()
    labels[:, 0] = (labels[:, 0] + 1) % vocab
    return dict(batch, labels=labels)


def device_batch(corpus, idx, device) -> dict:
    return {n: torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for n, a in corpus.get(np.asarray(idx)).items()}


def epoch_rows(order: np.ndarray, batch: int) -> list[np.ndarray]:
    """An epoch's batches: the full ones in order, then the trailing
    partial one padded by cycling from the front of the epoch."""
    order = np.asarray(order)
    n_full = len(order) // batch
    rows = [order[k * batch:(k + 1) * batch] for k in range(n_full)]
    rem = len(order) - n_full * batch
    if rem and len(order) >= batch:
        rows.append(np.concatenate([order[n_full * batch:],
                                    order[:batch - rem]]))
    return rows


def reference_plan(rec: dict, kcfg: dict | None, key_dtype=None):
    """(hidden mask, visible order, LR factor) of the epoch recorded in
    ``rec``, from the sample state and permutation its plan started from;
    without a KAKURENBO configuration, every sample in the permutation's
    order.  ``key_dtype`` rounds the losses ranked (the control)."""
    perm = rec["perm"].cpu().numpy()
    if kcfg is None:
        return np.zeros(len(perm), bool), perm, 1.0
    before = {k: v.cpu() for k, v in rec["before"].items()}
    loss = before["loss"]
    if key_dtype is not None:
        loss = loss.to(key_dtype).float()
    hidden, visible, _, factor = ref.plan(
        loss.numpy(), before["seen"].numpy(), perm, kcfg["max_fraction"],
        kcfg["moveback"], before["pa"].numpy(), before["pc"].numpy(),
        kcfg["tau"])
    return hidden, visible, factor


def replay(arch: dict, corpus, start: dict, rows: list, opt: dict, lr: float,
           device, tf32: bool = False, fault: str | None = None) -> dict:
    """The reference's train steps on ``rows`` from ``start`` (``params``,
    ``m``, ``v``, ``t``; copied, never written): each step's loss, each
    leaf's first gradient norm, the final parameters and each sample's
    last (loss, PC).  ``tf32`` computes in the precision below float32
    (the control); ``fault`` plants one in the reference: ``"half_batch"``
    takes each step's mean over half of its rows, ``"token"`` alters a
    label of every row."""
    w = {k: v.detach().clone().requires_grad_(True)
         for k, v in start["params"].items()}
    adam = ref.AdamW(w, lr, opt["b1"], opt["b2"], opt["eps"],
                     opt["weight_decay"], start.get("m"), start.get("v"),
                     start.get("t", 0))
    losses, grad, obs = [], None, {}
    with ref.precision(tf32):
        for k, r in enumerate(rows):
            batch = device_batch(corpus, r, device)
            if fault == "token":
                batch = alter_token(batch, corpus.vocab)
            loss, _, pc = ref.per_sample(arch, w, batch)
            scalar = (loss[: len(r) // 2] if fault == "half_batch"
                      else loss).mean()
            grads = dict(zip(w, torch.autograd.grad(scalar, list(w.values()))))
            losses.append(float(scalar.detach()))
            if k == 0:
                grad = weights.leaf_norms(grads)
            got = zip(r.tolist(), loss.detach().double().cpu().tolist(),
                      pc.double().cpu().tolist())
            obs.update((i, (a, b)) for i, a, b in got)
            adam.step(grads)
            del grads, loss, scalar
    return {"losses": losses, "grad": grad,
            "params": {k: v.detach() for k, v in w.items()}, "obs": obs}


def reference_metrics(arch: dict, params: dict, corpus, idx: np.ndarray,
                      batch: int, device, tf32: bool = False,
                      fault: str | None = None) -> dict:
    """The reference's {sample: (loss, PC)} of samples ``idx`` at
    ``params``, ``batch`` rows at a time (``fault="token"``: a label of
    every row altered)."""
    out = {}
    with torch.no_grad(), ref.precision(tf32):
        for s in range(0, len(idx), batch):
            b = device_batch(corpus, idx[s:s + batch], device)
            if fault == "token":
                b = alter_token(b, corpus.vocab)
            loss, _, pc = ref.per_sample(arch, params, b)
            out.update(zip(idx[s:s + batch].tolist(),
                           zip(loss.double().cpu().tolist(),
                               pc.double().cpu().tolist())))
    return out


def reference_readout(cell, seed: int, corpus, out: dict, device,
                      tf32: bool = False, fault: str | None = None,
                      dtype=torch.float32) -> dict:
    """What the reference makes of the two stretches (see the module's
    docstring): ``losses``, ``change``, ``grad`` (the epoch's first
    gradient's leaf norms) and, with a sample state, ``obs``.  ``fault``
    also takes ``"lr_unscaled"``: the epoch at the LR without Eq. 8.
    ``dtype`` is the reference's (float64: a witness of float32's
    rounding)."""
    arch, traffic = cell.arch, cell.traffic
    opt = traffic["optimizer"]
    kcfg = traffic["kakurenbo"] if "plan" in traffic["checks"] else None
    batch = cell.shape["batch"]

    def cast(tree: dict) -> dict:
        return {k: v.to(dtype) for k, v in tree.items()}
    _, order, _ = reference_plan(out["start"], kcfg)
    first = replay(arch, corpus,
                   {"params": cast(weights.make(arch, seed, device))},
                   epoch_rows(order, batch)[:START_STEPS], opt, opt["lr"],
                   device, tf32, fault)
    del first["params"]
    hidden, order, factor = reference_plan(out["epoch"], kcfg)
    if fault == "lr_unscaled":
        factor = 1.0
    start = {k: cast(v) if isinstance(v, dict) else v
             for k, v in out["before"].items()}
    ep = replay(arch, corpus, start, epoch_rows(order, batch), opt,
                opt["lr"] * factor, device, tf32, fault)
    with torch.no_grad():
        change = weights.leaf_norms({k: v - start["params"][k]
                                     for k, v in ep["params"].items()})
    res = {"losses": first["losses"] + ep["losses"], "change": change,
           "grad": ep["grad"]}
    if "obs" in traffic["checks"]:
        res["obs"] = ep["obs"]
        res["refresh"] = reference_metrics(arch, ep["params"], corpus,
                                           np.flatnonzero(hidden), batch,
                                           device, tf32, fault)
    return res


def program_readout(out: dict) -> dict:
    """The program's side of ``reference_readout``'s numbers."""
    res = {"losses": (out["start"]["losses"][:START_STEPS]
                      + out["epoch"]["losses"]),
           "change": out["change"]}
    if out["state"] is not None:
        res["state"] = {k: v.double().cpu().numpy()
                        for k, v in out["state"].items()}
    return res


def numbers(program: dict, reference: dict) -> dict:
    """``loss_gap``, ``change_gap`` and (with ``obs``) ``obs_gap`` of a
    readout against the reference's, the worst step, leaf or sample, and
    each one's ``_median``: the median step's, the median leaf's, and the
    larger of the train steps' and the refresh's median sample's.
    ``program`` gives its observations as the sample state (``state``)
    or, as a readout of the reference's own, as ``obs`` and ``refresh``."""
    med_g = float(np.median(list(reference["grad"].values())))
    moved = {k: g >= 1e-3 * med_g for k, g in reference["grad"].items()}
    n = min(len(program["losses"]), len(reference["losses"]))
    steps = rel_gaps(program["losses"][:n], reference["losses"][:n])
    leaves = leaf_gaps(program["change"], reference["change"], moved)
    got = {"loss_gap": float(steps.max()),
           "loss_gap_median": float(np.median(steps)),
           "change_gap": float(leaves.max()),
           "change_gap_median": float(np.median(leaves))}
    if "obs" in reference:
        groups = []
        for key in ("obs", "refresh"):
            ids = sorted(reference[key])
            if not ids:
                continue
            want = np.array([reference[key][i] for i in ids])
            if "state" in program:
                have = np.stack([program["state"]["loss"][ids],
                                 program["state"]["pc"][ids]], axis=1)
            else:
                have = np.array([program[key][i] for i in ids])
            groups.append(rel_gaps(have, want).max(axis=1))
        got["obs_gap"] = float(max(g.max() for g in groups))
        got["obs_gap_median"] = float(max(np.median(g) for g in groups))
    return got


def plan_numbers(rec: dict, state: dict, kcfg: dict,
                 key_dtype=None) -> dict:
    """``plan_mismatch`` of the plan recorded in ``rec``, and the sample
    state ``state`` after its epoch; ``key_dtype`` rounds the losses the
    reference ranks (the control: bfloat16)."""
    hidden, visible, factor = reference_plan(rec, kcfg, key_dtype)
    plan = rec["plan"]
    got_hidden = np.zeros_like(hidden)
    got_hidden[plan.hidden_indices] = True
    vis = np.asarray(plan.visible_indices)
    n = min(len(vis), len(visible))
    seen = state["seen"].cpu().numpy()
    miss = (int((got_hidden != hidden).sum())
            + int((vis[:n] != visible[:n]).sum()) + abs(len(vis) - len(visible))
            + int(plan.lr_scale != factor)
            + int((seen != rec["epoch"]).sum()))
    return {"plan_mismatch": miss}


def judge(cell, out: dict, reference: dict) -> dict:
    """Every number of the cell: the program's outputs against the
    reference's readout."""
    got = numbers(program_readout(out), reference)
    if "plan" in cell.traffic["checks"]:
        got.update(plan_numbers(out["epoch"], out["state"],
                                cell.traffic["kakurenbo"]))
    return got


def run_checks(cell, seed: int, corpus, out: dict, device) -> dict:
    """Every number of the cell, from the program's outputs
    (``Session.outputs``), the reference run on ``device``."""
    reference = reference_readout(cell, seed, corpus, out, device)
    out["reference_losses"] = reference["losses"]
    return judge(cell, out, reference)


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(every number that ``limits`` names within its limit, {name:
    {value, limit}} of those numbers).  The cell's limits file names the
    numbers it compares; the others are readings only."""
    table = {k: {"value": numbers.get(k), "limit": v}
             for k, v in limits.items()}
    ok = all(c["value"] is not None and c["value"] <= c["limit"]
             for c in table.values())
    return ok, table
