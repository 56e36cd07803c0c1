#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hymba-lr-witness

Phases, each printed as one JSON line; any failure exits non-zero:

1. environment: ``nvidia-smi`` name and power limit, torch and CUDA versions;
2. build: the CUDA kernels compiled with nvcc from ``src/repro_torch/kernels/csrc``;
3. kernel checks: every kernel against its plain PyTorch version on the same
   inputs, at the main path's shapes and at larger ones, with times, and
   beside one PyTorch call computing the same function where there is one
   (``F.cross_entropy`` for B1's ce); the histogram-select (B2 and B3
   fused with the CDF walks and the masks into one kernel) exactly, its
   two masks, histogram, raw range and walk, at N = 50,000 and 1,281,167
   on exponential losses (0.3 invalid), all invalid, one valid, all
   equal, signed zeros and NaN/+-inf losses, and at N = 1, a ragged N, an
   N past its shared-memory path and one past 2**24, for low fractions
   {0, 0.3, 1} x high fractions {0, 0.02} x bins {512, 64}; its call at
   N = 50,000 and 1,281,167 with its device time and device launches,
   beside ``torch.aminmax`` + ``torch.histc`` (the nearest two calls;
   neither gives the masks); the rank-select (B4 and B5 fused into one
   kernel) exactly, its mask, four pass histograms and threshold triple, also
   against the stable-sort rank window, at N = 50,000 and 1,281,167 on
   exponential losses, FORGET-like event counts with +inf, signed zeros,
   +/-inf and all-equal inputs, for k in {0, 1, N/3, N} both ways, and at
   N = 1, a ragged N and an N past its shared-memory path; its call at
   N = 50,000 and 1,281,167 with its device time and device launches,
   beside ``torch.kthvalue`` and a stable ``torch.sort`` as yardsticks;
   the SSD scan (B6) at mamba2-130m's serve shapes and at two smaller
   shapes whose MMA tiles have edges to mask; flash attention (B7)
   at smollm-135m's prefill shape (B, S, Hq, Hkv, D) = (4, 2048, 9, 3,
   64), causal and not, float32 (allclose 1e-5) and bfloat16 (2e-2), at a
   ragged S = 1,000 and at head dims 128, 32 and 16, beside
   ``F.scaled_dot_product_attention`` under its math, efficient and cuDNN
   backends as a yardstick.  Every row holds its call time (CUDA events)
   and its device-only time (``torch.profiler``), and its bound at the
   rate of the unit the kernel uses: fp32 on the CUDA cores for B1-B5,
   3xTF32 on the tensor cores for B6 and B7 (which also get the fp32
   bound).  The float32 rows of B6 and B7 also give the kernel's and the
   plain version's error against a float64 reference.  Then the same at
   the LM training path's shapes (phase 14): B1 forward at (1,024,
   49,152) and (1,024, 50,280), its backward at (1,024, 49,152), B7 at
   (32, 32, 9, 3, 64) causal, B6 at (32, 32) of mamba2-130m;
4. plan: ``_plan_step`` at N = 1,281,167 (ImageNet-1K's train size) with
   ``"histogram_pallas"`` (the histogram-select kernel) against
   ``"histogram"`` (plain) on the card and against itself on the CPU (its
   plain version), and with ``"sort"`` + DropTop 0.02 and FORGET's
   ``_prune_step`` (the rank-select kernel) against the same on the CPU:
   the plans must be equal;
5. train: the paper CNN at the full width of ``configs/paper_cnn.py`` on
   ``SyntheticClassification(50_000)``, 3 epochs of ``baseline`` then of
   ``kakurenbo`` (``histogram_pallas`` with DropTop 0.02, fused scoring),
   through the default engine: the dataset on the device, each block of 8
   train steps one CUDA graph replay (``train/engines.py``), whose kernel
   launches the engine counts a replay (B1's backward must count at least
   one launch a train step);
6. table 2: ``repro_torch.experiments.table2`` at the same width and size,
   3 epochs of each of its seven strategies, KAKURENBO under ``"sort"`` with
   DropTop 0.02; FORGET must prune floor(0.3 N) and restart, ISWR must draw
   repeated indices into a batch, SB must skip backward samples.  Table 2
   scores as the reference harness does (PA by argmax), so B1 must not run
   there.  The launch counts of phases 5, 6, 10 and 11, each set to 0
   just before it, show that each path went through its kernels (the
   ``kernels`` line sums them, and the serve phases');
7. train step and epoch: ``Trainer.train_step`` timed and profiled (paper
   CNN; the wide-head model) and one replay of the scanned engine's 8-step
   graph under the profiler (device activities, busy vs wall); one
   KAKURENBO epoch split on the host under each engine (the host loop:
   ``get``, ``to_device``, ``train_step``; the scanned engine: the one-time
   materialize and captures, replays, the plan's copy, the epoch-end
   fetch; both: plan, refresh, ``evaluate``);
8. engines: the host loop and the scanned engine from the same weights,
   3 KAKURENBO epochs of the main path and one epoch of each Table 2
   strategy, under the trainer's defaults (it runs its epochs with
   ``cudnn.deterministic``; the script sets no flag): losses, plans and
   the whole train state bit-identical (and whether two host loops are
   without the flag, ``trainer.CUDNN_DETERMINISTIC`` off, reported); the
   first capture of an unweighted and of a weighted block, with their
   warm-up blocks, leaves a fresh trainer's state as it was, bit for bit
   (as in phase 14 for smollm-135m);
9. restart: KAKURENBO and SB under the scanned engine crash before epoch 2
   and between two blocks of epoch 2; each restore into a trainer built
   from other weights and seeds ends bit-identical to the uninterrupted run;
10. resilience, on the main path with the numeric guard
   (``guard_policy="skip_update"``): a clean run bit-identical to the
   unguarded one under both engines and the 8-step graph's replay timed
   guarded against unguarded in turns (its overhead beside the reference's
   3% budget); a poisoned run (NaN features for a few ids) with finite
   parameters, one held step a poisoned batch, the poisoned samples at the
   never-seen sentinel and never hidden, the guard-off control going
   non-finite; ``guard_abort_after`` raising a restartable
   ``NonFiniteError``; a ``CrashAtStep`` in the middle of epoch 1
   recovered by ``run_with_restarts`` bit-identical to the uninterrupted
   run for the seven Table 2 strategies (scanned), Grad-Match at N =
   1,024 and KAKURENBO on the host loop, with the recovery's times; the
   host-observe path bit-identical to the fused one; AdamW, RMSProp and
   Adafactor, one epoch, scanned = host loop.  Its launch counts, set to 0
   before it, must hold B1 (forward and backward), the histogram-select
   and the rank-select (FORGET's prune);
11. table 3: ``repro_torch.experiments.table3`` at full width, N = 1,024,
   16 epochs: baseline, Grad-Match (its OMP on the host, timed) and
   KAKURENBO under ``"sort"`` with DropTop 0.02 (the rank-select);
12. card vs CPU: the same small run on ``cuda`` and on ``cpu`` from the same
   params and permutations, TF32 off; per-epoch losses within 1e-4;
13. serve: ``repro_torch.launch.serve`` at full width and depth in f32
   with seeded weights, prefill of 4 x 2,048 tokens then 32 greedy
   tokens, first on mamba2-130m (24 layers; the SSD scan must run through
   kernel B6, 24 launches for the one prefill), then on smollm-135m (30
   layers; prefill attention must run through kernel B7, 30 launches).
   For each, at full width: prefill's last logits against the full
   forward's at S - 1 (2e-4), one decode step against the forward's at S
   (3e-3), one prefill and one decode step under the profiler, and at 2
   layers the card's prefill (the kernel) against the CPU's (its plain
   version: logits and every cache tensor within 1e-4) and their greedy
   tokens.  The kernels themselves are held against their plain versions
   in phase 3, with B1 also on rows a poisoned sample gives (NaN ce and
   pmax where the plain version has them);
14. LM training, ``examples/torch_lm_train.py --full`` at its defaults
   (512 sequences of 32 tokens from ``SyntheticLM``, batch 32, AdamW,
   12 epochs), through the default engine (CUDA graphs), its kernels
   checked at its shapes in phase 3; with the counts set to 0, smollm-135m
   under baseline, KAKURENBO ("sort") and KAKURENBO ("histogram_pallas" +
   DropTop 0.02), and mamba2-130m under KAKURENBO ("sort" + DropTop 0.02):
   per epoch wall s, loss, F* and backward samples; B1's backward at
   least once a train step, B7 (B6) 30 (24) times a forward, the
   histogram-select and the rank-select launched; the loss must fall and
   some epoch hide sequences.  Then one train step's gradients through the
   kernel forwards against the plain forwards at full width and depth,
   per leaf (1e-3 relative, the attention at its input's fan-in; the
   reference's init recorded), every leaf a launch without a backward
   left at zero now non-zero; card vs CPU at 2 layers (losses 1e-4
   relative, first plans equal); the host loop = the scanned engine bit
   for bit over 3 KAKURENBO epochs and a restart from a crash between two
   blocks of epoch 2 into a trainer from other weights, bit-identical;
   one train step profiled at (32, 32) and (32, 512) for each arch;
15. zoo serve: ``repro_torch.launch.serve`` at full width in f32 on
   phi3.5-moe-42b-a6.6b (4 of 32 layers: 16 experts top-2), hymba-1.5b
   (32 layers: attention and SSM heads mean-fused, a 1,024-token window
   except in 3 layers), qwen3-1.7b (28 layers, qk_norm) and
   llava-next-mistral-7b (8 of 32 layers, 576 patch embeddings before
   the prompt), then kimi-k2 reduced: prefill of 4 x 2,048 tokens and 32
   greedy tokens, the B7 (and B6) launches of the one prefill (4; 3 and
   32; 28; 8; 2), prefill and one decode step against the forward (the
   MoE at a capacity no expert overflows), one prefill and one decode
   step profiled, card vs CPU at 2 layers and 4 prompts of 128 tokens;
   B7 at these prefill shapes and kimi-k2's (4, 2048, 64, 8, 112), B6 at
   hymba's and B1 at their vocabularies are held in phase 3
   (``zoo_kernel_checks``);
16. zoo LM training, ``examples/torch_lm_train.py --full``'s defaults with
   the counts set to 0: phi3.5-moe at 2 layers and hymba-1.5b full at
   LR 1e-3 (12 epochs each; ``--hymba-lr-witness`` below on why not 1e-2),
   kimi-k2 reduced (2 epochs): per epoch wall s, loss,
   F* and backward samples, B1's backward a step, B7 (B6) once a layer a
   forward, the loss falls and some epoch hides sequences; the host loop
   = the scanned engine bit for bit over 2 epochs of phi3.5-moe at 1
   layer; one eager step of each profiled by group (GEMMs, the MoE's
   routing, expert products and dispatch/combine, B6/B7 and their plain
   backward, AdamW).  Each phase frees its models before the next.

Then the ``kernels`` line, the card's name and power limit, and last
``{"ok": true, "device": {...}}``.

``--hymba-lr-witness`` runs phases 1-2 and then only this: hymba-1.5b at
the reference's LR of 1e-2, full width and depth, 12 KAKURENBO epochs
through the kernels and again through their plain versions (both on the
card), with one train step's loss and gradients on 4 sequences through
the kernels, through the plain versions and on the CPU at the kernel run's
weights at epochs 0, 1, 6 and 12 (the kernels within 1e-3 of the CPU a
leaf, or within 10 times the plain versions' distance from it) and how
far each position's prediction lies from the batch's mean; then the
same run at 4 layers, and card vs CPU over 2 epochs at 4 layers beside a
CPU run from weights changed by 1e-7.  Without a CUDA device, or without the
rest of the repository beside it, the script exits non-zero and prints no
result.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import itertools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM data-sheet peaks (dense): HBM bytes/s, fp32 outside the tensor
#: cores, and float32 products on the tensor cores in 3xTF32 (three TF32
#: products at the 495 TFLOP/s TF32 rate), the unit B6 and B7 use.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
TF32X3_OPS_PER_S = 495e12 / 3


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def bound(nbytes: float, ops: float,
          rate: float = FP32_OPS_PER_S) -> tuple[float, str]:
    """Least time (ms) for the work: bytes at HBM rate vs ops at the peak
    ``rate`` of the unit that does them (fp32 on the CUDA cores unless
    given)."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / rate
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


#: Host calls that put one activity on the device's timeline.
DEVICE_CALLS = {"cudaLaunchKernel", "cudaLaunchKernelExC",
                "cudaLaunchCooperativeKernel", "cuLaunchKernel",
                "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync"}


def profiled(warm, active, tries: int = 3):
    """Run ``warm`` and then ``active`` in one ``torch.profiler`` session,
    keeping only ``active``'s events: ``warm`` runs in the schedule's
    warm-up step, while the profiler sets up its buffers.  A trace with
    fewer device activities than the host calls that launched them lost
    some (seen on the card, at random): it is taken again, up to ``tries``
    times.  Returns (profile, wall ms of ``active`` with the profiler's own
    host cost, whether the trace holds every launch)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    # No CUDA: the phases' rehearsal on the CPU.
    sync_all = (torch.cuda.synchronize if torch.cuda.is_available()
                else lambda: None)
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1),
                     acc_events=True) as prof:
            warm()
            sync_all()
            prof.step()
            t0 = time.perf_counter()
            active()
            sync_all()
            wall_ms = (time.perf_counter() - t0) * 1e3
            prof.step()
        launched = sum(e.name in DEVICE_CALLS for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CPU)
        complete = len(device_events(prof)) >= launched
        if complete:
            break
    return prof, wall_ms, complete


def device_events(prof) -> list:
    """The device activities of a profile: kernels, copies and memsets, not
    the ranges a ``record_function`` (as ``Optimizer.step`` or the
    profiler's own step) marks on the device's timeline."""
    import torch
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and not e.name.startswith("ProfilerStep")]


def device_profile(fn, reps: int) -> tuple[float, float, list]:
    """``fn``'s device activities (kernels, copies, memsets) under
    ``torch.profiler`` over ``reps`` calls: their summed duration a call
    (ms), their number a call, and their names.  Beside ``time_ms``, which
    also holds the host's cost of each call where the device waits for it."""
    def calls():
        for _ in range(reps):
            fn()

    prof, _, complete = profiled(fn, calls)
    require(complete, "the profiler lost device activities in three traces")
    events = device_events(prof)
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / reps,
            len(events) / reps, sorted({e.name for e in events}))


def device_ms(fn, reps: int) -> float:
    """Device-only time of ``fn`` a call (``device_profile``)."""
    return device_profile(fn, reps)[0]


# ---------------------------------------------------------------------------
# Kernel checks
# ---------------------------------------------------------------------------


def lc_inputs(dev, t: int, v: int, dtype, seed: int = 0):
    """Seeded (T, V) logits at scale 3, int32 labels and a per-row g."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    logits = (torch.randn(t, v, generator=g, device=dev) * 3).to(dtype)
    labels = torch.randint(0, v, (t,), generator=g, device=dev,
                           dtype=torch.int32)
    return logits, labels, torch.randn(t, generator=g, device=dev)


def check_loss_confidence(dev, t: int, v: int, dtype, tol: float, reps: int,
                          seed: int = 0) -> dict:
    """B1's forward against its plain version (ce, pmax within ``tol``,
    correct exactly), its call, its C entry alone on buffers allocated
    once, and ``F.cross_entropy`` (ce alone) as the yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import backend
    from repro_torch.kernels import loss_confidence as lc
    logits, labels, _ = lc_inputs(dev, t, v, dtype, seed)
    ce, cor, pm = lc.loss_confidence(logits, labels)
    ce_p, cor_p, pm_p = lc.loss_confidence_plain(logits, labels)
    torch.cuda.synchronize()
    err = max(float((ce - ce_p).abs().max()), float((pm - pm_p).abs().max()))
    require(cor.dtype == torch.bool and torch.equal(cor, cor_p),
            f"loss_confidence correct differs at {(t, v)}")
    require(err <= tol, f"loss_confidence err {err} > {tol} at {(t, v, dtype)}")
    elt = logits.element_size()
    # Read the logits and labels once; write ce, pmax (f32) and correct (1 B).
    b_ms, b_by = bound(t * v * elt + t * 4 + t * 9, 5.0 * t * v)
    # Yardstick: F.cross_entropy gives ce alone (not correct or pmax).
    labels64 = labels.long()
    ce_lib = F.cross_entropy(logits, labels64, reduction="none")
    entry = lc._FORWARD[logits.dtype]

    def entry_only():
        backend.launch(entry, lc.NAME, dev, logits.data_ptr(),
                       labels.data_ptr(), ce.data_ptr(), cor.data_ptr(),
                       pm.data_ptr(), t, v)

    dev_ms, activities, _ = device_profile(
        lambda: lc.loss_confidence(logits, labels), min(reps, 20))
    return {"shape": [t, v], "dtype": str(dtype).replace("torch.", ""),
            "max_abs_err": err, "tol": tol,
            "ms": time_ms(lambda: lc.loss_confidence(logits, labels), reps),
            "entry_only_ms": time_ms(entry_only, reps),
            "device_ms": dev_ms, "device_activities": activities,
            "plain_ms": time_ms(lambda: lc.loss_confidence_plain(logits, labels),
                                reps),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": time_ms(lambda: F.cross_entropy(
                logits, labels64, reduction="none"), reps),
            "library_backend": "F.cross_entropy(reduction='none'): ce only",
            "library_ce_err": float((ce_lib.float() - ce_p).abs().max())}


def check_loss_confidence_nonfinite(dev) -> dict:
    """B1 on rows a poisoned sample gives (the numeric guard's input): all
    logits NaN, one NaN logit beside a finite maximum at the label, NaN at
    the label.  The kernel must give NaN ce and pmax exactly where its
    plain version does, the same ``correct``, and its backward a NaN row
    there too; the finite rows agree within 1e-5."""
    import torch
    from repro_torch.kernels import loss_confidence as lc
    logits, labels, g = lc_inputs(dev, 128, 10, torch.float32, seed=3)
    logits[5] = float("nan")
    logits[9, (int(labels[9]) + 1) % 10] = float("nan")
    logits[9, int(labels[9])] = 100.0
    logits[17, int(labels[17])] = float("nan")
    ce, cor, pm = lc.loss_confidence(logits, labels)
    ce_p, cor_p, pm_p = lc.loss_confidence_plain(logits, labels)
    dl = lc.loss_confidence_backward(logits, labels, ce, g)
    dl_p = lc.loss_confidence_backward_plain(logits, labels, ce_p, g)
    torch.cuda.synchronize()
    same_nan = all(torch.equal(torch.isnan(a), torch.isnan(b))
                   for a, b in ((ce, ce_p), (pm, pm_p), (dl, dl_p)))
    fin = torch.isfinite(ce_p)
    err = max(float((ce - ce_p)[fin].abs().max()),
              float((pm - pm_p)[fin].abs().max()))
    row = {"rows": [5, 9, 17], "ce_nan_rows": torch.isnan(ce).nonzero()
           .flatten().tolist(), "same_nan": same_nan,
           "correct_equal": torch.equal(cor, cor_p), "finite_max_abs_err": err}
    require(same_nan and row["ce_nan_rows"] == [5, 9, 17],
            f"loss_confidence non-finite rows differ from the plain: {row}")
    require(row["correct_equal"] and err <= 1e-5,
            f"loss_confidence with NaN rows: {row}")
    return row


def bf16_ulps(a, b):
    """Elementwise distance in bf16 ulps (sign-magnitude bits mapped to a
    monotone integer; +0 and -0 both to 0)."""
    import torch

    def key(x):
        i = x.view(torch.int16).to(torch.int32)
        return torch.where(i < 0, -32768 - i, i)
    return (key(a) - key(b)).abs()


def parent_scoring():
    """The fused scoring without the backward kernel, as an autograd
    Function: the forward kernel, a second launch for ``correct != 0``
    (for a forward that writes an int32 ``correct``), and the backward as
    PyTorch ops (``loss_confidence_backward_plain``, ten launches): the
    composition ``lc_backward`` replaces, as a yardstick on the card."""
    import torch
    from repro_torch.kernels import loss_confidence as lc

    class ParentScoring(torch.autograd.Function):
        @staticmethod
        def forward(ctx, logits, labels):
            ce, cor, pmax = lc.loss_confidence(logits, labels)
            correct = cor != 0
            ctx.save_for_backward(logits, labels, ce)
            ctx.mark_non_differentiable(correct, pmax)
            return ce, correct, pmax

        @staticmethod
        def backward(ctx, g_ce, _g_correct, _g_pmax):
            logits, labels, ce = ctx.saved_tensors
            return lc.loss_confidence_backward_plain(logits, labels, ce,
                                                     g_ce), None

    return ParentScoring


def check_loss_confidence_bwd(dev, t: int, v: int, dtype, reps: int,
                              seed: int = 0) -> dict:
    """B1's backward against its plain version on the forward kernel's ce,
    for a per-row g and for the mean's stride-0 g: float32 within 1e-6,
    bf16 within one ulp.  Timed beside the plain version; the fused
    forward plus backward (through ``ops.fused_loss_metrics`` and
    ``torch.autograd.grad``) beside ``F.cross_entropy``'s forward plus its
    autograd backward on the same g, and beside ``parent_scoring``
    (forward kernel, a ``!= 0`` and the plain backward on the card); with
    the device activities of each."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import loss_confidence as lc
    from repro_torch.kernels import ops
    logits, labels, g = lc_inputs(dev, t, v, dtype, seed)
    ce, _, _ = lc.loss_confidence(logits, labels)
    g_mean = torch.full((), 1.0 / t, device=dev).expand(t)
    err, ulps = 0.0, 0
    for gg in (g, g_mean):
        got = lc.loss_confidence_backward(logits, labels, ce, gg)
        want = lc.loss_confidence_backward_plain(logits, labels, ce, gg)
        torch.cuda.synchronize()
        require(got.dtype == dtype and got.shape == (t, v),
                f"loss_confidence_bwd gave {got.dtype} {tuple(got.shape)}")
        err = max(err, float((got.float() - want.float()).abs().max()))
        if dtype == torch.bfloat16:
            ulps = max(ulps, int(bf16_ulps(got, want).max()))
        del got, want
    if dtype == torch.bfloat16:
        require(ulps <= 1, f"loss_confidence_bwd {ulps} bf16 ulps off at {(t, v)}")
    else:
        require(err <= 1e-6, f"loss_confidence_bwd err {err} > 1e-6 at {(t, v)}")
    elt = logits.element_size()
    b_ms, b_by = bound(2 * t * v * elt + 16 * t, 5.0 * t * v)
    x = logits.detach().requires_grad_(True)
    labels64 = labels.long()

    def fused():
        c, _, _ = ops.fused_loss_metrics(x, labels)
        return torch.autograd.grad(c, x, g)

    parent_fn = parent_scoring()

    def parent():
        c, _, _ = parent_fn.apply(x, labels)
        return torch.autograd.grad(c, x, g)

    def library():
        c = F.cross_entropy(x, labels64, reduction="none")
        return torch.autograd.grad(c, x, g)

    lib_err = float((library()[0].float() - fused()[0].float()).abs().max())
    # Fused, parent and library are host-paced at small shapes: each is the
    # median of turns taken in rotation (11 there, 5 at device-bound sizes).
    turns = collections.defaultdict(list)
    for _ in range(11 if t * v < 2 ** 24 else 5):
        for name, fn in (("fused", fused), ("parent", parent),
                         ("library", library)):
            turns[name].append(time_ms(fn, reps))
    med = {k: sorted(v)[len(v) // 2] for k, v in turns.items()}
    row = {"shape": [t, v], "dtype": str(dtype).replace("torch.", ""),
           "max_abs_err": err, "tol": "1e-6" if dtype == torch.float32
           else "1 bf16 ulp", "max_bf16_ulps": ulps,
           "ms": time_ms(lambda: lc.loss_confidence_backward(
               logits, labels, ce, g), reps),
           "plain_ms": time_ms(lambda: lc.loss_confidence_backward_plain(
               logits, labels, ce, g), reps),
           "bound_ms": b_ms, "bound_by": b_by,
           "fused_fwd_bwd_ms": med["fused"],
           "parent_fwd_bwd_ms": med["parent"],
           "library_ms": med["library"],
           "min_ms": {k: min(v) for k, v in turns.items()},
           "library_backend": "F.cross_entropy(reduction='none') forward + "
                              "torch.autograd.grad on the same g",
           "library_grad_err": lib_err}
    for key, fn in (("", lambda: lc.loss_confidence_backward(
                        logits, labels, ce, g)),
                    ("fused_fwd_bwd_", fused), ("parent_fwd_bwd_", parent),
                    ("library_", library)):
        dev_ms, activities, _ = device_profile(fn, min(reps, 20))
        row[f"{key}device_ms"] = dev_ms
        row[f"{key}device_activities"] = activities
    return row


def selection_inputs(dev, n: int, invalid: float, seed: int, kind: str = "exp"):
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    if kind in ("exp", "single"):
        loss = r.exponential(1.0, n)
    elif kind == "equal":
        loss = np.full(n, 2.5)
    elif kind == "naninf":                  # non-finite losses count as invalid
        loss = np.select([r.random(n) < 0.05, r.random(n) < 0.05,
                          r.random(n) < 0.05], [np.nan, np.inf, -np.inf],
                         r.exponential(1.0, n))
    else:                                   # signed zeros
        loss = np.where(r.random(n) < 0.5, -0.0, 0.0)
    valid = r.random(n) >= invalid
    if kind == "single":
        valid = np.arange(n) == n // 3
    return (torch.tensor(loss, dtype=torch.float32, device=dev),
            torch.tensor(valid, device=dev))


def check_histogram_select(dev, n: int, invalid: float, kind: str,
                           seed: int = 0) -> int:
    """The histogram-select kernel (B2 and B3 fused with the CDF walks and
    the masks) against its plain version on the same card: both masks, the
    histogram, the walk exactly and the raw range by ``==`` (a signed zero
    may come back as either zero; both bin alike), for low fractions {0,
    0.3, 1} (by value and as a float32 device scalar in turn) x high
    fractions {0, 0.02} x bins {512, 64}.  Returns the cases run."""
    import torch
    from repro_torch.kernels import threshold_select as ts
    loss, valid = selection_inputs(dev, n, invalid, seed, kind)
    nv = int((valid & torch.isfinite(loss)).sum())
    cases = 0
    for bins in (512, 64):
        for j, low in enumerate((0.0, 0.3, 1.0)):
            for high in (0.0, 0.02):
                tag = f"N={n} invalid={invalid} {kind} F={low} top={high} bins={bins}"
                f = (torch.full((), low, device=dev) if (j + cases) % 2 else low)
                got = ts.histogram_select(loss, valid, f, high, bins)
                want = ts.histogram_select_plain(loss, valid, low, high, bins)
                for name, a, b in zip(("low mask", "high mask", "histogram"),
                                      got, want):
                    require((a is None) == (b is None), f"{name}: None differs ({tag})")
                    require(a is None or torch.equal(a, b), f"{name} differs in "
                            f"{0 if a is None else int((a != b).sum())} places ({tag})")
                require(bool((got[3] == want[3]).all()),
                        f"range {got[3].tolist()} != {want[3].tolist()} ({tag})")
                require(torch.equal(got[4], want[4]),
                        f"walk {got[4].tolist()} != {want[4].tolist()} ({tag})")
                require(int(got[2].sum()) == nv, f"histogram lost counts ({tag})")
                cases += 1
    return cases


#: Losses a block of the histogram-select keeps in shared memory at 512
#: bins (``csrc/threshold_select.cu``: 220 KiB less 12 bytes a bin, over 4):
#: up to SMs x this N the losses are read from HBM once.
HS_SLICE_LOSSES = (220 * 1024 - 12 * 512) // 4


def time_histogram_masks(dev, n: int, reps: int, invalid: float = 0.3,
                         high: float = 0.02) -> dict:
    """``planops.histogram_masks`` as the plan calls it (F = 0.3 as a
    float32 device scalar, DropTop ``high``) with ``use_kernel`` on (the
    kernel path) and off (the plain composition), and the device
    activities of one kernel-path call.  Only ``planops``' public
    signature is used, so the same function times an earlier tree's
    composition."""
    import torch
    from repro_torch.core import planops
    loss, valid = selection_inputs(dev, n, invalid, 0, "exp")
    f = torch.full((), 0.3, device=dev)

    def masks(use_kernel):
        return planops.histogram_masks(loss, valid, f, high,
                                       use_kernel=use_kernel)

    dev_ms, launches, names = device_profile(lambda: masks(True), min(reps, 20))
    return {"n": n, "invalid": invalid, "high_fraction": high,
            "masks_kernel_ms": time_ms(lambda: masks(True), reps),
            "masks_plain_ms": time_ms(lambda: masks(False), reps),
            "masks_device_ms": dev_ms, "masks_cuda_launches": launches,
            "masks_device_events": names}


def time_histogram_select(dev, n: int, reps: int) -> dict:
    """The histogram-select call at the plan's arguments (F = 0.3 as a
    device scalar, DropTop 0.02, 0.3 invalid, 512 bins) against its plain
    version on the card, the C entry alone on buffers allocated once, and
    ``torch.aminmax`` + ``torch.histc`` on the same losses (the nearest two
    calls: the range and a histogram, neither gives the masks; used nowhere
    in the port).  ``cuda_launches`` counts the device activities of one
    call under the profiler: the memset and the kernel."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels import threshold_select as ts
    invalid, high, bins = 0.3, 0.02, 512
    loss, valid = selection_inputs(dev, n, invalid, 0, "exp")
    f = torch.full((), 0.3, device=dev)
    got = ts.histogram_select(loss, valid, f, high, bins)
    want = ts.histogram_select_plain(loss, valid, 0.3, high, bins)
    err = max(float((a.double() - b.double()).abs().max())
              for a, b in zip(got, want))
    require(err == 0.0, f"histogram_select at the timing shape N={n}: "
            f"max abs difference {err}")
    lo, hi = (float(v) for v in want[3])

    def library():
        return torch.aminmax(loss), torch.histc(loss, bins, lo, hi)

    scratch = torch.empty(ts._HS_HIST_WORD + bins + 2 * ts._HS_MAX_BLOCKS,
                          dtype=torch.int32, device=dev)
    low_out = torch.empty(n, dtype=torch.bool, device=dev)
    high_out = torch.empty(n, dtype=torch.bool, device=dev)

    def entry_only():
        backend.launch("hs_histogram_select", "histogram_select", dev,
                       loss.data_ptr(), valid.data_ptr(), f.data_ptr(), 0.0,
                       high, bins, scratch.data_ptr(), scratch.numel(),
                       low_out.data_ptr(), high_out.data_ptr(), n)

    def call():
        return ts.histogram_select(loss, valid, f, high, bins)

    dev_ms, launches, names = device_profile(call, min(reps, 20))
    require(launches <= 2, f"a histogram_select call ran {launches} device "
            f"activities ({names}), more than the memset and the kernel")
    nv = int(valid.sum())
    # Bytes: the float losses and bool flags read once, the two bool masks
    # written once; ops: the validity select on every loss, then min, max,
    # the bin index (sub, div, mul, truncate, two clamps) and two mask
    # compares on each valid one, at the fp32 rate.
    b_ms, b_by = bound(5 * n + 2 * n, n + 10 * nv)
    return {"phase": "histogram_select", "n": n, "invalid": invalid,
            "high_fraction": high, "bins": bins, "max_abs_err": err,
            "ms": time_ms(call, reps), "entry_only_ms": time_ms(entry_only, reps),
            "device_ms": dev_ms, "cuda_launches": launches,
            "device_events": names,
            "shared_path": n <= HS_SLICE_LOSSES * torch.cuda.get_device_properties(
                dev).multi_processor_count,
            "plain_ms": time_ms(lambda: ts.histogram_select_plain(
                loss, valid, f, high, bins), reps),
            "library_ms": time_ms(library, reps),
            "library_backend": "torch.aminmax + torch.histc over [lo, hi]: the "
                               "nearest two calls, neither gives the masks",
            "bound_ms": b_ms, "bound_by": b_by,
            **time_histogram_masks(dev, n, reps, invalid, high)}


def radix_scores(dev, n: int, kind: str, seed: int = 0):
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    if kind == "exp":
        x = r.exponential(1.0, n)
    elif kind == "events":        # FORGET: small counts, never-correct +inf
        x = np.where(r.random(n) < 0.1, np.inf, r.integers(0, 4, n))
    elif kind == "zeros":         # signed zeros must tie
        x = np.where(r.random(n) < 0.5, -0.0, 0.0)
    elif kind == "inf":
        x = np.where(r.random(n) < 0.2, -np.inf,
                     np.where(r.random(n) < 0.2, np.inf, r.normal(size=n)))
    else:                         # all equal
        x = np.full(n, 2.5)
    return torch.tensor(x, dtype=torch.float32, device=dev)


def rank_oracle(scores, k: int, high: bool):
    """The stable-argsort rank window.  Signed zeros are collapsed first: a
    radix sort on the card orders -0.0 before +0.0, a stable sort by value
    treats them as ties."""
    import torch
    from repro_torch.core.planops import stable_rank_order
    rank = stable_rank_order(torch.where(scores == 0, 0.0, scores))
    n = scores.shape[0]
    return rank >= n - k if high else rank < k


def check_radix(dev, n: int, kind: str) -> int:
    """The rank-select kernel (B4 and B5 in one launch) against its plain
    version on the same card: the mask, the four pass histograms and the
    (thresh, needed, total) triple exactly, and the mask against the stable
    sort's rank window, for k in {0, 1, N/3, N} both ways, k passed by value
    and as int32 and int64 device scalars in turn.  Returns the cases run."""
    import torch
    from repro_torch.kernels import threshold_select as ts
    scores = radix_scores(dev, n, kind, seed=n)
    cases = 0
    for high in (False, True):
        for j, k in enumerate((0, 1, n // 3, n)):
            tag = f"N={n} {kind} k={k} high={high}"
            k_arg = (k, torch.tensor(k, dtype=torch.int32, device=dev),
                     torch.tensor(k, device=dev), k)[j]
            mask, hists, triple = ts.rank_select(scores, k_arg, high)
            want, hists_p, triple_p = ts.rank_select_plain(scores, k, high)
            require(torch.equal(hists, hists_p), f"pass histograms differ ({tag}): "
                    f"rows {(hists != hists_p).any(1).nonzero().flatten().tolist()}")
            require(torch.equal(triple, triple_p), f"(thresh, needed, total) "
                    f"{triple.tolist()} != {triple_p.tolist()} ({tag})")
            require(torch.equal(mask, want), f"mask differs in "
                    f"{int((mask != want).sum())} places ({tag})")
            require(torch.equal(mask, rank_oracle(scores, k, high)),
                    f"rank window differs from the stable sort ({tag})")
            require(int(mask.sum()) == k, f"mask holds {int(mask.sum())} != k ({tag})")
            cases += 1
    return cases


#: Keys a block of the rank-select keeps in shared memory
#: (``csrc/rank_select.cu``'s kMaxSliceKeys): up to SMs x this N the
#: scores are read from HBM once.
RS_SLICE_KEYS = 55 * 1024


def time_rank_select(dev, n: int, reps: int) -> dict:
    """The whole rank-select (DropTop's k = N/50 largest) against its plain
    version and two one-call yardsticks the port never uses:
    ``torch.kthvalue`` (the threshold alone) and a stable ``torch.sort``
    with a scatter of the ranks (the same mask).  ``cuda_launches`` counts
    the device activities of one call under the profiler."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.kernels import threshold_select as ts
    scores = radix_scores(dev, n, "exp")
    k = n // 50
    k_dev = torch.tensor(k, dtype=torch.int32, device=dev)
    want = rank_oracle(scores, k, True)
    mask, hists, triple = ts.rank_select(scores, k, True)
    _, hists_p, triple_p = ts.rank_select_plain(scores, k, True)
    require(torch.equal(mask, want) and torch.equal(hists, hists_p)
            and torch.equal(triple, triple_p), "rank_select at the timing shape")

    def sort_mask():
        order = torch.sort(scores, stable=True).indices
        rank = torch.empty_like(order)
        rank[order] = torch.arange(n, device=dev)
        return rank >= n - k

    require(torch.equal(sort_mask(), want), "sort-mask yardstick")
    # The C entry alone on buffers allocated once (the memset and the
    # cooperative launch): the call's host cost without the wrapper's.
    scratch = torch.empty(ts._RS_TIE_WORD + ts._RS_MAX_BLOCKS,
                          dtype=torch.int32, device=dev)
    out = torch.empty(n, dtype=torch.bool, device=dev)

    def entry_only():
        backend.launch("rs_rank_select", "rank_select", dev, scores.data_ptr(),
                       0, 0, k, 1, scratch.data_ptr(), scratch.numel(),
                       out.data_ptr(), n)

    dev_ms, launches, names = device_profile(
        lambda: ts.rank_select(scores, k, True), min(reps, 20))
    require(launches <= 2, f"a rank_select call ran {launches} device "
            f"activities ({names}), more than the memset and the kernel")
    # Bytes: the float scores read once, the bool mask written once; a few
    # integer operations a key over the five passes, counted at the fp32
    # rate (the data sheet has no int32 row).
    b_ms, b_by = bound(4 * n + n, 20.0 * n)
    sort_ms = time_ms(sort_mask, reps)
    return {"phase": "rank_select", "n": n, "k": k, "high": True,
            "max_abs_err": float((mask.int() - want.int()).abs().max()),
            "ms": time_ms(lambda: ts.rank_select(scores, k, True), reps),
            "k_device_ms": time_ms(lambda: ts.rank_select(scores, k_dev, True),
                                   reps),
            "entry_only_ms": time_ms(entry_only, reps),
            "device_ms": dev_ms, "cuda_launches": launches,
            "device_events": names,
            "shared_path": n <= RS_SLICE_KEYS * torch.cuda.get_device_properties(
                dev).multi_processor_count,
            "plain_ms": time_ms(lambda: ts.rank_select_plain(scores, k, True),
                                reps),
            "kthvalue_ms": time_ms(lambda: torch.kthvalue(scores, n - k + 1),
                                   reps),
            "sort_mask_ms": sort_ms, "library_ms": sort_ms,
            "library_backend": "torch.sort(stable=True) + scatter of the ranks",
            "bound_ms": b_ms, "bound_by": b_by}


#: mamba2-130m's scan: 24 heads of P = 64, state N = 128, chunk 128.
SSD_SHAPE = dict(nh=24, p=64, n=128, chunk=128)
#: allclose (rtol = atol) of B6 against its plain version: the JAX
#: package's kernel-vs-oracle tolerance (tests/test_kernels.py).
SSD_TOL = 1e-4


def ssd_inputs(dev, b: int, s: int, kind: str, seed: int = 0,
               shape: dict = SSD_SHAPE):
    """x, raw dt, a_log, b, c, d_skip at ``shape`` (the serve shape by
    default).  ``model``: dt and a_log as the model draws them at init
    (fast decay: the carried state matters for a few rows of a chunk);
    ``slow``: dt ~ softplus(N(-5, 1)), a in [-e, -1], so the state carries
    across chunks."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    nh, p, n = shape["nh"], shape["p"], shape["n"]

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

    def unif(lo, hi, *shape):
        return torch.rand(*shape, generator=g, device=dev) * (hi - lo) + lo

    # x, b and c are column slices of one (B, S, NH.P + 2N) activation, as
    # the model hands them to the wrapper (views, not contiguous).
    xbc = randn(b, s, nh * p + 2 * n)
    x, bm, cm = torch.split(xbc, [nh * p, n, n], dim=-1)
    x = x.view(b, s, nh, p)
    dt = randn(b, s, nh)
    if kind == "model":
        a_log = torch.log(unif(1.0, 16.0, nh))
    else:
        dt, a_log = dt - 5.0, unif(0.0, 1.0, nh)
    return x, dt, a_log, bm, cm, randn(nh)


def ssd_scan_f64(x, dt, a_log, b, c, d_skip, chunk: int):
    """``ssd_scan_plain``'s chunked form with its products in float64, on
    the float32 dt and chunk cumsum that B6 and the plain version both
    take: another order of the cumsum alone moves y by ~6e-3 at the
    model's decays (ROADMAP C), so only with the same cum does the
    difference measure the products' rounding.  A yardstick for both."""
    import torch
    import torch.nn.functional as F
    B, S, NH, P = x.shape
    s_orig = S
    if S % chunk:
        pad = chunk - S % chunk
        x, b, c = (F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)) for t in (x, b, c))
        dt = F.pad(dt, (0, 0, 0, pad), value=-1e30)
        S += pad
    N, nc = b.shape[-1], S // chunk
    dt = F.softplus(dt.float())
    cum = torch.cumsum((dt * -torch.exp(a_log.float())).reshape(B, nc, chunk, NH),
                       dim=2).double()
    dtr = dt.double().reshape(B, nc, chunk, NH)
    xr = x.double().reshape(B, nc, chunk, NH, P)
    br, cr = (t.double().reshape(B, nc, chunk, N) for t in (b, c))
    seg = cum[:, :, -1]
    tri = torch.ones(chunk, chunk, dtype=torch.bool, device=x.device).tril()
    decay = torch.exp((cum[:, :, :, None] - cum[:, :, None]).masked_fill(
        ~tri[None, None, :, :, None], -1e300))
    cb = torch.einsum("bctn,bcsn->bcts", cr, br)
    y = torch.einsum("bctsh,bcshp->bcthp", cb[..., None] * decay * dtr[:, :, None], xr)
    w = torch.exp(seg[:, :, None] - cum) * dtr
    states = torch.einsum("bcsh,bcsn,bcshp->bchnp", w, br, xr)
    h = torch.zeros(B, NH, N, P, dtype=torch.float64, device=x.device)
    h_prev = []
    for i in range(nc):
        h_prev.append(h)
        h = h * torch.exp(seg[:, i])[:, :, None, None] + states[:, i]
    y = y + torch.einsum("bctn,bcth,bchnp->bcthp", cr, torch.exp(cum),
                         torch.stack(h_prev, dim=1))
    y = y.reshape(B, S, NH, P) + d_skip.double()[None, None, :, None] * x.double()
    return y[:, :s_orig], h


def check_ssd_scan(dev, b: int, s: int, kind: str, reps: int,
                   shape: dict = SSD_SHAPE) -> dict:
    """B6 against its plain version on the card: y and the final state
    within SSD_TOL (allclose), times and the bound; both against
    ``ssd_scan_f64``."""
    import torch
    from repro_torch.kernels import ssd_scan as ssd
    args = ssd_inputs(dev, b, s, kind, shape=shape)
    chunk = shape["chunk"]
    y, st = ssd.ssd_scan(*args, chunk)
    y_p, st_p = ssd.ssd_scan_plain(*args, chunk)
    torch.cuda.synchronize()
    tag = f"B={b} S={s} {kind} {shape}"
    require(bool(torch.isfinite(y).all()) and bool(torch.isfinite(st).all()),
            f"ssd_scan non-finite ({tag})")
    for name, a, ref in (("y", y, y_p), ("state", st, st_p)):
        require(torch.allclose(a, ref, rtol=SSD_TOL, atol=SSD_TOL),
                f"ssd_scan {name} differs from the plain version by "
                f"{float((a - ref).abs().max())} ({tag})")
    nh, p, n = shape["nh"], shape["p"], shape["n"]
    # The chunked form's products over this run's chunk lengths, counting
    # only the causal s <= t half of C.B^T and scores.X, with C.B^T once
    # per (batch, chunk) (b and c are one group shared by every head): B6's
    # work, on the tensor cores in 3xTF32.  On the CUDA cores in fp32 the
    # per-token recurrence's 5 N P (decay, outer-product update, C.state)
    # may be fewer; the fp32 bound takes the fewer of the two.
    lens = [min(chunk, s - c0) for c0 in range(0, s, chunk)]
    chunked = b * sum(l * (l + 1) * n + nh * (l * (l + 1) * p + 4 * l * n * p)
                      for l in lens)
    recurrent = b * nh * s * 5 * n * p
    ops = chunked
    nbytes = 4 * (2 * y.numel() + b * s * nh + 2 * b * s * n + 2 * nh + st.numel())
    b_ms, b_by = bound(nbytes, chunked, TF32X3_OPS_PER_S)
    b32_ms, _ = bound(nbytes, min(chunked, recurrent))
    err_y = float((y - y_p).abs().max())
    err_st = float((st - st_p).abs().max())
    y64, st64 = ssd_scan_f64(*args, chunk)

    def err64(a, ref):
        return float((a.double() - ref).abs().max())
    return {"name": "ssd_scan", "shape": [b, s, nh, p, n], "chunk": chunk,
            "kind": kind, "max_abs_err": max(err_y, err_st),
            "max_abs_err_y": err_y, "max_abs_err_state": err_st,
            "f64_err_y": err64(y, y64), "plain_f64_err_y": err64(y_p, y64),
            "f64_err_state": err64(st, st64),
            "plain_f64_err_state": err64(st_p, st64),
            "max_abs_y": float(y_p.abs().max()), "tol": SSD_TOL,
            "ms": time_ms(lambda: ssd.ssd_scan(*args, chunk), reps),
            "device_ms": device_ms(lambda: ssd.ssd_scan(*args, chunk), reps),
            "plain_ms": time_ms(lambda: ssd.ssd_scan_plain(*args, chunk),
                                max(reps // 4, 1)),
            "bound_ms": b_ms, "bound_by": b_by, "bound_unit": "3xTF32",
            "bound_fp32_ms": b32_ms, "gflop": ops / 1e9,
            "gflop_chunked_causal": chunked / 1e9,
            "gflop_recurrent": recurrent / 1e9, "mbytes": nbytes / 1e6}


#: smollm-135m's prefill attention: (B, S, Hq, Hkv, D), 9 query heads
#: sharing 3 KV heads of 64.
ATTN_SHAPE = (4, 2048, 9, 3, 64)


def sdpa_kernels(fn) -> list:
    """The CUDA kernels one call of ``fn`` runs (which SDPA backend ran)."""
    prof, _, _ = profiled(fn, fn)
    return sorted({e.name[:90] for e in device_events(prof)})


def attention_f64(q, k, v, causal: bool):
    """Causal or full GQA attention in float64 (B, S, H, D): a yardstick
    for B7 and its plain version alike."""
    import torch
    b, s, hq, d = q.shape
    hkv = k.shape[2]
    q5 = q.double().view(b, s, hkv, hq // hkv, d)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", q5, k.double()) * d ** -0.5
    if causal:
        tri = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~tri, float("-inf"))
    out = torch.einsum("bhgqk,bkhd->bqhgd", torch.softmax(scores, -1), v.double())
    return out.reshape(b, s, hq, d)


def check_flash_attention(dev, shape, causal: bool, dtype, tol: float,
                          reps: int, library: bool = False,
                          seed: int = 0) -> dict:
    """B7 against its plain version on the card (allclose ``tol``), with
    times and both bounds; with ``library``, SDPA under each backend
    (``sdpa_backends``) as a yardstick, the fastest as ``library_ms``."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    b, s, hq, hkv, d = shape
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    out = fa.flash_attention(q, k, v, causal)
    ref = fa.flash_attention_plain(q, k, v, causal)
    torch.cuda.synchronize()
    tag = f"{shape} causal={causal} {dtype}"
    require(out.shape == ref.shape and out.dtype == q.dtype,
            f"flash_attention returned {tuple(out.shape)} {out.dtype} ({tag})")
    require(bool(torch.isfinite(out).all()), f"flash_attention non-finite ({tag})")
    ok, err = close(out.float(), ref.float(), tol)
    require(ok, f"flash_attention differs from the plain version by {err} "
                f"> {tol} ({tag})")
    # The causal half only where causal: s(s+1)/2 (query, key) pairs.
    pairs = s * (s + 1) // 2 if causal else s * s
    ops = 4 * b * hq * d * pairs
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    b_ms, b_by = bound(nbytes, ops, TF32X3_OPS_PER_S)
    b32_ms, _ = bound(nbytes, ops)
    row = {"name": "flash_attention", "shape": list(shape), "causal": causal,
           "dtype": str(dtype).replace("torch.", ""), "max_abs_err": err,
           "tol": tol, "ms": time_ms(lambda: fa.flash_attention(q, k, v, causal),
                                     reps),
           "device_ms": device_ms(lambda: fa.flash_attention(q, k, v, causal),
                                  reps),
           "plain_ms": time_ms(lambda: fa.flash_attention_plain(q, k, v, causal),
                               max(reps // 4, 1)),
           "bound_ms": b_ms, "bound_by": b_by, "bound_unit": "3xTF32",
           "bound_fp32_ms": b32_ms, "gflop": ops / 1e9,
           "mbytes": nbytes / 1e6, "library_ms": None}
    if dtype == torch.float32:
        o64 = attention_f64(q, k, v, causal)
        row["f64_err"] = float((out.double() - o64).abs().max())
        row["plain_f64_err"] = float((ref.double() - o64).abs().max())
        del o64
    if library:
        backends = sdpa_backends(q, k, v, causal, ref, reps)
        timed = {k: r for k, r in backends.items() if "ms" in r}
        row["sdpa_backends"] = backends
        if timed:
            best = min(timed, key=lambda k: timed[k]["ms"])
            row["library_ms"] = timed[best]["ms"]
            row["library_backend"] = best
    return row


def sdpa_backends(q, k, v, causal: bool, ref, reps: int) -> dict:
    """``F.scaled_dot_product_attention`` on (B, H, S, D) views of q, k, v
    under each backend that might take a float32 call (math, efficient,
    cuDNN), forced through ``torch.nn.attention.sdpa_kernel``: with
    ``enable_gqa=True``, or where the backend refuses that, with K and V
    expanded to Hq heads outside the timed call.  Each backend's time, its
    error against the plain version and its kernels, or its refusals.  A
    yardstick: the port never calls SDPA."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    group = q.shape[2] // k.shape[2]
    expanded = tuple(t.repeat_interleave(group, dim=1) for t in (kt, vt))
    out = {}
    for name, backend in (("math", SDPBackend.MATH),
                          ("efficient", SDPBackend.EFFICIENT_ATTENTION),
                          ("cudnn", SDPBackend.CUDNN_ATTENTION)):
        row = {"refused": []}
        for gqa, (kk, vv) in ((True, (kt, vt)), (False, expanded)):
            def call(kk=kk, vv=vv, gqa=gqa):
                return F.scaled_dot_product_attention(qt, kk, vv,
                                                      is_causal=causal,
                                                      enable_gqa=gqa)
            with sdpa_kernel(backend):
                try:
                    lib = call()
                    torch.cuda.synchronize()
                except RuntimeError as e:
                    row["refused"].append(
                        f"enable_gqa={gqa}: {str(e).strip().splitlines()[0][:200]}")
                    continue
                row.update(
                    ms=time_ms(call, reps), enable_gqa=gqa,
                    expanded_kv=not gqa,
                    max_abs_err=float((lib.transpose(1, 2).float()
                                       - ref.float()).abs().max()),
                    kernels=sdpa_kernels(call))
            break
        out[name] = row
    return out


def phase_kernels(dev) -> tuple[dict, dict]:
    """Every kernel against its plain version; returns the main-shape rows
    and the LM training path's (``lm_kernel_checks``)."""
    import torch
    main = {"loss_confidence": check_loss_confidence(dev, 128, 10, torch.float32,
                                                     1e-5, 200)}
    big = [check_loss_confidence(dev, 1024, 8192, torch.float32, 1e-4, 50),
           check_loss_confidence(dev, 4096, 151936, torch.float32, 1e-4, 5),
           check_loss_confidence(dev, 4096, 151936, torch.bfloat16, 1e-4, 5),
           check_loss_confidence(dev, 1000, 50257, torch.float32, 1e-4, 10)]
    # B1's backward: the CNN's batch, a ragged one, the wide-head model's
    # (benchmarks/step_throughput.py::fused_scoring_main), GPT-2's and
    # Qwen's vocabularies, in float32 and bf16.
    bwd = [check_loss_confidence_bwd(dev, t, v, dtype, reps)
           for t, v, reps in ((128, 10, 200), (7, 33, 50), (1024, 8192, 50),
                              (1000, 50257, 10), (4096, 151936, 5))
           for dtype in (torch.float32, torch.bfloat16)]
    main["loss_confidence_bwd"] = dict(bwd[0], max_abs_err=max(
        r["max_abs_err"] for r in bwd if r["dtype"] == "float32"))
    big.extend(bwd)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    # One loss; an N no slice size divides; an N past the shared-memory
    # path; an N past 2**24, where f32(N) rounds.
    hs_cases = sum(check_histogram_select(dev, n, invalid, kind)
                   for n, invalid, kind in (
                       (50_000, 0.3, "exp"), (1_281_167, 0.3, "exp"),
                       (50_000, 1.0, "exp"), (50_000, 0.0, "single"),
                       (50_000, 0.0, "equal"), (50_000, 0.2, "zeros"),
                       (50_000, 0.2, "naninf"), (1_281_167, 0.1, "naninf"),
                       (1, 0.0, "exp"), (1_000_003, 0.3, "exp"),
                       (HS_SLICE_LOSSES * sms + 4_099, 0.3, "exp"),
                       (2 ** 24 + 1, 0.3, "exp")))
    hs = time_histogram_select(dev, 50_000, 200)
    main["minmax"] = main["histogram"] = dict(hs, fused="histogram_select")
    radix_cases = sum(check_radix(dev, n, kind)
                      for n in (50_000, 1_281_167)
                      for kind in ("exp", "events", "zeros", "inf", "equal"))
    # One key; an N no slice size divides; an N past the shared-memory path.
    radix_cases += sum(check_radix(dev, n, kind)
                       for n in (1, 1_000_003, RS_SLICE_KEYS * sms + 4_099)
                       for kind in ("exp", "events"))
    rs = time_rank_select(dev, 50_000, 200)
    main["byte_histogram"] = main["select_mask"] = dict(rs, fused="rank_select")
    ssd_rows = [check_ssd_scan(dev, 4, 2048, kind, 20)
                for kind in ("model", "slow")]
    main["ssd_scan"] = dict(ssd_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in ssd_rows))
    big.extend(ssd_rows)
    big.extend(check_ssd_scan(dev, 4, s, "slow", 8) for s in (1000, 64))
    # Shapes off the model's that the wrapper takes: MMA tiles with edges
    # (P, N, chunk not multiples of 8 or 16) and a P that is not a multiple
    # of 4 (x then copied by plain loads, not cp.async).
    big.extend(check_ssd_scan(dev, 2, s, "slow", 4, shape)
               for s, shape in ((100, dict(nh=3, p=20, n=12, chunk=20)),
                                (50, dict(nh=2, p=6, n=8, chunk=12))))
    fa_rows = [check_flash_attention(dev, ATTN_SHAPE, True, torch.float32,
                                     1e-5, 20, library=True)]
    b, _, hq, hkv, d = ATTN_SHAPE
    for shape, causal, dtype, tol in (
            ((b, 1000, hq, hkv, d), True, torch.float32, 1e-5),   # ragged
            (ATTN_SHAPE, False, torch.float32, 1e-5),
            (ATTN_SHAPE, True, torch.bfloat16, 2e-2),
            ((1, 512, 2, 1, 128), True, torch.float32, 1e-5),
            ((1, 512, 2, 1, 128), False, torch.bfloat16, 2e-2),
            ((1, 256, 8, 8, 32), True, torch.float32, 1e-5),
            ((2, 128, 4, 2, 16), False, torch.float32, 1e-5)):
        fa_rows.append(check_flash_attention(dev, shape, causal, dtype, tol, 8))
    main["flash_attention"] = dict(fa_rows[0], max_abs_err=max(
        r["max_abs_err"] for r in fa_rows if r["dtype"] == "float32"))
    big.extend(fa_rows)
    emit({"phase": "kernel_checks", "main": main, "more": big,
          "histogram_select_cases": hs_cases, "radix_cases": radix_cases,
          "loss_confidence_nan_rows": check_loss_confidence_nonfinite(dev)})
    emit(time_histogram_select(dev, 1_281_167, 50))
    emit(time_rank_select(dev, 1_281_167, 50))
    return main, lm_kernel_checks(dev)


# ---------------------------------------------------------------------------
# Plan at ImageNet-1K size
# ---------------------------------------------------------------------------


def sync(dev) -> None:
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seeded_state(dev, n: int, seed: int = 0):
    import numpy as np
    import torch
    from repro_torch.core.state import init_sample_state
    r = np.random.default_rng(seed)
    st = init_sample_state(n, dev)
    seen = r.random(n) >= 0.1
    st.loss.copy_(torch.from_numpy(np.where(
        seen, r.exponential(1.0, n), 1e9).astype(np.float32)))
    st.pa.copy_(torch.from_numpy(r.random(n) < 0.7))
    st.pc.copy_(torch.from_numpy(r.random(n).astype(np.float32)))
    st.seen.copy_(torch.from_numpy(np.where(seen, 0, -1).astype(np.int32)))
    st.hidden.copy_(torch.from_numpy(r.random(n) < 0.2))
    return st


def phase_plan(dev, n: int = 1_281_167, reps: int = 5) -> None:
    """The plans at ImageNet-1K's size: ``"histogram_pallas"`` (the
    histogram-select kernel) against ``"histogram"`` (plain) on the card
    and against itself on the CPU (its plain version), then the radix
    plans."""
    import torch
    from repro_torch.core.kakurenbo import _plan_step
    st = seeded_state(dev, n)
    perm = torch.randperm(n, generator=torch.Generator(device=dev).manual_seed(1),
                          device=dev)
    cpu = torch.device("cpu")
    st_cpu = dataclasses.replace(st, **{f.name: getattr(st, f.name).to(cpu)
                                        for f in dataclasses.fields(st)})
    row = {"phase": "plan", "n": n}
    for drop in (0.0, 0.02):
        outs, ms = {}, {}
        for method in ("histogram_pallas", "histogram"):
            def run(method=method):
                return _plan_step(st, perm, 0.3, method=method, tau=0.7,
                                  drop_top=drop, moveback=True, adjust_lr=True)
            outs[method] = run()
            ms[method] = median_ms(dev, run, reps)
        for a, b in zip(outs["histogram_pallas"], outs["histogram"]):
            require(torch.equal(a, b), f"plan differs between methods (drop_top={drop})")
        host = _plan_step(st_cpu, perm.cpu(), 0.3, method="histogram_pallas",
                          tau=0.7, drop_top=drop, moveback=True, adjust_lr=True)
        for name, a, b in zip(PLAN_FIELDS, outs["histogram_pallas"], host):
            require(torch.equal(a.cpu(), b), f"histogram_pallas plan: {name} "
                    f"differs between the card and the CPU (drop_top={drop})")
        hidden = int(outs["histogram"][3])
        require(hidden > 0, "plan hid nothing")
        row[f"drop_top={drop}"] = {"num_hidden": hidden,
                                   "f_star": float(outs["histogram"][4]),
                                   "kernel_plan_ms": ms["histogram_pallas"],
                                   "plain_plan_ms": ms["histogram"]}
    row.update(radix_plans(dev, st, st_cpu, perm, reps))
    emit(row)


#: The fields of ``_plan_step``'s result, in order.
PLAN_FIELDS = ("hidden", "moved_back", "order", "num_hidden", "f_star",
               "lr_scale")


def median_ms(dev, fn, reps: int) -> float:
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        fn()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[len(times) // 2]


def radix_plans(dev, st, st_cpu, perm, reps: int) -> dict:
    """The plans that run the radix select: ``"sort"`` + DropTop 0.02 and
    FORGET's prune at 0.3 N, on the card (the rank-select kernel) and on
    the CPU (its plain version).  Equal, and the prune equal to the stable-sort
    rank window."""
    import numpy as np
    import torch
    from repro_torch.core.forget import _prune_step
    from repro_torch.core.kakurenbo import _plan_step
    from repro_torch.core.planops import stable_rank_order
    n = st.num_samples
    r = np.random.default_rng(2)
    st.forget_events.copy_(torch.from_numpy(r.integers(0, 4, n).astype(np.int32)))
    st_cpu.forget_events.copy_(st.forget_events)
    cpu = torch.device("cpu")

    def plan(state, p):
        return _plan_step(state, p, 0.3, method="sort", tau=0.7, drop_top=0.02,
                          moveback=True, adjust_lr=True)

    card, host = plan(st, perm), plan(st_cpu, perm.cpu())
    for name, a, b in zip(PLAN_FIELDS, card, host):
        require(torch.equal(a.cpu(), b), f"sort+DropTop plan: {name} differs "
                "between the card and the CPU")
    k = int(math.floor(0.3 * n))
    prune = _prune_step(st, k)
    require(torch.equal(prune.cpu(), _prune_step(st_cpu, k)),
            "FORGET prune differs between the card and the CPU")
    scores = torch.where(st.pa | (st.forget_events > 0),
                         st.forget_events.float(), torch.inf)
    require(torch.equal(prune, stable_rank_order(scores) < k),
            "FORGET prune differs from the stable-sort rank window")
    require(int(prune.sum()) == k, "FORGET pruned the wrong count")
    return {"sort_drop_top=0.02": {
                "num_hidden": int(card[3]), "f_star": float(card[4]),
                "kernel_plan_ms": median_ms(dev, lambda: plan(st, perm), reps),
                "cpu_plain_plan_ms": median_ms(cpu, lambda: plan(st_cpu, perm.cpu()),
                                               1)},
            "forget_prune": {
                "k": k, "kernel_ms": median_ms(dev, lambda: _prune_step(st, k), reps),
                "cpu_plain_ms": median_ms(cpu, lambda: _prune_step(st_cpu, k), 1)}}


# ---------------------------------------------------------------------------
# Training: the main path
# ---------------------------------------------------------------------------


def _logits_fn(model, batch):
    return model(batch["images"])


def watch_fraction_bound(strategy, checks: list) -> None:
    """Wrap the sampler's ``begin_epoch`` to check F* <= F_e up to the
    boundary-bin slack of ``core/selection.py``: the low tail may pass
    floor(F_e * N) by half its boundary bin, and DropTop's top tail
    floor(F_top * N) by half of its own."""
    import torch
    from repro_torch.core.selection import select_hidden
    from repro_torch.kernels import threshold_select as ts
    inner = strategy._inner
    begin = inner.begin_epoch

    def checked(epoch):
        st = inner.state
        valid = (st.seen >= 0) & torch.isfinite(st.loss)
        f_e, c = float(inner._fraction_schedule(epoch)), inner.config
        _, _, hist, _, walk = ts.histogram_select_plain(
            st.loss, st.seen >= 0, f_e, c.drop_top_fraction)
        num_hide, b, _, num_top, b_top, _ = walk.tolist()
        top = c.drop_top_fraction > 0.0
        slack = int(hist[b]) // 2 + (int(hist[b_top]) // 2 if top else 0)
        # What the low tail alone would hide, by histogram and by sort.
        low_only = {m: int(select_hidden(st, f_e, method=m, tau=c.tau).sum())
                    for m in ("histogram", "sort")}
        plan = begin(epoch)
        nh = len(plan.hidden_indices)
        require(nh <= num_hide + num_top + slack,
                f"epoch {epoch}: hidden {nh} > floor(F_e*N)={num_hide} + "
                f"floor(F_top*N)={num_top} + {slack}")
        checks.append({"epoch": epoch, "hidden": nh, "floor_FeN": num_hide,
                       "floor_FtopN": num_top, "slack": slack,
                       "lowest_bin": int(hist[0]), "seen": int(valid.sum()),
                       "low_tail_only_hidden": low_only})
        return plan

    inner.begin_epoch = checked


def main_trainer(dev, strategy: str, n: int, n_test: int, epochs: int, model,
                 lr: float = 0.05, tau: float = 0.7, ds=None, **tc_kw):
    """The main path's ``Trainer`` (``examples/torch_quickstart.py --full``):
    SGD 0.9, cosine LR, KAKURENBO on ``"histogram_pallas"`` with DropTop
    0.02, fused scoring, the default engine unless ``tc_kw`` says; ``ds``
    replaces ``SyntheticClassification(n)`` (a poisoned copy)."""
    from repro_torch.core import KakurenboConfig, LRSchedule
    from repro_torch.data import SyntheticClassification
    from repro_torch.train import Trainer, TrainConfig
    ds = ds or SyntheticClassification(num_samples=n, seed=0)
    test = ds.test_split(n_test) if n_test else None
    # DropTop 0.02 (paper App. D; the data's 2% label-noise tail): without it
    # the histogram plan hides nothing here — after one epoch most lagging
    # losses share the lowest of the 512 bins, and the boundary-bin rule
    # leaves that bin out (see the lowest_bin counts of the train summary).
    tc = TrainConfig(epochs=epochs, batch_size=128, strategy=strategy,
                     fused_scoring=True,
                     lr=LRSchedule(lr, "cosine", epochs, 1),
                     kakurenbo=KakurenboConfig(max_fraction=0.3, tau=tau,
                                               selection="histogram_pallas",
                                               drop_top_fraction=0.02),
                     **tc_kw)
    return Trainer(tc, model, None, ds, test, logits_fn=_logits_fn, device=dev)


def train(dev, strategy: str, n: int, n_test: int, epochs: int, model,
          perms=None, checks=None, lr: float = 0.05, tau: float = 0.7):
    tr = main_trainer(dev, strategy, n, n_test, epochs, model, lr, tau)
    if perms is not None:
        it = iter(perms)
        tr.strategy._inner.draw_permutation = lambda: next(it)
    if checks is not None:
        watch_fraction_bound(tr.strategy, checks)
    return tr.run()


def phase_train(dev, n: int = 50_000, n_test: int = 10_000, epochs: int = 3):
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.kernels import backend
    from repro_torch.models.cnn import CNN
    backend.reset_launches()
    t0 = time.perf_counter()
    hist, checks = {}, []
    for strategy in ("baseline", "kakurenbo"):
        model = CNN(CONFIG, torch.Generator().manual_seed(0))
        hist[strategy] = train(dev, strategy, n, n_test, epochs, model,
                               checks=checks if strategy == "kakurenbo" else None)
        for h in hist[strategy]:
            emit({"phase": "train", "strategy": strategy, "epoch": h.epoch,
                  "train_loss": h.train_loss, "test_acc": h.test_acc,
                  "F_star": h.hidden_fraction, "fwd_samples": h.fwd_samples,
                  "bwd_samples": h.bwd_samples, "lr": h.lr,
                  "wall_s": h.wall_time})
    launches = dict(backend.LAUNCHES)
    for s, hs in hist.items():
        require(all(math.isfinite(h.train_loss) for h in hs), f"{s}: non-finite loss")
    require(any(h.hidden_fraction > 0 for h in hist["kakurenbo"]),
            "kakurenbo hid nothing in any epoch")
    bwd = {s: sum(h.bwd_samples for h in hs) for s, hs in hist.items()}
    require(bwd["kakurenbo"] < bwd["baseline"],
            f"kakurenbo backward samples {bwd['kakurenbo']} not below baseline")
    for name in ("loss_confidence", "loss_confidence_bwd", "histogram_select"):
        require(launches.get(name, 0) > 0, f"kernel {name} never launched")
    # Every train step's backward ran B1's backward: under graph replay the
    # engine adds each graph's launches a replay (ScanEpochEngine).
    steps = sum(h.bwd_samples for hs in hist.values() for h in hs) // 128
    require(launches["loss_confidence_bwd"] >= steps,
            f"B1 bwd counted {launches['loss_confidence_bwd']} launches for "
            f"{steps} train steps")
    emit({"phase": "train_summary", "train_steps": steps, "model": CONFIG.name, "n": n,
          "n_test": n_test, "epochs": epochs, "bwd_samples": bwd,
          "final_test_acc": {s: hs[-1].test_acc for s, hs in hist.items()},
          "fraction_checks": checks, "launches": launches,
          "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# One train step, and where an epoch's time goes
# ---------------------------------------------------------------------------

#: The reference's wide-head fused-scoring model and batch
#: (benchmarks/step_throughput.py::fused_scoring_main): 8,192 classes on a
#: small conv front end, batch 1024 of 4 x 1024 samples.
WIDE_HEAD = {"model": dict(name="wide_head_cnn", image_size=8, widths=(8,),
                           hidden=32, num_classes=8192),
             "batch": 1024, "n": 4 * 1024}


def step_trainer(dev, model_cfg, n: int, batch: int, fused: bool):
    """A KAKURENBO ``Trainer`` as the train phase builds it (histogram-select
    plan, DropTop 0.02), scoring with the fused pass (B1) or, unfused, with
    ``cnn.per_sample_metrics`` as the ``loss_fn``."""
    import torch
    from repro_torch.core import KakurenboConfig, LRSchedule
    from repro_torch.data import SyntheticClassification
    from repro_torch.experiments.table2 import _loss_fn
    from repro_torch.models.cnn import CNN
    from repro_torch.train import Trainer, TrainConfig
    ds = SyntheticClassification(num_samples=n, image_size=model_cfg.image_size,
                                 num_classes=model_cfg.num_classes, seed=0)
    tc = TrainConfig(epochs=3, batch_size=batch, strategy="kakurenbo",
                     fused_scoring=fused, lr=LRSchedule(0.05, "cosine", 3, 1),
                     kakurenbo=KakurenboConfig(max_fraction=0.3, tau=0.7,
                                               selection="histogram_pallas",
                                               drop_top_fraction=0.02))
    model = CNN(model_cfg, torch.Generator().manual_seed(0))
    return Trainer(tc, model, None if fused else _loss_fn, ds, None,
                   logits_fn=_logits_fn, device=dev), ds


#: How a ``train_step`` scores its batch: B1's two kernels; B1's forward
#: with the backward as PyTorch ops (``parent_scoring``); or
#: ``cnn.per_sample_metrics`` as the ``loss_fn`` (no B1).
STEP_SCORING = ("fused", "parent_scoring", "per_sample_metrics")


def time_train_step(dev, model_cfg, n: int, batch: int, rounds: int = 5,
                    steps: int = 10, warmup: int = 5) -> dict:
    """``Trainer.train_step`` under each of ``STEP_SCORING``, on batches
    built once (``ds.get`` and ``Trainer.to_device``, outside the timed
    loop): ``warmup`` steps each, then ``rounds`` turns in rotation of
    ``steps`` synchronised steps each (the host's pace drifts: rotation
    shares it out); the median step, launches a step, and one step under
    the profiler."""
    import numpy as np
    from repro_torch.kernels import backend
    from repro_torch.kernels import ops
    parent = parent_scoring()
    runs = {}
    for scoring in STEP_SCORING:
        tr, ds = step_trainer(dev, model_cfg, n, batch,
                              scoring != "per_sample_metrics")
        batches = [(idx, tr.to_device(ds.get(idx))) for idx in
                   (np.arange(k * batch, (k + 1) * batch) % n for k in range(4))]
        runs[scoring] = {"tr": tr, "batches": batches, "turn": itertools.count(),
                         "state": tr.strategy.get_device_state(), "times": [],
                         "launches": collections.Counter()}

    for run in runs.values():
        run["tr"].lr_dev.fill_(0.05)

    def step(run):
        tr = run["tr"]
        idx, b = run["batches"][next(run["turn"]) % len(run["batches"])]
        run["state"], _, _, _ = tr.train_step(run["state"], b, idx, tr.epoch_dev,
                                           tr.lr_dev)

    def scored(scoring):
        if scoring == "parent_scoring":
            return patched_attr(ops, "_FusedLossMetrics", parent)
        return contextlib.nullcontext()

    for scoring, run in runs.items():
        with scored(scoring):
            for _ in range(warmup):
                step(run)
    for _ in range(rounds):
        for scoring, run in runs.items():
            with scored(scoring):
                sync(dev)
                backend.reset_launches()
                for _ in range(steps):
                    sync(dev)
                    t0 = time.perf_counter()
                    step(run)
                    sync(dev)
                    run["times"].append((time.perf_counter() - t0) * 1e3)
                run["launches"].update(backend.LAUNCHES)
    out = {}
    for scoring, run in runs.items():
        with scored(scoring):
            prof = device_breakdown(dev, lambda: step(run), top=100)
        g = prof["groups_ms"]
        g["conv or GEMM"] = g.get("GEMM (cuBLAS)", 0.0) + g.get("conv (cuDNN)", 0.0)
        times = sorted(run["times"])
        out[scoring] = {"step_ms": times[len(times) // 2], "min_ms": times[0],
                        "steps": len(times),
                        "launches_per_step": {k: c / len(times) for k, c
                                              in run["launches"].items()},
                        "breakdown": prof}
    return out


def phase_train_step(dev) -> dict:
    """One train step of the paper CNN (batch 128) and of the wide-head
    model (batch 1024), each scored three ways; B1's forward and backward
    must be one device activity each in a fused step, and absent from an
    unfused one."""
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models.cnn import CNNConfig
    out = {}
    for name, cfg, n, batch in (
            ("paper_cnn", CONFIG, 50_000, 128),
            ("wide_head", CNNConfig(**WIDE_HEAD["model"]), WIDE_HEAD["n"],
             WIDE_HEAD["batch"])):
        rows = time_train_step(dev, cfg, n, batch)
        emit({"phase": "train_step", "config": name,
              "model": dataclasses.asdict(cfg), "batch": batch, **rows})
        calls = {s: r["breakdown"]["groups_calls"] for s, r in rows.items()}
        require(calls["fused"].get("B1 fwd") == 1 and calls["fused"].get("B1 bwd") == 1,
                f"{name}: a fused step ran B1 as {calls['fused']}")
        require(calls["parent_scoring"].get("B1 bwd", 0) == 0
                and "B1 fwd" not in calls["per_sample_metrics"]
                and "B1 bwd" not in calls["per_sample_metrics"],
                f"{name}: B1 ran where it should not: {calls}")
        out[name] = rows
    row = replay_profile(dev)
    emit({"phase": "train_step", "config": "paper_cnn_replay", **row})
    out["paper_cnn_replay"] = row
    return out


def replay_profile(dev, n: int = 50_000, reps: int = 20) -> dict:
    """One replay of the scanned engine's ``scan_steps``-step graph (the
    main path's KAKURENBO trainer after one epoch, which captured it):
    synchronised wall ms of ``reps`` replays (median) and one replay under
    the profiler: device activities by group and busy vs wall ms."""
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models.cnn import CNN
    tr = main_trainer(dev, "kakurenbo", n, 0, 1,
                      CNN(CONFIG, torch.Generator().manual_seed(0)))
    tr.run(1)
    eng = tr.engine
    graph = eng._graphs[eng.scan_steps, False].graph
    times = []
    for _ in range(reps):
        sync(dev)
        t0 = time.perf_counter()
        graph.replay()
        sync(dev)
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    prof = device_breakdown(dev, graph.replay, top=100)
    row = {"engine": eng.name, "steps_per_replay": eng.scan_steps,
           "replay_ms": times[len(times) // 2], "replay_min_ms": times[0],
           "step_ms": times[len(times) // 2] / eng.scan_steps,
           "breakdown": prof}
    if prof["device_kernels"] == 0:
        row["note"] = "torch.profiler shows no device activity inside a replay"
    else:
        row["activities_per_step"] = prof["device_kernels"] / eng.scan_steps
        row["device_busy_share"] = (prof["device_busy_ms"]
                                    / prof["profiled_wall_ms"])
    return row


class HostSplit:
    """Exclusive seconds spent inside each wrapped callable, synchronising
    the device before and after each call so that its device work lands in
    its own bucket; nested calls count only in the innermost."""

    def __init__(self, dev):
        self.dev = dev
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self._stack = []        # seconds of the inner calls of each open call

    def wrap(self, name: str, fn):
        def timed(*args, **kw):
            sync(self.dev)
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kw)
            finally:
                sync(self.dev)
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.seconds[name] += dt - inner
                self.calls[name] += 1
                if self._stack:
                    self._stack[-1] += dt
        return timed


def epoch_split(dev, engine: str, n: int = 50_000,
                n_test: int = 10_000) -> dict:
    """The paper CNN's KAKURENBO epoch (the main path's trainer) under
    ``engine``: epochs 0 and 1 as they run, then epoch 2 with its parts
    wrapped by ``HostSplit`` (here, never in the package).  The host loop:
    the dataset's ``get``, ``Trainer.to_device``, ``train_step``, the plan,
    the refresh and ``evaluate`` (its ``get`` inside it).  The scanned
    engine: the one-time ``materialize`` (``Trainer.device_data``, at epoch
    0) and captures (epoch 0, ``first_epoch_s``), then the plan, the
    plan's copy to the device, the replays (a sync after each), the
    epoch-end fetch, the refresh and ``evaluate``."""
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models.cnn import CNN
    tr = main_trainer(dev, "kakurenbo", n, n_test, 3,
                      CNN(CONFIG, torch.Generator().manual_seed(0)),
                      engine=engine)
    split, first = HostSplit(dev), {}
    if engine == "scan":
        eng = tr.engine
        tr.device_data = split.wrap("materialize", tr.device_data)
        eng._capture = split.wrap("capture", eng._capture)
        walls = [tr.run_epoch(0).wall_time]
        first = dict(split.seconds)
        split.seconds.clear()
        walls.append(tr.run_epoch(1).wall_time)
        eng._dispatch = split.wrap("replays", eng._dispatch)
        eng._fetch = split.wrap("fetch", eng._fetch)
        eng._place = split.wrap("plan_to_device", eng._place)
    else:
        walls = [tr.run_epoch(e).wall_time for e in range(2)]
        tr.pipeline.get_fn = split.wrap("get", tr.pipeline.get_fn)
        tr.to_device = split.wrap("to_device", tr.to_device)
        tr.train_step = split.wrap("train_step", tr.train_step)
    tr.strategy.plan = split.wrap("plan", tr.strategy.plan)
    tr.strategy.on_epoch_end = split.wrap("refresh", tr.strategy.on_epoch_end)
    tr.evaluate = split.wrap("evaluate", tr.evaluate)
    st = tr.run_epoch(2)
    sec = dict(split.seconds)
    sec["other"] = st.wall_time - sum(sec.values())
    return {"phase": "epoch_split", "engine": tr.engine.name,
            "model": CONFIG.name, "n": n, "n_test": n_test,
            "strategy": "kakurenbo", "fused_scoring": True,
            "epoch_wall_s": walls, "first_epoch_s": first, "split_epoch": 2,
            "split_epoch_wall_s": st.wall_time, "hidden_fraction": st.hidden_fraction,
            "train_steps": st.bwd_samples // 128,
            "seconds": sec, "calls": dict(split.calls)}


def watch_table2(tr, log: dict) -> None:
    """Record each plan (restart flag, visible count, batches holding a
    repeated index) and every restore of the initial weights."""
    import numpy as np
    from repro_torch.data.pipeline import epoch_index_plan
    plan, load = tr.strategy.plan, tr.model.load_state_dict
    log.update(plans=[], reinits=0)

    def planned(epoch):
        p = plan(epoch)
        rows = epoch_index_plan(p.visible_indices, tr.cfg.batch_size)
        log["plans"].append({
            "epoch": epoch, "visible": len(p.visible_indices),
            "hidden": len(p.hidden_indices), "reinit_model": p.reinit_model,
            "batches_with_repeats": int(sum(len(np.unique(r)) < len(r)
                                            for r in rows))})
        return p

    def reloaded(*a, **kw):
        log["reinits"] += 1
        return load(*a, **kw)

    tr.strategy.plan = planned
    tr.model.load_state_dict = reloaded


def phase_table2(dev, n: int = 50_000, n_test: int = 10_000, epochs: int = 3):
    """``experiments/table2`` at full width: every strategy, KAKURENBO under
    ``"sort"`` with DropTop 0.02 (the rank-select kernel, B4 and B5)."""
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.experiments import table2
    from repro_torch.kernels import backend
    kcfg = dataclasses.replace(table2.kakurenbo_config(epochs),
                               drop_top_fraction=0.02)
    backend.reset_launches()
    t0 = time.perf_counter()
    hist, logs = {}, {}
    for strategy in table2.STRATEGIES:
        tr = table2.make_trainer(strategy, model_cfg=CONFIG, n=n, n_test=n_test,
                                 epochs=epochs, kakurenbo=kcfg, device=dev)
        logs[strategy] = {}
        watch_table2(tr, logs[strategy])
        hist[strategy] = tr.run()
        for h in hist[strategy]:
            emit({"phase": "table2", "strategy": strategy, "epoch": h.epoch,
                  "train_loss": h.train_loss, "test_acc": h.test_acc,
                  "hidden_fraction": h.hidden_fraction,
                  "fwd_samples": h.fwd_samples, "bwd_samples": h.bwd_samples,
                  "lr": h.lr, "wall_s": h.wall_time})
    launches = dict(backend.LAUNCHES)
    for s, hs in hist.items():
        require(all(math.isfinite(h.train_loss) for h in hs), f"{s}: non-finite loss")
    warmup = max(epochs // 4, 2)
    fp = logs["forget"]["plans"]
    require([p["reinit_model"] for p in fp] == [e == warmup for e in range(epochs)],
            f"FORGET restart flags {[p['reinit_model'] for p in fp]}")
    require(fp[warmup]["visible"] == n - math.floor(0.3 * n),
            f"FORGET kept {fp[warmup]['visible']} of {n} after its prune")
    require(logs["forget"]["reinits"] == 1, "FORGET did not restore its initial weights")
    require(sum(p["batches_with_repeats"] for p in logs["iswr"]["plans"]) > 0,
            "ISWR drew no repeated index into a batch")
    fwd = {s: sum(h.fwd_samples for h in hs) for s, hs in hist.items()}
    bwd = {s: sum(h.bwd_samples for h in hs) for s, hs in hist.items()}
    require(bwd["sb"] < fwd["sb"], "SB skipped no backward samples")
    require(any(h.hidden_fraction > 0 for h in hist["kakurenbo"]),
            "kakurenbo hid nothing under sort")
    require(launches.get("rank_select", 0) > 0, "kernel rank_select never launched")
    # Table 2 scores with cnn.per_sample_metrics (argmax), as the reference
    # harness does: the fused pass (B1) is the train phase's.
    require(launches.get("loss_confidence", 0) == 0
            and launches.get("loss_confidence_bwd", 0) == 0,
            "Table 2 went through the fused scoring pass (B1)")
    emit({"phase": "table2_summary", "model": CONFIG.name, "n": n,
          "n_test": n_test, "epochs": epochs, "kakurenbo": dataclasses.asdict(kcfg),
          "fwd_samples": fwd, "bwd_samples": bwd,
          "best_test_acc": {s: max(h.test_acc for h in hs) for s, hs in hist.items()},
          "plans": {s: lg["plans"] for s, lg in logs.items()},
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


def phase_card_vs_cpu(dev, n: int = 2048, epochs: int = 2) -> None:
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models.cnn import CNN
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(3)
    perms = [torch.randperm(n, generator=g) for _ in range(epochs)]
    model = CNN(CONFIG, torch.Generator().manual_seed(0))
    # A control: the CPU run again from weights changed by 1e-7 relative.
    # How far that moves the losses says how well conditioned the run is.
    # At the train phase's LR 0.05 it moves epoch 1 by percents (the
    # training is chaotic), so no 1e-4 comparison could hold there; LR
    # 0.005 keeps it well conditioned.  tau 0.1 lets the low tail hide
    # samples here (the phase prints F*).
    perturbed = copy.deepcopy(model)
    with torch.no_grad():
        for p in perturbed.parameters():
            p.mul_(1 + 1e-7)
    cpu = torch.device("cpu")
    runs = {}
    for name, d, m in ((dev.type, dev, model), ("cpu", cpu, model),
                       ("cpu_perturbed", cpu, perturbed)):
        runs[name] = train(d, "kakurenbo", n, 0, epochs, copy.deepcopy(m),
                           perms=[p.to(d) for p in perms], lr=0.005, tau=0.1)

    def max_rel(a, b):
        return max(abs(x.train_loss - y.train_loss) / abs(y.train_loss)
                   for x, y in zip(runs[a], runs[b]))

    rel = max_rel(dev.type, "cpu")
    emit({"phase": "card_vs_cpu", "n": n, "epochs": epochs, "lr": 0.005,
          "tau": 0.1,
          "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "loss": {k: [h.train_loss for h in v] for k, v in runs.items()},
          "F_star": {k: [h.hidden_fraction for h in v] for k, v in runs.items()},
          "max_rel_diff": rel,
          "perturbed_max_rel_diff": max_rel("cpu_perturbed", "cpu")})
    require(rel <= 1e-4, f"card vs CPU losses differ by {rel} relative")


# ---------------------------------------------------------------------------
# Engines and restart: the scanned engine's contract on the card
# ---------------------------------------------------------------------------


def train_state(tr) -> dict:
    """Copies of every tensor of the train state, by name: parameters,
    momentum, the strategy's checkpoint arrays (its device state and its
    generators' states)."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    out = {}
    for path, v in ckpt.flatten(tr._ckpt_tree()):
        out[path] = (v.detach().clone() if isinstance(v, torch.Tensor)
                     else torch.from_numpy(v.copy()))
    return out


def state_diff(a: dict, b: dict) -> list:
    """Names whose tensors differ in any bit (or are missing on one side)."""
    import torch
    return sorted(k for k in a.keys() | b.keys()
                  if k not in a or k not in b or not torch.equal(a[k], b[k]))


def capture_keeps_state(tr, label: str) -> dict:
    """The scanned engine's first capture of an unweighted and then of a
    weighted block (each with its eager warm-up blocks on the capture
    stream and the train state restored after them) on a fresh trainer:
    every tensor of the train state must be as it was, bit for bit."""
    eng = tr.engine
    require(eng.name == "scan", f"{label}: engine {eng.name}")
    eng._setup()
    before = train_state(tr)
    if tr.device.type == "cuda":
        for weighted in (False, True):
            eng._capture(eng.scan_steps, weighted)
    else:
        eng.warmup()                      # a rehearsal: blocks, restored
    sync(tr.device)
    diff = state_diff(before, train_state(tr))
    row = {"phase": "capture_keeps_state", "model": label,
           "captured": [list(k) for k in eng._graphs],
           "state_tensors": len(before), "state_differs": diff}
    emit(row)
    require(not diff, f"{label}: a capture changed the train state: {diff}")
    return row


def recorded_run(tr, epochs=None, fail_at_epoch=None):
    """``tr.run`` with every plan recorded as (visible, hidden, moved back,
    restart flag)."""
    plans, plan = [], tr.strategy.plan

    def planned(epoch):
        p = plan(epoch)
        plans.append((p.visible_indices, p.hidden_indices, p.moveback_indices,
                      p.reinit_model))
        return p

    tr.strategy.plan = planned
    return tr.run(epochs, fail_at_epoch), plans


def same_plans(a: list, b: list) -> bool:
    import numpy as np
    return len(a) == len(b) and all(
        all(np.array_equal(x, y) for x, y in zip(pa[:3], pb[:3]))
        and pa[3] == pb[3] for pa, pb in zip(a, b))


def phase_engines(dev, n: int = 50_000, epochs: int = 3) -> dict:
    """The host loop against the scanned engine (CUDA graphs) from the same
    initial weights: the main path's KAKURENBO trainer for ``epochs``
    epochs, then each Table 2 strategy for one epoch.  Losses, plans and
    the whole train state must be bit-identical under the trainer's own
    defaults (it runs its epochs with ``cudnn.deterministic``: cuDNN may
    pick atomics-based convolution gradients otherwise); whether two host
    loops are bit-identical without it (``trainer.CUDNN_DETERMINISTIC``
    off, the global flags left off) is reported, not required."""
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.experiments import table2
    from repro_torch.models.cnn import CNN
    from repro_torch.train import trainer as trainer_mod
    t0 = time.perf_counter()

    def model():
        return CNN(CONFIG, torch.Generator().manual_seed(0))

    def kakurenbo(engine, ep, **kw):
        tr = main_trainer(dev, "kakurenbo", n, 0, epochs, model(),
                          engine=engine, **kw)
        hist, plans = recorded_run(tr, ep)
        return [h.train_loss for h in hist], plans, train_state(tr), hist

    require(not torch.backends.cudnn.deterministic,
            "the caller's cudnn.deterministic is on")
    trainer_mod.CUDNN_DETERMINISTIC = False
    try:
        loose = [kakurenbo("host", 1) for _ in range(2)]
    finally:
        trainer_mod.CUDNN_DETERMINISTIC = True
    loose_same = (loose[0][0] == loose[1][0]
                  and not state_diff(loose[0][2], loose[1][2]))
    runs = {e: kakurenbo(e, epochs) for e in ("host", "scan")}
    require(not torch.backends.cudnn.deterministic,
            "the trainer left cudnn.deterministic on")
    (lh, ph, sh, hh), (ls, ps, ss, hs) = runs["host"], runs["scan"]
    diff = state_diff(sh, ss)
    row = {"phase": "engines", "model": CONFIG.name, "n": n, "epochs": epochs,
           "strategy": "kakurenbo",
           "cudnn.deterministic": "the trainer's (its default)",
           "loss": {"host": lh, "scan": ls},
           "wall_s": {"host": [h.wall_time for h in hh],
                      "scan": [h.wall_time for h in hs]},
           "hidden": [len(p[1]) for p in ps],
           "losses_equal": lh == ls, "plans_equal": same_plans(ph, ps),
           "state_tensors": len(ss), "state_differs": diff,
           "host_vs_host_without_deterministic_bit_identical": loose_same,
           "host_vs_host_without_deterministic_loss": [r[0] for r in loose]}
    require(lh == ls, f"engines: losses differ {lh} vs {ls}")
    require(same_plans(ph, ps), "engines: plans differ")
    require(not diff, f"engines: train state differs in {diff}")
    require(any(len(p[1]) for p in ps), "engines: kakurenbo hid nothing")
    row["capture_keeps_state"] = capture_keeps_state(
        main_trainer(dev, "kakurenbo", n, 0, epochs, model(), engine="scan"),
        CONFIG.name)["state_differs"]
    kcfg = dataclasses.replace(table2.kakurenbo_config(1),
                               drop_top_fraction=0.02)
    row["table2"] = {}
    for strategy in table2.STRATEGIES:
        got = {}
        for engine in ("host", "scan"):
            tr = table2.make_trainer(strategy, model_cfg=CONFIG, n=n,
                                     n_test=128, epochs=1, kakurenbo=kcfg,
                                     engine=engine, device=dev)
            hist, plans = recorded_run(tr)
            got[engine] = (hist[0].train_loss, hist[0].bwd_samples, plans,
                           train_state(tr), tr.engine.name)
        (lh, bh, ph, sh, eh), (ls, bs, ps, ss, es) = got["host"], got["scan"]
        diff = state_diff(sh, ss)
        row["table2"][strategy] = {"loss": [lh, ls], "bwd_samples": [bh, bs],
                                   "engines": [eh, es], "state_differs": diff}
        require((eh, es) == ("host", "scan"), f"{strategy}: engines {eh}, {es}")
        require(lh == ls and bh == bs and same_plans(ph, ps) and not diff,
                f"engines: {strategy} host vs scan differ: loss {lh} vs {ls}, "
                f"bwd {bh} vs {bs}, state {diff}")
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    return row


def phase_restart(dev, n: int = 50_000, epochs: int = 3) -> dict:
    """Restart under the scanned engine (CUDA graphs), KAKURENBO and SB on
    the main path's trainer: a crash before epoch 2 (an epoch boundary)
    and one between two blocks of epoch 2, each restored from the epoch-2
    checkpoint into a trainer built from other weights and seeds, must end
    bit-identical to the uninterrupted run."""
    import shutil
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models.cnn import CNN
    t0 = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)

    def trainer(strategy, seed, ckpt_dir=None):
        return main_trainer(dev, strategy, n, 0, epochs,
                            CNN(CONFIG, torch.Generator().manual_seed(seed)),
                            seed=seed, engine="scan",
                            checkpoint_dir=str(ckpt_dir) if ckpt_dir else None,
                            checkpoint_every=1 if ckpt_dir else 0)

    rows = restart_runs(trainer, root)
    row = {"phase": "restart", "model": CONFIG.name, "n": n, "epochs": epochs,
           "engine": "scan",
           "cudnn.deterministic": "the trainer's (its default)",
           "runs": rows,
           "seconds": time.perf_counter() - t0}
    emit(row)
    return row


def restart_runs(trainer, root) -> dict:
    """For KAKURENBO and SB: the uninterrupted run, then the two crashes
    and their restores; the rows of ``phase_restart``."""
    import shutil
    rows = {}
    try:
        for strategy in ("kakurenbo", "sb"):
            ref = trainer(strategy, 0)
            ref.run()
            want, last = train_state(ref), ref.history[-1].train_loss
            out = {}
            # An epoch boundary: the run dies before epoch 2.
            d = root / strategy / "boundary"
            try:
                trainer(strategy, 0, d).run(fail_at_epoch=2)
            except RuntimeError as e:
                require("injected" in str(e), f"restart: {e}")
            tr = trainer(strategy, 7, d)
            require(tr.restore_latest() and tr.epoch == 2,
                    f"{strategy}: boundary restore")
            tr.run()
            out["boundary"] = {"state_differs": state_diff(train_state(tr), want),
                               "last_loss": [tr.history[-1].train_loss, last]}
            # Between blocks: epoch 2 dies after its first replay.
            d = root / strategy / "between_blocks"
            tr = trainer(strategy, 0, d)
            tr.run(2)
            dispatch, calls = tr.engine._dispatch, [0]

            def bomb(size, weighted):
                if calls[0] == 1:
                    raise RuntimeError("injected failure between blocks")
                calls[0] += 1
                dispatch(size, weighted)

            tr.engine._dispatch = bomb
            try:
                tr.run_epoch(2)
            except RuntimeError as e:
                require("between blocks" in str(e), f"restart: {e}")
            live = train_state(tr)      # checkpoint on fault: state readable
            tr2 = trainer(strategy, 7, d)
            require(tr2.restore_latest() and tr2.epoch == 2,
                    f"{strategy}: between-blocks restore")
            tr2.run()
            out["between_blocks"] = {
                "replays_before_crash": calls[0],
                "fault_state_tensors": len(live),
                "state_differs": state_diff(train_state(tr2), want),
                "last_loss": [tr2.history[-1].train_loss, last]}
            for case, r in out.items():
                require(not r["state_differs"] and r["last_loss"][0] == last,
                        f"restart {strategy}/{case}: {r}")
            rows[strategy] = out
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return rows


# ---------------------------------------------------------------------------
# The resilient runtime: guard, host-observe path, supervisor, optimizers
# ---------------------------------------------------------------------------

#: The poisoned samples of the resilience phase (NaN features).
POISON_IDS = (7, 4_242, 31_337, 49_999)
#: The reference's budget for the guard's cost on the scanned engine
#: (benchmarks/step_throughput.py::guard_main).
GUARD_BUDGET = 0.03


def poisoned_batches(plans, ids, batch: int = 128) -> list:
    """Train steps of each recorded plan whose batch holds one of ``ids``."""
    import numpy as np
    from repro_torch.data.pipeline import epoch_index_plan
    return [int(sum(np.isin(row, ids).any()
                    for row in epoch_index_plan(p[0], batch))) for p in plans]


def replay_times(dev, trainers: dict, rounds: int = 4, reps: int = 20) -> dict:
    """The ``scan_steps``-step graph of each trainer replayed in turns
    (a, b, b, a per round), ``reps`` synchronised replays a turn; median ms
    per trainer, and one replay of each under the profiler."""
    graphs = {k: tr.engine._graphs[tr.engine.scan_steps, False].graph
              for k, tr in trainers.items()}
    times = {k: [] for k in graphs}
    order = list(graphs)
    for r in range(rounds):
        for k in order + order[::-1]:
            for _ in range(reps):
                sync(dev)
                t0 = time.perf_counter()
                graphs[k].replay()
                sync(dev)
                times[k].append((time.perf_counter() - t0) * 1e3)
    out = {}
    for k, ts in times.items():
        ts.sort()
        prof = device_breakdown(dev, graphs[k].replay, top=8)
        out[k] = {"replay_ms": ts[len(ts) // 2], "replay_min_ms": ts[0],
                  "replays": len(ts),
                  "device_kernels": prof["device_kernels"],
                  "device_busy_ms": prof["device_busy_ms"],
                  "profiled_wall_ms": prof["profiled_wall_ms"]}
    return out


def supervised_crash(trainer, epochs: int, root, split_dev=None) -> dict:
    """The uninterrupted run of ``trainer(ckpt_dir)``, then a run that a
    ``CrashAtStep`` kills in the middle of epoch 1 (by the uninterrupted
    run's step counts), recovered by ``run_with_restarts`` from its last
    checkpoint: the recovered state must equal the uninterrupted one bit
    for bit.  Times the recovery: the new trainer's build and restore, its
    first epoch (with the materialize and the captures it pays, split when
    ``split_dev`` is given) and the whole."""
    import shutil
    from repro_torch.data.pipeline import epoch_index_plan
    from repro_torch.train import chaos, fault
    ref = trainer(None)
    _, plans = recorded_run(ref)
    steps = [len(epoch_index_plan(p[0], ref.cfg.batch_size)) for p in plans]
    crash_step = steps[0] + steps[1] // 2
    want, last = train_state(ref), ref.history[-1].train_loss
    del ref
    shutil.rmtree(root, ignore_errors=True)
    builds, t = [], {}
    split = HostSplit(split_dev) if split_dev is not None else None
    bomb = chaos.CrashAtStep(crash_step)

    def make():
        t0 = time.perf_counter()
        tr = trainer(root)
        builds.append(tr)
        if len(builds) == 1:
            bomb.install(tr)
        else:
            t["build_s"] = time.perf_counter() - t0
            restore = tr.restore_latest

            def timed_restore():
                t1 = time.perf_counter()
                ok = restore()
                t["restore_s"] = time.perf_counter() - t1
                return ok
            tr.restore_latest = timed_restore
            if split is not None and tr.engine.name == "scan":
                tr.device_data = split.wrap("materialize", tr.device_data)
                tr.engine._capture = split.wrap("capture", tr.engine._capture)
        return tr

    def on_restart(n, exc):
        t["restart_at"] = time.perf_counter()
        t["error"] = f"{type(exc).__name__}: {exc}"

    try:
        tr, restarts = fault.run_with_restarts(
            make, epochs, sleep_fn=lambda s: None, on_restart=on_restart)
        recover_s = time.perf_counter() - t.pop("restart_at")
        crashed = builds[0]
        diff = state_diff(train_state(tr), want)
        row = {"restarts": restarts, "steps_per_epoch": steps,
               "crash_step": crash_step,
               "steps_done_at_crash": bomb.steps_done,
               "crashed_in_epoch": crashed.epoch, "engine": tr.engine.name,
               "recover_s": recover_s, "first_epoch_s": tr.history[0].wall_time,
               "epochs_rerun": len(tr.history), "state_differs": diff,
               "last_loss": [tr.history[-1].train_loss, last], **t}
        if split is not None:
            row["first_epoch_split_s"] = dict(split.seconds)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(restarts == 1 and bomb.fired and not diff
            and row["last_loss"][0] == last,
            f"supervised restart not bit-identical: {row}")
    return row


def phase_resilience(dev, n: int = 50_000, epochs: int = 3) -> dict:
    """The resilient runtime on the main path (paper CNN, full width,
    ``SyntheticClassification(50_000)``, KAKURENBO ``"histogram_pallas"`` +
    DropTop 0.02, fused scoring), under the trainer's defaults (no cuDNN
    flag set here):

    - the guard (``skip_update``) on a clean run, scanned and host loop:
      losses, plans and the whole train state bit-identical to the
      unguarded run, one host sync an epoch scanned; the 8-step graph's
      replay time guarded against unguarded, in turns, beside the
      reference's 3% budget;
    - a poisoned run (NaN features for ``POISON_IDS``): parameters finite,
      ``nonfinite_steps`` = the batches holding a poisoned id, each
      poisoned sample kept at the never-seen sentinel and never hidden, the
      next plan finite; the guard-off control goes non-finite;
    - every sample poisoned with ``guard_abort_after=2``: ``NonFiniteError``,
      classified restartable;
    - a ``CrashAtStep`` in the middle of epoch 1 recovered by
      ``run_with_restarts`` bit-identical to the uninterrupted run: the
      seven Table 2 strategies scanned (guard on; FORGET prunes at epoch 2,
      through the rank-select), Grad-Match at N = 1,024, KAKURENBO on the
      host loop;
    - the host-observe path (``fused_observe=False``) bit-identical to the
      fused one, ``host_syncs`` above 1 against 1;
    - AdamW, RMSProp and Adafactor, one epoch scanned and on the host loop,
      bit-identical.
    Returns the kernel launches of the phase."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.core import ForgetConfig
    from repro_torch.data import SyntheticClassification
    from repro_torch.experiments import table2
    from repro_torch.kernels import backend
    from repro_torch.models.cnn import CNN
    from repro_torch.train import chaos, fault, guard
    backend.reset_launches()
    t_phase = time.perf_counter()
    root = ROOT / "build" / "chip_smoke_chaos"
    out = {"phase": "resilience", "model": CONFIG.name, "n": n,
           "epochs": epochs}

    def model(seed=0):
        return CNN(CONFIG, torch.Generator().manual_seed(seed))

    def finite(tr):
        return all(bool(torch.isfinite(p).all()) for p in tr.model.parameters())

    # The guard on a clean run.
    clean, kept = {}, {}
    for engine in ("scan", "host"):
        runs = {}
        for policy in ("off", "skip_update"):
            tr = main_trainer(dev, "kakurenbo", n, 0, epochs, model(),
                              engine=engine, guard_policy=policy)
            hist, plans = recorded_run(tr)
            runs[policy] = (tr, hist, plans, train_state(tr))
        (t_off, h_off, p_off, s_off), (t_on, h_on, p_on, s_on) = (
            runs["off"], runs["skip_update"])
        diff = state_diff(s_off, s_on)
        clean[engine] = {
            "loss": {"off": [h.train_loss for h in h_off],
                     "guarded": [h.train_loss for h in h_on]},
            "wall_s": {"off": [h.wall_time for h in h_off],
                       "guarded": [h.wall_time for h in h_on]},
            "hidden": [len(p[1]) for p in p_on],
            "host_syncs": [h.host_syncs for h in h_on],
            "nonfinite_steps": [h.nonfinite_steps for h in h_on],
            "state_tensors": len(s_on), "state_differs": diff}
        require([h.train_loss for h in h_off] == [h.train_loss for h in h_on]
                and same_plans(p_off, p_on) and not diff,
                f"guarded clean run differs ({engine}): {clean[engine]}")
        require(all(h.nonfinite_steps == h.quarantined_observations == 0
                    for h in h_on), f"guard fired on clean data ({engine})")
        require(any(len(p[1]) for p in p_on), f"kakurenbo hid nothing ({engine})")
        if engine == "scan":
            require(all(h.host_syncs == 1 for h in h_on),
                    f"guarded scan host_syncs {clean[engine]['host_syncs']}")
            g = t_on.engine._graphs[t_on.engine.scan_steps, False].launches
            require(g["loss_confidence"] == g["loss_confidence_bwd"]
                    == t_on.engine.scan_steps,
                    f"a guarded replay's B1 launches {dict(g)}")
            kept = {"off": t_off, "guarded": t_on, "plans": p_off,
                    "state": s_off, "loss": [h.train_loss for h in h_off]}
    out["clean"] = clean
    rt = replay_times(dev, {"off": kept["off"], "guarded": kept["guarded"]})
    rt["overhead"] = rt["guarded"]["replay_ms"] / rt["off"]["replay_ms"] - 1.0
    rt["budget"] = GUARD_BUDGET
    rt["within_budget"] = rt["overhead"] < GUARD_BUDGET
    rt["extra_device_kernels_per_step"] = (
        rt["guarded"]["device_kernels"] - rt["off"]["device_kernels"]
    ) / kept["off"].engine.scan_steps
    out["replay"] = rt
    emit({"phase": "resilience_guard", "clean": clean, "replay": rt})
    del kept["guarded"]

    # The host-observe path against the fused (scanned, unguarded) run.
    tr = main_trainer(dev, "kakurenbo", n, 0, epochs, model(),
                      fused_observe=False)
    hist, plans = recorded_run(tr)
    diff = state_diff(train_state(tr), kept["state"])
    out["host_observe"] = {
        "engine": tr.engine.name, "host_syncs": [h.host_syncs for h in hist],
        "fused_host_syncs": 1, "wall_s": [h.wall_time for h in hist],
        "state_differs": diff,
        "losses_equal": [h.train_loss for h in hist] == kept["loss"]}
    require(tr.engine.name == "host" and not diff
            and out["host_observe"]["losses_equal"]
            and same_plans(plans, kept["plans"])
            and all(h.host_syncs > 1 for h in hist),
            f"host-observe path: {out['host_observe']}")
    kept.clear()
    del tr

    # A poisoned run, guarded, and its control.
    ids = np.asarray(POISON_IDS)
    poisoned = {}
    for policy in ("skip_update", "off"):
        ds = chaos.poison_samples(SyntheticClassification(num_samples=n, seed=0),
                                  POISON_IDS)
        tr = main_trainer(dev, "kakurenbo", n, 0, epochs, model(), ds=ds,
                          guard_policy=policy)
        hist, plans = recorded_run(tr)
        st = tr.strategy.state
        row = {"finite_params": finite(tr)}
        if policy == "skip_update":
            row.update(
                nonfinite_steps=[h.nonfinite_steps for h in hist],
                poisoned_batches=poisoned_batches(plans, ids),
                quarantined=[h.quarantined_observations for h in hist],
                seen=st.seen[ids].tolist(), loss=st.loss[ids].tolist(),
                ever_hidden=bool(any(np.isin(ids, p[1]).any() for p in plans)))
            nxt = tr.strategy.plan(epochs)
            row.update(
                next_plan_f_star=nxt.hidden_fraction,
                next_plan_hides_poisoned=bool(np.isin(ids, nxt.hidden_indices).any()),
                hidden=[len(p[1]) for p in plans])
            require(row["finite_params"]
                    and row["nonfinite_steps"] == row["poisoned_batches"]
                    and all(q >= 1 for q in row["quarantined"])
                    and row["seen"] == [-1] * len(ids)
                    and row["loss"] == [1e9] * len(ids)
                    and not row["ever_hidden"]
                    and math.isfinite(nxt.hidden_fraction)
                    and not row["next_plan_hides_poisoned"],
                    f"poisoned guarded run: {row}")
        else:
            require(not row["finite_params"],
                    "the unguarded poisoned run kept finite parameters")
        poisoned[policy] = row
        del tr
    out["poisoned"] = poisoned

    # The abort: every sample poisoned.
    ds = chaos.poison_samples(SyntheticClassification(num_samples=n, seed=0),
                              range(n))
    tr = main_trainer(dev, "kakurenbo", n, 0, epochs, model(), ds=ds,
                      guard_policy="skip_update", guard_abort_after=2)
    init = [p.detach().clone() for p in tr.model.parameters()]
    err = None
    try:
        tr.run()
    except guard.NonFiniteError as e:
        err = e
    out["abort"] = {"raised": err is not None, "message": str(err),
                    "classified": fault.classify_failure(err) if err else None,
                    "epoch": tr.epoch,
                    "params_held": all(torch.equal(p, q) for p, q in
                                       zip(tr.model.parameters(), init))}
    require(out["abort"]["raised"] and out["abort"]["classified"] == "restartable"
            and out["abort"]["params_held"], f"guard abort: {out['abort']}")
    del tr
    emit({"phase": "resilience_poison", "poisoned": poisoned,
          "abort": out["abort"], "host_observe": out["host_observe"]})

    # Crash and supervised recovery.
    chaos_rows = {}
    for strategy in table2.STRATEGIES:
        def trainer(d, strategy=strategy):
            return main_trainer(
                dev, strategy, n, 0, epochs, model(), engine="scan",
                guard_policy="skip_update",
                forget=ForgetConfig(fraction=0.3, warmup_epochs=2),
                checkpoint_dir=str(d) if d else None,
                checkpoint_every=1 if d else 0)
        chaos_rows[strategy] = supervised_crash(trainer, epochs,
                                                root / strategy, dev)
    gm_n = 1024

    def gm_trainer(d):
        return table2.make_trainer(
            "gradmatch", model_cfg=CONFIG, n=gm_n, n_test=128, epochs=epochs,
            device=dev, guard_policy="skip_update",
            checkpoint_dir=str(d) if d else None,
            checkpoint_every=1 if d else 0)
    chaos_rows["gradmatch_n1024"] = supervised_crash(
        gm_trainer, epochs, root / "gradmatch", dev)

    def host_trainer(d):
        return main_trainer(dev, "kakurenbo", n, 0, epochs, model(),
                            engine="host", guard_policy="skip_update",
                            checkpoint_dir=str(d) if d else None,
                            checkpoint_every=1 if d else 0)
    chaos_rows["kakurenbo_host"] = supervised_crash(
        host_trainer, epochs, root / "host")
    for name, r in chaos_rows.items():
        require(r["crashed_in_epoch"] == 1, f"{name}: crash outside epoch 1: {r}")
    out["crash_recovery"] = chaos_rows
    emit({"phase": "resilience_crash", "rows": chaos_rows})

    # The optimizers: one epoch, scanned against the host loop.
    opt_rows = {}
    for name in ("adamw", "rmsprop", "adafactor"):
        got = {}
        for engine in ("scan", "host"):
            tr = main_trainer(dev, "kakurenbo", n, 0, 1, model(), lr=1e-3,
                              engine=engine, optimizer=name, optimizer_hp={})
            hist = tr.run()
            got[engine] = (hist[0].train_loss, train_state(tr), tr.engine.name,
                           hist[0].wall_time, finite(tr))
            del tr
        (ls, ss, es, ws, fs), (lh, sh, eh, wh, fh) = got["scan"], got["host"]
        diff = state_diff(ss, sh)
        opt_rows[name] = {"loss": [ls, lh], "engines": [es, eh],
                          "wall_s": [ws, wh], "state_tensors": len(ss),
                          "state_differs": diff, "finite": fs and fh}
        require((es, eh) == ("scan", "host") and ls == lh and not diff
                and fs and fh and math.isfinite(ls),
                f"optimizer {name}: {opt_rows[name]}")
    out["optimizers"] = opt_rows
    launches = dict(backend.LAUNCHES)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    for name in ("loss_confidence", "loss_confidence_bwd", "histogram_select",
                 "rank_select"):
        require(launches.get(name, 0) > 0,
                f"resilience: kernel {name} never launched")
    emit({"phase": "resilience_summary", "optimizers": opt_rows,
          "guard_overhead": rt["overhead"], "budget": GUARD_BUDGET,
          "launches": launches, "seconds": out["seconds"]})
    return launches


def phase_table3(dev, n: int = 1024, n_test: int = 512, epochs: int = 16):
    """``experiments/table3`` at the paper CNN's full width and the
    reference's size (N = 1,024, 16 epochs, batch 128): baseline, Grad-Match
    (its OMP on the host) and KAKURENBO, the latter under ``"sort"`` with
    DropTop 0.02 as the Table 2 phase runs it (the rank-select kernel).
    Wall time per strategy, accuracy, backward samples and OMP seconds."""
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.experiments import table2, table3
    from repro_torch.kernels import backend
    kcfg = dataclasses.replace(table2.kakurenbo_config(epochs),
                               drop_top_fraction=0.02)
    backend.reset_launches()
    t0 = time.perf_counter()
    rows = table3.run_table(model_cfg=CONFIG, n=n, n_test=n_test, epochs=epochs,
                            kakurenbo=kcfg, device=dev)
    launches = dict(backend.LAUNCHES)
    base = rows[0][1]
    out = {}
    for name, res in rows:
        hist = res["history"]
        out[name] = {"wall_s": res["wall_s"],
                     "us_per_epoch": res["wall_s"] / epochs * 1e6,
                     "time_vs_base": res["wall_s"] / base["wall_s"],
                     "best_acc": res["best_acc"], "final_acc": res["final_acc"],
                     "fwd": res["fwd"], "bwd": res["bwd"], "omp_s": res["omp_s"],
                     "epoch_wall_s": [h.wall_time for h in hist],
                     "hidden_fraction": [h.hidden_fraction for h in hist],
                     "train_loss": [h.train_loss for h in hist]}
        require(all(math.isfinite(h.train_loss) for h in hist),
                f"{name}: non-finite loss")
    gm, kk = out["table3/gradmatch-0.3"], out["table3/kakurenbo-0.3"]
    require(gm["omp_s"] > 0 and gm["bwd"] < base["bwd"],
            f"gradmatch trained no subset: {gm}")
    require(any(h.hidden_fraction > 0 for h in rows[2][1]["history"]),
            f"kakurenbo hid nothing: {kk}")
    require(launches.get("rank_select", 0) > 0,
            "Table 3: kernel rank_select never launched")
    emit({"phase": "table3", "model": CONFIG.name, "n": n, "n_test": n_test,
          "epochs": epochs, "kakurenbo": dataclasses.asdict(kcfg), "rows": out,
          "launches": launches, "seconds": time.perf_counter() - t0})
    return launches


# ---------------------------------------------------------------------------
# Serving: mamba2-130m (B6) and smollm-135m (B7)
# ---------------------------------------------------------------------------

#: The kernel each served architecture's prefill runs once a layer, and its
#: wrapper in ``kernels/ops.py``.
SERVE_KERNEL = {"mamba2-130m": "ssd_scan", "smollm-135m": "flash_attention"}


def kernel_group(name: str) -> str:
    """The group of a device activity, by its name: this port's kernels,
    cuBLAS GEMMs, cuDNN convolutions, and the rest."""
    low = name.lower()
    for group, keys in (("B1 fwd", ("lc_warp_rows", "lc_block_rows")),
                        ("B1 bwd", ("lc_backward",)),
                        ("B6 ssd_scan", ("ssd_",)),
                        ("B7 flash_attention", ("flash_attention",)),
                        ("GEMM (cuBLAS)", ("gemm", "gemv")),
                        ("conv (cuDNN)", ("convolve", "conv2d", "convolution",
                                          "cudnn", "fprop", "dgrad", "wgrad",
                                          "nchwtonhwc", "nhwctonchw"))):
        if any(k in low for k in keys):
            return group
    return "other"


def device_breakdown(dev, fn, top: int = 12) -> dict:
    """One call of ``fn`` under ``torch.profiler``: device time and
    activities by kernel, grouped by ``kernel_group``, and the device's busy
    time against the call's wall time (the profiler's own host cost
    included)."""
    fn()
    sync(dev)
    prof, wall_ms, complete = profiled(fn, fn)
    require(complete, "the profiler lost device activities in three traces")
    per = collections.defaultdict(lambda: [0, 0.0])
    spans = []
    for e in device_events(prof):
        t = e.time_range.elapsed_us() / 1e3
        per[e.name][0] += 1
        per[e.name][1] += t
        spans.append((e.time_range.start, e.time_range.end))
    groups, group_calls = collections.Counter(), collections.Counter()
    for name, (calls, ms) in per.items():
        group = kernel_group(name)
        groups[group] += ms
        group_calls[group] += calls
    busy = 0.0
    end = None
    for a, b in sorted(spans):        # union of the device's intervals
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    ranked = sorted(per.items(), key=lambda kv: -kv[1][1])[:top]
    return {"profiled_wall_ms": wall_ms, "device_busy_ms": busy / 1e3,
            "device_kernels": sum(c for c, _ in per.values()),
            "groups_ms": dict(groups), "groups_calls": dict(group_calls),
            "top": [{"name": k[:90], "calls": c, "ms": ms}
                    for k, (c, ms) in ranked]}


@contextlib.contextmanager
def patched_attr(obj, name: str, value):
    """Within the block, ``obj.<name>`` is ``value``."""
    orig = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, orig)


def patched_op(op: str, wrap):
    """Within the block, ``kernels/ops.<op>`` is ``wrap(original)``."""
    from repro_torch.kernels import ops as kops
    return patched_attr(kops, op, wrap(getattr(kops, op)))


def kernel_share(dev, fn, op: str) -> float:
    """The device time (ms) of wrapper ``ops.<op>`` inside one call of
    ``fn``, by CUDA events around every call (a check on the profiler's
    figure)."""
    import torch
    events = []

    def wrap(orig):
        def timed(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(*args, **kw)
            end.record()
            events.append((start, end))
            return out
        return timed

    with patched_op(op, wrap):
        fn()
    sync(dev)
    return sum(a.elapsed_time(b) for a, b in events)


def attention_fan_in(params: dict, cfg) -> dict:
    """Rescale, in place, the attention projections of an ``init_params``
    tree from the reference's fan-in to the fan-in of their input.

    ``init_params`` (the reference's, copied by the port) takes
    ``shape[-2]`` as fan-in: for wq, wk, wv (d, H, Dh) that is H, for wo
    (H, Dh, d) Dh.  At smollm-135m's width q and k then draw at std 8, the
    scaled scores at std ~64, the softmax is near one-hot, and a 30-layer
    model is chaotic in float32: two correct attention orders (B7 and the
    plain version) part by ~6 in the logits (ROADMAP C).  At the input's
    fan-in (d_model for wq, wk, wv; H.Dh for wo) the same draws give a
    model whose logits agree to ~1e-5 at any depth, so a comparison of two
    paths through it can tell right from wrong."""
    a = params["layers"]["attn"]
    dh = cfg.resolved_head_dim
    for name, fan in (("wq", cfg.d_model), ("wk", cfg.d_model),
                      ("wv", cfg.d_model), ("wo", cfg.num_heads * dh)):
        a[name].mul_((a[name].shape[-2] / fan) ** 0.5)
    return params


def close(a, b, tol: float) -> tuple[bool, float]:
    """(allclose with rtol = atol = tol, max abs difference)."""
    import torch
    return (bool(torch.allclose(a, b, rtol=tol, atol=tol)),
            float((a - b).abs().max()))


def plain_attention():
    """Within the block, ``ops.flash_attention`` runs B7's plain version."""
    from repro_torch.kernels import flash_attention as fa
    return patched_op("flash_attention", lambda orig: lambda q, k, v, causal=True:
                      fa.flash_attention_plain(q, k, v, causal))


def conditioning_control(model, cfg, ids, contract, checked) -> dict:
    """Recorded, not required: how far two correct attention orders part
    under the reference's init and under ``checked`` (the weights the
    checks use).  The contract on the reference's init at full depth,
    through B7 and through its plain version alone; and the forward
    through B7 against the forward through the plain version at depths 2,
    8 and full.  Parting alike with or without B7, and growing with depth
    under the reference's init only, is the init's conditioning, not a
    fault of either path."""
    import torch
    from repro_torch.models import transformer
    reference = model.init(torch.Generator().manual_seed(0))
    (_, d1), (_, d2), _, _ = contract(reference)
    with plain_attention():
        (_, p1), (_, p2), _, _ = contract(reference)
    out = {"reference_init": {
        "prefill_vs_forward": d1, "decode_vs_forward": d2,
        "plain_attention": {"prefill_vs_forward": p1, "decode_vs_forward": p2}},
        "fan_in": {}}
    for name, params in (("reference_init", reference), ("fan_in", checked)):
        by_depth = {}
        for depth in (2, 8, cfg.num_layers):
            c = dataclasses.replace(cfg, num_layers=depth)
            with torch.no_grad():
                a, _, _ = transformer.forward(c, params, {"tokens": ids})
                with plain_attention():
                    b, _, _ = transformer.forward(c, params, {"tokens": ids})
            by_depth[depth] = float((a - b).abs().max())
            del a, b
        out[name]["forward_b7_vs_plain_by_depth"] = by_depth
    return out


def with_patches(tokens, pe) -> dict:
    """A prompt batch: the tokens, and the VLM's patch embeddings."""
    return {"tokens": tokens} if pe is None else {"tokens": tokens,
                                                  "patch_embeds": pe}


def serve_contract(cfg, model, params, ids, pe, prompt: int):
    """Prefill of ``ids[:, :prompt]`` (after the VLM's patches ``pe``): its
    last logits against the full forward's at S - 1 (2e-4), one decode
    step of ``ids[:, prompt]`` against the forward's at S (3e-3)
    (``tests/test_arch_smoke.py:81``), S counting the patches.  Returns
    both (ok, max abs difference), the forward's logits and the cache."""
    import torch
    from repro_torch.models import transformer
    n = cfg.num_patch_tokens + prompt
    with torch.no_grad():
        full, _, _ = transformer.forward(cfg, params, with_patches(ids, pe))
        lg, cache = model.prefill(params, with_patches(ids[:, :prompt], pe),
                                  max_len=n + 1)
        lg2, _ = model.decode_step(params, ids[:, prompt:], cache)
    return (close(lg[:, 0], full[:, n - 1], 2e-4),
            close(lg2[:, 0], full[:, n], 3e-3), full, cache)


def serve_card_vs_cpu(dev, small, p_dev, p_cpu, ids, pe, max_len: int,
                      gen: int) -> tuple[dict, list]:
    """``small``'s prefill of the CPU prompt batch ``ids`` (after the VLM's
    patches ``pe``) and ``gen`` greedy decode steps on the card (the
    kernels) and on the CPU (their plain versions), from the same weights:
    the prefill logits and every cache tensor (snapshot copies: decode
    writes the cache in place) within 1e-4, the greedy tokens equal.
    Returns the row's entry and the checks that failed."""
    import torch
    from repro_torch.models import build_model
    cpu = torch.device("cpu")
    runs = {}
    for name, p, d in (("card", p_dev, dev), ("cpu", p_cpu, cpu)):
        m = build_model(small, d)
        t = time.perf_counter()
        with torch.no_grad():
            lg, c = m.prefill(p, with_patches(
                ids.to(d), None if pe is None else pe.to(d)), max_len=max_len)
            first = (lg.cpu(), {k: v.to("cpu", copy=True)
                                for k, v in c.items() if k != "len"})
            tok, seq = lg[:, -1:].argmax(-1), []
            for _ in range(gen):
                seq.append(tok.cpu())
                lg, c = m.decode_step(p, tok, c)
                tok = lg[:, -1:].argmax(-1)
        runs[name] = (first, torch.cat(seq, 1), lg.cpu(),
                      time.perf_counter() - t)
    ok_l, d_l = close(runs["card"][0][0], runs["cpu"][0][0], 1e-4)
    cache_diff = {k: close(t, runs["cpu"][0][1][k], 1e-4)
                  for k, t in runs["card"][0][1].items()}
    same = torch.equal(runs["card"][1], runs["cpu"][1])
    failed = [f"card vs CPU cache {k} differs by {d} > 1e-4"
              for k, (ok, d) in cache_diff.items() if not ok]
    if not ok_l:
        failed.insert(0, f"card vs CPU prefill logits differ by {d_l} > 1e-4")
    if not same:
        failed.append("card and CPU greedy tokens differ")
    return {"layers": small.num_layers, "batch": ids.shape[0],
            "prompt": ids.shape[1], "gen_tokens": gen,
            "prefill_logits_max_abs_diff": d_l,
            "cache_max_abs_diff": {k: d for k, (_, d) in cache_diff.items()},
            "tol": 1e-4, "last_decode_logits_max_abs_diff": float(
                (runs["card"][2] - runs["cpu"][2]).abs().max()),
            "same_greedy_tokens": same,
            "card_s": runs["card"][3], "cpu_s": runs["cpu"][3]}, failed


def phase_serve(dev, arch: str = "mamba2-130m", batch: int = 4,
                prompt: int = 2048, gen: int = 32, cpu_layers: int = 2,
                cpu_gen: int = 16) -> dict:
    """The serve path of ``arch`` at full width and depth (its prefill must
    launch its kernel once a layer), its prefill/forward/decode contract,
    and card against CPU at full width and ``cpu_layers`` layers.  Returns
    the launch counts of the serve call."""
    import numpy as np
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model
    # Full float32 everywhere: no TF32 in cuBLAS (and none in cuDNN, which
    # this path does not call: the causal conv is a sum of shifted products).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(arch)
    kernel = SERVE_KERNEL[arch]
    # A first, short call warms cuBLAS and the caching allocator at these
    # shapes; the second is the one measured and counted.
    serve(cfg.name, reduced=False, batch=batch, prompt_len=prompt,
          gen_tokens=2, seed=0, verbose=False, device=dev)

    backend.reset_launches()
    t0 = time.perf_counter()
    stats = serve(cfg.name, reduced=False, batch=batch, prompt_len=prompt,
                  gen_tokens=gen, seed=0, verbose=False, device=dev)
    wall = time.perf_counter() - t0
    launches = dict(backend.LAUNCHES)
    require(launches.get(kernel, 0) == cfg.num_layers,
            f"serve launched {kernel} {launches.get(kernel, 0)} times, not "
            f"once per layer ({cfg.num_layers}) of the one prefill")
    toks = stats["generated"]
    require(toks.shape == (batch, gen) and bool(((toks >= 0)
                                                 & (toks < cfg.vocab_size)).all()),
            f"serve generated {toks.shape} tokens outside the vocabulary")
    row = {"phase": "serve", "arch": cfg.name, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "batch": batch, "prompt": prompt,
           "gen_tokens": gen, "dtype": "float32",
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_token": stats["decode_per_token_ms"],
           "decode_tok_per_s": stats["decode_tok_per_s"],
           "kernel": kernel, "kernel_launches": launches.get(kernel, 0),
           "launches": launches, "sample_tokens": toks[0, :8].tolist(),
           "wall_s": wall}

    # Prefill matches forward (tests/test_arch_smoke.py:81), at full width
    # and depth.  The dense family's checks draw the same seeded weights
    # with the attention projections at their input's fan-in: under the
    # reference's init its 30 layers are chaotic in float32 (see
    # attention_fan_in; conditioning_control measures it on every run).
    def weights(m, c):
        p = m.init(torch.Generator().manual_seed(0))
        return attention_fan_in(p, c) if c.family == "dense" else p

    model = build_model(cfg, dev)
    params = weights(model, cfg)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt + 1))).to(dev)

    def contract(p):
        return serve_contract(cfg, model, p, ids, None, prompt)

    (ok1, d1), (ok2, d2), full, cache = contract(params)
    row["prefill_vs_forward"] = {"max_abs_diff": d1, "tol": 2e-4}
    row["decode_vs_forward"] = {"max_abs_diff": d2, "tol": 3e-3}
    require(ok1, f"prefill logits differ from the forward's by {d1} > 2e-4")
    require(ok2, f"decode logits differ from the forward's by {d2} > 3e-3")
    if cfg.family == "dense":
        row["weights_for_checks"] = "init_params, attention at input fan-in"
        row["conditioning_control"] = conditioning_control(
            model, cfg, ids, contract, params)

    # Where the time goes: one prefill and one decode step under the
    # profiler, and the kernel's share of a prefill by CUDA events.
    with torch.no_grad():
        def prefill():
            return model.prefill(params, {"tokens": ids[:, :prompt]})

        def step():
            return model.decode_step(params, ids[:, prompt:], cache)

        row["prefill_breakdown"] = device_breakdown(dev, prefill)
        row["prefill_breakdown"]["kernel_ms_by_cuda_events"] = kernel_share(
            dev, prefill, kernel)
        row["decode_breakdown"] = device_breakdown(dev, step)
    del full, cache, params

    # Card (the kernel) against CPU (its plain version), full width, cut
    # depth: the prefill logits and every cache tensor.
    small = dataclasses.replace(cfg, num_layers=cpu_layers)
    p_cpu = weights(build_model(small, "cpu"), small)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, prompt)))
    # The cache holds the decoded tokens too, as serve() sizes it.
    row["card_vs_cpu"], failed = serve_card_vs_cpu(
        dev, small, tree_to(p_cpu, dev), p_cpu, ids, None, prompt + cpu_gen,
        cpu_gen)
    emit(row)
    require(not failed, "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# LM training: smollm-135m (B7) and mamba2-130m (B6), sequences scored by B1
# ---------------------------------------------------------------------------

#: The leaves a launch without a backward left at zero gradient, by family
#: (the attention's inputs, or the scan's and the conv's parameters); the
#: SSM's ``w_in`` columns for x, B, C and dt are checked apart.
FAULT_LEAVES = {"dense": ("ln1", "attn.wq", "attn.wk", "attn.wv"),
                "ssm": ("ssm.conv_w", "ssm.conv_b", "ssm.a_log",
                        "ssm.d_skip", "ssm.dt_bias")}
#: Per-leaf relative gradient error (norm of the difference over the
#: plain forwards' norm) allowed between the kernel forwards and the plain
#: ones at full width and depth, under the conditioning control: float32
#: sums in other orders over 24-30 layers.
LM_GRAD_TOL = 1e-3


def lm_example():
    """``examples/torch_lm_train.py`` as a module (its ``make_trainer``)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_lm_train", ROOT / "examples" / "torch_lm_train.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_batch(dev, n: int = 32, seq: int = 32) -> dict:
    """The example's corpus' first ``n`` sequences on ``dev``."""
    import numpy as np
    import torch
    from repro_torch.data import SyntheticLM
    ds = SyntheticLM(num_samples=n, seq_len=seq, vocab_size=64, order=1,
                     easy_fraction=0.7, seed=0)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in ds.get(np.arange(n)).items()}


def lm_kernel_checks(dev) -> dict:
    """B1 forward and backward, B7 and B6 against their plain versions at
    the LM path's shapes (batch 32 x seq 32): the logits of smollm-135m's
    and mamba2-130m's vocabularies, smollm's attention, mamba2's scan."""
    import torch
    rows = {"loss_confidence": check_loss_confidence(
                dev, 1024, 49152, torch.float32, 1e-4, 20),
            "loss_confidence_mamba2": check_loss_confidence(
                dev, 1024, 50280, torch.float32, 1e-4, 20),
            "loss_confidence_bwd": check_loss_confidence_bwd(
                dev, 1024, 49152, torch.float32, 10),
            "flash_attention": check_flash_attention(
                dev, (32, 32, 9, 3, 64), True, torch.float32, 1e-5, 50,
                library=True),
            "ssd_scan": check_ssd_scan(dev, 32, 32, "model", 50)}
    emit({"phase": "lm_kernel_checks", **rows})
    return rows


def layer_kernels(cfg, seq: int) -> dict:
    """The launches of B7 and B6 one forward over ``seq`` positions makes:
    B7 in every attention layer without a window in effect (global, or
    ``seq`` within the window), B6 in every SSM layer."""
    from repro_torch.models import transformer
    out = {}
    if cfg.family != "ssm":
        out["flash_attention"] = sum(
            g or seq <= cfg.attn_window
            for g in transformer.global_layer_flags(cfg))
    if cfg.family in ("ssm", "hybrid"):
        out["ssd_scan"] = cfg.num_layers
    return out


def lm_train_run(dev, arch: str, strategy: str, selection: str = "sort",
                 drop_top: float = 0.0, full: bool = True,
                 layers: int | None = None, steps: int = 200,
                 lr: float = 1e-2) -> tuple[dict, collections.Counter]:
    """``examples/torch_lm_train.py --full`` at its defaults (512 sequences
    of 32 tokens, batch 32, 200 steps: 12 epochs) under the default engine,
    no checkpoints, at ``layers`` layers (None: the arch's depth) and base
    LR ``lr`` (``full=False``: the reduced config, a rehearsal on the CPU).
    Returns its row and the kernel launches it made."""
    import torch
    from repro_torch.kernels import backend
    before = collections.Counter(backend.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = lm_example().make_trainer(arch, full=full, strategy=strategy,
                                   selection=selection, drop_top=drop_top,
                                   ckpt_dir=None, device=dev,
                                   num_layers=layers, steps=steps, lr=lr)
    built = time.perf_counter() - t0
    hist = tr.run()
    sync(dev)
    wall = time.perf_counter() - t0
    launches = collections.Counter(backend.LAUNCHES)
    launches.subtract(before)
    launches = +launches
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    cfg = tr.model.cfg
    per_forward = layer_kernels(cfg, 32)
    steps = sum(h.bwd_samples for h in hist) // tr.cfg.batch_size
    forwards = launches["loss_confidence"]
    row = {"phase": "lm_train", "arch": arch, "layers": cfg.num_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "strategy": strategy, "selection": selection, "drop_top": drop_top,
           "lr": lr,
           "engine": tr.engine.name, "epochs": len(hist), "train_steps": steps,
           "build_s": built, "wall_s": wall,
           "epoch_wall_s": [h.wall_time for h in hist],
           "loss": [h.train_loss for h in hist],
           "F_star": [h.hidden_fraction for h in hist],
           "bwd_samples": [h.bwd_samples for h in hist],
           "fwd_samples": [h.fwd_samples for h in hist],
           "launches": dict(launches),
           "forwards": forwards,
           "kernel_per_forward": {k: launches[k] / max(forwards, 1)
                                  for k in per_forward},
           "peak_mem_gb": peak / 1e9}
    # One replay of the 8-step graph after the run (it trains on).
    eng = tr.engine
    cap = eng._graphs.get((eng.scan_steps, False))
    if cap is not None:
        times = []
        for _ in range(5):
            sync(dev)
            t = time.perf_counter()
            cap.graph.replay()
            sync(dev)
            times.append((time.perf_counter() - t) * 1e3)
        row["replay_8_steps_ms"] = sorted(times)[2]
    emit(row)
    require(tr.engine.name == "scan", f"{arch}: engine {tr.engine.name}")
    require(all(math.isfinite(h.train_loss) for h in hist),
            f"{arch} {strategy}: non-finite loss {row['loss']}")
    require(hist[-1].train_loss < hist[0].train_loss,
            f"{arch} {strategy}: the loss did not fall: {row['loss']}")
    require(launches["loss_confidence_bwd"] >= steps > 0,
            f"{arch}: B1 backward launched {launches['loss_confidence_bwd']} "
            f"times in {steps} train steps")
    require(forwards >= steps, f"{arch}: B1 forward launched {forwards} "
                               f"times in {steps} train steps")
    for kernel, n in per_forward.items():
        require(launches[kernel] == n * forwards,
                f"{arch}: {kernel} launched {launches[kernel]} times, not "
                f"{n} a forward ({forwards} forwards)")
    if strategy == "kakurenbo":
        require(any(h.hidden_fraction > 0 for h in hist),
                f"{arch}: kakurenbo hid nothing: {row['F_star']}")
    if selection == "histogram_pallas":
        require(launches["histogram_select"] > 0,
                f"{arch}: the histogram-select never launched")
    if selection == "sort" and drop_top > 0:
        require(launches["rank_select"] > 0,
                f"{arch}: the rank-select never launched")
    del tr, eng, cap
    return row, launches


@contextlib.contextmanager
def plain_forwards():
    """Within the block, B1, B6 and B7 run their plain versions under
    autograd (``ops.fused_loss_metrics``, ``ops.ssd_scan``,
    ``ops.flash_attention``): the reference's own forms."""
    from repro_torch.kernels import loss_confidence as lc
    from repro_torch.kernels import ssd_scan as ssd
    with contextlib.ExitStack() as stack:
        stack.enter_context(plain_attention())
        stack.enter_context(patched_op(
            "ssd_scan", lambda orig: lambda *a: ssd.ssd_scan_plain(*a)))
        stack.enter_context(patched_op(
            "fused_loss_metrics", lambda orig: lc.loss_confidence_plain))
        yield


def lm_grads(cfg, params: dict, batch: dict, plain: bool):
    """One train step's gradients (``LM.loss_and_metrics``, backward), the
    loss and the kernel launches it made."""
    from repro_torch.kernels import backend
    from repro_torch.models import LM
    lm = LM(cfg, params)
    before = collections.Counter(backend.LAUNCHES)
    with plain_forwards() if plain else contextlib.nullcontext():
        scalar, _ = lm.loss_and_metrics(batch)
        scalar.backward()
    launches = collections.Counter(backend.LAUNCHES)
    launches.subtract(before)
    return ({n: p.grad for n, p in lm.named_parameters()}, scalar.item(),
            dict(+launches))


def lm_grad_check(dev, arch: str, full: bool = True) -> dict:
    """One train step's gradients at full width and depth through the
    kernel forwards (B7 or B6, and B1) against the same step through the
    plain forwards on the card, per leaf: on the weights the checks use
    (the dense family's attention at its input's fan-in, the serve
    phase's conditioning control) within LM_GRAD_TOL; under the
    reference's init recorded only.  The leaves the gradient fault left at
    zero must have a gradient."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import build_model
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    model = build_model(cfg, dev)
    batch = lm_batch(dev)
    di = cfg.ssm.d_inner or cfg.ssm.expand * cfg.d_model if cfg.ssm else 0
    row = {"phase": "lm_grad_check", "arch": arch, "batch": [32, 32],
           "tol": LM_GRAD_TOL}
    inits = ["checked"] + (["reference_init"] if cfg.family == "dense" else [])
    for name in inits:
        params = model.init(torch.Generator().manual_seed(0))
        if name == "checked" and cfg.family == "dense":
            attention_fan_in(params, cfg)
        gk, lk, nk = lm_grads(cfg, params, batch, plain=False)
        gp, lp, np_ = lm_grads(cfg, params, batch, plain=True)
        rel = {n: float((gk[n] - gp[n]).norm() / gp[n].norm().clamp_min(1e-30))
               for n in gk}
        fault = {n: float(gk[n].norm()) for n in gk
                 if any(n.endswith(leaf) for leaf in FAULT_LEAVES[cfg.family])}
        if cfg.family == "ssm":
            for n in gk:
                if n.endswith("ssm.w_in"):
                    fault[n + "[:, x|B|C|dt]"] = float(gk[n][:, di:].norm())
        worst = max(rel, key=rel.get)
        row[name] = {"loss": [lk, lp], "launches_kernel_pass": nk,
                     "launches_plain_pass": np_, "leaves": len(rel),
                     "max_rel_err": rel[worst], "worst_leaf": worst,
                     "fault_leaves": len(fault),
                     "fault_leaves_min_norm": min(fault.values()),
                     "fault_leaves_max_rel_err": max(rel[n.split("[")[0]]
                                                     for n in fault)}
        if name == "checked":
            require(nk.get(SERVE_KERNEL[arch]) == cfg.num_layers
                    and nk.get("loss_confidence") == 1
                    and nk.get("loss_confidence_bwd") == 1,
                    f"{arch}: the kernel pass launched {nk}")
            require(not np_, f"{arch}: the plain pass launched {np_}")
            require(min(fault.values()) > 0,
                    f"{arch}: a leaf has no gradient: "
                    f"{min(fault, key=fault.get)}")
            require(rel[worst] <= LM_GRAD_TOL,
                    f"{arch}: {worst}'s gradient differs by {rel[worst]} "
                    f"relative > {LM_GRAD_TOL}")
        del gk, gp, params
    emit(row)
    return row


def tree_to(tree, dev):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.to(dev, copy=True)
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, dev) for v in tree]
    return {k: tree_to(v, dev) for k, v in tree.items()}


def lm_card_vs_cpu(dev, arch: str, n: int = 64, layers: int = 2,
                   epochs: int = 2, lr: float = 1e-3,
                   full: bool = True, check: bool = True) -> dict:
    """The example's setup at full width and ``layers`` layers on the card
    and on the CPU, from the same weights and permutations, TF32 off: the
    per-epoch losses within 1e-4 relative and the first epoch's plan
    equal; a CPU run from weights changed by 1e-7 relative says how well
    conditioned the comparison is.  At the example's LR of 1e-2 that
    control moves mamba2-130m's second epoch by 4e-4 (the run is chaotic:
    no 1e-4 comparison could hold there); ``lr`` 1e-3 keeps it well
    conditioned, as the CNN's card-vs-CPU phase takes a tenth of its LR.
    ``check=False`` records the comparison without requiring it."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import LM, Model
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    cfg = dataclasses.replace(cfg, num_layers=layers)
    params = Model(cfg, "cpu").init(torch.Generator().manual_seed(0))
    if cfg.family == "dense":
        attention_fan_in(params, cfg)
    g = torch.Generator().manual_seed(3)
    perms = [torch.randperm(n, generator=g) for _ in range(epochs)]
    cpu = torch.device("cpu")
    ex = lm_example()
    runs = {}
    for name, d, scale in ((dev.type, dev, 1.0), ("cpu", cpu, 1.0),
                           ("cpu_perturbed", cpu, 1 + 1e-7)):
        p = tree_to(params, d)
        if scale != 1.0:
            with torch.no_grad():
                for _, t in flatten(p):
                    t.mul_(scale)
        t0 = time.perf_counter()
        tr = ex.make_trainer(arch, full=full, steps=epochs * (n // 32),
                             num_samples=n, ckpt_dir=None, device=d,
                             model=LM(cfg, p), lr=lr)
        it = iter([q.to(d) for q in perms])
        tr.strategy._inner.draw_permutation = lambda it=it: next(it)
        hist, plans = recorded_run(tr)
        runs[name] = (hist, plans, time.perf_counter() - t0)

    def max_rel(a, b):
        return max(abs(x.train_loss - y.train_loss) / abs(y.train_loss)
                   for x, y in zip(runs[a][0], runs[b][0]))

    rel = max_rel(dev.type, "cpu")
    same = [same_plans([a], [b]) for a, b in zip(runs[dev.type][1],
                                                runs["cpu"][1])]
    row = {"phase": "lm_card_vs_cpu", "arch": arch, "layers": layers,
           "n": n, "epochs": epochs, "lr": lr,
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "loss": {k: [h.train_loss for h in v[0]] for k, v in runs.items()},
           "F_star": {k: [h.hidden_fraction for h in v[0]]
                      for k, v in runs.items()},
           "seconds": {k: v[2] for k, v in runs.items()},
           "max_rel_diff": rel,
           "perturbed_max_rel_diff": max_rel("cpu_perturbed", "cpu"),
           "plans_equal_by_epoch": same}
    emit(row)
    if check:
        require(rel <= 1e-4,
                f"{arch}: card vs CPU losses differ by {rel} relative")
        require(same[0], f"{arch}: card vs CPU first plans differ")
    return row


def lm_engines_restart(dev, arch: str = "smollm-135m", steps: int = 48,
                       full: bool = True) -> dict:
    """The example's trainer at full width for 3 KAKURENBO epochs
    (``"histogram_pallas"`` + DropTop 0.02, which hides from epoch 1): the
    host loop against the scanned engine (losses, plans, every parameter,
    AdamW moment and strategy tensor bit-identical), then the scanned run
    crashing between two blocks of epoch 2, restored from the epoch-2
    checkpoint into a trainer built from other weights and seeds, ending
    bit-identical to the uninterrupted scanned run."""
    import shutil
    ex = lm_example()
    root = ROOT / "build" / "chip_smoke_lm_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()

    def trainer(engine, seed=0, ckpt=False):
        return ex.make_trainer(arch, full=full, steps=steps, device=dev,
                               seed=seed, engine=engine,
                               selection="histogram_pallas", drop_top=0.02,
                               ckpt_dir=str(root) if ckpt else None,
                               checkpoint_every=2)

    runs = {}
    for engine in ("host", "scan"):
        tr = trainer(engine)
        hist, plans = recorded_run(tr)
        runs[engine] = ([h.train_loss for h in hist], plans, train_state(tr),
                        [h.wall_time for h in hist], tr.engine.name)
        del tr
    (lh, ph, sh, wh, eh), (ls, ps, ss, ws, es) = runs["host"], runs["scan"]
    diff = state_diff(sh, ss)
    row = {"phase": "lm_engines_restart", "arch": arch, "epochs": len(lh),
           "engines": [eh, es], "loss": {"host": lh, "scan": ls},
           "epoch_wall_s": {"host": wh, "scan": ws},
           "hidden": [len(p[1]) for p in ps], "losses_equal": lh == ls,
           "plans_equal": same_plans(ph, ps), "state_tensors": len(ss),
           "state_differs": diff}
    del sh
    row["capture_keeps_state"] = capture_keeps_state(
        trainer("scan"), arch)["state_differs"]
    try:
        tr = trainer("scan", ckpt=True)
        tr.run(2)
        dispatch, calls = tr.engine._dispatch, [0]

        def bomb(size, weighted):
            if calls[0] == 1:
                raise RuntimeError("injected failure between blocks")
            calls[0] += 1
            dispatch(size, weighted)

        tr.engine._dispatch = bomb
        try:
            tr.run_epoch(2)
        except RuntimeError as e:
            require("between blocks" in str(e), f"lm restart: {e}")
        del tr
        t1 = time.perf_counter()
        tr2 = trainer("scan", seed=7, ckpt=True)
        require(tr2.restore_latest() and tr2.epoch == 2, "lm restart: restore")
        restore_s = time.perf_counter() - t1
        tr2.run()
        restart_diff = state_diff(train_state(tr2), ss)
        row["restart"] = {"replays_before_crash": calls[0],
                          "restore_s": restore_s,
                          "state_differs": restart_diff,
                          "last_loss": [tr2.history[-1].train_loss, ls[-1]]}
        del tr2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    require((eh, es) == ("host", "scan"), f"lm engines: {eh}, {es}")
    require(lh == ls, f"lm engines: losses differ {lh} vs {ls}")
    require(same_plans(ph, ps), "lm engines: plans differ")
    require(not diff, f"lm engines: train state differs in {diff}")
    require(any(row["hidden"]), "lm engines: kakurenbo hid nothing")
    r = row["restart"]
    require(not r["state_differs"] and r["last_loss"][0] == r["last_loss"][1],
            f"lm restart: {r}")
    return row


#: Device activities inside these ``record_function`` ranges of a train
#: step form groups of their own (the innermost range wins); a GEMM inside
#: the MoE's forward range, not its routing, is an expert product.
STEP_RANGES = {"lm:plain_backward": "plain attention/scan backward",
               "lm:optimizer": "AdamW",
               "lm:moe_route": "MoE routing (forward)",
               "lm:moe": "MoE dispatch + combine (forward)"}


def lm_step_breakdown(dev, arch: str, seq: int, full: bool = True,
                      layers: int | None = None) -> dict:
    """One KAKURENBO train step of the example's trainer at batch 32 x
    ``seq`` (eager, as the host loop runs it), at ``layers`` layers (None:
    the arch's depth), under the profiler: device time by group, the plain
    attention/scan backward, the optimizer and the MoE's forward parts
    (routing; the expert products; dispatch and combine) told apart by
    ``record_function`` ranges on the device's timeline (and by CUDA events
    around them), busy vs wall."""
    import numpy as np
    import torch
    from torch.profiler import record_function
    from repro_torch.kernels import ops
    from repro_torch.models import moe
    tr = lm_example().make_trainer(arch, full=full, seq_len=seq,
                                   num_samples=64, ckpt_dir=None, device=dev,
                                   num_layers=layers)
    tr.lr_dev.fill_(float(tr.cfg.lr(0)))
    batch = tr.to_device(tr.dataset.get(np.arange(32)))
    idx = torch.arange(32, device=dev)

    def step():
        tr.train_step(tr.strategy.get_device_state(), batch, idx,
                      tr.epoch_dev, tr.lr_dev)

    events = collections.defaultdict(list)
    timing = [False]

    def ranged(name, fn):
        def call(*a, **kw):
            with record_function(name):
                if timing[0] and dev.type == "cuda":
                    start = torch.cuda.Event(enable_timing=True)
                    end = torch.cuda.Event(enable_timing=True)
                    start.record()
                    out = fn(*a, **kw)
                    end.record()
                    events[name].append((start, end))
                    return out
                return fn(*a, **kw)
        return call

    with patched_attr(ops, "plain_grads", ranged("lm:plain_backward",
                                                 ops.plain_grads)), \
            patched_attr(tr.opt, "step", ranged("lm:optimizer", tr.opt.step)), \
            patched_attr(moe, "moe_ffn", ranged("lm:moe", moe.moe_ffn)), \
            patched_attr(moe, "route", ranged("lm:moe_route", moe.route)):
        step()
        sync(dev)
        t0 = time.perf_counter()
        step()
        sync(dev)
        step_ms = (time.perf_counter() - t0) * 1e3
        timing[0] = True
        step()
        sync(dev)
        timing[0] = False
        by_events = {k: sum(a.elapsed_time(b) for a, b in v)
                     for k, v in events.items()}
        prof, wall_ms, complete = profiled(step, step)
    ranges = [(e.name, e.time_range.start, e.time_range.end)
              for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.name.startswith("lm:")]
    groups, calls = collections.Counter(), collections.Counter()
    spans = []
    for e in device_events(prof):
        a, b = e.time_range.start, e.time_range.end
        group = kernel_group(e.name)
        inside = [(hi - lo, name) for name, lo, hi in ranges
                  if lo <= a and b <= hi]
        if inside:
            name = min(inside)[1]
            if name == "lm:moe" and group == "GEMM (cuBLAS)":
                group = "MoE expert products (forward)"
            else:
                group = STEP_RANGES[name]
        if group == "other":
            group = "small kernels"
        groups[group] += (b - a) / 1e3
        calls[group] += 1
        spans.append((a, b))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy, end = busy + (b - a), b
        elif b > end:
            busy, end = busy + (b - end), b
    row = {"phase": "lm_step_profile", "arch": arch, "batch": [32, seq],
           "layers": tr.model.cfg.num_layers,
           "step_ms": step_ms, "profiled_wall_ms": wall_ms,
           # False: the trace lost device activities (three tries), so
           # the groups below undercount.
           "trace_complete": complete,
           "device_busy_ms": busy / 1e3,
           "device_kernels": sum(calls.values()),
           "groups_ms": dict(groups), "groups_calls": dict(calls),
           "device_ranges_found": sorted({r[0] for r in ranges}),
           "ranges_ms_by_cuda_events": by_events}
    emit(row)
    del tr
    return row


def free_memory() -> None:
    """Collect the last run's trainer (its graphs and pool) and return the
    cached blocks to the card, so that each run starts from the same
    memory."""
    import gc
    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def phase_lm_train(dev, full: bool = True) -> collections.Counter:
    """LM training (``examples/torch_lm_train.py --full``; its kernels at
    its shapes are checked in ``phase_kernels``): smollm-135m under
    baseline, KAKURENBO ("sort") and KAKURENBO ("histogram_pallas" +
    DropTop 0.02), mamba2-130m under KAKURENBO ("sort" + DropTop 0.02),
    their launches counted from 0 just
    before the four runs; then the gradient check, card vs CPU at 2
    layers, host loop = scanned engine and restart, and one profiled step
    of each arch at seq 32 and 512.  Returns the four runs' launches.
    ``full=False`` rehearses it on the CPU at the reduced configs."""
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    backend.reset_launches()
    launches = collections.Counter()
    for arch, strategy, selection, drop_top in (
            ("smollm-135m", "baseline", "sort", 0.0),
            ("smollm-135m", "kakurenbo", "sort", 0.0),
            ("smollm-135m", "kakurenbo", "histogram_pallas", 0.02),
            ("mamba2-130m", "kakurenbo", "sort", 0.02)):
        _, got = lm_train_run(dev, arch, strategy, selection, drop_top, full)
        launches.update(got)
        free_memory()
    require(launches == collections.Counter(backend.LAUNCHES),
            "lm_train: launches outside the four runs")
    for arch in ("smollm-135m", "mamba2-130m"):
        lm_grad_check(dev, arch, full)
        free_memory()
    for arch in ("smollm-135m", "mamba2-130m"):
        lm_card_vs_cpu(dev, arch, full=full)
    lm_engines_restart(dev, full=full)
    free_memory()
    for arch in ("smollm-135m", "mamba2-130m"):
        for seq in (32, 512):
            lm_step_breakdown(dev, arch, seq, full)
            free_memory()
    emit({"phase": "lm_train_done", "seconds": time.perf_counter() - t0,
          "launches": dict(launches)})
    return launches


# ---------------------------------------------------------------------------
# The model zoo: phi3.5-moe (MoE), hymba-1.5b (hybrid), qwen3-1.7b, llava
# (VLM) and kimi-k2 (reduced), served and trained through B1, B6 and B7
# ---------------------------------------------------------------------------

#: B7 at the zoo's prefill shapes (B, S, Hq, Hkv, D), causal: phi3.5-moe,
#: qwen3, hymba (GQA group 5), llava (2,048 tokens after 576 patches) and
#: kimi-k2 (head_dim 112) at full width; then the LM training path's
#: (batch 32 x seq 32) of phi3.5-moe and hymba.
ZOO_ATTN = (("phi3.5-moe-42b-a6.6b", (4, 2048, 32, 8, 128)),
            ("qwen3-1.7b", (4, 2048, 16, 8, 128)),
            ("hymba-1.5b", (4, 2048, 25, 5, 64)),
            ("llava-next-mistral-7b", (4, 2624, 32, 8, 128)),
            ("kimi-k2-1t-a32b", (4, 2048, 64, 8, 112)),
            ("phi3.5-moe-42b-a6.6b lm", (32, 32, 32, 8, 128)),
            ("hymba-1.5b lm", (32, 32, 25, 5, 64)))
#: hymba-1.5b's scan: 25 heads of P = 64, state N = 16, chunk 128.
HYMBA_SSD = dict(nh=25, p=64, n=16, chunk=128)


def zoo_kernel_checks(dev) -> dict:
    """B7 at the zoo's shapes (float32, causal, against its plain version
    within 1e-5 and float64, beside SDPA), B6 at hymba's serve (4, 2,048)
    and train (32, 32) shapes, B1's forward at phi3.5-moe's and hymba's
    vocabularies (1,024 rows) and its backward at phi3.5-moe's."""
    import torch
    rows = {"flash_attention": [
        dict(check_flash_attention(dev, shape, True, torch.float32, 1e-5,
                                   10 if shape[1] > 32 else 50, library=True),
             arch=arch) for arch, shape in ZOO_ATTN],
        "ssd_scan": [dict(check_ssd_scan(dev, b, s, "model", reps, HYMBA_SSD),
                          arch="hymba-1.5b" + (" lm" if b == 32 else ""))
                     for b, s, reps in ((4, 2048, 20), (32, 32, 50))],
        "loss_confidence": [
            dict(check_loss_confidence(dev, 1024, v, torch.float32, 1e-4, 20),
                 arch=arch) for arch, v in (("phi3.5-moe-42b-a6.6b", 32064),
                                            ("hymba-1.5b", 32001))],
        "loss_confidence_bwd": [dict(check_loss_confidence_bwd(
            dev, 1024, 32064, torch.float32, 10), arch="phi3.5-moe-42b-a6.6b")]}
    emit({"phase": "zoo_kernel_checks", **rows})
    return rows


#: The zoo's served configurations (full width): depth (None: the arch's)
#: and the launches of B7 and B6 one prefill of 2,048 tokens makes.
#: hymba's 29 windowed layers attend in plain PyTorch past the window of
#: 1,024 (B7 has no window; the reference's windowed attention is jnp).
ZOO_SERVE = (("phi3.5-moe-42b-a6.6b", 4, {"flash_attention": 4}),
             ("hymba-1.5b", None, {"flash_attention": 3, "ssd_scan": 32}),
             ("qwen3-1.7b", None, {"flash_attention": 28}),
             ("llava-next-mistral-7b", 8, {"flash_attention": 8}))


def no_drop(cfg):
    """``cfg`` with a capacity no expert can overflow (every choice of a
    token to a distinct expert fits: capacity_factor = E / k), so that
    prefill, the forward and decode route each token alike (the
    reference's tests/test_arch_smoke.py raises it to 64 for the same
    reason: with drops, routing depends on the whole batch)."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))


def patches(dev, cfg, batch: int, seed: int):
    """The VLM's patch embeddings (None for the other families)."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import VLM_PATCH_DIM
    if cfg.family != "vlm":
        return None
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(batch, cfg.num_patch_tokens, VLM_PATCH_DIM)).astype(
            np.float32)).to(dev)


def phase_zoo_serve(dev, arch: str, layers: int | None, expected: dict,
                    full: bool = True, batch: int = 4, prompt: int = 2048,
                    gen: int = 32, cpu_layers: int = 2, cpu_batch: int = 4,
                    cpu_prompt: int = 128, cpu_gen: int = 4) -> dict:
    """``arch`` served through ``repro_torch.launch.serve`` at full width
    (``full=False``: reduced) and ``layers`` layers, f32: prefill ms,
    decode ms a token and tok/s, the B7/B6 launches of its one prefill
    (``expected``); prefill/forward/decode contract of phase 13 (2e-4,
    3e-3) on weights drawn on the card with the attention at its input's
    fan-in and, for an MoE, a capacity no expert overflows; one prefill
    and one decode step profiled; card against CPU at ``cpu_layers``
    layers, ``cpu_batch`` prompts of ``cpu_prompt`` tokens (the CPU's
    expert products at 2,048 tokens take minutes) and ``cpu_gen`` greedy
    tokens.  Returns the serve call's launches."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import backend
    from repro_torch.launch.serve import serve
    from repro_torch.models import build_model, transformer
    from repro_torch.models.common import map_defs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    kw = dict(reduced=not full, batch=batch, prompt_len=prompt, seed=0,
              verbose=False, device=dev, num_layers=layers)
    t0 = time.perf_counter()
    serve(arch, gen_tokens=2, **kw)           # warms cuBLAS and the allocator
    free_memory()
    backend.reset_launches()
    t1 = time.perf_counter()
    stats = serve(arch, gen_tokens=gen, **kw)
    wall = time.perf_counter() - t1
    launches = dict(backend.LAUNCHES)
    free_memory()
    got = {k: launches.get(k, 0) for k in ("flash_attention", "ssd_scan")}
    want = {k: expected.get(k, 0) for k in got}
    toks = stats["generated"]
    n_params = sum(n for _, n in flatten(map_defs(
        lambda d: math.prod(d.shape), transformer.param_defs(cfg))))
    row = {"phase": "zoo_serve", "arch": arch, "layers": cfg.num_layers,
           "full_width": full, "d_model": cfg.d_model, "params": n_params,
           "batch": batch, "prompt": prompt,
           "patch_tokens": cfg.num_patch_tokens, "gen_tokens": gen,
           "dtype": "float32", "prefill_ms": stats["prefill_s"] * 1e3,
           "decode_ms_per_token": stats["decode_per_token_ms"],
           "decode_tok_per_s": stats["decode_tok_per_s"],
           "prefill_tok_per_s": batch * (prompt + cfg.num_patch_tokens)
           / stats["prefill_s"],
           "layer_kernel_launches": got, "expected": want,
           "launches": launches, "sample_tokens": toks[0, :8].tolist(),
           "wall_s": wall}
    require(got == want, f"{arch} serve launched {got}, not {want}")
    require(toks.shape == (batch, gen) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        f"{arch}: serve generated {toks.shape} tokens outside the vocabulary")

    # The contract, on weights drawn on the card.
    checked = no_drop(cfg)
    model = build_model(checked, dev)
    params = attention_fan_in(model.init(
        torch.Generator(device=dev).manual_seed(0)), cfg)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt + 1))).to(dev)
    pe = patches(dev, cfg, batch, 1)
    npatch = cfg.num_patch_tokens
    (ok1, d1), (ok2, d2), full_lg, cache = serve_contract(
        checked, model, params, ids, pe, prompt)
    row["prefill_vs_forward"] = {"max_abs_diff": d1, "tol": 2e-4}
    row["decode_vs_forward"] = {"max_abs_diff": d2, "tol": 3e-3}
    row["weights_for_checks"] = ("drawn on the card, attention at input "
                                 "fan-in" + (", capacity_factor E/k"
                                             if cfg.moe else ""))
    del full_lg, cache
    require(ok1, f"{arch}: prefill logits differ from the forward's by {d1}")
    require(ok2, f"{arch}: decode logits differ from the forward's by {d2}")

    # Where the time goes: the served config's prefill and decode step.
    served = build_model(cfg, dev)
    with torch.no_grad():
        _, cache = served.prefill(params, with_patches(ids[:, :prompt], pe),
                                  max_len=npatch + prompt + 1)

        def prefill():
            return served.prefill(params, with_patches(ids[:, :prompt], pe))

        def step():
            return served.decode_step(params, ids[:, prompt:], cache)

        row["prefill_breakdown"] = device_breakdown(dev, prefill)
        row["decode_breakdown"] = device_breakdown(dev, step)
    del params, cache, model, served
    free_memory()

    # Card (B6/B7) against CPU (their plain versions) at cut depth, on
    # weights drawn on the card.
    small = dataclasses.replace(cfg, num_layers=min(cpu_layers, cfg.num_layers))
    p_dev = attention_fan_in(build_model(small, dev).init(
        torch.Generator(device=dev).manual_seed(3)), small)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (cpu_batch, cpu_prompt)))
    row["card_vs_cpu"], failed = serve_card_vs_cpu(
        dev, small, p_dev, tree_to(p_dev, torch.device("cpu")), ids,
        patches(torch.device("cpu"), cfg, cpu_batch, 2),
        npatch + cpu_prompt + cpu_gen, cpu_gen)
    row["seconds"] = time.perf_counter() - t0
    del p_dev
    free_memory()
    emit(row)
    require(not failed, f"{arch}: " + "; ".join(failed))
    return launches


def host_state(tr) -> dict:
    """The train state's tensors copied to the host, by name (a model near
    the card's size cannot hold two copies of its state on the card)."""
    import torch
    from repro_torch.checkpoint import checkpoint as ckpt
    return {path: (v.detach().to("cpu", copy=True)
                   if isinstance(v, torch.Tensor) else torch.from_numpy(v.copy()))
            for path, v in ckpt.flatten(tr._ckpt_tree())}


def zoo_engines(dev, arch: str = "phi3.5-moe-42b-a6.6b", layers: int = 1,
                steps: int = 32, full: bool = True) -> dict:
    """The example's trainer at ``layers`` layers for 2 KAKURENBO epochs
    (``"histogram_pallas"`` + DropTop 0.02, which hides from epoch 1):
    the host loop against the scanned engine, losses, plans and every
    parameter, AdamW moment and strategy tensor bit-identical."""
    ex = lm_example()
    t0 = time.perf_counter()
    runs = {}
    for engine in ("host", "scan"):
        tr = ex.make_trainer(arch, full=full, steps=steps, device=dev,
                             engine=engine, selection="histogram_pallas",
                             drop_top=0.02, ckpt_dir=None, num_layers=layers)
        hist, plans = recorded_run(tr)
        runs[engine] = ([h.train_loss for h in hist], plans, host_state(tr),
                        [h.wall_time for h in hist], tr.engine.name)
        del tr
        free_memory()
    (lh, ph, sh, wh, eh), (ls, ps, ss, ws, es) = runs["host"], runs["scan"]
    diff = state_diff(sh, ss)
    row = {"phase": "zoo_engines", "arch": arch, "layers": layers,
           "epochs": len(lh), "engines": [eh, es],
           "loss": {"host": lh, "scan": ls},
           "epoch_wall_s": {"host": wh, "scan": ws},
           "hidden": [len(p[1]) for p in ps], "losses_equal": lh == ls,
           "plans_equal": same_plans(ph, ps), "state_tensors": len(ss),
           "state_gb": sum(t.numel() * t.element_size()
                           for t in ss.values()) / 1e9,
           "state_differs": diff, "seconds": time.perf_counter() - t0}
    del runs, sh, ss
    emit(row)
    require((eh, es) == ("host", "scan"), f"zoo engines: {eh}, {es}")
    require(lh == ls, f"zoo engines: losses differ {lh} vs {ls}")
    require(same_plans(ph, ps), "zoo engines: plans differ")
    require(not diff, f"zoo engines: train state differs in {diff}")
    require(any(row["hidden"]), "zoo engines: kakurenbo hid nothing")
    return row


#: The zoo's LM training runs: arch, depth (None: the arch's), full
#: width, base LR, steps.  hymba-1.5b at the reference's LR of 1e-2 stalls
#: at the corpus' unigram loss on an H100 (3.43 from epoch 6 on, nothing
#: hidden in 12 epochs); it trains at 1e-3, as its CPU test does.
ZOO_LM = (("phi3.5-moe-42b-a6.6b", 2, True, 1e-2, 200),
          ("hymba-1.5b", None, True, 1e-3, 200),
          ("kimi-k2-1t-a32b", None, False, 1e-2, 32))


def phase_zoo_lm(dev, full: bool = True) -> collections.Counter:
    """KAKURENBO LM training (``examples/torch_lm_train.py --full``'s
    defaults, ``"sort"``) on phi3.5-moe at 2 layers and hymba-1.5b (LR
    1e-3) at full width and depth, and 2 epochs of kimi-k2 reduced, their launches
    counted from 0 just before the runs: per epoch wall s, loss, F* and
    backward samples; B1's backward each step, B7 (and B6) once a layer a
    forward; the loss falls and some epoch hides sequences.  Then the host
    loop = the scanned engine on phi3.5-moe at 1 layer, and one profiled
    step of each of the two at seq 32.  ``full=False`` rehearses it on the
    CPU at the reduced configs."""
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    backend.reset_launches()
    launches = collections.Counter()
    for arch, layers, wide, lr, steps in ZOO_LM:
        _, got = lm_train_run(dev, arch, "kakurenbo", full=full and wide,
                              layers=layers if full else None, steps=steps,
                              lr=lr)
        launches.update(got)
        free_memory()
    require(launches == collections.Counter(backend.LAUNCHES),
            "zoo_lm: launches outside the runs")
    zoo_engines(dev, layers=1, full=full)
    for arch, layers, *_ in ZOO_LM[:2]:
        lm_step_breakdown(dev, arch, 32, full, layers if full else None)
        free_memory()
    emit({"phase": "zoo_lm_done", "seconds": time.perf_counter() - t0,
          "launches": dict(launches)})
    return launches


def lr_grad_point(dev, tr, epoch: int, n: int = 4) -> dict:
    """At ``tr``'s weights after ``epoch`` epochs, one train step's loss
    and gradients on the corpus' first ``n`` sequences through the kernels
    and through their plain versions on the card and on the CPU (each leaf
    against the CPU's, relative, and the kernels' against the plain
    versions' on the card), and how far the predictions depend on
    the input: the mean total-variation distance of each position's
    predicted distribution from the batch's mean prediction (0: one
    prediction for every context, the corpus' unigram)."""
    import torch
    from repro_torch.models import LM
    cfg, cpu = tr.model.cfg, torch.device("cpu")
    with torch.no_grad():
        params = tree_to(tr.model.params(), cpu)
    batch = {k: v[:n] for k, v in lm_batch(cpu).items()}
    grads, row = {}, {"epoch": epoch}
    for name, d, plain in (("cpu", cpu, False), ("kernels", dev, False),
                           ("plain", dev, True)):
        p, b = tree_to(params, d), {k: v.to(d) for k, v in batch.items()}
        t0 = time.perf_counter()
        g, loss, launches = lm_grads(cfg, p, b, plain)
        row[name] = {"loss": loss, "launches": launches,
                     "seconds": time.perf_counter() - t0}
        grads[name] = {k: v.to(cpu) for k, v in g.items()}
        if name == "kernels":
            with torch.no_grad():
                logits, mask, _ = LM(cfg, p)(b)
                prob = torch.softmax(logits.double(), -1)[mask.bool()]
                row["context_tv"] = float(0.5 * (prob - prob.mean(0)).abs()
                                          .sum(-1).mean())
        del p, g
        free_memory()
    for name, ref in (("kernels", "cpu"), ("plain", "cpu"),
                      ("kernels", "plain")):
        a, b = grads[name], grads[ref]
        rel = {k: float((a[k] - b[k]).norm() / b[k].norm().clamp_min(1e-30))
               for k in b}
        worst = max(rel, key=rel.get)
        row[name if ref == "cpu" else "kernels_vs_plain"] = {
            **(row[name] if ref == "cpu" else {}),
            "max_rel_err": rel[worst], "worst_leaf": worst,
            "loss_rel_diff": abs(row[name]["loss"] - row[ref]["loss"])
            / abs(row[ref]["loss"])}
    return row


def witness_hymba_lr(dev, lr: float = 1e-2, marks=(1, 6, 12),
                     full: bool = True) -> dict:
    """Is hymba-1.5b's stall at the reference's LR of 1e-2 (the loss at
    the corpus' unigram level, nothing hidden) the LR's or the port's?
    The example's KAKURENBO run (``"sort"``, 12 epochs, default engine) at
    full width and depth through the kernels, with ``lr_grad_point`` at
    epoch 0 and at each of ``marks``; the same run through the kernels'
    plain versions (on the card, under ``plain_forwards``); the same run
    at 4 layers; card vs CPU over 2 epochs at 4 layers beside a CPU run
    from weights changed by 1e-7.  At full depth hymba's float32 gradient
    is ill-conditioned: the plain versions on the card (the CPU's code
    under cuBLAS's sum orders) part from the CPU by O(1) relative on some
    SSM leaves at the init.  So at each gradient point the kernels must
    agree with the CPU within LM_GRAD_TOL a leaf and 1e-5 in the loss, or
    within 10 times the plain versions' distance from the CPU (the
    control); the plain run must launch none of B1, B6 and B7, and the
    card-vs-CPU losses must agree within 1e-4 relative or within 10 times
    the perturbed control's difference.
    ``full=False`` rehearses it on the CPU at the reduced config."""
    import torch
    from repro_torch.kernels import backend
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ex = lm_example()
    t0 = time.perf_counter()
    out, failed = {"phase": "hymba_lr_witness", "lr": lr}, []
    layer_ops = ("flash_attention", "ssd_scan", "loss_confidence",
                 "loss_confidence_bwd")
    for name, layers, points in (("kernels", None, True),
                                 ("plain", None, False),
                                 ("kernels_4_layers", 4, False)):
        before = collections.Counter(backend.LAUNCHES)
        with plain_forwards() if name == "plain" else contextlib.nullcontext():
            tr = ex.make_trainer("hymba-1.5b", full=full, lr=lr, steps=200,
                                 ckpt_dir=None, device=dev, num_layers=layers)
            grad_points = [lr_grad_point(dev, tr, 0)] if points else []
            for m in marks:
                tr.run(m)
                if points:
                    grad_points.append(lr_grad_point(dev, tr, m))
        sync(dev)
        launches = collections.Counter(backend.LAUNCHES)
        launches.subtract(before)
        hist = tr.history
        row = {"layers": tr.model.cfg.num_layers, "engine": tr.engine.name,
               "loss": [h.train_loss for h in hist],
               "F_star": [h.hidden_fraction for h in hist],
               "bwd_samples": [h.bwd_samples for h in hist],
               "epoch_wall_s": [h.wall_time for h in hist],
               "launches": {k: v for k, v in launches.items() if v}}
        if grad_points:
            row["grad_points"] = grad_points
        out[name] = row
        emit({"phase": "hymba_lr_witness_run", "run": name, **row})
        del tr
        free_memory()
        if name == "plain" and any(launches[k] for k in layer_ops):
            failed.append(f"the plain run launched {dict(launches)}")
        for gp in grad_points:
            k, c = gp["kernels"], gp["plain"]
            for key, tol in (("max_rel_err", LM_GRAD_TOL),
                             ("loss_rel_diff", 1e-5)):
                if k[key] > max(tol, 10 * c[key]):
                    failed.append(f"epoch {gp['epoch']}: kernels vs CPU "
                                  f"{key} {k[key]} (control {c[key]})")
    cvc = lm_card_vs_cpu(dev, "hymba-1.5b", layers=4, lr=lr, full=full,
                         check=False)
    out["card_vs_cpu_4_layers"] = {k: cvc[k] for k in (
        "loss", "F_star", "max_rel_diff", "perturbed_max_rel_diff",
        "plans_equal_by_epoch", "seconds")}
    if cvc["max_rel_diff"] > max(1e-4, 10 * cvc["perturbed_max_rel_diff"]):
        failed.append(f"card vs CPU at 4 layers: {cvc['max_rel_diff']} "
                      f"(control {cvc['perturbed_max_rel_diff']})")
    free_memory()
    out["failed"] = failed
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    require(not failed, "hymba LR witness: " + "; ".join(failed))
    return out


# ---------------------------------------------------------------------------


#: Each TPU kernel's row: its port's source and the ``pallas_call`` site it
#: replaces.  B4 and B5 are one fused kernel, counted as ``rank_select``.
KERNELS = {
    "loss_confidence": ("src/repro_torch/kernels/csrc/loss_confidence.cu",
                        "src/repro/kernels/loss_confidence.py:63"),
    # Not a pallas_call: the jnp custom_vjp bwd of the fused scoring.
    "loss_confidence_bwd": ("src/repro_torch/kernels/csrc/loss_confidence.cu",
                            "src/repro/kernels/ops.py:206"),
    "minmax": ("src/repro_torch/kernels/csrc/threshold_select.cu",
               "src/repro/kernels/threshold_select.py:114"),
    "histogram": ("src/repro_torch/kernels/csrc/threshold_select.cu",
                  "src/repro/kernels/threshold_select.py:71"),
    "byte_histogram": ("src/repro_torch/kernels/csrc/rank_select.cu",
                       "src/repro/kernels/threshold_select.py:225"),
    "select_mask": ("src/repro_torch/kernels/csrc/rank_select.cu",
                    "src/repro/kernels/threshold_select.py:273"),
    "ssd_scan": ("src/repro_torch/kernels/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan.py:72"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:63"),
}


def main(argv: list[str]) -> int:
    if argv not in ([], ["--hymba-lr-witness"]):
        print("usage: chip_smoke.py [--hymba-lr-witness]", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} is missing: run from a "
              "checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import backend

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    emit({"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "device_count": torch.cuda.device_count()})
    t0 = time.perf_counter()
    so = backend.build()
    backend.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(so.relative_to(ROOT))})

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()
    if argv == ["--hymba-lr-witness"]:
        witness_hymba_lr(dev)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    main_rows, lm_rows = phase_kernels(dev)
    zoo_rows = zoo_kernel_checks(dev)
    phase_plan(dev)
    launches = collections.Counter(phase_train(dev))
    launches.update(phase_table2(dev))
    phase_train_step(dev)
    for engine in ("host", "scan"):
        emit(epoch_split(dev, engine))
    phase_engines(dev)
    phase_restart(dev)
    launches.update(phase_resilience(dev))
    launches.update(phase_table3(dev))
    phase_card_vs_cpu(dev)
    launches.update(phase_serve(dev, "mamba2-130m"))
    launches.update(phase_serve(dev, "smollm-135m"))
    launches.update(phase_lm_train(dev))
    for arch, layers, expected in ZOO_SERVE:
        launches.update(phase_zoo_serve(dev, arch, layers, expected))
    launches.update(phase_zoo_serve(dev, "kimi-k2-1t-a32b", None,
                                    {"flash_attention": 2}, full=False))
    launches.update(phase_zoo_lm(dev))

    rows = []
    for name, (source, replaces) in KERNELS.items():
        r = main_rows[name]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": launches.get(r.get("fused", name), 0),
                     "fused": r.get("fused"),
                     "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                     "kernel_ms": r["ms"], "device_ms": r["device_ms"],
                     "plain_ms": r["plain_ms"],
                     "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                     "bound_unit": r.get("bound_unit", "fp32"),
                     "bound_fp32_ms": r.get("bound_fp32_ms", r["bound_ms"]),
                     "library_ms": r.get("library_ms"),
                     "library_backend": r.get("library_backend"),
                     "shape": r.get("shape") or [r["n"]]})
        lm = lm_rows.get(name)
        if lm is not None:
            # The same kernel at the LM training path's shape.
            rows[-1]["lm_path"] = {k: lm.get(k) for k in (
                "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_backend")}
        if name in zoo_rows:
            # The same kernel at the model zoo's shapes.
            rows[-1]["zoo"] = [{k: z.get(k) for k in (
                "arch", "shape", "max_abs_err", "f64_err", "plain_f64_err",
                "f64_err_y", "plain_f64_err_y", "ms", "device_ms", "plain_ms",
                "bound_ms", "bound_by", "library_ms", "library_backend")}
                for z in zoo_rows[name]]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
