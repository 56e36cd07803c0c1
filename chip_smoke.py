#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --hymba-lr-witness
    python3 chip_smoke.py --encdec-lr-witness
    python3 chip_smoke.py --model-axis
    python3 chip_smoke.py --dry-run
    python3 chip_smoke.py --samplers

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
   (32, 32, 9, 3, 64) causal, B6 at (32, 32) of mamba2-130m.  Also the
   staged histogram selection (``histogram_range``,
   ``histogram_count``, ``histogram_walk``: three launches of the same
   source, the mesh's cross-shard plan) against the fused launch bit for
   bit at N = 50,000 and 1,281,167 (0.3 invalid, non-finite, all equal,
   nothing valid), each stage timed beside its plain version, a library
   yardstick and its bound, and the staged call beside the fused one in
   turns;
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
   at N = 12,800 (``CHECK_N``: the time limit), 2 KAKURENBO epochs of
   the main path (phase 20 holds 3 under the
   mesh; the time limit) and one epoch of each Table 2
   strategy, under the trainer's defaults (it runs its epochs with
   ``cudnn.deterministic``; the script sets no flag): losses, plans and
   the whole train state bit-identical (and whether two host loops are
   without the flag, ``trainer.CUDNN_DETERMINISTIC`` off, reported); the
   first capture of an unweighted and of a weighted block, with their
   warm-up blocks, leaves a fresh trainer's state as it was, bit for bit
   (as in phase 14 for smollm-135m);
9. restart (N = 12,800): KAKURENBO and SB under the scanned engine crash
   before epoch 2
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
   Adafactor, one epoch, scanned = host loop (the crashes and the
   optimizers at N = 12,800).  Its launch counts, set to 0
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
   tokens.  ``serve()`` decodes through one captured CUDA graph a step
   (``launch/serve.py::capture_decode``); one more call at the same
   settings decodes eagerly (``graph=False``): the row's ``decode`` holds
   both ms a token, the capture's seconds and its pool's bytes beside
   ``nvidia-smi``'s name and power limit, and ``captured_vs_eager`` the
   32 greedy steps from copies of one prefill's cache through the graph
   and through ``model.decode_step``: every step's logits, the tokens and
   the final cache bit for bit, and one replay's device time under the
   profiler.  The kernels themselves are held against their plain versions
   in phase 3, with B1 also on rows a poisoned sample gives (NaN ce and
   pmax where the plain version has them);
14. LM training, ``examples/torch_lm_train.py --full`` at its defaults
   (512 sequences of 32 tokens from ``SyntheticLM``, batch 32, AdamW),
   3 epochs (of the example's 12), through the default engine (CUDA
   graphs), its kernels checked at its shapes in phase 3; with the counts
   set to 0, smollm-135m under baseline, KAKURENBO ("sort") and KAKURENBO
   ("histogram_pallas" + DropTop 0.02), and mamba2-130m under KAKURENBO
   ("sort" + DropTop 0.02): per epoch wall s, loss, F* and backward
   samples; B1's backward at least once a train step, B7 (B6) once a
   layer a forward (at 15 of smollm's 30 layers and 12 of mamba2's 24:
   the time limit), the histogram-select and the rank-select launched; the loss
   must fall and some epoch hide sequences.  Then one train step's
   gradients through the kernel forwards against the plain forwards at full
   width and depth, per leaf (1e-3 relative, the attention at its input's
   fan-in; the reference's init recorded), every leaf a launch without a
   backward left at zero now non-zero; card vs CPU at 2 layers (losses 1e-4
   relative, first plans equal); the host loop = the scanned engine bit for
   bit over 3 KAKURENBO epochs (smollm-135m at 10 of its 30 layers: the
   time limit) and a restart from a crash between two
   blocks of epoch 2 into a trainer from other weights, bit-identical; one
   train step profiled at (32, 32) and (32, 512) for each arch (at the
   runs' depth);
15. zoo serve: ``repro_torch.launch.serve`` at full width in f32 on
   phi3.5-moe-42b-a6.6b (2 of 32 layers: 16 experts top-2), hymba-1.5b
   (16 of 32 layers: attention and SSM heads mean-fused, a 1,024-token
   window except in 3 layers), qwen3-1.7b (28 layers, qk_norm) and
   llava-next-mistral-7b (4 of 32 layers, 576 patch embeddings before
   the prompt), then kimi-k2 reduced: prefill of 4 x 2,048 tokens and 32
   greedy tokens, the B7 (and B6) launches of the one prefill (4; 3 and
   16; 28; 4; 2), prefill and one decode step against the forward (the
   MoE at a capacity no expert overflows), one prefill and one decode
   step profiled, card vs CPU at 2 layers and 4 prompts of 128 tokens;
   decode captured (and once eager) and held captured against eager bit
   for bit as in phase 13, and for hymba also from a ring cache of its
   window's 1,024 slots set 4 short of its wrap, 8 steps across it;
   B7 at these prefill shapes and kimi-k2's (4, 2048, 64, 8, 112), B6 at
   hymba's and B1 at their vocabularies are held in phase 3
   (``zoo_kernel_checks``);
16. zoo LM training, ``examples/torch_lm_train.py --full``'s defaults with
   the counts set to 0: phi3.5-moe at 1 layer (3 epochs) and hymba-1.5b
   at 12 layers, LR 1e-3 (4 epochs; ``--hymba-lr-witness`` below on why not 1e-2),
   kimi-k2 reduced (2 epochs): per epoch wall s, loss,
   F* and backward samples, B1's backward a step, B7 (B6) once a layer a
   forward, the loss falls and some epoch hides sequences; the host loop
   = the scanned engine bit for bit over 2 epochs of phi3.5-moe at 1
   layer; one eager step of each profiled by group (GEMMs, the MoE's
   routing, expert products and dispatch/combine, B6/B7 and their plain
   backward, AdamW).  Each phase frees its models before the next;
17. compression (after phase 12): the main path with
   ``grad_compression=True`` (8-bit error feedback, ``dist/compression.py``):
   host loop = scanned engine bit for bit, the residual included; a crash
   between two blocks of epoch 2 restored (its ``"ef"``) into a trainer
   from other weights, bit-identical; guarded over poisoned samples, every
   held step leaves the residual bit for bit (host loop, scanned =
   host); the 8-step replay compressed against uncompressed, in turns;
   card vs CPU (LR 0.002) within 1e-4;
18. encdec serve (after phase 15's zoo): seamless-m4t-large-v2 at full
   width and depth (24 + 24 layers) through phase 15's path, frames of 4 x
   2,048 beside the prompt: 48 B7 launches a prefill (24 encoder layers
   full, 24 decoder causal), the contracts, the plain cross-attention's
   and B7's ms in a prefill by CUDA events, card vs CPU at 2 + 2 layers;
   B7 at its serve and train shapes and B1 at (256, 256,206) are held in
   phase 3 (``encdec_kernel_checks``);
19. encdec LM training (after phase 16): seamless-m4t at full width and
   8 + 8 of its 24 + 24 layers (the time limit;
   AdamW) over ``FramesLM`` (the example's corpus
   at 8 tokens beside 32 N(0, 1) frames), ``"sort"`` + DropTop 0.02, 12
   epochs at LR 1e-3 (``--encdec-lr-witness`` below on why not 1e-2),
   its launches counted from 0: B1's backward each step, B7 16
   times a forward, the loss falls, some epoch hides more than DropTop's
   tail; the gradient through the kernels vs the plain forwards per leaf
   (1e-3); host = scan bit for bit at 2 + 2 layers; one profiled step.
20. mesh (after phase 17): the data-parallel trainer
   (``TrainConfig.mesh_shape``), the main path at N = 50,000, batch 128,
   8 gradient chunks, 3 KAKURENBO epochs under NCCL at world 1 in this
   process through the scanned engine (the fold's all-gather captured in
   its graphs): the three staged launches once a plan (counts from 0),
   epoch 1's plan = the single-device plan (the fused launch) from the
   same state and permutation, a crash between two blocks of epoch 2
   restored into a trainer from other weights bit-identical, the 8-step
   replay against the single-device one in turns (the fold's cost); then
   at N = 8,192 (``"histogram_pallas"`` and ``"sort"``, DropTop 0.02)
   world 1 under NCCL scanned = its host loop bit for bit (losses, plans,
   train state), and = a world of 2 gloo ranks on this card (host loop;
   ``launch.mesh.spawn``; NCCL refuses two ranks on one GPU) bit for bit.
21. model axis (after phase 20): ``launch/train.py::make_train_step`` on
   a ``("data", "model")`` mesh (``launch/mesh.py::make_data_model_mesh``,
   ``build_ctx`` with FSDP and layer remat).  qwen3-1.7b (28 layers) and
   mamba2-130m (24) at full width, batch 2 x 256 tokens: one AdamW step on
   a (1, 1) mesh under NCCL equals the step without a context bit for bit
   (the loss, the per-sample metrics, every updated leaf; the two runs one
   after the other, the first one's gradients and moments freed before
   the second, its updated leaves kept on the card).  Then a gloo
   world of 4 ranks on this card as (2, 2) (``launch.mesh.spawn``), both
   archs at full width and 4 layers, batch 4 x 256: four AdamW steps over
   ``plan_global_batches`` of a KAKURENBO plan at ``plan_lr``, the first
   one's loss and per-sample losses within 1e-5 of one device and every
   rank's block of every gradient within 1e-4 of the leaf's max |g| (each
   rank runs the one-device step itself), every rank alike; B7 at qwen3's local shape (2, 256, 8, 4, 128) and B6 at
   mamba2's (2, 256) against their plain versions; the card's stream-copy
   rate beside the datasheet's 3.35 TB/s.  Its launches (the mesh runs'
   and the ranks', counted from 0) join the ``kernels`` line.
   The other families and serving (A.9(c)): on the (1, 1) mesh, bit for
   bit against no context, one AdamW step of phi3.5-moe (1 layer, both
   FSDP layouts of its experts, the runs one after the other),
   seamless-m4t (2 + 2 layers; B7 in the encoder and the decoder) and
   llava (2 layers, its 576 patch positions in front), each at 2 x 256;
   and ``Model.prefill`` of 2 x 256 tokens then 8 greedy
   ``decode_step``s of qwen3-1.7b (28 layers), phi3.5-moe (2: one MoE
   layer feeds another) and mamba2-130m (24: B6 in a mesh prefill), the
   logits, the tokens and the gathered cache.  In the gloo world, one
   SGD step at LR 0 (the gradients) of phi3.5-moe at 1 layer,
   expert-parallel (8 of its 16 experts a model rank) in ``"gather"``
   and ``"partial"``, and of seamless-m4t (2 + 2) and llava (2), each
   against the port on one device, computed once before the spawn and
   passed to the ranks through CUDA IPC (the MoE in ``"gather"`` against
   the mean of one device's steps on each data shard's rows): loss and
   per-sample losses within 1e-5, every rank's block of every gradient
   within 1e-4 of the leaf's max |g|; and qwen3-1.7b at 4 layers served
   (prefill of 2 x 256, 8 greedy steps) with the logits within 1e-5 of
   their max of one device's and the same tokens, and again under
   ``seq_parallel_kv`` (the cache's sequence over the model axis) within
   1e-5 of the decode without it.  A batch of 1, which divides no data
   axis (every data rank takes it whole, as the reference's spec guard
   replicates it): mamba2-130m at full depth and hymba-1.5b at 4 layers
   served from a prompt of 2,048 with 32 greedy tokens (logits within
   1e-5 of one device's, the same tokens, the cache whole on each rank)
   and, at 4 layers, one SGD step at LR 0 on 1 x 256 with FSDP (loss and
   per-sample loss within 1e-5, every gradient within 1e-4 of the leaf's
   max: the data ranks' summed shares are one device's gradient); the
   SSMs' ``a_log`` at U[0, 1) (``ssm_decay_control``).
22. dry run (after phase 21, ``phase_dry_run``): qwen3-1.7b at full width
   and 28 layers, one AdamW step of 2 x 256 tokens on a (1, 1) mesh under
   NCCL with no remat, ``remat_policy`` ``"nothing"`` and ``"dots"``: the
   loss and every gradient bit for bit, the step's peak of allocated bytes
   ``nothing <= dots <= none``, each step's seconds; the same step on meta
   tensors over a fake (1, 1) group (``launch/dryrun.py``, in a process
   of its own): the bytes the shards, the optimizer state, the LR and the
   batch asked the card's caching allocator for within 512 B a tensor of
   the record's ``argument_size_in_bytes``, its predicted peak beside the
   card's; kimi-k2 reduced, one Adafactor step at (1, 1) bit for bit the
   step without a context; in phase 21's gloo world, for kimi-k2 reduced
   and qwen3-1.7b at 4 layers, Adafactor's update on sharded leaves from
   one device's gradients within 1e-5 of one device's largest parameter
   change, and a whole step within ``ADAFACTOR_WHOLE_TOL`` (its gradients
   within 1e-4 of their max), with reduced qwen3's float32 and float64
   twins on the host's CPU (the float64 whole step within 1e-5); and
   ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
   train_4k --extrapolate`` on this host: status ``ok``, its seconds; the
   ``long_500k`` cells (batch 1 over 16 data ranks, replicated) of
   hymba-1.5b and mamba2-130m on both production meshes ``ok``, and
   internlm2-20b ``train_4k``'s probes' own FSDP decisions.
23. samplers (after phase 5, ``phase_samplers``): the reference's
   low-level sampler API at N = 1,281,167: ``ISWRSampler``,
   ``ForgetSampler`` (warmup 1), ``InfoBatchSampler``,
   ``KakurenboSampler`` (``"histogram_pallas"`` + DropTop 0.02) and
   ``GradMatchSampler`` on the card and on the CPU from the same state and
   the card's draws, an observation of N/2 ids (with repeats) before each
   of 3 ``begin_epoch``s: indices, masks, pruned sets and InfoBatch's
   weights bit for bit, ISWR's probabilities within 1e-6 relative and
   its draws the CPU's inverse CDF over the card's probabilities, the
   FORGET prune the stable-sort rank window through the rank-select
   (launch counted); Grad-Match with a host reselection at N = 1,024;
   ``SelectiveBackprop`` card = CPU over 8 batches; each card
   ``begin_epoch``'s call ms beside the card's name and power limit.

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
CPU run from weights changed by 1e-7.  ``--encdec-lr-witness`` runs phases
1-2 and then phase 19's seamless-m4t run at the example's LR of 1e-2,
through the kernels and through their plain versions (on the card), and
through the kernels at 2 + 2 layers: per epoch loss and F*, how far the
predictions depend on the input, beside the corpus' unigram loss.
``--model-axis`` runs phases 1-2 and then phase 21 alone, ``--samplers``
phase 23 alone; ``--dry-run``
phases 1-2 and then phase 22 alone (its Adafactor steps in the gloo world
run inside phase 21's world, so not under ``--dry-run``).
Without a CUDA device, or without the
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

#: When this module was loaded (in a spawned rank: its re-import as the
#: main module, before the rank's function runs).
LOADED_AT = time.time()
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


#: Traces ``profiled`` takes before it reports an incomplete one: three
#: traces in a row that lost activities were seen once on the card.
PROFILE_TRIES = 8


def profiled(warm, active, tries: int = PROFILE_TRIES):
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
    require(complete, "the profiler lost device activities in "
                      f"{PROFILE_TRIES} traces")
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
    # The chunked form's products (``ssd.scan_ops``): B6's work, on the
    # tensor cores in 3xTF32.  On the CUDA cores in fp32 the per-token
    # recurrence's 5 N P (decay, outer-product update, C.state) may be
    # fewer; the fp32 bound takes the fewer of the two.
    chunked = ssd.scan_ops(b, s, nh, p, n, chunk)
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
    # The causal half only where causal (``fa.attention_ops``).
    ops = fa.attention_ops(b, s, hq, d, causal)
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
# The low-level sampler API (phase 23)

#: The samplers phase's epochs (``begin_epoch`` calls, observations
#: between) and the share of N each epoch observes (ids drawn with
#: repeats, as ISWR's draws repeat them).
SAMPLER_EPOCHS = 3
SAMPLER_OBSERVED = 0.5
#: Grad-Match's reselection runs on the host (its OMP is quartic in a
#: class's size): at Table 3's N, with 10 classes of 16-d features.
SAMPLER_GM_N = 1024


def smi_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit``'s line ("" without
    one)."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return ""


def recorded_draws(card, host, names: tuple[str, ...]) -> None:
    """``card``'s ``draw_*`` methods record what they draw; ``host``'s
    take the same numbers, copied to its device, in the same order."""
    import collections as col
    queue = col.deque()
    for name in names:
        def drawn(*a, _f=getattr(card, name)):
            out = _f(*a)
            queue.append(out)
            return out
        setattr(card, name, drawn)
        setattr(host, name, lambda *a: queue.popleft().cpu())


def sampler_observations(n: int, epochs: int, seed: int = 7) -> list:
    """Per epoch ``SAMPLER_OBSERVED * n`` ids with repeats and their
    (loss, PA, PC), as numpy."""
    import numpy as np
    r = np.random.default_rng(seed)
    b = int(SAMPLER_OBSERVED * n)
    return [(r.integers(0, n, b).astype(np.int64),
             r.exponential(size=b).astype(np.float32), r.random(b) < 0.7,
             r.random(b).astype(np.float32)) for _ in range(epochs)]


def phase_samplers(dev, n: int = 1_281_167) -> collections.Counter:
    """The reference's low-level sampler API at ImageNet-1K's N:
    ``ISWRSampler``, ``ForgetSampler`` (warmup 1: it prunes at epoch 1
    through the rank-select), ``InfoBatchSampler``, ``KakurenboSampler``
    (``"histogram_pallas"`` + DropTop 0.02: the histogram-select) and
    ``GradMatchSampler`` (at N and, with a reselection, at
    ``SAMPLER_GM_N``) on the card and on the CPU (the plain versions),
    from the same state and the card's draws (``recorded_draws``), an
    observation before each of ``SAMPLER_EPOCHS`` ``begin_epoch``s and
    after the last: the indices, masks, pruned sets and InfoBatch's
    weights bit for bit; ISWR's probabilities within 1e-6 relative and
    its draws equal to the CPU's inverse CDF over the card's
    probabilities (its own draws' differences counted); the prune mask
    the stable-sort rank window, with the rank-select launched; and
    ``SelectiveBackprop`` on the card and the CPU, whose counter draws are
    the same on both, over 8 batches of 1,024.  Each card
    ``begin_epoch``'s call ms beside the card's name and power limit."""
    import numpy as np
    import torch
    from repro_torch.core import (ForgetConfig, ForgetSampler,
                                  GradMatchConfig, GradMatchSampler,
                                  InfoBatchConfig, InfoBatchSampler,
                                  ISWRSampler, KakurenboConfig,
                                  KakurenboSampler, SBConfig,
                                  SelectiveBackprop, planops)
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    cpu = torch.device("cpu")
    epochs = SAMPLER_EPOCHS
    obs = sampler_observations(n, epochs + 1)
    makers = {
        "iswr": (lambda d: ISWRSampler(n, seed=0, device=d), ("draw_uniform",)),
        "forget": (lambda d: ForgetSampler(n, ForgetConfig(0.3, 1), seed=0,
                                           device=d), ("draw_permutation",)),
        "infobatch": (lambda d: InfoBatchSampler(
            n, InfoBatchConfig(total_epochs=epochs + 1), seed=0, device=d),
            ("draw_uniform", "draw_permutation")),
        "kakurenbo": (lambda d: KakurenboSampler(n, KakurenboConfig(
            selection="histogram_pallas", drop_top_fraction=0.02), seed=0,
            device=d), ("draw_permutation",)),
        "gradmatch": (lambda d: GradMatchSampler(n, 10, seed=0, device=d),
                      ("draw_permutation",))}
    row = {"phase": "samplers", "n": n, "epochs": epochs,
           "nvidia_smi": smi_line(), "samplers": {}}
    launches = collections.Counter()
    fails = []

    def observe(s, e):
        idx, loss, pa, pc = obs[e]
        s.observe(idx, torch.from_numpy(loss).to(s.device),
                  torch.from_numpy(pa).to(s.device),
                  torch.from_numpy(pc).to(s.device), e)

    for name, (make, draws) in makers.items():
        card, host = make(dev), make(cpu)
        recorded_draws(card, host, draws)
        rec = {"begin_epoch_ms": [], "equal": []}
        backend.reset_launches()
        for e in range(epochs):
            if name != "gradmatch":
                observe(card, e)
                observe(host, e)
            sync(dev)
            t1 = time.perf_counter()
            got = card.begin_epoch() if name == "gradmatch" \
                else card.begin_epoch(e)
            sync(dev)
            rec["begin_epoch_ms"].append((time.perf_counter() - t1) * 1e3)
            want = host.begin_epoch() if name == "gradmatch" \
                else host.begin_epoch(e)
            if name == "iswr":
                p, q = card.probs.cpu().double(), host.probs.double()
                rel = float(((p - q).abs() / q).max())
                u = planops.uniform(torch.Generator(device=dev).manual_seed(e),
                                    n)
                rec.setdefault("probs_rel_err", []).append(rel)
                rec.setdefault("draws_differing", []).append(
                    int((torch.from_numpy(got) != torch.from_numpy(want))
                        .sum()))
                # Given equal probabilities the draws are equal: the CPU's
                # inverse CDF over the card's probabilities and uniforms.
                same = torch.equal(
                    planops.with_replacement(card.probs.cpu(), u.cpu()),
                    planops.with_replacement(card.probs, u).cpu())
                ok = rel <= 1e-6 and same
            elif name == "forget":
                ok = (np.array_equal(got, want)
                      and torch.equal(card.pruned_mask.cpu(), host.pruned_mask)
                      and card.should_restart == host.should_restart)
                if e == 1:
                    st = card.state
                    scores = torch.where(st.pa | (st.forget_events > 0),
                                         st.forget_events.float(), torch.inf)
                    k = int(math.floor(0.3 * n))
                    window = planops.stable_rank_order(scores) < k
                    ok = ok and card.should_restart and torch.equal(
                        card.pruned_mask, window) and int(
                        card.pruned_mask.sum()) == k
                    rec["pruned"] = int(card.pruned_mask.sum())
            elif name == "infobatch":
                ok = (np.array_equal(got[0], want[0])
                      and np.array_equal(got[1], want[1])
                      and card.weights.tobytes() == host.weights.tobytes())
                rec.setdefault("pruned", []).append(len(got[1]))
            elif name == "kakurenbo":
                ok = all(np.array_equal(getattr(got, f), getattr(want, f))
                         for f in ("visible_indices", "hidden_indices",
                                   "moveback_indices")) and (
                    got.hidden_fraction, got.lr_scale) == (
                    want.hidden_fraction, want.lr_scale)
                rec.setdefault("hidden", []).append(len(got.hidden_indices))
            else:
                ok = np.array_equal(got, want)
            rec["equal"].append(bool(ok))
            if not ok:
                fails.append(f"{name} epoch {e}")
        if name != "gradmatch":
            observe(card, epochs)
            observe(host, epochs)
        rec["launches"] = dict(backend.LAUNCHES)
        launches.update(backend.LAUNCHES)
        row["samplers"][name] = rec
        del card, host
    # Grad-Match with a reselection (host OMP) at Table 3's N.
    r = np.random.default_rng(8)
    feats = r.normal(size=(SAMPLER_GM_N, 16)).astype(np.float32)
    labels = np.arange(SAMPLER_GM_N) % 10
    cfg = GradMatchConfig(interval=2)
    card = GradMatchSampler(SAMPLER_GM_N, 10, cfg, seed=0, device=dev)
    host = GradMatchSampler(SAMPLER_GM_N, 10, cfg, seed=0, device=cpu)
    recorded_draws(card, host, ("draw_permutation",))
    gm = {"n": SAMPLER_GM_N, "equal": []}
    for e in range(epochs):
        f = feats + np.float32(0.05 * e) * r.normal(size=feats.shape).astype(
            np.float32)
        card.maybe_reselect(e, f, labels)
        host.maybe_reselect(e, f, labels)
        ok = (card.subset.tobytes() == host.subset.tobytes()
              and card.weights.tobytes() == host.weights.tobytes()
              and np.array_equal(card.begin_epoch(), host.begin_epoch()))
        gm["equal"].append(bool(ok))
        if not ok:
            fails.append(f"gradmatch (N={SAMPLER_GM_N}) epoch {e}")
    gm["subset"], gm["omp_seconds"] = len(card.subset), card.omp_seconds
    row["samplers"]["gradmatch_reselect"] = gm
    # SelectiveBackprop: counter draws, the same numbers on both devices.
    losses = np.random.default_rng(9).exponential(size=(8, 1024)).astype(
        np.float32)
    masks = [[s.select(x) for x in losses]
             for s in (SelectiveBackprop(SBConfig(), seed=0, device=d)
                       for d in (dev, cpu))]
    ok = all(np.array_equal(a, b) for a, b in zip(*masks))
    row["samplers"]["selective_backprop"] = {
        "equal": ok, "kept": [float(m.mean()) for m in masks[0]]}
    if not ok:
        fails.append("selective_backprop")
    row["launches"] = dict(launches)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    require(not fails, f"samplers: card and CPU differ: {fails}")
    if dev.type == "cuda":
        require(row["samplers"]["forget"]["launches"].get("rank_select", 0)
                > 0, "samplers: FORGET's prune never launched rank_select")
        require(row["samplers"]["kakurenbo"]["launches"].get(
            "histogram_select", 0) >= epochs,
                "samplers: KAKURENBO's plans launched histogram_select "
                f"{row['samplers']['kakurenbo']['launches']}")
    return launches


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
                 lr: float = 0.05, tau: float = 0.7, ds=None,
                 selection: str = "histogram_pallas", **tc_kw):
    """The main path's ``Trainer`` (``examples/torch_quickstart.py --full``):
    SGD 0.9, cosine LR, KAKURENBO on ``"histogram_pallas"`` (or
    ``selection``) with DropTop 0.02, fused scoring, the default engine
    unless ``tc_kw`` says; ``ds`` replaces ``SyntheticClassification(n)``
    (a poisoned copy)."""
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
                                               selection=selection,
                                               drop_top_fraction=0.02),
                     **tc_kw)
    return Trainer(tc, model, None, ds, test, logits_fn=_logits_fn, device=dev)


def train(dev, strategy: str, n: int, n_test: int, epochs: int, model,
          perms=None, checks=None, lr: float = 0.05, tau: float = 0.7,
          **tc_kw):
    tr = main_trainer(dev, strategy, n, n_test, epochs, model, lr, tau,
                      **tc_kw)
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


def phase_card_vs_cpu(dev, n: int = 2048, epochs: int = 2, lr: float = 0.005,
                      **tc_kw) -> dict:
    """The same small KAKURENBO run on the card and on the CPU (``tc_kw``:
    more trainer settings, e.g. compression), losses within 1e-4."""
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
                           perms=[p.to(d) for p in perms], lr=lr, tau=0.1,
                           **tc_kw)

    def max_rel(a, b):
        return max(abs(x.train_loss - y.train_loss) / abs(y.train_loss)
                   for x, y in zip(runs[a], runs[b]))

    rel = max_rel(dev.type, "cpu")
    row = {"phase": "card_vs_cpu", "n": n, "epochs": epochs, "lr": lr,
           "tau": 0.1, "trainer_settings": tc_kw,
           "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
           "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "loss": {k: [h.train_loss for h in v] for k, v in runs.items()},
           "F_star": {k: [h.hidden_fraction for h in v]
                      for k, v in runs.items()},
           "max_rel_diff": rel,
           "perturbed_max_rel_diff": max_rel("cpu_perturbed", "cpu")}
    emit(row)
    require(rel <= 1e-4, f"card vs CPU losses differ by {rel} relative "
                         f"({tc_kw})")
    return row


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
#: The main path's N in the phases that hold two runs of it to each other
#: bit for bit (engines, restart, the supervised crashes and the
#: optimizers): 100 batches of 128 where the train phase has 50,000 (the
#: time limit; the contracts do not depend on N).
CHECK_N = 12_800
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


def phase_resilience(dev, n: int = 50_000, epochs: int = 2,
                     guard_epochs: int = 2, crash_n: int = CHECK_N) -> dict:
    """The resilient runtime on the main path (paper CNN, full width,
    ``SyntheticClassification(50_000)``, KAKURENBO ``"histogram_pallas"`` +
    DropTop 0.02, fused scoring), under the trainer's defaults (no cuDNN
    flag set here); the guard's, the host-observe path's and the poisoned
    runs over ``guard_epochs`` and the crash recoveries over ``epochs`` (2
    each: the time limit), the crash recoveries and the optimizers at
    ``crash_n`` samples:

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
      seven Table 2 strategies scanned (guard on; FORGET prunes in the
      last epoch, the crashed one, through the rank-select), Grad-Match at
      N = 1,024, KAKURENBO on the host loop;
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
           "crash_n": crash_n, "epochs": epochs,
           "guard_epochs": guard_epochs}

    def model(seed=0):
        return CNN(CONFIG, torch.Generator().manual_seed(seed))

    def finite(tr):
        return all(bool(torch.isfinite(p).all()) for p in tr.model.parameters())

    # The guard on a clean run.
    clean, kept = {}, {}
    for engine in ("scan", "host"):
        runs = {}
        for policy in ("off", "skip_update"):
            tr = main_trainer(dev, "kakurenbo", n, 0, guard_epochs, model(),
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
    tr = main_trainer(dev, "kakurenbo", n, 0, guard_epochs, model(),
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
        tr = main_trainer(dev, "kakurenbo", n, 0, guard_epochs, model(),
                          ds=ds, guard_policy=policy)
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
            nxt = tr.strategy.plan(guard_epochs)
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
                dev, strategy, crash_n, 0, epochs, model(), engine="scan",
                guard_policy="skip_update",
                forget=ForgetConfig(fraction=0.3, warmup_epochs=epochs - 1),
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
        return main_trainer(dev, "kakurenbo", crash_n, 0, epochs, model(),
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
            tr = main_trainer(dev, "kakurenbo", crash_n, 0, 1, model(),
                              lr=1e-3, engine=engine, optimizer=name,
                              optimizer_hp={})
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
    require(complete, f"the profiler lost device activities in {PROFILE_TRIES} "
                      "traces")
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


def kernel_share(dev, fn, op: str, module=None) -> float:
    """The device time (ms) of wrapper ``ops.<op>`` (or ``module.<op>``)
    inside one call of ``fn``, by CUDA events around every call (a check on
    the profiler's figure)."""
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

    with (patched_op(op, wrap) if module is None
          else patched_attr(module, op, wrap(getattr(module, op)))):
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
    paths through it can tell right from wrong.  The encoder-decoder's
    self-attention in both stacks and its cross-attention alike.  A model
    without attention (mamba2) is returned as it is."""
    if not cfg.num_heads:
        return params
    dh = cfg.resolved_head_dim
    blocks = ([params["layers"]["attn"]] if "layers" in params else
              [params["enc_layers"]["attn"], params["dec_layers"]["attn"],
               params["dec_layers"]["xattn"]])
    for a in blocks:
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


def with_inputs(tokens, extra) -> dict:
    """A prompt batch: the tokens, and ``extra`` (None, or the VLM's patch
    embeddings or the encoder-decoder's frames by name)."""
    return {"tokens": tokens, **(extra or {})}


def serve_contract(cfg, model, params, ids, pe, prompt: int):
    """Prefill of ``ids[:, :prompt]`` (after the VLM's patches, or over the
    encoder-decoder's frames: ``pe``): its last logits against the full
    forward's at S - 1 (2e-4), one decode step of ``ids[:, prompt]``
    against the forward's at S (3e-3) (``tests/test_arch_smoke.py:81``), S
    counting the patches.  Returns both (ok, max abs difference), the
    forward's logits and the cache."""
    import torch
    from repro_torch.models.model import family_module
    n = cfg.num_patch_tokens + prompt
    with torch.no_grad():
        full, _, _ = family_module(cfg).forward(cfg, params,
                                                with_inputs(ids, pe))
        lg, cache = model.prefill(params, with_inputs(ids[:, :prompt], pe),
                                  max_len=n + 1)
        lg2, _ = model.decode_step(params, ids[:, prompt:], cache)
    return (close(lg[:, 0], full[:, n - 1], 2e-4),
            close(lg2[:, 0], full[:, n], 3e-3), full, cache)


def serve_card_vs_cpu(dev, small, p_dev, p_cpu, ids, pe, max_len: int,
                      gen: int) -> tuple[dict, list]:
    """``small``'s prefill of the CPU prompt batch ``ids`` (with ``pe``, the
    VLM's patches or the encdec's frames) and ``gen`` greedy decode steps on
    the card (the
    kernels) and on the CPU (their plain versions), from the same weights:
    the prefill logits and every cache tensor (snapshot copies: decode
    writes the cache in place) within 1e-4, the greedy tokens equal.
    Returns the row's entry and the checks that failed."""
    import torch
    from repro_torch.models import build_model
    cpu = torch.device("cpu")
    runs = {}
    for name, p, d in (("card", p_dev, dev), ("cpu", p_cpu, cpu)):
        m = build_model(small, device=d)
        t = time.perf_counter()
        with torch.no_grad():
            lg, c = m.prefill(p, with_inputs(
                ids.to(d), {k: v.to(d) for k, v in (pe or {}).items()}),
                max_len=max_len)
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


def captured_vs_eager(dev, model, params, token, cache: dict,
                      gen: int) -> tuple[dict, list]:
    """``gen`` greedy decode steps from copies of ``cache``, ``token`` (B,
    1) first, through ``launch/serve.py::capture_decode`` (one CUDA graph)
    and through ``model.decode_step`` (eager), in turns: every step's
    logits, the greedy tokens and the final cache (k, v, the SSM state,
    the conv buffer, ``len``) must be equal bit for bit, and the captured
    step must refuse the eager run's cache.  Then one replay of the
    captured step under the profiler (the fullest of three traces): its
    device time.  Returns
    the row's entry and the checks that failed."""
    import torch
    from repro_torch.launch.serve import capture_decode
    eager = {k: v.clone() for k, v in cache.items()}
    graphed = {k: v.clone() for k, v in cache.items()}
    step = capture_decode(model, params, token, graphed)
    apart, toks_e, toks_g = [], [], []
    tok_e = tok_g = token
    with torch.no_grad():
        for i in range(gen):
            lg_e, eager = model.decode_step(params, tok_e, eager)
            lg_g, graphed = step(params, tok_g, graphed)
            if not torch.equal(lg_e, lg_g):
                apart.append([i, float((lg_e - lg_g).abs().max())])
            tok_e, tok_g = lg_e[:, -1:].argmax(-1), lg_g[:, -1:].argmax(-1)
            toks_e.append(tok_e)
            toks_g.append(tok_g)
    same_tokens = torch.equal(torch.cat(toks_e, 1), torch.cat(toks_g, 1))
    cache_equal = {k: torch.equal(eager[k], graphed[k]) for k in sorted(eager)}
    failed = []
    if apart:
        failed.append(f"captured decode logits part from eager ones at "
                      f"(step, max abs diff) {apart[:4]}")
    if not same_tokens:
        failed.append("captured and eager greedy tokens differ")
    if not all(cache_equal.values()):
        failed.append("captured and eager final caches differ in "
                      f"{[k for k, ok in cache_equal.items() if not ok]}")
    try:                      # a cache it was not captured on is refused
        step(params, tok_g, eager)
        refused = False
    except ValueError:
        refused = True
    if not refused:
        failed.append("the captured step ran on a cache it was not "
                      "captured on")
    # Replays past the checked steps write on: the cache clamps the write.
    # A trace can lose device activities, and a replay's one host call
    # cannot show it (``profiled``'s check): keep the fullest of three.
    with torch.no_grad():
        traces = [device_breakdown(dev, lambda: step(params, tok_g, graphed))
                  for _ in range(3)]
    replay = max(traces, key=lambda t: t["device_kernels"])
    row = {"steps": gen, "start_len": int(cache["len"]),
           "logits_equal_steps": gen - len(apart), "tokens_equal": same_tokens,
           "cache_equal": cache_equal, "refuses_other_cache": refused,
           "capture_s": step.capture_s,
           "pool_bytes": step.pool_bytes,
           "replay_device_busy_ms": replay["device_busy_ms"],
           "replay_traces_kernels": [t["device_kernels"] for t in traces],
           "replay_breakdown": replay}
    del step, eager, graphed
    return row, failed


def serve_timings(stats: dict, eager: dict) -> dict:
    """The decode's time a token captured (``stats``, ``serve()``'s
    default on the card) and eager (``eager``, ``graph=False``) and the
    capture's seconds, beside the card's name and power limit (the
    graph's pool: ``captured_vs_eager``'s ``pool_bytes``)."""
    return {"nvidia_smi": smi_line(),
            "decode_ms_per_token_captured": stats["decode_per_token_ms"],
            "decode_ms_per_token_eager": eager["decode_per_token_ms"],
            "decode_capture_s": stats.get("decode_capture_s"),
            "eager_prefill_ms": eager["prefill_s"] * 1e3,
            "same_tokens": bool((stats["generated"]
                                 == eager["generated"]).all())}


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
    # The call decoding eagerly, one PyTorch call at a time, comes first:
    # it also warms cuBLAS and the caching allocator at these shapes for
    # the second, the one measured and counted (decoding captured).
    t1 = time.perf_counter()
    eager = serve(cfg.name, reduced=False, batch=batch, prompt_len=prompt,
                  gen_tokens=gen, seed=0, verbose=False, device=dev,
                  graph=False)
    eager_s = time.perf_counter() - t1

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
           "wall_s": wall, "decode": serve_timings(stats, eager),
           "eager_wall_s": eager_s}

    # Prefill matches forward (tests/test_arch_smoke.py:81), at full width
    # and depth.  The dense family's checks draw the same seeded weights
    # with the attention projections at their input's fan-in: under the
    # reference's init its 30 layers are chaotic in float32 (see
    # attention_fan_in; conditioning_control measures it on every run).
    def weights(m, c):
        p = m.init(torch.Generator().manual_seed(0))
        return attention_fan_in(p, c) if c.family == "dense" else p

    model = build_model(cfg, device=dev)
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
        # The captured decode against the eager one, from one prefill.
        lg, cache = model.prefill(params, {"tokens": ids[:, :prompt]},
                                  max_len=prompt + gen)
    row["captured_vs_eager"], failed_graph = captured_vs_eager(
        dev, model, params, lg[:, -1:].argmax(-1), cache, gen)
    del full, cache, params, lg

    # Card (the kernel) against CPU (its plain version), full width, cut
    # depth: the prefill logits and every cache tensor.
    small = dataclasses.replace(cfg, num_layers=cpu_layers)
    p_cpu = weights(build_model(small, device="cpu"), small)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (batch, prompt)))
    # The cache holds the decoded tokens too, as serve() sizes it.
    row["card_vs_cpu"], failed = serve_card_vs_cpu(
        dev, small, tree_to(p_cpu, dev), p_cpu, ids, None, prompt + cpu_gen,
        cpu_gen)
    emit(row)
    failed += failed_graph
    require(not failed, "; ".join(failed))
    return launches


# ---------------------------------------------------------------------------
# LM training: smollm-135m (B7) and mamba2-130m (B6), sequences scored by B1
# ---------------------------------------------------------------------------

#: The leaves a launch without a backward left at zero gradient, by family
#: (the attention's inputs, or the scan's and the conv's parameters); the
#: SSM's ``w_in`` columns for x, B, C and dt are checked apart.
FAULT_LEAVES = {"dense": ("ln1", "attn.wq", "attn.wk", "attn.wv"),
                "encdec": ("ln1", "attn.wq", "attn.wk", "attn.wv"),
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


class FramesLM:
    """The encoder-decoder's batch source: ``SyntheticLM``'s sequences of
    ``seq // DEC_FRACTION`` tokens (the example's corpus) beside N(0, 1)
    frames of (seq, ``dim``) from ``default_rng(seed)``.  The package has
    no frames dataset, as the reference has none
    (``tests/test_arch_smoke.py`` builds its encdec batch the same way)."""

    def __init__(self, num_samples: int, seq: int, dim: int, seed: int = 0):
        import numpy as np
        from repro_torch.data import SyntheticLM
        from repro_torch.models.model import DEC_FRACTION
        self.lm = SyntheticLM(num_samples=num_samples,
                              seq_len=seq // DEC_FRACTION, vocab_size=64,
                              order=1, easy_fraction=0.7, seed=seed)
        self.frames = np.random.default_rng(seed).normal(
            size=(num_samples, seq, dim)).astype(np.float32)
        self.num_samples = num_samples

    def get(self, indices) -> dict:
        import numpy as np
        batch = self.lm.get(indices)
        batch["frames"] = self.frames[np.asarray(indices)]
        return batch


def encdec_trainer(*, full: bool = True, steps: int = 200, batch: int = 32,
                   seq_len: int = 32, num_samples: int = 512,
                   strategy: str = "kakurenbo", selection: str = "sort",
                   drop_top: float = 0.0, ckpt_dir: str | None = None,
                   device=None, seed: int = 0, model=None, lr: float = 1e-2,
                   num_layers: int | None = None, **tc_kw):
    """``examples/torch_lm_train.py``'s trainer (its settings and flags)
    for seamless-m4t-large-v2 over ``FramesLM``: frames of ``seq_len``
    positions, ``seq_len // DEC_FRACTION`` decoder tokens."""
    import torch
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import KakurenboConfig, LRSchedule
    from repro_torch.models import LM
    from repro_torch.train import Trainer, TrainConfig
    cfg = get_arch(ENCDEC) if full else get_arch(ENCDEC).reduced()
    if num_layers is not None:
        cfg = cut_depth(cfg, num_layers)
    ds = FramesLM(num_samples, seq_len, cfg.encoder_input_dim)
    epochs = max(steps // (num_samples // batch), 1)
    tc = TrainConfig(**{
        "epochs": epochs, "batch_size": batch, "strategy": strategy,
        "optimizer": "adamw", "optimizer_hp": {},
        "lr": LRSchedule(lr, "cosine", epochs, 1),
        "kakurenbo": KakurenboConfig(
            max_fraction=0.3, selection=selection, drop_top_fraction=drop_top,
            fraction_milestones=(0, epochs // 3, epochs // 2,
                                 3 * epochs // 4)),
        "checkpoint_dir": ckpt_dir or None,
        "checkpoint_every": max(epochs // 4, 1), "seed": seed, **tc_kw})
    if model is None:
        model = LM.init(cfg, torch.Generator(device=device).manual_seed(seed),
                        device)
    return Trainer(tc, model, lambda m, b: m.loss_and_metrics(b), ds, None,
                   device=device)


def make_lm_trainer(arch: str, **kw):
    """The LM example's ``make_trainer`` for a decoder-only arch;
    ``encdec_trainer`` (its settings over frames) for the encoder-decoder,
    which the example refuses (its corpus has no frames)."""
    if arch == ENCDEC:
        return encdec_trainer(**kw)
    return lm_example().make_trainer(arch, **kw)


def frames_batch(dev, dim: int, n: int = 32, seq: int = 32) -> dict:
    """``FramesLM``'s first ``n`` rows (frames ``dim`` wide) on ``dev``."""
    import numpy as np
    import torch
    ds = FramesLM(n, seq, dim)
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
    ``seq`` within the window; the encdec's encoder and decoder layers),
    B6 in every SSM layer."""
    from repro_torch.models import transformer
    if cfg.family == "encdec":
        return {"flash_attention": cfg.num_encoder_layers + cfg.num_layers}
    out = {}
    if cfg.family != "ssm":
        out["flash_attention"] = sum(
            g or seq <= cfg.attn_window
            for g in transformer.global_layer_flags(cfg))
    if cfg.family in ("ssm", "hybrid"):
        out["ssd_scan"] = cfg.num_layers
    return out


#: Train steps of the LM phases' runs: 3 epochs of 16 (the example's
#: default is 200, 12 epochs; cut for the script's time limit, PERF.md §4).
LM_STEPS = 48


def lm_train_run(dev, arch: str, strategy: str, selection: str = "sort",
                 drop_top: float = 0.0, full: bool = True,
                 layers: int | None = None, steps: int = LM_STEPS,
                 lr: float = 1e-2) -> tuple[dict, collections.Counter]:
    """``examples/torch_lm_train.py --full`` at its defaults (512 sequences
    of 32 tokens, batch 32) for ``steps`` (``LM_STEPS``: 3 epochs) under
    the default engine, no checkpoints, at ``layers`` layers (None: the
    arch's depth) and base LR ``lr`` (``full=False``: the reduced config,
    a rehearsal on the CPU).
    Returns its row and the kernel launches it made."""
    import torch
    from repro_torch.kernels import backend
    before = collections.Counter(backend.LAUNCHES)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    tr = make_lm_trainer(arch, full=full, strategy=strategy,
                         selection=selection, drop_top=drop_top,
                         ckpt_dir=None, device=dev, num_layers=layers,
                         steps=steps, lr=lr)
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
        # More than DropTop's top tail: the low-loss tail hides too.
        require(any(h.hidden_fraction > drop_top for h in hist),
                f"{arch}: kakurenbo hid nothing beyond DropTop's "
                f"{drop_top}: {row['F_star']}")
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
    model = build_model(cfg, device=dev)
    attends = cfg.family in ("dense", "encdec")
    if cfg.family == "encdec":
        batch = frames_batch(dev, cfg.encoder_input_dim)
    else:
        batch = lm_batch(dev)
    di = cfg.ssm.d_inner or cfg.ssm.expand * cfg.d_model if cfg.ssm else 0
    row = {"phase": "lm_grad_check", "arch": arch, "batch": [32, 32],
           "tol": LM_GRAD_TOL}
    inits = ["checked"] + (["reference_init"] if attends else [])
    for name in inits:
        params = model.init(torch.Generator(device=dev).manual_seed(0)
                            if cfg.family == "encdec"
                            else torch.Generator().manual_seed(0))
        if name == "checked" and attends:
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
                     "nonfinite_grad_leaves": [
                         sum(not bool(torch.isfinite(g[n]).all()) for n in g)
                         for g in (gk, gp)],
                     "max_rel_err": rel[worst], "worst_leaf": worst,
                     "fault_leaves": len(fault),
                     "fault_leaves_min_norm": min(fault.values()),
                     "fault_leaves_max_rel_err": max(rel[n.split("[")[0]]
                                                     for n in fault)}
        if name == "checked":
            require(all(nk.get(k) == n
                        for k, n in layer_kernels(cfg, 32).items())
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
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
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
                       full: bool = True, layers: int | None = 10) -> dict:
    """The example's trainer at full width, at ``layers`` layers (10 of
    smollm-135m's 30: the script's time limit; None: the
    arch's depth), for 3 KAKURENBO epochs
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
                               checkpoint_every=2,
                               num_layers=layers if full else None)

    runs = {}
    for engine in ("host", "scan"):
        tr = trainer(engine)
        hist, plans = recorded_run(tr)
        runs[engine] = ([h.train_loss for h in hist], plans, train_state(tr),
                        [h.wall_time for h in hist], tr.engine.name)
        del tr
    (lh, ph, sh, wh, eh), (ls, ps, ss, ws, es) = runs["host"], runs["scan"]
    diff = state_diff(sh, ss)
    row = {"phase": "lm_engines_restart", "arch": arch,
           "layers": layers if full else None,
           "epochs": len(lh),
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
    tr = make_lm_trainer(arch, full=full, seq_len=seq, num_samples=64,
                         ckpt_dir=None, device=dev, num_layers=layers)
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
           # False: the trace lost device activities (PROFILE_TRIES tries), so
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


#: The LM runs' and their profiled steps' depth: 15 of smollm-135m's 30
#: layers and 12 of mamba2-130m's 24 (the script's time limit; the
#: gradient check and card vs CPU keep theirs).
LM_LAYERS = {"smollm-135m": 15, "mamba2-130m": 12}


def phase_lm_train(dev, full: bool = True) -> collections.Counter:
    """LM training (``examples/torch_lm_train.py --full`` at
    ``LM_LAYERS``; its kernels at its shapes are checked in
    ``phase_kernels``): smollm-135m under
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
        _, got = lm_train_run(dev, arch, strategy, selection, drop_top, full,
                              layers=LM_LAYERS[arch] if full else None)
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
            lm_step_breakdown(dev, arch, seq, full,
                              LM_LAYERS[arch] if full else None)
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
#: phi3.5-moe at 2 and llava at 4 of their 32 layers (4 and 8 until the
#: model axis' phase took their time), hymba's 13 windowed layers (of 16
#: served, of its 32: the time limit)
#: attend in plain PyTorch past the window of 1,024 (B7 has no window; the
#: reference's windowed attention is jnp).
ZOO_SERVE = (("phi3.5-moe-42b-a6.6b", 2, {"flash_attention": 2}),
             ("hymba-1.5b", 16, {"flash_attention": 3, "ssd_scan": 16}),
             ("qwen3-1.7b", None, {"flash_attention": 28}),
             ("llava-next-mistral-7b", 4, {"flash_attention": 4}))


def cut_depth(cfg, layers: int):
    """``cfg`` at ``layers`` layers (the encoder-decoder's two stacks
    alike, as ``launch/serve.py --layers`` cuts them)."""
    return dataclasses.replace(
        cfg, num_layers=layers,
        num_encoder_layers=layers if cfg.num_encoder_layers else 0)


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


def prompt_inputs(dev, cfg, batch: int, seed: int, prompt: int):
    """A prompt batch's inputs besides the tokens, by name: the VLM's
    patch embeddings, the encoder-decoder's N(0, 1) frames over ``prompt``
    positions (as ``launch/serve.py`` draws them); None for the other
    families."""
    import numpy as np
    import torch
    from repro_torch.models.transformer import VLM_PATCH_DIM
    if cfg.family == "vlm":
        name, shape = "patch_embeds", (batch, cfg.num_patch_tokens,
                                       VLM_PATCH_DIM)
    elif cfg.family == "encdec":
        name, shape = "frames", (batch, prompt, cfg.encoder_input_dim)
    else:
        return None
    return {name: torch.from_numpy(np.random.default_rng(seed).normal(
        size=shape).astype(np.float32)).to(dev)}


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
    from repro_torch.models import attention, build_model
    from repro_torch.models.common import map_defs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    if layers is not None:
        cfg = cut_depth(cfg, layers)
    kw = dict(reduced=not full, batch=batch, prompt_len=prompt, seed=0,
              verbose=False, device=dev, num_layers=layers)
    # The call decoding eagerly, one PyTorch call at a time, comes first:
    # it also warms cuBLAS and the allocator for the one measured and
    # counted (decoding captured).
    t0 = time.perf_counter()
    eager = serve(arch, gen_tokens=gen, graph=False, **kw)
    eager_s = time.perf_counter() - t0
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
        lambda d: math.prod(d.shape), build_model(cfg, device="cpu").param_defs())))
    row = {"phase": "zoo_serve", "arch": arch, "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers,
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
           "wall_s": wall, "decode": serve_timings(stats, eager),
           "eager_wall_s": eager_s}
    require(got == want, f"{arch} serve launched {got}, not {want}")
    require(toks.shape == (batch, gen) and bool(
        ((toks >= 0) & (toks < cfg.vocab_size)).all()),
        f"{arch}: serve generated {toks.shape} tokens outside the vocabulary")

    # The contract, on weights drawn on the card.
    checked = no_drop(cfg)
    model = build_model(checked, device=dev)
    params = attention_fan_in(model.init(
        torch.Generator(device=dev).manual_seed(0)), cfg)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (batch, prompt + 1))).to(dev)
    pe = prompt_inputs(dev, cfg, batch, 1, prompt)
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

    # The captured decode against the eager one from one prefill (sized
    # as serve() sizes it), then where the time goes: the served config's
    # prefill and decode step.
    served = build_model(cfg, device=dev)
    with torch.no_grad():
        lg, cache = served.prefill(params, with_inputs(ids[:, :prompt], pe),
                                   max_len=npatch + prompt + gen)
    row["captured_vs_eager"], failed_graph = captured_vs_eager(
        dev, served, params, lg[:, -1:].argmax(-1), cache, gen)
    del lg
    if cfg.family == "hybrid" and cfg.attn_window is not None:
        # A ring cache of the window's slots, 4 slots short of its wrap.
        ring = served.init_cache(batch, cfg.attn_window + 16, torch.float32,
                                 ring=True)
        ring["len"].fill_(cfg.attn_window - 4)
        row["ring"], failed_ring = captured_vs_eager(
            dev, served, params, ids[:, prompt:], ring, 8)
        row["ring"]["slots"] = ring["k"].shape[2]
        failed_graph += [f"ring: {f}" for f in failed_ring]
        del ring
    with torch.no_grad():

        def prefill():
            return served.prefill(params, with_inputs(ids[:, :prompt], pe))

        def step():
            return served.decode_step(params, ids[:, prompt:], cache)

        row["prefill_breakdown"] = device_breakdown(dev, prefill)
        if cfg.family == "encdec" and dev.type == "cuda":
            # The plain cross-attention (bmm GEMMs and a softmax inside
            # attention.cross_attend) and B7, by CUDA events around them.
            brk = row["prefill_breakdown"]
            brk["cross_attention_ms_by_cuda_events"] = kernel_share(
                dev, prefill, "cross_attend", attention)
            brk["kernel_ms_by_cuda_events"] = kernel_share(
                dev, prefill, "flash_attention")
        row["decode_breakdown"] = device_breakdown(dev, step)
    del params, cache, model, served
    free_memory()

    # Card (B6/B7) against CPU (their plain versions) at cut depth, on
    # weights drawn on the card.
    small = cut_depth(cfg, min(cpu_layers, cfg.num_layers))
    p_dev = attention_fan_in(build_model(small, device=dev).init(
        torch.Generator(device=dev).manual_seed(3)), small)
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (cpu_batch, cpu_prompt)))
    row["card_vs_cpu"], failed = serve_card_vs_cpu(
        dev, small, p_dev, tree_to(p_dev, torch.device("cpu")), ids,
        prompt_inputs(torch.device("cpu"), cfg, cpu_batch, 2, cpu_prompt),
        npatch + cpu_prompt + cpu_gen, cpu_gen)
    row["seconds"] = time.perf_counter() - t0
    del p_dev
    free_memory()
    emit(row)
    failed += failed_graph
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
    t0 = time.perf_counter()
    runs = {}
    for engine in ("host", "scan"):
        tr = make_lm_trainer(arch, full=full, steps=steps, device=dev,
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
#: hidden in 12 epochs); it trains at 1e-3, as its CPU test does.  Both
#: phi3.5-moe runs ``LM_STEPS`` (3 epochs of the example's 12: the time
#: limit) at 1 of its 32 layers (32 and 2 until the model axis' phase took
#: their time; 2 layers fit one card: PERF.md §4), hymba 4 epochs (it
#: hides from epoch 2 on) at 12 of its 32 layers.
ZOO_LM = (("phi3.5-moe-42b-a6.6b", 1, True, 1e-2, LM_STEPS),
          ("hymba-1.5b", 12, True, 1e-3, 64),
          ("kimi-k2-1t-a32b", None, False, 1e-2, 32))


def phase_zoo_lm(dev, full: bool = True) -> collections.Counter:
    """KAKURENBO LM training (``examples/torch_lm_train.py --full``'s
    defaults, ``"sort"``) on phi3.5-moe at 1 layer and hymba-1.5b (LR
    1e-3) at 16 layers, at full width, and 2 epochs of kimi-k2 reduced, their launches
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
# The encoder-decoder (seamless-m4t-large-v2) through B7 and B1, and
# error-feedback gradient compression on the main path
# ---------------------------------------------------------------------------

ENCDEC = "seamless-m4t-large-v2"
#: B7 at seamless-m4t's shapes (B, S, Hq, Hkv, D) and causal flag: the
#: served encoder (full attention) and decoder (causal) over 4 x 2,048, and
#: the train path's encoder over 32 frames and decoder over 8 tokens.
ENCDEC_ATTN = (("encoder", (4, 2048, 16, 16, 64), False),
               ("decoder", (4, 2048, 16, 16, 64), True),
               ("encoder lm", (32, 32, 16, 16, 64), False),
               ("decoder lm", (32, 8, 16, 16, 64), True))
#: Served at full depth: one prefill launches B7 in its 24 encoder and 24
#: decoder layers.
ENCDEC_SERVE = (ENCDEC, None, {"flash_attention": 48})
#: The encdec's LM run: train steps (the example's 200: 12 epochs of 16 at
#: batch 32) and base LR.  At the example's LR of 1e-2 seamless-m4t stalls
#: at the corpus' unigram loss (3.63 against 3.625 at 8 tokens) and hides
#: only DropTop's 2%, through the kernels and through their plain versions
#: alike (``--encdec-lr-witness``; ROADMAP C): it trains at 1e-3, where
#: its low-loss tail hides from epoch 5 (in 6 epochs it hides none).
ENCDEC_STEPS, ENCDEC_LR = 200, 1e-3
#: The encdec LM run's depth: 8 of each stack's 24 layers
#: (the script's time limit; the gradient check stays at full depth).
ENCDEC_LM_LAYERS = 8


def encdec_kernel_checks(dev) -> dict:
    """B7 at seamless-m4t's serve and train shapes (float32, against its
    plain version within 1e-5 and float64, beside SDPA), B1's forward and
    backward over the train path's logits (256 tokens x 256,206)."""
    import torch
    rows = {"flash_attention": [
        dict(check_flash_attention(dev, shape, causal, torch.float32, 1e-5,
                                   10 if shape[1] > 32 else 50, library=True),
             arch=f"{ENCDEC} {part}") for part, shape, causal in ENCDEC_ATTN],
        "loss_confidence": [dict(check_loss_confidence(
            dev, 256, 256206, torch.float32, 1e-4, 20), arch=f"{ENCDEC} lm")],
        "loss_confidence_bwd": [dict(check_loss_confidence_bwd(
            dev, 256, 256206, torch.float32, 10), arch=f"{ENCDEC} lm")]}
    emit({"phase": "encdec_kernel_checks", **rows})
    return rows


def phase_encdec_lm(dev, full: bool = True) -> collections.Counter:
    """KAKURENBO training of seamless-m4t-large-v2 at full width and
    ``ENCDEC_LM_LAYERS`` + ``ENCDEC_LM_LAYERS`` layers (the time limit;
    AdamW at ``ENCDEC_LR``) over ``FramesLM`` (512
    sequences of 32 frames and 8 tokens, batch 32, ``"sort"`` + DropTop
    0.02, the default engine),
    its launches counted from 0 just before the run: per epoch wall s,
    loss, F* and backward samples, peak memory; B1's backward each train
    step, B7 once a layer a forward (the encoder's full, the decoder's
    causal); the loss falls and some epoch hides more than DropTop's
    tail.  Then one step's
    gradients through the kernels against the plain forwards per leaf
    (1e-3), the host loop = the scanned engine bit for bit at 2 + 2 layers,
    one profiled step.  ``full=False`` rehearses it on the CPU, reduced."""
    from repro_torch.kernels import backend
    t0 = time.perf_counter()
    backend.reset_launches()
    _, launches = lm_train_run(dev, ENCDEC, "kakurenbo", "sort", 0.02, full,
                               layers=ENCDEC_LM_LAYERS if full else None,
                               steps=ENCDEC_STEPS, lr=ENCDEC_LR)
    require(launches == collections.Counter(backend.LAUNCHES),
            "encdec_lm: launches outside the run")
    free_memory()
    lm_grad_check(dev, ENCDEC, full)
    free_memory()
    zoo_engines(dev, ENCDEC, layers=2, full=full)
    free_memory()
    lm_step_breakdown(dev, ENCDEC, 32, full)
    free_memory()
    emit({"phase": "encdec_lm_done", "seconds": time.perf_counter() - t0,
          "launches": dict(launches)})
    return launches


def context_tv(model, batch: dict) -> float:
    """How far the predictions depend on the input: the mean total-variation
    distance of each position's predicted distribution from the batch's
    mean prediction (0: one prediction for every input, the unigram)."""
    import torch
    with torch.no_grad():
        logits, mask, _ = model(batch)
        prob = torch.softmax(logits.double(), -1)[mask.bool()]
        return float(0.5 * (prob - prob.mean(0)).abs().sum(-1).mean())


def witness_encdec_lr(dev, lr: float = 1e-2, full: bool = True) -> dict:
    """Is seamless-m4t's stall at the example's LR of 1e-2 (the loss at the
    corpus' unigram level, only DropTop's 2% hidden) the LR's or the
    port's?  Phase 19's run (``"sort"`` + DropTop 0.02; 96 steps, 6
    epochs) at ``lr``, full width and depth, through the kernels and through
    their plain versions (on the card, ``plain_forwards``), from the same
    weights; then through the kernels at 2 + 2 layers.  Per epoch loss,
    F* and backward samples, and at the end how far the predictions
    depend on the input (``context_tv``), beside the corpus' unigram
    loss.  The plain run must launch none of B1 and B7."""
    import numpy as np
    import torch
    from repro_torch.kernels import backend
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    probe = encdec_trainer(full=False, device=torch.device("cpu"))
    labels = probe.dataset.get(np.arange(probe.num_samples))["labels"]
    freq = np.bincount(labels.ravel(), minlength=64) / labels.size
    unigram = float(-(freq[freq > 0] * np.log(freq[freq > 0])).sum())
    out = {"phase": "encdec_lr_witness", "lr": lr, "unigram_loss": unigram}
    failed = []
    for name, layers in (("kernels", None), ("plain", None),
                         ("kernels_2_layers", 2)):
        before = collections.Counter(backend.LAUNCHES)
        with (plain_forwards() if name == "plain"
              else contextlib.nullcontext()):
            tr = encdec_trainer(full=full, lr=lr, steps=96,
                                selection="sort", drop_top=0.02, device=dev,
                                num_layers=layers)
            tr.run()
            tv = context_tv(tr.model, frames_batch(
                dev, tr.model.cfg.encoder_input_dim))
        sync(dev)
        launches = collections.Counter(backend.LAUNCHES)
        launches.subtract(before)
        hist = tr.history
        row = {"layers": tr.model.cfg.num_layers, "engine": tr.engine.name,
               "loss": [h.train_loss for h in hist],
               "F_star": [h.hidden_fraction for h in hist],
               "bwd_samples": [h.bwd_samples for h in hist],
               "epoch_wall_s": [h.wall_time for h in hist],
               "context_tv": tv,
               "launches": {k: v for k, v in launches.items() if v}}
        out[name] = row
        emit({"phase": "encdec_lr_witness_run", "run": name, **row})
        del tr
        free_memory()
        if name == "plain" and (launches["flash_attention"]
                                or launches["loss_confidence"]):
            failed.append(f"the plain run launched {dict(launches)}")
    out["failed"] = failed
    out["seconds"] = time.perf_counter() - t0
    emit(out)
    require(not failed, "encdec LR witness: " + "; ".join(failed))
    return out


def phase_compression(dev, n: int = 50_000, epochs: int = 3) -> dict:
    """Error-feedback gradient compression (``grad_compression=True``) on
    the main path (paper CNN, ``SyntheticClassification(50_000)``,
    KAKURENBO ``"histogram_pallas"`` + DropTop 0.02, fused scoring):

    - the scanned engine = the host loop, losses, plans and the whole train
      state (the residual among it) bit for bit;
    - a crash between two blocks of epoch 2, restored from the epoch-2
      checkpoint (its ``"ef"``) into a trainer built from other weights and
      seeds, ends bit-identical to the uninterrupted scanned run;
    - guarded (``skip_update``) over ``POISON_IDS``, on the host loop:
      every held step leaves the residual bit for bit, the residual stays
      finite, and the scanned run of the same is bit-identical to it;
    - the 8-step graph's replay compressed against uncompressed, in turns
      (the compressor's cost, recorded; no limit);
    - card against CPU (``phase_card_vs_cpu``'s run, compressed, at LR
      0.002) within 1e-4 relative.
    Returns the phase's kernel launches."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.data import SyntheticClassification
    from repro_torch.kernels import backend
    from repro_torch.models.cnn import CNN
    from repro_torch.train import chaos
    backend.reset_launches()
    t0 = time.perf_counter()
    out = {"phase": "compression", "model": CONFIG.name, "n": n,
           "epochs": epochs}

    def trainer(engine, seed=0, **kw):
        return main_trainer(dev, "kakurenbo", n, 0, epochs,
                            CNN(CONFIG, torch.Generator().manual_seed(seed)),
                            seed=seed, engine=engine, grad_compression=True,
                            **kw)

    runs = {}
    for engine in ("host", "scan"):
        tr = trainer(engine)
        hist, plans = recorded_run(tr)
        runs[engine] = (tr, hist, plans, train_state(tr))
    (_, hh, ph, sh), (scan, hs, ps, ss) = runs["host"], runs["scan"]
    del runs
    diff = state_diff(sh, ss)
    ef = [k for k in ss if k.startswith("/ef/")]
    out["engines"] = {
        "engines": [scan.engine.name], "loss": {"host": [h.train_loss for h in hh],
                                                "scan": [h.train_loss for h in hs]},
        "epoch_wall_s": {"host": [h.wall_time for h in hh],
                         "scan": [h.wall_time for h in hs]},
        "hidden": [len(p[1]) for p in ps], "state_tensors": len(ss),
        "ef_tensors": len(ef),
        "ef_max_abs": max(float(ss[k].abs().max()) for k in ef),
        "state_differs": diff}
    require(scan.engine.name == "scan" and ef and out["engines"]["ef_max_abs"] > 0,
            f"compression engines: {out['engines']}")
    require([h.train_loss for h in hh] == [h.train_loss for h in hs]
            and same_plans(ph, ps) and not diff,
            f"compression: host loop and scanned engine differ: {diff}")
    require(any(out["engines"]["hidden"]), "compression: kakurenbo hid nothing")
    del sh

    # A crash between two blocks of epoch 2, restored with its residual.
    root = ROOT / "build" / "chip_smoke_ef_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    try:
        tr = trainer("scan", checkpoint_dir=str(root), checkpoint_every=1)
        tr.run(2)
        dispatch, calls = tr.engine._dispatch, [0]

        def bomb(size, weighted):
            if calls[0] == 1:
                raise RuntimeError("injected failure between blocks")
            calls[0] += 1
            dispatch(size, weighted)

        tr.engine._dispatch = bomb
        crashed = False
        try:
            tr.run_epoch(2)
        except RuntimeError as e:
            crashed = "between blocks" in str(e)
        require(crashed, "compression restart: epoch 2 did not crash")
        del tr
        tr2 = trainer("scan", seed=7, checkpoint_dir=str(root),
                      checkpoint_every=1)
        fresh = not any(bool(e.any()) for e in tr2.ef_state)
        require(tr2.restore_latest() and tr2.epoch == 2,
                "compression restart: restore")
        tr2.run()
        rdiff = state_diff(train_state(tr2), ss)
        out["restart"] = {"replays_before_crash": calls[0],
                          "restored_into_zero_residual": fresh,
                          "state_differs": rdiff,
                          "last_loss": [tr2.history[-1].train_loss,
                                        hs[-1].train_loss]}
        del tr2
    finally:
        shutil.rmtree(root, ignore_errors=True)
    require(not rdiff and out["restart"]["last_loss"][0] == hs[-1].train_loss,
            f"compression restart: {out['restart']}")

    # The compressor's cost on a replay of the 8-step graph.
    off = main_trainer(dev, "kakurenbo", n, 0, 1,
                       CNN(CONFIG, torch.Generator().manual_seed(0)),
                       engine="scan")
    off.run()
    rt = replay_times(dev, {"uncompressed": off, "compressed": scan})
    rt["cost"] = rt["compressed"]["replay_ms"] / rt["uncompressed"]["replay_ms"] - 1.0
    rt["extra_device_kernels_per_step"] = (
        rt["compressed"]["device_kernels"]
        - rt["uncompressed"]["device_kernels"]) / scan.engine.scan_steps
    out["replay"] = rt
    del off, scan, ss

    # Guarded over poisoned samples: each held step keeps the residual.
    ids = np.asarray(POISON_IDS)
    poisoned = {}
    for engine in ("host", "scan"):
        ds = chaos.poison_samples(SyntheticClassification(num_samples=n, seed=0),
                                  POISON_IDS)
        tr = trainer(engine, ds=ds, guard_policy="skip_update")
        held = []
        if engine == "host":
            step = tr.train_step

            def watched(*args, tr=tr, step=step, held=held):
                before = [e.clone() for e in tr.ef_state]
                seen = int(tr.guard_state.nonfinite_steps)
                got = step(*args)
                if int(tr.guard_state.nonfinite_steps) > seen:
                    held.append(all(torch.equal(a, b)
                                    for a, b in zip(before, tr.ef_state)))
                return got

            tr.train_step = watched
        hist, plans = recorded_run(tr)
        poisoned[engine] = (hist, plans, train_state(tr), held,
                            all(bool(torch.isfinite(e).all())
                                for e in tr.ef_state))
        del tr
    (hh, ph, sh, held, fin_h), (hs, ps, ss, _, fin_s) = (poisoned["host"],
                                                          poisoned["scan"])
    want = poisoned_batches(ph, ids)
    pdiff = state_diff(sh, ss)
    out["poisoned"] = {
        "ids": list(POISON_IDS), "nonfinite_steps": [h.nonfinite_steps for h in hh],
        "poisoned_batches": want, "held_steps_checked": len(held),
        "held_steps_residual_kept": sum(held), "ef_finite": [fin_h, fin_s],
        "scan_state_differs": pdiff}
    require([h.nonfinite_steps for h in hh] == want and held and all(held)
            and len(held) == sum(want) and fin_h and fin_s,
            f"compression poisoned: {out['poisoned']}")
    require(not pdiff and np.array_equal(
        np.array([h.train_loss for h in hh]), np.array([h.train_loss for h in hs]),
        equal_nan=True) and same_plans(ph, ps),
        f"compression poisoned: scanned run differs in {pdiff}")
    del poisoned, sh, ss
    launches = collections.Counter(backend.LAUNCHES)
    # LR 0.002, not phase 12's 0.005: the quantizer's rounding is a step
    # function, so a last-bit difference can move an element by a whole
    # quantum, and at 0.005 the CPU control from weights changed by 1e-7
    # moves epoch 2 by 1.8e-4 (no 1e-4 comparison could hold); at 0.002 by
    # 5.3e-7 (both on the CPU).
    out["card_vs_cpu"] = phase_card_vs_cpu(dev, lr=0.002,
                                           grad_compression=True)
    out["seconds"] = time.perf_counter() - t0
    out["launches"] = dict(launches)
    emit(out)
    return launches


# ---------------------------------------------------------------------------
# The data-parallel trainer (mesh_shape over torch.distributed)
# ---------------------------------------------------------------------------

#: The staged histogram selection's kernels: (kernel, its stage's plain
#: version, what it replaces).  Their rows join the ``kernels`` line.
STAGED = ("histogram_range", "histogram_count", "histogram_walk")


def staged_inputs(dev, n: int, kind: str, seed: int = 1):
    """Losses and flags for the staged-vs-fused checks; ``"empty"`` has
    nothing valid."""
    import torch
    loss, valid = selection_inputs(dev, n, 0.3, seed,
                                   "exp" if kind == "empty" else kind)
    return loss, torch.zeros_like(valid) if kind == "empty" else valid


def stage_err(stage: str, got, want, tag: str) -> float:
    """One staged launch's outputs against its plain version's on the same
    inputs, each bit for bit (the range by ``==``); the largest absolute
    difference (0 where both hold the same value, so the range's
    sentinels compare too)."""
    import torch
    err = 0.0
    for a, b in zip(got, want):
        require((a is None) == (b is None), f"{stage}: None differs ({tag})")
        if a is None:
            continue
        d = torch.where(a.double() == b.double(), 0.0, a.double() - b.double())
        err = max(err, float(d.abs().max()))
        require(torch.equal(a, b), f"{stage} differs from its plain version "
                f"in {int((a != b).sum())} places ({tag})")
    return err


def staged_kernel_checks(dev, reps: int = 100) -> dict:
    """The staged histogram selection (B2's range, B3's count and the walk
    with the masks, three launches) at N = 50,000 and 1,281,167 (0.3
    invalid, non-finite losses, all equal, nothing valid; F in {0.3, 1} x
    DropTop {0.02, 0}): each launch against its plain version on the same
    inputs bit for bit, and at one rank the three against the fused
    histogram-select launch (masks, histogram, raw range and walk).  A
    second rank's rows (another draw) then make a world of two: the range
    and counts over the joint range summed, and each rank's walk over the
    global histogram with ``n_count = 2 N`` against ``walk_plain``.  Each
    stage is timed (CUDA events and device-only) beside its plain version,
    its library yardstick and its bound, and the whole staged call beside
    the fused one.  Returns the kernel rows by name (N = 50,000, with the
    largest difference from the plain version over every case) and the
    timings at both N."""
    import torch
    from repro_torch.kernels import threshold_select as ts
    cases, errs = 0, dict.fromkeys(STAGED, 0.0)

    def held(stage, got, want, tag):
        errs[stage] = max(errs[stage], stage_err(stage, got, want, tag))

    for n in (50_000, 1_281_167):
        for kind in ("exp", "naninf", "equal", "empty"):
            loss, valid = staged_inputs(dev, n, kind)
            other = staged_inputs(dev, n, kind, seed=2)
            for low, high in ((0.3, 0.02), (1.0, 0.0)):
                tag = f"N={n} {kind} F={low} top={high}"
                f = torch.full((), low, device=dev)
                fused = ts.histogram_select(loss, valid, f, high)
                lo_hi = ts.histogram_range(loss, valid)
                held("histogram_range", (lo_hi,),
                     (ts.range_plain(loss, valid),), tag)
                hist = ts.histogram_count(loss, valid, lo_hi)
                held("histogram_count", (hist,),
                     (ts.count_plain(loss, valid, lo_hi),), tag)
                lm, hm, walk = ts.histogram_walk(loss, valid, hist, lo_hi, n,
                                                 f, high)
                held("histogram_walk", (lm, hm, walk),
                     ts.walk_plain(loss, valid, hist, lo_hi, n, f, high), tag)
                for name, a, b in (("low", lm, fused[0]), ("high", hm, fused[1]),
                                   ("hist", hist, fused[2]),
                                   ("walk", walk, fused[4])):
                    require((a is None) == (b is None)
                            and (a is None or torch.equal(a, b)),
                            f"staged {name} differs from the fused launch ({tag})")
                require(torch.equal(lo_hi.view(torch.int32),
                                    fused[3].view(torch.int32)),
                        f"staged range {lo_hi.tolist()} != {fused[3].tolist()} "
                        f"({tag})")
                # World 2: this rank's rows and the other's, reduced as
                # planops.histogram_masks reduces them over a group.
                tag2 = f"{tag} world 2"
                r2 = ts.histogram_range(*other)
                held("histogram_range", (r2,), (ts.range_plain(*other),), tag2)
                g = torch.stack([torch.minimum(lo_hi[0], r2[0]),
                                 torch.maximum(lo_hi[1], r2[1])])
                total = torch.zeros_like(hist)
                for rows in ((loss, valid), other):
                    h = ts.histogram_count(*rows, g)
                    held("histogram_count", (h,),
                         (ts.count_plain(*rows, g),), tag2)
                    total += h
                for rows in ((loss, valid), other):
                    held("histogram_walk",
                         ts.histogram_walk(*rows, total, g, 2 * n, f, high),
                         ts.walk_plain(*rows, total, g, 2 * n, f, high), tag2)
                cases += 1
    rows, timing = {}, []
    for n in (50_000, 1_281_167):
        loss, valid = staged_inputs(dev, n, "exp")
        f = torch.full((), 0.3, device=dev)
        lo_hi = ts.histogram_range(loss, valid)
        hist = ts.histogram_count(loss, valid, lo_hi)
        lo, hi = (float(v) for v in lo_hi)
        nv = int((valid & torch.isfinite(loss)).sum())
        stages = {
            # Bytes: the losses and flags read once (and the bins, the
            # masks); ops at the fp32 rate as time_histogram_select counts.
            "histogram_range": (lambda: ts.histogram_range(loss, valid),
                                lambda: ts.range_plain(loss, valid),
                                lambda: torch.aminmax(loss),
                                "torch.aminmax (no validity mask)",
                                bound(5 * n + 8, n + 2 * nv)),
            "histogram_count": (lambda: ts.histogram_count(loss, valid, lo_hi),
                                lambda: ts.count_plain(loss, valid, lo_hi),
                                lambda: torch.histc(loss, 512, lo, hi),
                                "torch.histc over [lo, hi] (no validity mask)",
                                bound(5 * n + 8 + 4 * 512, n + 6 * nv)),
            "histogram_walk": (lambda: ts.histogram_walk(
                                   loss, valid, hist, lo_hi, n, f, 0.02),
                               lambda: ts.walk_plain(loss, valid, hist, lo_hi,
                                                     n, f, 0.02),
                               None, None,
                               bound(5 * n + 8 + 4 * 512 + 2 * n,
                                     n + 8 * nv + 4 * 512)),
        }
        for name, (kern, plain, lib, lib_name, (b_ms, b_by)) in stages.items():
            d_ms, d_launch, _ = device_profile(kern, 20)
            row = {"n": n, "max_abs_err": errs[name], "ms": time_ms(kern, reps),
                   "device_ms": d_ms, "cuda_launches": d_launch,
                   "plain_ms": time_ms(plain, reps),
                   "library_ms": time_ms(lib, reps) if lib else None,
                   "library_backend": lib_name or "null: no PyTorch call "
                   "walks a histogram's CDF into masks",
                   "bound_ms": b_ms, "bound_by": b_by}
            if n == 50_000:
                rows[name] = row
            timing.append({"stage": name, **row})

        def staged():
            r = ts.histogram_range(loss, valid)
            return ts.histogram_walk(loss, valid,
                                     ts.histogram_count(loss, valid, r),
                                     r, n, f, 0.02)

        def fused():
            return ts.histogram_select(loss, valid, f, 0.02)

        s_dev, s_launch, _ = device_profile(staged, 20)
        f_dev, f_launch, _ = device_profile(fused, 20)
        order = [staged, fused, fused, staged]
        turns = {staged: [], fused: []}
        for fn in order:
            turns[fn].append(time_ms(fn, reps))
        timing.append({"stage": "staged_vs_fused", "n": n,
                       "staged_ms": turns[staged], "fused_ms": turns[fused],
                       "staged_device_ms": s_dev, "fused_device_ms": f_dev,
                       "staged_cuda_launches": s_launch,
                       "fused_cuda_launches": f_launch,
                       "bound_ms": bound(5 * n + 2 * n, n + 10 * nv)[0]})
    emit({"phase": "staged_kernel_checks", "cases": cases, "timing": timing})
    return rows


def mesh_trainer(dev, n: int, epochs: int, world, seed: int = 0, **kw):
    """The main path's trainer under ``mesh_shape=(world,)`` (None: one
    device, the default engine), no test set, weights drawn from ``seed``."""
    import torch
    from repro_torch.configs.paper_cnn import CONFIG
    from repro_torch.models.cnn import CNN
    model = CNN(CONFIG, torch.Generator().manual_seed(seed))
    mesh = dict(mesh_shape=(world,), grad_chunks=8) if world else {}
    return main_trainer(dev, "kakurenbo", n, 0, epochs, model, seed=seed,
                        **mesh, **kw)


def mesh_run(dev, n: int, epochs: int, world, **kw):
    """``mesh_trainer`` run through: (trainer, history, recorded plans)."""
    tr = mesh_trainer(dev, n, epochs, world, **kw)
    hist, plans = recorded_run(tr)
    return tr, hist, plans


def watch_epoch1(inner) -> dict:
    """Record the sampler's permutations and a copy of its state just
    before epoch 1's plan."""
    seen = {"perms": []}
    draw, begin = inner.draw_permutation, inner.begin_epoch

    def drawn():
        p = draw()
        seen["perms"].append(p.clone())
        return p

    def begun(epoch):
        if epoch == 1:
            seen["state"] = copy.deepcopy(inner.state)
        return begin(epoch)

    inner.draw_permutation, inner.begin_epoch = drawn, begun
    return seen


def mesh_restart(dev, n: int, epochs: int, root, want: dict,
                 want_loss: float) -> dict:
    """World 1, scanned: epoch 2 dies after its first replay; the epoch-2
    checkpoint restored into a trainer from other weights and seeds ends
    bit-identical to the uninterrupted run (``want``)."""
    kw = dict(engine="scan", checkpoint_dir=str(root), checkpoint_every=1)
    tr = mesh_trainer(dev, n, epochs, 1, **kw)
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
        require("between blocks" in str(e), f"mesh restart: {e}")
    tr2 = mesh_trainer(dev, n, epochs, 1, seed=7, **kw)
    require(tr2.restore_latest() and tr2.epoch == 2, "mesh restore")
    tr2.run()
    out = {"replays_before_crash": calls[0],
           "state_differs": state_diff(train_state(tr2), want),
           "last_loss": [tr2.history[-1].train_loss, want_loss]}
    require(not out["state_differs"] and out["last_loss"][0] == want_loss,
            f"mesh restart: {out}")
    return out


def mesh_records(dev, world: int, n: int, epochs: int,
                 engine: str = "host", state: bool = False) -> dict:
    """The small mesh runs: ``"histogram_pallas"`` and ``"sort"``, both
    with DropTop 0.02, under ``engine``: per-epoch losses, engines, wall s,
    host syncs, plans and final parameters (and, with ``state``, every
    tensor of the train state)."""
    out = {}
    for selection in ("histogram_pallas", "sort"):
        tr, hist, plans = mesh_run(dev, n, epochs, world, engine=engine,
                                   selection=selection)
        out[selection] = {
            "loss": [h.train_loss for h in hist],
            "engine": [h.engine for h in hist],
            "wall_s": [h.wall_time for h in hist],
            "host_syncs": [h.host_syncs for h in hist],
            "plans": plans,
            "params": [p.detach().cpu() for p in tr.model.parameters()]}
        if state:
            out[selection]["state"] = train_state(tr)
    return out


def tf32_flags() -> tuple[bool, bool]:
    """cuDNN's and cuBLAS's TF32 switches (earlier phases turn them off)."""
    import torch
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def mesh_gloo_rank(rank: int, world: int, device_type: str, n: int,
                   epochs: int, flags: tuple[bool, bool]) -> dict:
    """One rank of the gloo world (``launch.mesh.spawn``) on
    ``device_type``: on the card both ranks share it (NCCL refuses two
    ranks on one GPU).  The spawning process' TF32 switches (``flags``)
    are taken, so that both worlds run the same convolutions."""
    import torch
    from repro_torch.launch.mesh import rank_device
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    return mesh_records(rank_device(device_type, rank), world, n, epochs)


def same_records(a: dict, b: dict) -> bool:
    import torch
    return all(a[s]["loss"] == b[s]["loss"]
               and same_plans(a[s]["plans"], b[s]["plans"])
               and all(torch.equal(x, y)
                       for x, y in zip(a[s]["params"], b[s]["params"]))
               for s in a)


def plan_from_state(inner, state, perm, epoch: int):
    """The single-device plan (``kakurenbo._plan_step``, no group: the
    fused histogram-select launch) from a copy of a sampler's state."""
    import numpy as np
    from repro_torch.core.kakurenbo import _plan_step
    c = inner.config
    hidden, moved_back, order, num_hidden, _, _ = _plan_step(
        state, perm, float(inner._fraction_schedule(epoch)),
        method=c.selection, tau=c.tau, drop_top=c.drop_top_fraction,
        moveback=c.moveback, adjust_lr=c.adjust_lr)
    order, nh = order.cpu().numpy(), int(num_hidden)
    return (order[:len(order) - nh], np.sort(order[len(order) - nh:]),
            np.flatnonzero(moved_back.cpu().numpy()))


def phase_mesh(dev, n: int = 50_000, epochs: int = 3, n_small: int = 8_192,
               gloo_device: str = "cuda") -> collections.Counter:
    """The data-parallel trainer (``TrainConfig.mesh_shape``).

    World 1 under NCCL in this process (``gloo`` when rehearsed on the
    CPU), the main path at N = ``n`` through the scanned engine, its NCCL
    collectives inside the CUDA graphs, with the staged histogram launches
    in every plan and their counts from 0; epoch 1's plan against the
    single-device plan from the same state and permutation; a crash
    between two blocks of epoch 2 restored into a trainer from other
    weights, bit-identical; the 8-step replay against the single-device
    one, in turns.  Then at N = ``n_small`` (``"histogram_pallas"`` and
    ``"sort"``, DropTop 0.02): world 1 scanned against its host loop bit
    for bit (losses, plans, the whole train state), and a world of 2 gloo
    ranks on ``gloo_device`` (host loop) against world 1, bit for bit."""
    import shutil
    import numpy as np
    import torch.distributed as dist
    from repro_torch.kernels import backend
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    row = {"phase": "mesh", "n": n, "epochs": epochs, "grad_chunks": 8}
    try:
        backend.reset_launches()
        scan = mesh_trainer(dev, n, epochs, 1)
        seen = watch_epoch1(scan.strategy._inner)
        hist_s, plans_s = recorded_run(scan)
        launches = collections.Counter(backend.LAUNCHES)
        row["backend"] = scan.ctx.backend
        row["launches"] = dict(launches)
        for name in (*STAGED, "loss_confidence", "loss_confidence_bwd"):
            require(launches.get(name, 0) > 0, f"mesh: {name} never launched")
        for name in STAGED:
            require(launches[name] == epochs,
                    f"mesh: {name} ran {launches[name]} times in {epochs} plans")
        require(launches.get("histogram_select", 0) == 0,
                "mesh: the fused launch ran under the group")
        want = train_state(scan)
        row.update({
            "engine": hist_s[0].engine,
            "loss": [h.train_loss for h in hist_s],
            "wall_s": [h.wall_time for h in hist_s],
            "hidden": [len(p[1]) for p in plans_s]})
        require(row["engine"] == "scan", f"mesh engine {row['engine']}")
        require(any(len(p[1]) for p in plans_s), "mesh: nothing hidden")
        require(all(h.host_syncs == 1 for h in hist_s), "mesh: host syncs")
        # Epoch 1's plan on one device (the fused launch) from the state
        # and permutation the mesh planned it from.
        single = plan_from_state(scan.strategy._inner, seen["state"],
                                 seen["perms"][1], 1)
        row["plan1_single_device_equal"] = all(
            np.array_equal(a, b) for a, b in zip(single, plans_s[1][:3]))
        require(row["plan1_single_device_equal"],
                "mesh: epoch 1's plan differs from the single-device plan")
        # A crash between two blocks of epoch 2, restored.
        root = ROOT / "build" / "chip_smoke_mesh_ckpt"
        shutil.rmtree(root, ignore_errors=True)
        try:
            row["restart"] = mesh_restart(dev, n, epochs, root, want,
                                          hist_s[-1].train_loss)
        finally:
            shutil.rmtree(root, ignore_errors=True)
        # The 8-step replay, fold vs one device, in turns.
        if dev.type == "cuda":
            single = mesh_trainer(dev, n, epochs, None)
            single.engine._setup()
            single.engine._capture(single.engine.scan_steps, False)
            row["replay"] = replay_times(dev, {"single_device": single,
                                               "mesh_fold": scan})
            row["fold_cost"] = (row["replay"]["mesh_fold"]["replay_ms"]
                                / row["replay"]["single_device"]["replay_ms"])
        # World 1 at N = n_small: scanned = host loop.
        one = mesh_records(dev, 1, n_small, epochs, "scan", state=True)
        host = mesh_records(dev, 1, n_small, epochs, "host", state=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    row["scan_vs_host"] = {
        "n": n_small,
        "engines": {s: [one[s]["engine"][0], host[s]["engine"][0]]
                    for s in one},
        "loss": {s: {"scan": one[s]["loss"], "host": host[s]["loss"]}
                 for s in one},
        "wall_s": {s: {"scan": one[s]["wall_s"], "host": host[s]["wall_s"]}
                   for s in one},
        "state_tensors": {s: len(one[s]["state"]) for s in one},
        "state_differs": {s: state_diff(one[s]["state"], host[s]["state"])
                          for s in one},
        "equal": same_records(one, host)}
    require(all(e == ["scan", "host"]
                for e in row["scan_vs_host"]["engines"].values()),
            f"mesh engines {row['scan_vs_host']['engines']}")
    require(row["scan_vs_host"]["equal"]
            and not any(row["scan_vs_host"]["state_differs"].values()),
            f"mesh: scan vs host differ: {row['scan_vs_host']}")
    require(all(one[s]["host_syncs"] == [1] * epochs for s in one),
            "mesh: host syncs")
    ranks = mesh_lib.spawn(mesh_gloo_rank, 2, "gloo", gloo_device,
                           (gloo_device, n_small, epochs, tf32_flags()))
    for s in one:
        require(ranks[0][s]["engine"] == ["host"] * epochs, "gloo engine")
    row["gloo_world2"] = {
        "n": n_small, "tf32_flags": tf32_flags(),
        "loss": {s: ranks[0][s]["loss"] for s in one},
        "world1_loss": {s: one[s]["loss"] for s in one},
        "equal_to_world1": same_records(one, ranks[0]),
        "ranks_agree": same_records(ranks[0], ranks[1]),
        "hidden": {s: [len(p[1]) for p in one[s]["plans"]] for s in one}}
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    require(row["gloo_world2"]["equal_to_world1"],
            "mesh: gloo world 2 differs from NCCL world 1")
    require(row["gloo_world2"]["ranks_agree"], "mesh: gloo ranks differ")
    return launches



# ---------------------------------------------------------------------------
# The mesh's model axis (phase 21)

#: The model axis' archs (full width), the sequence length, the gloo
#: world's mesh and the depth its models are cut to.
AXIS_ARCHS = ("qwen3-1.7b", "mamba2-130m")
AXIS_SEQ = 256
AXIS_WORLD = (2, 2)
AXIS_LAYERS = 4
#: Sequences of the KAKURENBO plan the gloo world trains four steps of.
AXIS_N = 16
#: A.9(c)'s families at full width: (arch, cut depth, MoE layouts), one
#: AdamW step on the (1, 1) mesh and a checked step in the gloo world.
AXIS_FAMILIES = (("phi3.5-moe-42b-a6.6b", 1, ("gather", "partial")),
                 ("seamless-m4t-large-v2", 2, ("gather",)),
                 ("llava-next-mistral-7b", 2, ("gather",)))
#: Served on the (1, 1) mesh against no context: (arch, cut depth or None).
AXIS_SERVE = (("qwen3-1.7b", None), ("phi3.5-moe-42b-a6.6b", 2),
              ("mamba2-130m", None))
#: Greedy decode steps after each served prefill.
AXIS_GEN = 8
#: A batch of 1 in the gloo world: it divides no data axis of 2, so every
#: data rank takes it whole, as the reference's spec guard replicates it.
#: (arch, cut depth or None: full), served from a prompt of
#: ``AXIS_B1_PROMPT`` tokens with ``AXIS_B1_GEN`` greedy tokens (hymba at
#: the depth the world serves qwen3 at), and one train step on 1 x
#: ``AXIS_SEQ`` at the world's training depth, ``AXIS_LAYERS``.
AXIS_B1 = (("mamba2-130m", None), ("hymba-1.5b", AXIS_LAYERS))
AXIS_B1_PROMPT, AXIS_B1_GEN = 2048, 32


def axis_cfg(arch: str, full: bool, layers: int | None = None):
    from repro_torch.configs.registry import get_arch
    cfg = get_arch(arch) if full else get_arch(arch).reduced()
    return cut_depth(cfg, layers) if layers else cfg


def axis_step(cfg, ctx, params: dict, batch: dict, dev, lr: float = 0.0,
              adamw: bool = False):
    """One ``launch/train.py::make_train_step`` on ``ctx``'s shards of the
    global ``params`` (None: one device) from the global ``batch``, SGD at
    ``lr`` (0: nothing moves, the grads are set) or the config's AdamW.
    Returns (loss, (lv, pa, pc), the local tree, the model, the step)."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.launch.train import make_train_step, optimizer_for
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import SGD
    model = build_model(cfg, ctx, device=dev)
    local = model.shard(params)
    leaves = [t.requires_grad_(True) for _, t in flatten(local)]
    step = make_train_step(
        model, optimizer_for(cfg, leaves) if adamw else SGD(leaves))
    loss, metrics = step(local, batch, lr)
    return loss, metrics, local, model, step


def b1_prompt(dev, full: bool) -> dict:
    """The batch-1 prompt: ``AXIS_B1_PROMPT`` tokens of the example's
    corpus (``AXIS_SEQ`` reduced)."""
    return {"tokens": lm_batch(dev, 1, AXIS_B1_PROMPT if full
                               else AXIS_SEQ)["tokens"]}


def axis_family_batch(dev, cfg, n: int) -> dict:
    """``n`` sequences of the example's corpus at ``AXIS_SEQ`` positions
    with the family's inputs: llava's patch embeddings (in front of the
    text), seamless-m4t's frames (its decoder a quarter as long)."""
    if cfg.family == "encdec":
        return frames_batch(dev, cfg.encoder_input_dim, n, AXIS_SEQ)
    return {**lm_batch(dev, n, AXIS_SEQ),
            **(prompt_inputs(dev, cfg, n, 1, AXIS_SEQ) or {})}


@contextlib.contextmanager
def counted_collectives(counter: collections.Counter):
    """Within the block, the bytes handed to each ``torch.distributed``
    collective, by name: the largest tensor of a call (a gather's output,
    a reduce-scatter's input, an all-reduce's or a broadcast's tensor),
    from ``launch/hlo_analysis.py::record_collectives``, whose record also
    gives the wire bytes (``collective_bytes``).  Under gloo on the card
    each such byte crosses host memory."""
    from repro_torch.launch.hlo_analysis import (largest_bytes,
                                                 record_collectives)
    with record_collectives() as record:
        yield record
    counter.update(largest_bytes(record))


def attention_calls(calls: collections.Counter):
    """A ``patched_op("flash_attention", ...)`` wrapper counting B7's
    calls by mask: ``"causal"`` (decoders) or ``"full"`` (the
    encoder)."""
    def wrap(orig):
        def counted(q, k, v, causal, *args, **kw):
            calls["causal" if causal else "full"] += 1
            return orig(q, k, v, causal, *args, **kw)
        return counted
    return wrap


def axis_unit_mesh(dev, arch: str, full: bool, mesh,
                   layers: int | None = None,
                   layouts: tuple[str, ...] = ("gather",)) -> dict:
    """``arch`` at full width (``layers``: its cut depth):
    ``loss_and_metrics`` and one AdamW step through ``make_train_step``
    without a context, then on a (1, 1) mesh with FSDP (``mesh``: NCCL at
    world 1) for each MoE layout in ``layouts``, one after the other
    (each run's gradients and AdamW moments freed before the next, the
    first run's updated leaves kept on the card: qwen3-1.7b's f32 step
    takes ~28 GB, phi3.5-moe's layer ~25 GB): the loss, the per-sample
    metrics and every updated leaf bit for bit.  The launches and B7's
    calls by mask are each mesh run's."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels import backend
    from repro_torch.launch.train import build_ctx
    from repro_torch.models.model import build_model
    from repro_torch.models.transformer import unstack_layers
    t_start = time.perf_counter()
    cfg = axis_cfg(arch, full, layers)
    batch = axis_family_batch(dev, cfg, 2)
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    runs = [("one_device", None)] + [
        ("mesh_1x1" if lay == "gather" else f"mesh_1x1_{lay}",
         build_ctx(cfg, mesh, fsdp=True, moe_fsdp_mode=lay))
        for lay in layouts]
    seconds, kept, meshes = {}, None, {}
    for name, ctx in runs:
        backend.reset_launches()
        calls = collections.Counter()
        t0 = time.perf_counter()
        with patched_op("flash_attention", attention_calls(calls)):
            loss, (lv, pa, pc), local, _, _ = axis_step(
                cfg, ctx, params, batch, dev, 1e-3, adamw=True)
        sync(dev)
        seconds[name] = time.perf_counter() - t0
        leaves = [t.detach() for _, t in flatten(local)]
        out = [t.detach() for t in (loss, lv, pa, pc)]
        del local, _
        if kept is None:
            moved = sum(not torch.equal(t, p) for t, (_, p) in zip(
                leaves, flatten(unstack_layers(params, copy=False))))
            kept = {"out": out, "leaves": leaves}
        else:
            meshes[name] = {
                "launches": dict(backend.LAUNCHES), "remat": ctx.remat,
                "attention_calls": dict(calls),
                "moe_fsdp_mode": ctx.moe_fsdp_mode,
                "equal": {
                    "loss": torch.equal(kept["out"][0], out[0]),
                    "metrics": all(torch.equal(x, y) for x, y in
                                   zip(kept["out"][1:], out[1:])),
                    "leaves": sum(torch.equal(t, h)
                                  for t, h in zip(leaves, kept["leaves"]))}}
        del leaves, out
        free_memory()
    row = {"arch": cfg.name, "layers": cfg.num_layers,
           "batch": [2, AXIS_SEQ], "n_leaves": len(kept["leaves"]),
           "leaves_moved": moved, "loss": float(kept["out"][0]),
           "seconds": seconds, "mesh": meshes}
    del params, kept
    free_memory()
    row["seconds"]["all"] = time.perf_counter() - t_start
    return row


def axis_greedy(cfg, ctx, params: dict, batch: dict, dev, max_len: int,
                gen: int = AXIS_GEN) -> dict:
    """``Model.prefill`` of the global ``batch`` on ``ctx``'s shards of
    ``params`` (None: one device), then ``gen`` greedy ``decode_step``s
    (every rank feeds the global batch's argmax): the last position's
    logits of the prefill and every step (gen + 1, B, V), the tokens (B,
    gen) and the cache gathered whole."""
    import torch
    from repro_torch.models.model import build_model
    model = build_model(cfg, ctx, device=dev)
    local = model.shard(params)
    with torch.no_grad():
        logits, cache = model.prefill(local, batch, max_len)
        outs, toks = [logits[:, -1]], []
        for _ in range(gen):
            tok = logits[:, -1:].argmax(dim=-1)
            toks.append(tok)
            logits, cache = model.decode_step(local, tok, cache)
            outs.append(logits[:, -1])
        local_k = list(cache["k"].shape) if "k" in cache else None
        cache = model.gather_cache(cache)
    del local
    return {"logits": torch.stack(outs), "tokens": torch.cat(toks, 1),
            "cache": cache, "local_k": local_k}


def axis_unit_serve(dev, arch: str, full: bool, mesh,
                    layers: int | None = None) -> dict:
    """``arch`` at full width served without a context and on the (1, 1)
    mesh (``axis_greedy``: prefill of 2 x ``AXIS_SEQ`` tokens, then
    ``AXIS_GEN`` greedy steps): the logits, the tokens and every entry of
    the gathered cache bit for bit.  The launches are the mesh run's."""
    import torch
    from repro_torch.kernels import backend
    from repro_torch.launch.train import build_ctx
    from repro_torch.models.model import build_model
    t_start = time.perf_counter()
    cfg = axis_cfg(arch, full, layers)
    batch = {"tokens": lm_batch(dev, 2, AXIS_SEQ)["tokens"]}
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    kept, seconds = None, {}
    for name, ctx in (("one_device", None),
                      ("mesh_1x1", build_ctx(cfg, mesh, fsdp=True))):
        backend.reset_launches()
        t0 = time.perf_counter()
        got = axis_greedy(cfg, ctx, params, batch, dev, AXIS_SEQ + AXIS_GEN)
        sync(dev)
        seconds[name] = time.perf_counter() - t0
        if kept is None:
            kept = got
            continue
        equal = {"logits": torch.equal(kept["logits"], got["logits"]),
                 "tokens": torch.equal(kept["tokens"], got["tokens"]),
                 "cache": kept["cache"].keys() == got["cache"].keys() and all(
                     kept["cache"][k] == got["cache"][k] if k == "len"
                     else torch.equal(kept["cache"][k], got["cache"][k])
                     for k in kept["cache"])}
        launches = dict(backend.LAUNCHES)
    row = {"arch": cfg.name, "layers": cfg.num_layers,
           "batch": [2, AXIS_SEQ], "gen": AXIS_GEN, "seconds": seconds,
           "launches": launches, "equal": equal,
           "tokens": kept["tokens"].tolist()}
    del params, kept, got
    free_memory()
    row["seconds"]["all"] = time.perf_counter() - t_start
    return row


def packed(tensors: list) -> dict:
    """``tensors`` as one flat tensor and their shapes (``unpacked``): one
    CUDA IPC handle for the spawned ranks to open, not one a leaf."""
    import torch
    return {"flat": torch.cat([t.reshape(-1) for t in tensors]),
            "shapes": [tuple(t.shape) for t in tensors]}


def shared(tree):
    """``tree`` (nested dicts) with each numpy array a CPU tensor: the
    spawned ranks then receive it through shared memory, not inside the
    pickled arguments.  A spawning parent writes those arguments into a
    pipe that a rank reads while it imports torch, so large ones start the
    ranks one after another."""
    import numpy as np
    import torch
    if isinstance(tree, dict):
        return {k: shared(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(tree))
    return tree


def unpacked(pack: dict) -> list:
    """``packed``'s tensors, views of its flat one."""
    sizes = [math.prod(s) for s in pack["shapes"]]
    return [t.view(s) for t, s in zip(pack["flat"].split(sizes),
                                      pack["shapes"])]


def axis_params(cfg, dev, dtype: str = "float32") -> dict:
    """The seed-0 draws of ``cfg`` on ``dev`` with every attention at its
    input's fan-in (``attention_fan_in``) and every SSM's ``a_log``
    U[0, 1) (``ssm_decay_control``): the gloo world's comparisons across
    orders of float32 sums (at the reference's init seamless-m4t's
    gradients part by ~1e-3 of their max between two correct orders, and
    mamba2's served logits at 24 layers by 2.6e-5 of their max); in
    ``dtype``, the float32 draws cast."""
    import torch
    from repro_torch.dist.sharding import map_specs
    from repro_torch.models.model import build_model
    params = ssm_decay_control(attention_fan_in(build_model(
        cfg, device=dev).init(torch.Generator(device=dev).manual_seed(0)),
        cfg), dev)
    if dtype == "float32":
        return params
    return map_specs(lambda t: t.to(getattr(torch, dtype)), params)


def ssm_decay_control(params: dict, dev) -> dict:
    """Set, in place, every SSM layer's ``a_log`` to U[0, 1) draws (seed
    1 on ``dev``), the CPU tests' control (``tests/
    test_torch_mesh_serve.py::_params``): at the reference's init (log of
    U[1, 16]) the decay within a chunk reaches about -1e3, where float32
    sums in two correct orders part (ROADMAP C); the same draws on every
    rank of the card.  A tree without an SSM is returned as it is."""
    import torch
    ssm = params.get("layers", {}).get("ssm")
    if ssm is not None:
        a = ssm["a_log"]
        a.copy_(torch.rand(a.shape, generator=torch.Generator(
            device=dev).manual_seed(1), device=dev, dtype=a.dtype))
    return params


def host_or(dev, host: bool):
    """The host's CPU if ``host``, else ``dev``."""
    import torch
    return torch.device("cpu") if host else dev


def axis_expectations(dev, full: bool) -> dict:
    """What the gloo world's new runs are held to, from the port on one
    device, computed once here (four ranks each holding a full-width
    reference would need ~4 x 12 GB for phi3.5-moe's layer): per
    ``AXIS_ARCHS`` arch (its first plan batch, the reference's init) and
    ``AXIS_FAMILIES`` arch and layout the loss, the per-sample losses
    (numpy) and every leaf's gradient (on the card, in ``flatten``'s
    order, ``packed``: passed to the ranks through CUDA IPC) of an SGD
    step at LR 0,
    the MoE in ``"gather"`` the mean of one device's steps on each data
    shard's rows; and qwen3-1.7b's served logits and tokens at
    ``AXIS_LAYERS`` layers.  The weights are ``axis_params``'."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.models.model import build_model
    want = {}
    for arch in AXIS_ARCHS:
        cfg, ds, _, _, batches = axis_arch_plan(dev, arch, full)
        params = build_model(cfg, device=dev).init(
            torch.Generator(device=dev).manual_seed(0))
        loss, (lv, _, _), local, _, _ = axis_step(
            cfg, None, params, axis_batch(ds, batches[0], dev), dev)
        want[arch] = {"loss": float(loss), "lv": lv.detach().cpu().numpy(),
                      "grads": packed([t.grad for _, t in flatten(local)])}
        del params, local, _
        free_memory()
    dp, n = AXIS_WORLD[0], 4
    for arch, layers, layouts in AXIS_FAMILIES:
        cfg = axis_cfg(arch, full, layers)
        batch = axis_family_batch(dev, cfg, n)
        params = axis_params(cfg, dev)
        for lay in layouts:
            shards = [range(n)] if lay == "partial" or cfg.moe is None \
                else [range(r * n // dp, (r + 1) * n // dp) for r in range(dp)]
            loss, lv, grads = 0.0, [], None
            for rows in shards:
                sub = {k: v[rows.start:rows.stop] for k, v in batch.items()}
                step_loss, (step_lv, _, _), local, _, _ = axis_step(
                    cfg, None, params, sub, dev)
                loss += float(step_loss) / len(shards)
                lv.append(step_lv.detach())
                g = [t.grad for _, t in flatten(local)]
                grads = g if grads is None else [a.add_(b) for a, b in
                                                 zip(grads, g)]
                del local, _, g
            if len(shards) > 1:
                for a in grads:
                    a.div_(len(shards))
            want[(arch, lay)] = {"loss": loss,
                                 "lv": torch.cat(lv).cpu().numpy(),
                                 "grads": packed(grads)}
            del grads
            free_memory()
        del params
        free_memory()
    cfg = axis_cfg("qwen3-1.7b", full, AXIS_LAYERS)
    params = axis_params(cfg, dev)
    got = axis_greedy(cfg, None, params,
                      {"tokens": lm_batch(dev, 2, AXIS_SEQ)["tokens"]}, dev,
                      AXIS_SEQ + AXIS_GEN)
    want["serve"] = {"logits": got["logits"].cpu().numpy(),
                     "tokens": got["tokens"].cpu().numpy()}
    del params, got
    free_memory()
    for arch, layers in AXIS_B1:
        cfg = axis_cfg(arch, full, layers)
        params = axis_params(cfg, dev)
        prompt = b1_prompt(dev, full)
        got = axis_greedy(cfg, None, params, prompt, dev,
                          prompt["tokens"].shape[1] + AXIS_B1_GEN,
                          AXIS_B1_GEN)
        del params
        free_memory()
        cfg = axis_cfg(arch, full, AXIS_LAYERS)
        params = axis_params(cfg, dev)
        loss, (lv, _, _), local, _, _ = axis_step(
            cfg, None, params, lm_batch(dev, 1, AXIS_SEQ), dev)
        want[("b1", arch)] = {
            "logits": got["logits"].cpu().numpy(),
            "tokens": got["tokens"].cpu().numpy(), "loss": float(loss),
            "lv": lv.detach().cpu().numpy(),
            "grads": packed([t.grad for _, t in flatten(local)])}
        del params, got, local, _
        free_memory()
    for arch, layers, width, host, dtype in ADAFACTOR_WORLD:
        want[("adafactor", arch, width, host, dtype)] = adafactor_expectation(
            host_or(dev, host), arch, layers, width and full, dtype)
    return want


def axis_world_family(dev, rank: int, mesh, arch: str, layers: int,
                      layout: str, want: dict, full: bool) -> dict:
    """In one rank of the gloo world: ``arch`` at full width and
    ``layers`` on the (2, 2) mesh with FSDP (the MoE's experts in
    ``layout``; ``axis_params``' weights), one SGD step at LR 0 of the
    global batch of 4 x ``AXIS_SEQ``: the loss and per-sample losses against ``want``'s, and
    every leaf's gradient on this rank against its block of ``want``'s,
    relative to the leaf's max |g|, the max over the ranks."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels import backend
    from repro_torch.launch.hlo_analysis import collective_bytes
    from repro_torch.launch.train import build_ctx, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import SGD
    t0 = time.perf_counter()
    cfg = axis_cfg(arch, full, layers)
    batch = axis_family_batch(dev, cfg, 4)
    params = axis_params(cfg, dev)
    ctx = build_ctx(cfg, mesh, fsdp=True, moe_fsdp_mode=layout)
    model = build_model(cfg, ctx, device=dev)
    local = model.shard(params)
    del params
    free_memory()
    leaves = [t.requires_grad_(True) for _, t in flatten(local)]
    backend.reset_launches()
    calls, moved = collections.Counter(), collections.Counter()
    t1 = time.perf_counter()
    with patched_op("flash_attention", attention_calls(calls)), \
            counted_collectives(moved) as record:
        loss, (lv, _, _) = make_train_step(model, SGD(leaves))(local, batch,
                                                               0.0)
    sync(dev)
    t2 = time.perf_counter()
    err = max(float((t.grad - ctx.local_shard(g, sp)).abs().max())
              / max(float(g.abs().max()), 1e-30)
              for t, g, sp in zip(leaves, unpacked(want["grads"]),
                                  model.leaf_specs(local)))
    errs = torch.tensor([err, abs(float(loss) - want["loss"]),
                         float((lv.cpu() - torch.as_tensor(want["lv"]))
                               .abs().max())], device=dev)
    torch.distributed.all_reduce(errs, op=torch.distributed.ReduceOp.MAX)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "layout": layout,
           "batch": [4, AXIS_SEQ], "tp_size": ctx.tp_size,
           "dp_size": ctx.dp_size, "loss": float(loss),
           "grad_rel_err": float(errs[0]), "loss_err": float(errs[1]),
           "lv_err": float(errs[2]), "leaves": len(leaves),
           "local_params": sum(t.numel() for t in leaves),
           "launches": dict(backend.LAUNCHES),
           "attention_calls": dict(calls), "collective_bytes": dict(moved),
           "collective_wire_bytes": collective_bytes(record),
           "seconds": {"set_up": t1 - t0, "step": t2 - t1,
                       "check": time.perf_counter() - t2}}
    del local, model, leaves
    free_memory()
    return out


def axis_world_serve(dev, rank: int, mesh, want: dict, full: bool) -> dict:
    """In one rank of the gloo world: qwen3-1.7b at full width and
    ``AXIS_LAYERS`` layers (``axis_params``) served on the (2, 2) mesh
    (weights sharded over the model axis only), ``axis_greedy``, and again under
    ``seq_parallel_kv``: each one's logits relative to their max against
    ``want``'s (one device), its tokens against one device's, and the
    sequence-parallel decode's logits against the plain one's."""
    import numpy as np
    import torch
    from repro_torch.kernels import backend
    from repro_torch.launch.train import build_ctx
    from repro_torch.models.model import build_model
    cfg = axis_cfg("qwen3-1.7b", full, AXIS_LAYERS)
    batch = {"tokens": lm_batch(dev, 2, AXIS_SEQ)["tokens"]}
    params = axis_params(cfg, dev)
    ref = torch.as_tensor(want["logits"])
    scale = float(ref.abs().max())
    out, logits = {}, {}
    for name, sp in (("plain", False), ("seq_parallel_kv", True)):
        ctx = build_ctx(cfg, mesh, fsdp=False, seq_parallel_kv=sp)
        backend.reset_launches()
        moved = collections.Counter()
        t0 = time.perf_counter()
        with counted_collectives(moved):
            got = axis_greedy(cfg, ctx, params, batch, dev,
                              AXIS_SEQ + AXIS_GEN)
        sync(dev)
        logits[name] = got["logits"].cpu()
        out[name] = {
            "seconds": time.perf_counter() - t0,
            "logits_rel_err": float((logits[name] - ref).abs().max()) / scale,
            "tokens_equal": bool(np.array_equal(got["tokens"].cpu().numpy(),
                                                np.asarray(want["tokens"]))),
            "local_k": got["local_k"], "collective_bytes": dict(moved),
            "launches": dict(backend.LAUNCHES)}
        del got
    out["sp_vs_plain_rel_err"] = float(
        (logits["seq_parallel_kv"] - logits["plain"]).abs().max()) / scale
    del params
    free_memory()
    return out


def axis_batch(ds, idx, dev) -> dict:
    import numpy as np
    import torch
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in ds.get(np.asarray(idx)).items()}


def axis_arch_plan(dev, arch: str, full: bool):
    """``arch``'s config at ``AXIS_LAYERS`` layers, its corpus, a KAKURENBO
    sampler, the sampler's epoch-0 plan and the first four global batches
    of it (``plan_global_batches``): the same in every rank and in the
    spawning process."""
    from repro_torch.core import KakurenboConfig, make_strategy
    from repro_torch.data import SyntheticLM
    from repro_torch.launch.train import plan_global_batches
    cfg = axis_cfg(arch, full, AXIS_LAYERS if full else None)
    ds = SyntheticLM(num_samples=AXIS_N, seq_len=AXIS_SEQ, vocab_size=64,
                     order=1, easy_fraction=0.7, seed=0)
    strat = make_strategy("kakurenbo", AXIS_N, KakurenboConfig(
        max_fraction=0.3, fraction_milestones=(0, 1, 2, 3)), seed=0,
        device=dev)
    plan = strat.plan(0)
    dp = AXIS_WORLD[0]
    batches = list(itertools.islice(
        plan_global_batches(plan, dp, 4 // dp), 4))
    return cfg, ds, strat, plan, batches


def axis_world_arch(dev, rank: int, mesh, arch: str, full: bool,
                    ref: dict) -> dict:
    """In one rank of the gloo world: ``arch`` at full width and
    ``AXIS_LAYERS`` layers on the (2, 2) mesh with FSDP (``axis_arch_plan``).
    Counts from 0: four AdamW steps over the plan's global batches at
    ``plan_lr``, each step's per-sample losses observed; the first step's
    loss, per-sample losses and gradients (taken before its update)
    against ``ref``, one device's SGD step at LR 0 on the first batch
    (``axis_expectations``; each rank compares its own shards, no
    gradient is gathered); the sampler's epoch-1 plan after the steps."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels import backend
    from repro_torch.launch.hlo_analysis import collective_bytes
    from repro_torch.launch.train import (build_ctx, make_train_step,
                                          optimizer_for, plan_lr,
                                          plan_summary)
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    cfg, ds, strat, plan, batches = axis_arch_plan(dev, arch, full)
    params = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))
    t_ref = time.perf_counter()
    backend.reset_launches()
    ctx = build_ctx(cfg, mesh, fsdp=True)
    model = build_model(cfg, ctx, device=dev)
    local = model.shard(params)
    del params
    leaves = [t.requires_grad_(True) for _, t in flatten(local)]
    step = make_train_step(model, optimizer_for(cfg, leaves))
    lr = plan_lr(1e-3, plan)
    losses, out = [], {}
    moved = collections.Counter()
    for i, idx in enumerate(batches):
        with (counted_collectives(moved) if i == 0
              else contextlib.nullcontext()) as record:
            loss, (lv, pa, pc) = step(local, axis_batch(ds, idx, dev), lr)
        strat.observe(idx, lv, pa, pc, 0)
        losses.append(float(loss))
        if i == 0:
            sync(dev)
            t_first = time.perf_counter()
            # This rank's block of every reference gradient: the error a
            # leaf relative to the leaf's max |g|, the max over the ranks.
            err = max(
                float((t.grad - ctx.local_shard(g, sp)).abs().max())
                / max(float(g.abs().max()), 1e-30)
                for t, g, sp in zip(leaves, unpacked(ref["grads"]),
                                    model.leaf_specs(local)))
            errs = torch.tensor([err, abs(float(loss) - ref["loss"]),
                                 float((lv.cpu() - torch.as_tensor(
                                     ref["lv"])).abs().max())],
                                device=dev)
            torch.distributed.all_reduce(errs,
                                         op=torch.distributed.ReduceOp.MAX)
            out.update({"grad_rel_err": float(errs[0]),
                        "loss_err": float(errs[1]), "lv_err": float(errs[2]),
                        "first_loss": losses[0], "leaves": len(leaves),
                        "first_step_collective_bytes": dict(moved),
                        "first_step_wire_bytes": collective_bytes(record)})
            del ref
    sync(dev)
    t_end = time.perf_counter()
    out.update({
        "arch": cfg.name, "layers": cfg.num_layers, "batch": [4, AXIS_SEQ],
        "tp_size": ctx.tp_size, "dp_size": ctx.dp_size, "fsdp": ctx.fsdp,
        "remat": ctx.remat, "local_params": sum(t.numel() for t in leaves),
        "plan": plan_summary(plan), "next_plan": plan_summary(strat.plan(1)),
        "lr": lr, "step_losses": losses, "launches": dict(backend.LAUNCHES),
        "seconds": {"set_up": t_ref - t0, "first_step": t_first - t_ref,
                    "three_steps": t_end - t_first}})
    del local, model, step, leaves
    free_memory()
    return out


def axis_world_b1(dev, rank: int, mesh, arch: str, layers: int | None,
                  want: dict, full: bool) -> dict:
    """In one rank of the gloo world: a batch of 1 on the (2, 2) mesh,
    which each data rank takes whole.  ``arch`` at ``layers``
    (``axis_params``) served with its weights over the model axis only
    (``axis_greedy`` of ``b1_prompt``, ``AXIS_B1_GEN`` greedy steps): the
    logits relative to their max against ``want``'s one-device logits,
    the tokens against one device's, the gathered cache's rows (1:
    nothing gathered); then at ``AXIS_LAYERS`` one SGD step at LR 0 with
    FSDP on 1 x ``AXIS_SEQ``: the loss and per-sample loss against one
    device's and this rank's block of every gradient (the data ranks'
    shares summed, ``ParallelCtx.dp_share``) relative to the leaf's max
    |g|.  Each error the max over the ranks."""
    import numpy as np
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels import backend
    from repro_torch.launch.train import build_ctx, make_train_step
    from repro_torch.models.model import build_model
    from repro_torch.optim.optimizers import SGD
    cfg = axis_cfg(arch, full, layers)
    params = axis_params(cfg, dev)
    prompt = b1_prompt(dev, full)
    s = prompt["tokens"].shape[1]
    ctx = build_ctx(cfg, mesh, fsdp=False)
    backend.reset_launches()
    t0 = time.perf_counter()
    got = axis_greedy(cfg, ctx, params, prompt, dev, s + AXIS_B1_GEN,
                      AXIS_B1_GEN)
    sync(dev)
    t1 = time.perf_counter()
    ref = torch.as_tensor(want["logits"])
    serve_err = float((got["logits"].cpu() - ref).abs().max()) / float(
        ref.abs().max())
    tokens_equal = bool(np.array_equal(got["tokens"].cpu().numpy(),
                                       np.asarray(want["tokens"])))
    serve_layers = cfg.num_layers
    serve = {"seconds": t1 - t0, "split": ctx.splits_batch(1),
             "cache_rows": sorted({int(v.shape[1]) for k, v in
                                   got["cache"].items() if k != "len"}),
             "launches": dict(backend.LAUNCHES)}
    del got, params
    free_memory()
    cfg = axis_cfg(arch, full, AXIS_LAYERS)
    params = axis_params(cfg, dev)
    ctx = build_ctx(cfg, mesh, fsdp=True)
    model = build_model(cfg, ctx, device=dev)
    local = model.shard(params)
    del params
    free_memory()
    leaves = [t.requires_grad_(True) for _, t in flatten(local)]
    backend.reset_launches()
    t2 = time.perf_counter()
    loss, (lv, _, _) = make_train_step(model, SGD(leaves))(
        local, lm_batch(dev, 1, AXIS_SEQ), 0.0)
    sync(dev)
    t3 = time.perf_counter()
    err = max(float((t.grad - ctx.local_shard(g, sp)).abs().max())
              / max(float(g.abs().max()), 1e-30)
              for t, g, sp in zip(leaves, unpacked(want["grads"]),
                                  model.leaf_specs(local)))
    errs = torch.tensor([serve_err, float(not tokens_equal), err,
                         abs(float(loss) - want["loss"]),
                         float((lv.detach().cpu()
                                - torch.as_tensor(want["lv"])).abs().max())],
                        device=dev)
    torch.distributed.all_reduce(errs, op=torch.distributed.ReduceOp.MAX)
    serve.update(logits_rel_err=float(errs[0]),
                 tokens_equal=bool(errs[1] == 0))
    train = {"seconds": t3 - t2, "loss": float(loss), "lv": lv.tolist(),
             "grad_rel_err": float(errs[2]), "loss_err": float(errs[3]),
             "lv_err": float(errs[4]), "fsdp": ctx.fsdp,
             "launches": dict(backend.LAUNCHES)}
    del local, model, leaves
    free_memory()
    return {"arch": cfg.name, "serve_layers": serve_layers,
            "train_layers": cfg.num_layers, "prompt": s, "gen": AXIS_B1_GEN,
            "mesh": list(AXIS_WORLD), "serve": serve, "train": train}


def model_axis_rank(rank: int, world: int, device_type: str, full: bool,
                    flags: tuple[bool, bool], want: dict) -> dict:
    """One rank of the gloo world (``launch.mesh.spawn``): every rank on
    ``device_type`` (the one card), the (2, 2) ``("data", "model")`` mesh,
    both archs in turn, then ``AXIS_FAMILIES`` (each layout),
    qwen3-1.7b's serving and ``ADAFACTOR_WORLD``'s Adafactor steps (phase
    22's) against ``want`` (``axis_expectations``).  The spawning
    process' TF32 switches are taken."""
    import torch
    from repro_torch.launch.mesh import make_data_model_mesh, rank_device
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    entered_at = time.time()
    torch.set_num_threads(2)
    dev = rank_device(device_type, rank)
    mesh = make_data_model_mesh(*AXIS_WORLD)
    out = {"loaded_at": LOADED_AT, "entered_at": entered_at,
           "started_at": time.time()}
    out.update({arch: axis_world_arch(dev, rank, mesh, arch, full,
                                      want[arch])
                for arch in AXIS_ARCHS})
    out["families"] = [
        axis_world_family(dev, rank, mesh, arch, layers, lay,
                          want[(arch, lay)], full)
        for arch, layers, layouts in AXIS_FAMILIES for lay in layouts]
    out["serve"] = axis_world_serve(dev, rank, mesh, want["serve"], full)
    out["batch_one"] = [
        axis_world_b1(dev, rank, mesh, arch, layers, want[("b1", arch)],
                      full) for arch, layers in AXIS_B1]
    out["adafactor"] = [
        axis_world_adafactor(host_or(dev, host), rank, mesh, arch, layers,
                             width and full, dtype,
                             want[("adafactor", arch, width, host, dtype)])
        for arch, layers, width, host, dtype in ADAFACTOR_WORLD]
    out["ended_at"] = time.time()
    return out


def stream_copy_gbps(dev, mb: int = 64, reps: int = 20) -> float:
    """The card's copy rate (``benchmarks/kernel_micro.py``'s probe: a
    device copy ``a + 0.0`` of ``mb`` MB of float32, read + write bytes
    over the best of ``reps`` timed calls)."""
    import torch
    x = torch.zeros(mb * 1024 * 1024 // 4, device=dev)
    best = float("inf")
    for _ in range(2):
        x + 0.0
    for _ in range(reps):
        best = min(best, time_ms(lambda: x + 0.0, 1))
    return 2 * x.numel() * 4 / (best * 1e-3) / 1e9


def phase_model_axis(dev, full: bool = True, gloo_device: str = "cuda"
                     ) -> tuple[collections.Counter, dict]:
    """The mesh's model axis (``launch/train.py``, ``dist/sharding.py``):
    qwen3-1.7b and mamba2-130m at full width and depth on a (1, 1)
    ``("data", "model")`` mesh under NCCL with FSDP, bit for bit against
    the port without a context (``axis_unit_mesh``), and so are
    ``AXIS_FAMILIES``' AdamW steps and ``AXIS_SERVE``'s serving
    (``axis_unit_serve``); then a gloo world of 4 ranks on this card as
    (2, 2) with FSDP, both archs at full width and ``AXIS_LAYERS`` layers
    (``axis_world_arch``): four KAKURENBO steps, the first one's loss and
    per-sample losses within 1e-5 of one device and its gradients within
    1e-4 of each leaf's max |g|; ``AXIS_FAMILIES`` and qwen3-1.7b's
    serving against ``axis_expectations`` at the same bounds (the
    sequence-parallel decode within 1e-5 of the plain one); B7 and B6 at
    the local shapes against their plain versions, and the card's
    stream-copy rate beside the datasheet's."""
    import torch
    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    row = {"phase": "model_axis", "full": full}
    launches = collections.Counter()
    backend_name = "nccl" if dev.type == "cuda" else "gloo"
    try:
        mesh = mesh_lib.make_data_model_mesh(1, 1, backend_name)
        row["unit_mesh"] = [axis_unit_mesh(dev, a, full, mesh)
                            for a in AXIS_ARCHS]
        row["unit_mesh"] += [axis_unit_mesh(dev, a, full, mesh, layers, lays)
                             for a, layers, lays in AXIS_FAMILIES]
        row["unit_serve"] = [axis_unit_serve(dev, a, full, mesh, layers)
                             for a, layers in AXIS_SERVE]
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    for r in row["unit_mesh"]:
        for m in r["mesh"].values():
            launches.update(m["launches"])
    for r in row["unit_serve"]:
        launches.update(r["launches"])
    row["unit_mesh_seconds"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    want = shared(axis_expectations(dev, full))
    row["expectations_seconds"] = time.perf_counter() - t1
    t1, spawned_at = time.perf_counter(), time.time()
    ranks = mesh_lib.spawn(model_axis_rank, math.prod(AXIS_WORLD), "gloo",
                           gloo_device,
                           (gloo_device, full, tf32_flags(), want))
    del want
    free_memory()
    joined_at = time.time()
    row["gloo_world"] = {"mesh": list(AXIS_WORLD), "ranks": len(ranks),
                         "spawn_and_run_seconds": time.perf_counter() - t1,
                         "load_seconds": max(r["loaded_at"] for r in ranks)
                         - spawned_at,
                         "entry_seconds": max(r["entered_at"] for r in ranks)
                         - spawned_at,
                         "start_seconds": max(r["started_at"] for r in ranks)
                         - spawned_at,
                         "exit_seconds": joined_at - max(r["ended_at"]
                                                         for r in ranks),
                         "archs": {a: ranks[0][a] for a in AXIS_ARCHS},
                         "families": ranks[0]["families"],
                         "serve": ranks[0]["serve"],
                         "batch_one": ranks[0]["batch_one"],
                         "adafactor": ranks[0]["adafactor"]}
    for r in ranks:
        for a in AXIS_ARCHS:
            launches.update(r[a]["launches"])
        for f in r["families"]:
            launches.update(f["launches"])
        for name in ("plain", "seq_parallel_kv"):
            launches.update(r["serve"][name]["launches"])
        for b in r["batch_one"]:
            launches.update(b["serve"]["launches"])
            launches.update(b["train"]["launches"])
    row["gloo_world"]["ranks_agree"] = all(
        r[a]["step_losses"] == ranks[0][a]["step_losses"]
        for r in ranks for a in AXIS_ARCHS) and all(
        [f["loss"] for f in r["families"]]
        == [f["loss"] for f in ranks[0]["families"]] for r in ranks)
    row["gloo_world"]["local_params"] = {
        a: [r[a]["local_params"] for r in ranks] for a in AXIS_ARCHS}
    if dev.type == "cuda":
        q = axis_cfg("qwen3-1.7b", full)
        tp = AXIS_WORLD[1]
        shape = (4 // AXIS_WORLD[0], AXIS_SEQ, q.num_heads // tp,
                 q.num_kv_heads // tp, q.resolved_head_dim)
        row["local_kernels"] = {
            "flash_attention": check_flash_attention(
                dev, shape, True, torch.float32, 1e-5, 20, library=True),
            "ssd_scan": check_ssd_scan(dev, 4 // AXIS_WORLD[0], AXIS_SEQ,
                                       "model", 20)}
        row["stream_copy_gbps"] = stream_copy_gbps(dev)
        row["datasheet_hbm_gbps"] = mesh_lib.HBM_BW / 1e9
    row["launches"] = dict(launches)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    for r in row["unit_mesh"]:
        for name, m in r["mesh"].items():
            require(all(m["equal"][k] for k in ("loss", "metrics"))
                    and m["equal"]["leaves"] == r["n_leaves"],
                    f"model axis: (1, 1) differs from one device: {r['arch']} "
                    f"{name} {m['equal']}")
            for k in ("loss_confidence", "loss_confidence_bwd"):
                require(m["launches"].get(k, 0) > 0,
                        f"model axis: {r['arch']} {name} launched {k} "
                        f"{m['launches'].get(k, 0)} times")
        require(r["leaves_moved"] == r["n_leaves"],
                f"model axis: AdamW moved {r['leaves_moved']} of "
                f"{r['n_leaves']} leaves ({r['arch']})")
        if r["arch"] == ENCDEC:
            for name, m in r["mesh"].items():
                require(m["attention_calls"].get("full", 0) > 0
                        and m["attention_calls"].get("causal", 0) > 0,
                        f"model axis: {ENCDEC} {name} B7 calls "
                        f"{m['attention_calls']} (encoder full, decoder "
                        "causal)")
    for r in row["unit_serve"]:
        require(all(r["equal"].values()),
                f"model axis: (1, 1) serving differs from one device: "
                f"{r['arch']} {r['equal']}")
    kernel_of = {"qwen3-1.7b": "flash_attention",
                 "phi3.5-moe-42b-a6.6b": "flash_attention",
                 "mamba2-130m": "ssd_scan"}
    for r in row["unit_serve"]:
        k = kernel_of[r["arch"]]
        require(r["launches"].get(k, 0) > 0,
                f"model axis: {r['arch']}'s mesh prefill launched {k} "
                f"{r['launches'].get(k, 0)} times")
    for a in AXIS_ARCHS:
        got = ranks[0][a]
        require(got["loss_err"] <= 1e-5 and got["lv_err"] <= 1e-5,
                f"model axis: {a} loss vs one device {got['loss_err']}, "
                f"per-sample {got['lv_err']}")
        require(got["grad_rel_err"] <= 1e-4,
                f"model axis: {a} gradient {got['grad_rel_err']} of its max")
        require(len(got["step_losses"]) == 4
                and all(math.isfinite(x) for x in got["step_losses"]),
                f"model axis: {a} plan {got['plan']}, steps "
                f"{got['step_losses']}")
    for f in ranks[0]["families"]:
        tag = f"{f['arch']} ({f['layout']})"
        require(f["loss_err"] <= 1e-5 and f["lv_err"] <= 1e-5,
                f"model axis: {tag} loss vs one device {f['loss_err']}, "
                f"per-sample {f['lv_err']}")
        require(f["grad_rel_err"] <= 1e-4,
                f"model axis: {tag} gradient {f['grad_rel_err']} of its max")
        for k in ("loss_confidence", "loss_confidence_bwd"):
            require(f["launches"].get(k, 0) > 0,
                    f"model axis: {tag} launched {k} "
                    f"{f['launches'].get(k, 0)} times")
        if f["arch"] == ENCDEC:
            require(f["attention_calls"].get("full", 0) > 0
                    and f["attention_calls"].get("causal", 0) > 0,
                    f"model axis: {tag} B7 calls {f['attention_calls']}")
    sv = ranks[0]["serve"]
    for name in ("plain", "seq_parallel_kv"):
        require(sv[name]["logits_rel_err"] <= 1e-5 and sv[name]["tokens_equal"],
                f"model axis: served qwen3 ({name}) vs one device "
                f"{sv[name]['logits_rel_err']}, tokens equal "
                f"{sv[name]['tokens_equal']}")
        require(sv[name]["launches"].get("flash_attention", 0) > 0,
                f"model axis: the mesh prefill ({name}) launched "
                f"flash_attention {sv[name]['launches']}")
    b1_kernels = {"mamba2-130m": ("ssd_scan",),
                  "hymba-1.5b": ("flash_attention", "ssd_scan")}
    for b in ranks[0]["batch_one"]:
        sv1, tr1 = b["serve"], b["train"]
        require(not sv1["split"] and sv1["cache_rows"] == [1],
                f"model axis: batch 1 of {b['arch']} split over the data "
                f"ranks: {sv1['split']}, cache rows {sv1['cache_rows']}")
        require(sv1["logits_rel_err"] <= 1e-5 and sv1["tokens_equal"],
                f"model axis: batch 1 of {b['arch']} served vs one device "
                f"{sv1['logits_rel_err']}, tokens equal "
                f"{sv1['tokens_equal']}")
        require(tr1["loss_err"] <= 1e-5 and tr1["lv_err"] <= 1e-5
                and tr1["grad_rel_err"] <= 1e-4,
                f"model axis: batch 1 of {b['arch']} trained vs one device: "
                f"loss {tr1['loss_err']}, per-sample {tr1['lv_err']}, "
                f"gradient {tr1['grad_rel_err']} of its max")
        for k in b1_kernels[b["arch"]]:
            require(sv1["launches"].get(k, 0) > 0,
                    f"model axis: batch 1 of {b['arch']} served, {k} "
                    f"launched {sv1['launches'].get(k, 0)} times")
        for k in ("loss_confidence", "loss_confidence_bwd"):
            require(tr1["launches"].get(k, 0) > 0,
                    f"model axis: batch 1 of {b['arch']} trained, {k} "
                    f"launched {tr1['launches'].get(k, 0)} times")
    require(sv["sp_vs_plain_rel_err"] <= 1e-5,
            f"model axis: sequence-parallel decode vs plain "
            f"{sv['sp_vs_plain_rel_err']}")
    for a in ranks[0]["adafactor"]:
        require(a["rel_err"] <= 1e-5,
                f"model axis: Adafactor on {a['arch']}'s sharded leaves "
                f"({a['device']}, {a['dtype']}) {a['rel_err']} of one "
                "device's largest change")
        tag = f"{a['arch']} ({a['device']}, {a['dtype']})"
        bound = 1e-5 if a["dtype"] == "float64" else ADAFACTOR_WHOLE_TOL
        require(a["whole_rel_err"] <= bound
                and a["whole_grad_rel_err"] <= 1e-4,
                f"model axis: a whole Adafactor step of {tag} "
                f"{a['whole_rel_err']} of one device's largest change (bound "
                f"{bound}), gradients {a['whole_grad_rel_err']} of their max")
    require(row["gloo_world"]["ranks_agree"], "model axis: ranks differ")
    for name in ("flash_attention", "ssd_scan", "loss_confidence",
                 "loss_confidence_bwd"):
        require(launches.get(name, 0) > 0,
                f"model axis: {name} never launched")
    return launches, row.get("local_kernels", {})

# ---------------------------------------------------------------------------
# The dry run, the recompute policies and Adafactor on the mesh (phase 22)

#: The recompute policies' model (full width and depth) and its batch.
REMAT_ARCH = "qwen3-1.7b"
REMAT_BATCH = 2
#: (name, ``build_ctx``'s remat, remat_policy): the three ways one AdamW
#: step runs on the (1, 1) mesh.
REMAT_RUNS = (("none", False, "nothing"), ("nothing", True, "nothing"),
              ("dots", True, "dots"))
#: Adafactor in the gloo world: (arch, cut depth or None, full width,
#: on the host's CPU, dtype).  The last two are one config's twins on the
#: host (the plain kernels, float32 and float64): a whole step on the mesh
#: parts from one device's in float32 where its float64 twin does not.
ADAFACTOR_WORLD = (("kimi-k2-1t-a32b", None, False, False, "float32"),
                   ("qwen3-1.7b", AXIS_LAYERS, True, False, "float32"),
                   ("qwen3-1.7b", AXIS_LAYERS, False, True, "float32"),
                   ("qwen3-1.7b", AXIS_LAYERS, False, True, "float64"))
#: Their LR: large enough that one ulp of a norm weight near 1.0 stays
#: well under 1e-5 of the largest change (at 1e-3 it does not).
ADAFACTOR_LR = 1e-2
#: A whole float32 Adafactor step on the gloo world against one device's,
#: relative to one device's largest change: about 3x the largest reading
#: of a sound run (1.74e-5, qwen3-1.7b at 4 layers on the card; the host
#: twin reads 1.60e-5 in float32 and 3.4e-7 in float64).  Adafactor's
#: normalised update turns the gradients' float32 sum orders into changes
#: of order the LR in rows of small gradients; the float64 twin is held to
#: 1e-5.
ADAFACTOR_WHOLE_TOL = 5e-5
#: The allocator's rounding of one tensor (``argument_size_in_bytes``).
ALLOC_ROUND = 512
#: The dry run of the remat runs' step, in a process of its own that
#: never touches the card: argv[1] is the JSON of (arch, full, batch, seq).
DRY_RUN_CELL = """
import json, sys, torch
from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import run_cell
arch, full, batch, seq = json.loads(sys.argv[1])
cfg = get_arch(arch) if full else get_arch(arch).reduced()
rec = run_cell(cfg, ShapeSpec("card", seq, batch, "train"), mesh_shape=(1, 1),
               dtype=torch.float32)
print(json.dumps(rec))
"""

#: Run after ``DRY_RUN_CELL`` in its process (one start and warm-up of
#: the dry run): the cells of a batch that does not divide the data axes
#: (``long_500k``, batch 1 over 16 data ranks) on both production meshes,
#: and internlm2-20b ``train_4k`` by its L = 2 and 4 probes, each deciding
#: FSDP for its own depth; one JSON line after the cell's.
DRY_RUN_PROBES = """
import json, types
from repro_torch.configs.registry import get_arch
from repro_torch.launch.dryrun import run_cell, run_cell_extrapolated
from repro_torch.launch.train import build_ctx
keys = ("status", "error", "fsdp", "probe_fsdp", "memory", "total_s")
out = {"long_500k": {}}
for arch in ("hymba-1.5b", "mamba2-130m"):
    for mp in (False, True):
        rec = run_cell(arch, "long_500k", multi_pod=mp)
        out["long_500k"][arch + " " + rec["mesh"]] = {
            k: rec.get(k) for k in keys}
rec = run_cell_extrapolated("internlm2-20b", "train_4k")
out["internlm2_train_4k"] = {k: rec.get(k) for k in keys}
mesh = types.SimpleNamespace(shape={"data": 16, "model": 16},
                             axis_names=("data", "model"))
out["internlm2_train_4k"]["full_depth_fsdp"] = build_ctx(
    get_arch("internlm2-20b"), mesh).fsdp
print(json.dumps(out))
"""


def adafactor_cfg(arch: str, full: bool, layers: int | None):
    """``arch`` (reduced unless ``full``; ``layers`` its cut depth) trained
    with Adafactor."""
    return dataclasses.replace(axis_cfg(arch, full, layers),
                               optimizer="adafactor")


def adafactor_step(cfg, ctx, params: dict, batch: dict, dev):
    """One ``make_train_step`` with ``optimizer_for``'s Adafactor (its
    stacked leaves, ``shard_over`` on a mesh) on ``ctx``'s shards of
    ``params`` (None: one device), the MoE's experts in ``"partial"`` (the
    whole batch routed, as one device routes it).  Returns (loss, the
    local tree after the step, the model, the optimizer)."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.launch.train import make_train_step, optimizer_for
    from repro_torch.models.model import build_model
    model = build_model(cfg, ctx, device=dev)
    local = model.shard(params)
    for _, t in flatten(local):
        t.requires_grad_(True)
    opt = optimizer_for(cfg, local)
    loss, _ = make_train_step(model, opt)(local, batch, ADAFACTOR_LR)
    return loss.detach(), local, model, opt


def adafactor_expectation(dev, arch: str, layers, full_width: bool,
                          dtype: str) -> dict:
    """One device's Adafactor step of ``arch`` in ``dtype`` on ``AXIS_SEQ``
    x 4 (``axis_params``' weights): its loss, its gradients and the
    parameters after it (``packed``, for the gloo world) and the largest
    change of one parameter."""
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.models.transformer import unstack_layers
    cfg = adafactor_cfg(arch, full_width, layers)
    params = axis_params(cfg, dev, dtype)
    loss, local, _, _ = adafactor_step(cfg, None, params,
                                       lm_batch(dev, 4, AXIS_SEQ), dev)
    leaves = [t for _, t in flatten(local)]
    change = max(float((a.detach() - b).abs().max()) for a, (_, b) in zip(
        leaves, flatten(unstack_layers(params, copy=False))))
    out = {"loss": float(loss), "max_change": change,
           "params": packed([t.detach() for t in leaves]),
           "grads": packed([t.grad for t in leaves])}
    del params, local, leaves
    free_memory()
    return out


def axis_world_adafactor(dev, rank: int, mesh, arch: str, layers,
                         full_width: bool, dtype: str, want: dict) -> dict:
    """In one rank of the gloo world: ``arch``'s shards on the (2, 2) mesh
    with FSDP, every leaf against its block of one device's updated
    parameters, relative to one device's largest change, the max over the
    ranks, after

    - Adafactor's update alone (its moments and RMS reduced over each
      leaf's mesh axes, ``shard_over``) from this rank's block of one
      device's gradients (``rel_err``): the optimizer;
    - a whole step on the mesh from the same weights (``whole_rel_err``),
      its gradients against one device's (``whole_grad_rel_err``,
      relative to each leaf's max |g|).

    The weights and the batch are in ``dtype`` (the optimizer's own
    arithmetic is float32 in both)."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.launch.train import build_ctx, optimizer_for
    from repro_torch.models.model import build_model
    t0 = time.perf_counter()
    cfg = adafactor_cfg(arch, full_width, layers)
    ctx = build_ctx(cfg, mesh, fsdp=True, moe_fsdp_mode="partial")
    model = build_model(cfg, ctx, device=dev)
    params = axis_params(cfg, dev, dtype)
    local = model.shard(params)
    free_memory()
    specs = model.leaf_specs(local)
    leaves = [t for _, t in flatten(local)]
    for t, g, sp in zip(leaves, unpacked(want["grads"]), specs):
        t.grad = ctx.local_shard(g, sp).clone()
    opt = optimizer_for(cfg, local)
    opt.shard_over(ctx, specs)
    opt.step(ADAFACTOR_LR)
    sync(dev)
    t1 = time.perf_counter()

    def worst(local) -> list:
        return sorted(
            ((float((t.detach() - ctx.local_shard(w, sp)).abs().max())
              / want["max_change"], path)
             for (path, t), w, sp in zip(flatten(local),
                                         unpacked(want["params"]), specs)),
            reverse=True)[:3]
    alone = worst(local)
    del local, leaves, opt
    free_memory()
    t2 = time.perf_counter()
    loss, local, _, _ = adafactor_step(cfg, ctx, params,
                                       lm_batch(dev, 4, AXIS_SEQ), dev)
    sync(dev)
    t3 = time.perf_counter()
    whole = worst(local)
    grad_err = max(float((t.grad - ctx.local_shard(g, sp)).abs().max())
                   / max(float(g.abs().max()), 1e-30)
                   for (_, t), g, sp in zip(flatten(local),
                                            unpacked(want["grads"]), specs))
    errs = torch.tensor([alone[0][0], whole[0][0], grad_err,
                         abs(float(loss) - want["loss"])], device=dev)
    torch.distributed.all_reduce(errs, op=torch.distributed.ReduceOp.MAX)
    out = {"arch": cfg.name, "layers": cfg.num_layers, "full": full_width,
           "device": dev.type, "dtype": dtype,
           "rel_err": float(errs[0]), "whole_rel_err": float(errs[1]),
           "whole_grad_rel_err": float(errs[2]),
           "whole_loss_err": float(errs[3]),
           "max_change": want["max_change"], "worst_leaves": alone,
           "whole_worst_leaves": whole,
           "seconds": {"optimizer": t1 - t0, "whole_step": t3 - t2}}
    del local, params, model
    free_memory()
    return out


def remat_run(dev, mesh, cfg, params: dict, batch: dict, remat: bool,
              policy: str, ref: dict | None) -> dict:
    """Two AdamW steps of ``cfg`` on the (1, 1) ``mesh`` under a recompute
    policy (the first warms the path up): both losses and the last
    step's gradients against ``ref``'s (None: kept as the reference, on
    the card, leaf by leaf), the bytes the shards, the optimizer state
    and the LR asked the caching allocator for (``requested_bytes``) and
    took from it (``memory_allocated``), each step's seconds, and the second step's peaks of
    allocated bytes over the bytes held before it: at the forward's end
    (the saved tensors, what the policy sets), before the optimizer and
    over the step (the first step's allocate the gradients, as the dry
    run's ``temp_size_in_bytes`` counts them)."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels import backend
    from repro_torch.launch.train import (build_ctx, make_train_step,
                                          optimizer_for)
    from repro_torch.models.model import build_model
    cuda = dev.type == "cuda"

    def allocated() -> int:
        return torch.cuda.memory_allocated(dev) if cuda else 0

    def peak() -> int:
        return torch.cuda.max_memory_allocated(dev) if cuda else 0
    ctx = build_ctx(cfg, mesh, remat=remat, remat_policy=policy)
    model = build_model(cfg, ctx, device=dev)
    a0, r0 = allocated(), requested_bytes(dev)
    local = model.shard(params)
    leaves = [t.requires_grad_(True) for _, t in flatten(local)]
    opt = optimizer_for(cfg, local)
    a1, r1 = allocated(), requested_bytes(dev)
    peaks = {}
    forward, step_opt = model.loss_and_metrics, opt.step

    def watched_forward(*a, **k):
        out = forward(*a, **k)
        peaks["forward"] = peak()
        return out

    def watched_step(*a, **k):
        peaks["backward"] = peak()
        return step_opt(*a, **k)
    model.loss_and_metrics, opt.step = watched_forward, watched_step
    step = make_train_step(model, opt)
    backend.reset_launches()
    losses, seconds, temps = [], [], []
    for _ in range(2):
        sync(dev)
        held = allocated()
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        loss, _ = step(local, batch, 1e-3)
        sync(dev)
        seconds.append(time.perf_counter() - t0)
        losses.append(loss.detach())
        peaks["step"] = peak()
        temps.append({k: v - held for k, v in peaks.items()})
    # Break the watchers' cycles (opt -> watched_step -> opt.step), or the
    # run's state outlives it into the next run's.
    del model.loss_and_metrics, opt.step
    del forward, step_opt, watched_forward, watched_step
    grads = [t.grad for t in leaves]
    tensors = leaves + opt.state_tensors() + [opt.lr]
    out = {"losses": [float(x) for x in losses], "fsdp": ctx.fsdp,
           "remat": ctx.remat, "remat_policy": ctx.remat_policy,
           "requested_bytes": r1 - r0,
           "tensor_bytes": sum(t.untyped_storage().nbytes()
                               for t in tensors),
           "tensors": len(tensors), "allocated_bytes": a1 - a0,
           "held_before_step": held, "seconds": seconds,
           "temp_bytes": temps,
           "launches": dict(backend.LAUNCHES)}
    if ref is None:
        out["ref"] = {"losses": losses, "grads": grads}
        out["equal"] = {"losses": True, "grads": True}
    else:
        out["equal"] = {
            "losses": all(torch.equal(a, b)
                          for a, b in zip(losses, ref["losses"])),
            "grads": len(grads) == len(ref["grads"]) and all(
                torch.equal(a, b) for a, b in zip(grads, ref["grads"]))}
    del local, leaves, opt, step, model, grads, tensors
    free_memory()
    return out


def requested_bytes(dev) -> int:
    """The bytes the live tensors on ``dev`` asked the caching allocator
    for (its ``requested_bytes`` counter: before its rounding to 512 B
    and its blocks; 0 off the card)."""
    import torch
    if dev.type != "cuda":
        return 0
    stats = torch.cuda.memory_stats(dev)
    if "requested_bytes.all.current" not in stats:
        raise RuntimeError("this torch's allocator counts no requested bytes")
    return stats["requested_bytes.all.current"]


def adafactor_unit_mesh(dev, mesh) -> dict:
    """kimi-k2 reduced: one Adafactor step without a context and on the
    (1, 1) ``mesh`` with FSDP: the loss, every parameter and every state
    tensor bit for bit."""
    import torch
    from repro_torch.checkpoint.checkpoint import flatten
    from repro_torch.kernels import backend
    from repro_torch.launch.train import build_ctx
    from repro_torch.models.transformer import unstack_layers
    cfg = adafactor_cfg("kimi-k2-1t-a32b", False, None)
    params = axis_params(cfg, dev)
    batch = lm_batch(dev, 4, AXIS_SEQ)
    got = []
    backend.reset_launches()
    for ctx in (None, build_ctx(cfg, mesh, fsdp=True)):
        loss, local, _, opt = adafactor_step(cfg, ctx, params, batch, dev)
        got.append((loss, [t.detach() for _, t in flatten(local)],
                    opt.state_tensors()))
    (la, pa, sa), (lb, pb, sb) = got
    out = {"arch": cfg.name, "loss": float(la),
           "equal": {"loss": bool(torch.equal(la, lb)),
                     "params": sum(torch.equal(a, b) for a, b in zip(pa, pb)),
                     "state": sum(torch.equal(a, b) for a, b in zip(sa, sb))},
           "n_params": len(pa), "n_state": len(sa),
           "moved": sum(not torch.equal(a, b) for a, (_, b) in zip(
               pa, flatten(unstack_layers(params, copy=False)))),
           "launches": dict(backend.LAUNCHES)}
    del params, got
    free_memory()
    return out


def phase_dry_run(dev, full: bool = True) -> collections.Counter:
    """The dry run (``launch/dryrun.py``) against the card, the recompute
    policies and Adafactor on a (1, 1) mesh under NCCL:

    - qwen3-1.7b at full width and depth, two AdamW steps of 2 x
      ``AXIS_SEQ`` tokens run three ways (no remat, ``"nothing"``,
      ``"dots"``; ``remat_run``): the losses and the gradients bit for
      bit, the second step's peak of allocated bytes at the forward's end
      (the saved tensors) ``nothing <= dots <= none``; at this size the
      step's own peak is the optimizer's (the gradients and AdamW's
      temporaries), the same in all three, and is recorded beside it;
    - the same step on meta tensors over a fake (1, 1) group, in a process
      of its own: the bytes the card's shards, optimizer state, LR and
      batch asked the caching allocator for while they were made (its
      ``requested_bytes`` counter, so anything else made then counts
      too) within ``ALLOC_ROUND`` a tensor of the record's
      ``argument_size_in_bytes``; beside it the tensors' own bytes and
      the bytes ``memory_allocated`` grew by (the allocator's blocks: it
      leaves a large block unsplit below 1 MB of remainder), and the
      record's predicted peak beside the card's;
    - kimi-k2 reduced, one Adafactor step at (1, 1) bit for bit the step
      without a context (phase 21's gloo world holds the sharded update,
      and qwen3-1.7b's at ``AXIS_LAYERS`` layers, against one device);
    - ``python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape
      train_4k --extrapolate`` on this host: status ``ok``;
    - ``DRY_RUN_PROBES``, after the same step's dry run in its process:
      the four ``long_500k`` cells (batch 1, replicated over the data
      axes) ``ok``, and internlm2-20b ``train_4k``'s L = 2 and 4 probes
      each deciding FSDP for its own depth (no FSDP: under the threshold)
      where the full depth shards.

    The two host processes run while the card works."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import mesh as mesh_lib
    t0 = time.perf_counter()
    row = {"phase": "dry_run", "full": full}
    launches = collections.Counter()
    env = dict(os.environ, PYTHONPATH=str(SRC), CUDA_VISIBLE_DEVICES="")
    out_dir = tempfile.mkdtemp(prefix="dryrun_")
    procs = {
        "witness": subprocess.Popen(
            [sys.executable, "-c", DRY_RUN_CELL + DRY_RUN_PROBES,
             json.dumps([REMAT_ARCH, full, REMAT_BATCH, AXIS_SEQ])],
            cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True),
        "production": subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             "qwen3-1.7b", "--shape", "train_4k", "--extrapolate", "--out",
             out_dir], cwd=ROOT, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)}
    started = time.perf_counter()
    try:
        cfg = get_arch(REMAT_ARCH) if full else get_arch(REMAT_ARCH).reduced()
        backend_name = "nccl" if dev.type == "cuda" else "gloo"
        mesh = mesh_lib.make_data_model_mesh(1, 1, backend_name)
        try:
            cuda = dev.type == "cuda"
            r0 = requested_bytes(dev)
            a0 = torch.cuda.memory_allocated(dev) if cuda else 0
            batch = lm_batch(dev, REMAT_BATCH, AXIS_SEQ)
            batch_requested = requested_bytes(dev) - r0
            batch_allocated = (torch.cuda.memory_allocated(dev) - a0
                               if cuda else 0)
            batch_bytes = sum(t.untyped_storage().nbytes()
                              for t in batch.values())
            # The weights wait on the host: each run's shards are copied
            # from them, and the card keeps room for the first run's
            # gradients beside the later runs'.
            params = tree_to(build_model_params(cfg, dev), "cpu")
            free_memory()
            runs, ref = {}, None
            for name, remat, policy in REMAT_RUNS:
                runs[name] = remat_run(dev, mesh, cfg, params, batch, remat,
                                       policy, ref)
                if ref is None:
                    ref = runs[name].pop("ref")
            del params, ref
            free_memory()
            unit = adafactor_unit_mesh(dev, mesh)
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        outs = {k: p.communicate(timeout=600) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    row["host_seconds"] = time.perf_counter() - started
    row["remat"] = runs
    for r in runs.values():
        launches.update(r["launches"])
    launches.update(unit["launches"])
    row["adafactor_unit_mesh"] = unit
    witness, cell = outs["witness"], outs["production"]
    failed = {"status": "failed", "stderr": witness[1][-2000:]}
    lines = (witness[0].strip().splitlines()
             if procs["witness"].returncode == 0 else [])
    rec = json.loads(lines[-2]) if len(lines) >= 2 else failed
    row["probes"] = json.loads(lines[-1]) if len(lines) >= 2 else failed
    nothing = runs["nothing"]
    tensors = nothing["tensors"] + len(batch)
    requested = nothing["requested_bytes"] + batch_requested
    mem = rec.get("memory") or {}
    row["witness"] = {
        "status": rec.get("status"), "error": rec.get("error"),
        "fsdp": rec.get("fsdp"), "memory": mem,
        "requested_argument_bytes": requested,
        "tensor_argument_bytes": nothing["tensor_bytes"] + batch_bytes,
        "allocated_argument_bytes": nothing["allocated_bytes"]
        + batch_allocated,
        "tensors": tensors,
        "predicted_temp_bytes": mem.get("temp_size_in_bytes"),
        "measured_temp_bytes": nothing["temp_bytes"][0]["step"],
        "hlo_flops": rec.get("hlo_flops"), "run_s": rec.get("run_s"),
        "total_s": rec.get("total_s")}
    files = sorted(Path(out_dir).glob("*.json"))
    cell_rec = json.loads(files[0].read_text()) if files else {}
    row["production_cell"] = {
        "returncode": procs["production"].returncode,
        "status": cell_rec.get("status"), "error": cell_rec.get("error"),
        "total_s": cell_rec.get("total_s"),
        "roofline": cell_rec.get("roofline"),
        "memory": cell_rec.get("memory"),
        "stderr": cell[1][-1000:] if procs["production"].returncode else ""}
    row["launches"] = dict(launches)
    row["seconds"] = time.perf_counter() - t0
    emit(row)
    cells = row["probes"].get("long_500k", {})
    require(len(cells) == 4 and all(c["status"] == "ok"
                                    for c in cells.values()),
            f"dry run: the long_500k cells {cells or row['probes']}")
    intern = row["probes"].get("internlm2_train_4k", {})
    require(intern.get("status") == "ok"
            and intern.get("probe_fsdp") == [False, False]
            and intern.get("full_depth_fsdp") is True,
            f"dry run: internlm2-20b train_4k's probes {intern}")
    for name, r in runs.items():
        require(all(r["equal"].values()),
                f"dry run: remat {name} differs from no remat: {r['equal']}")
    require(rec.get("status") == "ok",
            f"dry run: the witness cell {rec.get('status')}: "
            f"{rec.get('error') or rec.get('stderr')}")
    require(row["production_cell"]["status"] == "ok",
            f"dry run: the production cell {row['production_cell']}")
    eq = unit["equal"]
    require(eq["loss"] and eq["params"] == unit["n_params"]
            and eq["state"] == unit["n_state"] and unit["moved"] > 0,
            f"dry run: Adafactor at (1, 1) differs from no context: "
            f"{unit['equal']}, moved {unit['moved']}")
    if dev.type == "cuda":
        fwd = {n: r["temp_bytes"][-1]["forward"] for n, r in runs.items()}
        require(fwd["nothing"] <= fwd["dots"] <= fwd["none"],
                f"dry run: forward peaks not nothing <= dots <= none: {fwd}")
        pred = mem["argument_size_in_bytes"]
        require(abs(requested - pred) <= ALLOC_ROUND * tensors,
                f"dry run: argument bytes on the card {requested}, predicted "
                f"{pred} ({tensors} tensors)")
    for name in ("flash_attention", "loss_confidence", "loss_confidence_bwd"):
        require(launches.get(name, 0) > 0,
                f"dry run: {name} never launched")
    return launches


def build_model_params(cfg, dev) -> dict:
    """Seed-0 draws of ``cfg`` on ``dev`` (the reference's init)."""
    import torch
    from repro_torch.models.model import build_model
    return build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(0))


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
    # The staged path of the same kernel source (the mesh's cross-shard
    # plan): B2 and B3 as launches of their own, then the CDF walks with
    # the masks (the reference's jnp walk after its psum).
    "histogram_range": ("src/repro_torch/kernels/csrc/threshold_select.cu",
                        "src/repro/kernels/threshold_select.py:114"),
    "histogram_count": ("src/repro_torch/kernels/csrc/threshold_select.cu",
                        "src/repro/kernels/threshold_select.py:71"),
    "histogram_walk": ("src/repro_torch/kernels/csrc/threshold_select.cu",
                       "src/repro/core/planops.py:384"),
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
    witnesses = {"--hymba-lr-witness": witness_hymba_lr,
                 "--encdec-lr-witness": witness_encdec_lr,
                 "--model-axis": phase_model_axis,
                 "--dry-run": phase_dry_run,
                 "--samplers": phase_samplers}
    if not (argv == [] or (len(argv) == 1 and argv[0] in witnesses)):
        print("usage: chip_smoke.py [--hymba-lr-witness | "
              "--encdec-lr-witness | --model-axis | --dry-run | "
              "--samplers]",
              file=sys.stderr)
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
    if argv:
        witnesses[argv[0]](dev)
        emit({"phase": "done", "seconds": time.perf_counter() - t_start})
        print(smi, flush=True)
        emit({"ok": True, "device": {"platform": "gpu",
                                     "kind": torch.cuda.get_device_name(0),
                                     "count": torch.cuda.device_count()}})
        return 0
    main_rows, lm_rows = phase_kernels(dev)
    main_rows.update(staged_kernel_checks(dev))
    zoo_rows = zoo_kernel_checks(dev)
    for name, extra in encdec_kernel_checks(dev).items():
        zoo_rows.setdefault(name, []).extend(extra)
    phase_plan(dev)
    launches = collections.Counter(phase_train(dev))
    launches.update(phase_samplers(dev))
    launches.update(phase_table2(dev))
    phase_train_step(dev)
    for engine in ("host", "scan"):
        emit(epoch_split(dev, engine))
    phase_engines(dev, n=CHECK_N, epochs=2)
    phase_restart(dev, n=CHECK_N)
    launches.update(phase_resilience(dev))
    launches.update(phase_table3(dev))
    phase_card_vs_cpu(dev)
    launches.update(phase_compression(dev))
    launches.update(phase_mesh(dev))
    axis_launches, axis_rows = phase_model_axis(dev)
    launches.update(axis_launches)
    launches.update(phase_dry_run(dev))
    launches.update(phase_serve(dev, "mamba2-130m"))
    launches.update(phase_serve(dev, "smollm-135m"))
    launches.update(phase_lm_train(dev))
    for arch, layers, expected in (*ZOO_SERVE, ENCDEC_SERVE):
        launches.update(phase_zoo_serve(dev, arch, layers, expected))
    launches.update(phase_zoo_serve(dev, "kimi-k2-1t-a32b", None,
                                    {"flash_attention": 2}, full=False))
    launches.update(phase_zoo_lm(dev))
    launches.update(phase_encdec_lm(dev))

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
        if name in axis_rows:
            # The same kernel at the model axis' local shapes.
            rows[-1]["model_axis"] = {k: axis_rows[name].get(k) for k in (
                "shape", "max_abs_err", "f64_err", "plain_f64_err", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "library_backend")}
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
