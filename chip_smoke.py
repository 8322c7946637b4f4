"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. card: its name and power limit; TF32 is switched off for matmuls and
   cuDNN, so float32 means float32 on the card as on the CPU;
2. build: every CUDA kernel of the port and the native reward scorer, one
   compiler (``nvcc``, or ``g++``) per source, started together, into
   ``image_caption_tpu_torch/_build/``;
3. kernel check: each kernel against its plain PyTorch version on the card,
   in float32 and bfloat16: the forward at the serving shapes, the
   decoder's training shapes, a ragged case and two shapes too large for
   one block's shared memory (30,000 keys; 300,000 query rows), the
   backward at the four training shapes, the ragged case and its other
   block layouts (the largest tiles one block takes, rows of 5 and 6
   floats; fully masked rows give exactly zero dq and finite dk, dv); both
   also at the four training shapes with 16 heads, one rank's of a model
   group of two, and at a sequence-parallel rank's shapes (its block of
   slots against every slot: Lq 7 against Lk 21, Lq 12 against Lk 36,
   and its 12 slots' pairs);
4. gradient check: ``torch.autograd.grad`` through ``sdp_attention``
   without weights (the two kernels) and with them (the plain path) on
   the card agree for q, k and v; two launches of each
   attention kernel at each training shape in float32, at 32 and at 16
   heads, are bitwise equal;
5. times: each kernel, its plain version and one PyTorch library call for
   the same function (the backward's: ``scaled_dot_product_attention``'s
   forward plus backward, minus its forward), by CUDA events (10 warm-up
   runs, median of 50), beside the least time the card could take; the
   forward at the serving and the decoder's training shapes, the backward
   at the four training shapes, each of these also at 16 heads;
5b. mla_decode: the latent attention of the ``mla_moe`` decode step
    (``csrc/mla_decode.cu``, bf16) at the ``kimi_vl_a3b`` cell's step
    (batch 1024, 87 cache rows, the cell's share of pad slots) at
    positions 38, 62 and 86, on the card tests' inputs: against the plain
    version on the CPU (max|c| / 128 + |plain| / 64); its device time
    beside its byte bound (the visible rows), the plain version's and the
    chain it replaced (two bf16 bmms and the passes between), cycling four
    input sets so the cache comes from device memory;
5c. kimi decode: the ``kimi_vl_a3b.decode_greedy`` cell's model at full
    size (meta, then filled on the card with the benchmark's seeded
    weights) decodes a batch of 1024 of the cell's region features through
    ``decode_split``, then a second: kernel #5's launches on each (27 on
    the eager first step and 27 at capture, then none: the steps replay
    graphs); the first step again with the plain version in the kernel's
    place and the kernel beside it at each of the 27 layers, on the same
    inputs (the card tests' tolerance); the logits of both passes and the
    rows a router near-tie sent to other experts, printed;
6. slice (serving): the flagship captioner at full width, random weights
   from ``torch.Generator`` seed 0, decodes a 70-image split greedily and
   with beam 3 through ``decode_split``; the kernel launch counts are read
   around that run, and the first batch is decoded again on the CPU through
   the plain path and compared;
7. train: the flagship's XE preset at full width with attention dropout 0
   (residual dropout 0.3 stays on), batch 32, random weights: 20
   ``Trainer.train_step`` calls on one batch (steps/s; the loss falls; each
   kernel launched exactly 13 times a step), one step under the profiler;
8. train loop: one epoch of ``train()`` on a synthetic dataset written to a
   temporary directory (valid decode, scores file, checkpoint), then a
   second ``train()`` call that resumes from that checkpoint;
9. card vs CPU: the same weights with all dropout off, 3 train steps on the
   card (kernels) and on the CPU (plain path): step-1 gradients within 1e-4
   norm-relative per tensor, the three losses within 2e-4; then scan
   steps: ``train.scan_steps`` K=4 (``Trainer.shard_stacked`` and
   ``train_steps_device``) against K=1 on 12 batches of phase 7's preset,
   each twice (K=1, K=4, K=4, K=1) from the same weights: the parameters
   bitwise equal (else the largest difference, which fails above 1e-6
   norm-relative), 13 launches of each kernel a step, the steps/s of both,
   one K=4 dispatch under the profiler (idle share);
10. scst: the flagship RL preset at full width with attention dropout 0
    (residual dropout 0.3 stays on), batch 32, 12,000 words, random
    weights from seed 0, rewards from the native scorer over a frozen CIDEr
    df written by ``build_doc_frequency`` over the batch's captions; the
    batch's images share 4 captions that 40 XE updates teach first, so
    that SCST starts, as users start it, from a model whose samples earn
    rewards: 20 ``RLTrainer`` updates on the batch from those weights
    four times,
    with the pipelined schedule (``rl.pipeline_depth`` 1), the serial one,
    the serial and the pipelined (losses, mean rewards, rows with a
    non-zero reward, steps/s, host ms of scoring a step; each attention
    kernel launched exactly 13 times a step; the two schedules'
    parameters within 1e-5 norm-relative per tensor);
11. profile scst step: one blocking SCST step under the profiler: device
    busy against the host clock, idle share, the kernels that take the
    most, the scoring's share of the step;
12. scst loop: one epoch of ``train()`` with the RL preset on the
    synthetic dataset (flush, valid decode, scores file, checkpoint), a
    resumed second epoch, then the ``evaluation`` verb on that checkpoint
    through ``main.main`` (beam 3; 3 launches of kernel #1);
13. scst card vs CPU: all dropout off, 3 SCST steps (argmax) on phase
    10's batch on the card and on the CPU, from fresh weights and from the
    weights phase 10 started from: sampled tokens equal except where the
    CPU's top-2 log-prob margin is below 1e-4, rewards of equal rows equal,
    losses within 2e-4, both updating with the CPU's sample and rewards;
    from fresh weights step-1 gradients within 1e-4 norm-relative per
    tensor; from the trained ones each of step 1's kernel calls against
    float64, within twice its plain version's error plus 1e-6 (there some
    cross-attention gradients are a thousandth of the others', and no f32
    formula computes them to 1e-4);
14. kernel check bottleneck: kernels #3 (one block) and #4 (a whole
    identity run) against ``bottleneck_reference`` and ``stage_reference``
    at ResNet-101's four identity runs (2, 3, 22 and 2 blocks) on 192, 133,
    5, 3 and 1 crops (128-row tiles that straddle crops, a ragged last
    tile, more tiles than SMs), within 1e-4 (f32) and 3e-2 (bf16) x
    max|ref|; two launches of #4 on the stage-3 run, and a third on half
    the SMs' worth of CTAs, are bitwise equal, in bf16 at 192 crops and
    in float32 at the Faster R-CNN batch's 1184 (a race in the grid
    barrier or a tile order that depends on the grid would show there);
15. time bottleneck: per run at 192 crops, each kernel's device and call
    time beside its bound (and as TFLOP/s and a multiple of it), its
    plain version and the cuDNN yardstick (the same blocks as
    channels-last ``F.conv2d`` with the epilogues), #4 and #3 in both
    dtypes; then kernel #4's float32 route at the Faster R-CNN batch's
    1184 crops, each run checked against ``stage_reference`` (1e-4 x
    max|ref|) and timed (device and call) beside its bound, its scratch
    traffic, its plain version and cuDNN float32;
16. extract: ``extract_features_batch`` at full width (YOLOv5x at 640,
    ResNet-101 at 224, random weights from seed 0) on the flagship's slot
    contract (36 objects, ``cap_half``, ``max_obj`` 5), bf16, 70 images in
    batches of 32: images/s on both ResNet routes, exactly 4 launches of
    kernel #4 per batch, the two routes' features and detections compared;
    one batch under the profiler;
17. caption: ``caption_images`` on 70 JPEGs with the flagship captioner at
    full width, greedy and beam 3: images/s end to end, 3 launches of
    kernel #1 and 4 of kernel #4 per batch; one greedy run under the
    profiler;
18. cpu check extract: 2 images at full width in float32, the card on the
    kernel route against the CPU on the plain route from the same weights:
    detections equal (except after a pick whose CPU score margin is below
    1e-4), features within 1e-3 x max|ref|;
19. features: a synthetic COCO tree (96 train and 64 val JPEGs of 300-640
    px, 5 captions an image from a small lexicon) in a temporary
    directory; the ``features`` verb through ``main.main`` at full width
    (YOLOv5x at 640, ResNet-101 at 224, bf16, batch 32) with phase 16's
    extractor passed to ``run_etl`` as ``extractor_params``: the train
    split alone (images/s end to end, the loader's route, exactly 4
    launches of kernel #4 a batch), again under the profiler (the device's
    idle share over the split), then every split (the artifacts' shapes
    [N, 37, 2048] and [N, 37, 84]), then every split once more (each split
    skipped on its fingerprint, no launch); the loader alone on the train
    JPEGs (images/s on 8 threads); the train split's feature rows equal
    ``extract_features_batch`` on the loader's canvases in the same padded
    batches bit for bit.  Feature files are ``.hkl`` where
    ``h5py`` imports, else ``.npy``; the loader is native where
    ``csrc/image_loader.cpp`` builds (it needs ``jpeglib.h``), else PIL;
20. roi: ``extract_features_roi`` at full width (trunk 448, detect 320),
    bf16, on phase 16's 70 canvases in batches of 32: images/s, one batch
    under the profiler, then 2 images in float32, the card against the
    CPU, held as in phase 18;
21. demo: the flagship captioner with random weights from seed 0 (its
    vocabulary the size of phase 19's ``word_index.pkl``) saved by the
    port's checkpoint manager; the ``demo`` verb through ``main.main`` on
    one of phase 19's JPEGs, greedy with ``--save-img`` and then beam 3:
    the caption line, the overlay files, 3 launches of kernel #1 and 4 of
    kernel #4 a run;
22. frcnn extract: ``init_frcnn_extractor``'s random weights from seed 0
    (ResNet-50-FPN + ResNet-101) with each ResNet block's last BN scale
    0.2 and four heads scaled by their outputs on one batch
    (``smoke_frcnn_extractor``); ``extract_features_frcnn`` at full width
    (800-px canvases, 256 proposals, 36 detections, 37 crops of 224 px an
    image), float32, 70 canvases in batches of 32: images/s on both
    ResNet routes, 4 launches of kernel #4 a batch, valid slots per image
    (none anywhere fails), the routes' detections equal and features
    within 1e-3 x max|ref|, peak device memory and one batch under the
    profiler;
23. frcnn check: 2 images, the card (kernel route) against the CPU (plain
    route): proposals equal except from an RPN pick whose CPU margin or
    per-level top-k gap is below 1e-4, detections equal except from a
    pick whose CPU margin is below 1e-4; features within 1e-3 x max|ref|
    and positions within 1e-5;
24. frcnn caption: ``caption_images`` on 70 JPEGs with the FRCNN preset's
    captioner at full width (random weights, seed 0), greedy and beam 3:
    images/s end to end, 2 launches of kernel #1 (the preset's two
    encoder blocks) and 4 of kernel #4 a batch;
25. frcnn features: the ``features`` verb with the FRCNN preset on phase
    19's COCO tree, every split: images/s, 4 launches of kernel #4 a
    batch, artifacts [N, 37, 2048] and [N, 37, 95], a rerun that skips
    every split;
26. frcnn demo: the ``demo`` verb with the FRCNN preset's captioner,
    greedy with overlays and beam 3: 2 launches of kernel #1 and 4 of #4
    a run;
27. dp world 1 (after phase 13): an NCCL group of one rank in this
    process, the XE preset of phase 7: 20 data-parallel ``Trainer`` steps
    against 20 plain ones from the same weights before and after it
    (parameters bitwise equal where two plain runs are, else within 1e-6
    norm-relative; 13 launches of each attention kernel a step), the
    steps/s of both and the gradient all-reduce's ms a step;
28. dp world 2: two subprocesses (``chip_smoke.py dp-worker``) on the one
    card over gloo, global batch 32, all dropout off, against one process
    here: 3 XE steps (losses 2e-4, step-1 gradients 1e-4 norm-relative,
    the ranks' weights bitwise equal), 3 pipelined SCST steps of the RL
    preset from phase 10's start with a frozen df (samples equal but at a
    top-2 margin below 1e-4, metrics 2e-4), ``decode_split`` of phase 6's
    split greedy and beam 3 (captions equal but at ties), launches per
    rank; a functional check, not a scaling figure; then tp world 2: the
    same inputs and single-process references, two
    ``chip_smoke.py tp-worker`` subprocesses as one model group
    (``train.model_axis`` 2: 16 heads a rank through kernels #1 and #2,
    the vocabulary split in two): losses 2e-4 and step-1 gradients in the
    full layout 1e-4, every rank's SCST samples on all 32 rows, the
    captions of the gathered replica, 13 + 13 launches a step a rank, the
    XE state saved at model 2 restored at model 1 bitwise equal to the
    ranks' gathered weights;
29. profile: ``train --profile --epochs 1`` through ``main.main`` on the
    synthetic dataset writes a Chrome trace holding the attention
    kernels; ``train --debug-nans`` runs a clean epoch and raises
    ``FloatingPointError`` on a dataset with a NaN feature;
30. sharded extract (after phase 18): ``extract_features_sharded`` over
    a single-process mesh of two replicas on the card, bf16, 70 JPEGs at
    batch 32: bitwise equal to ``extract_features_batch`` on the same
    halves (4 launches of #4 a batch a replica); against batches of 32 on
    one device, features of slot 0 and of images whose detections agree
    within 3e-2 x max|ref| (images that detect otherwise are printed with
    the detector's own bf16 score gap between the two batch sizes); then
    ``caption_images`` over that mesh: equal to one device's at batch 16,
    and at batch 32 on images with equal detections but at ties;
31. sp world 3 (after phase 28): three subprocesses (``chip_smoke.py
    sp-worker``) on the one card over gloo as one sequence group, full
    width, against one process here: 3 XE steps of
    ``maxlen49_20obj_128_14b_16h_mask`` at attention dropout 0 (7 of its
    21 slots a rank; losses 2e-4, step-1 gradients 1e-4, the ranks'
    weights bitwise equal) and ``decode_split`` of 70 images greedy and
    beam 3 after them (captions equal but at ties), 3 pipelined argmax
    SCST steps of the RL flagship at 35 objects (36 slots, 12 a rank;
    samples equal but at a top-2 margin below 1e-4), one XE step of the
    flagship at its 37 slots, which 3 do not divide (every rank holds
    every slot); launches per rank; functional, not a scaling figure.

It prints a JSON line of the kernels (their launches by path, the
scanned, tensor- and sequence-parallel paths among them), the card's
name and power
limit, and
as its last line ``{"ok": true, "device": {...}}``.  Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
from concurrent.futures import ThreadPoolExecutor
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FLAGSHIP = "RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
# the flagship's XE counterpart (same model, caption_model 'Transformer')
XE_PRESET = "maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
TRAIN_STEPS = 20
# fused attention calls per train step: 1 pair block + 2 encoder blocks +
# 5 decoder self + 5 decoder cross
LAUNCHES_PER_STEP = 13
# the flagship's 32 heads on one rank of a model group of two
TP_HEADS = 16
# the sequence-3 phase: three ranks, one block of slots each, of the XE
# preset below (21 slots, 7 a rank) and of the RL flagship at 35 objects
# (36 slots, 12 a rank)
SP_WORLD = 3
SP_PRESET = "maxlen49_20obj_128_14b_16h_mask"
SP_OBJECTS = 35
# H100 SXM data-sheet peaks: HBM bytes/s; float32 FLOP/s off the tensor
# cores (the attention kernels compute in float32 on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TOL = {"float32": 1e-5, "bfloat16": 1e-2}
PEAK_BF16_FLOPS = 989e12              # dense, tensor cores
# the bottleneck's float32 products: three TF32 passes on the tensor cores
# (each operand split into a TF32 high and low part), so a float32
# multiply-add costs three TF32 ones at the dense TF32 peak
PEAK_TF32_FLOPS = 495e12
TF32_PASSES = 3
# ResNet-101's identity runs at 224-px crops: (name, H=W, C, Wd, blocks)
RESNET101_RUNS = (("stage1", 56, 256, 64, 2), ("stage2", 28, 512, 128, 3),
                  ("stage3", 14, 1024, 256, 22), ("stage4", 7, 2048, 512, 2))
# crops per extraction batch: 32 images x (the whole image + max_obj 5)
CROPS = 192
# and the other crop counts the kernels are checked at: 133 gives more
# stage-4 tiles than SMs; 5, 3 and 1 tiles that straddle crops or are ragged
CHECK_CROPS = (CROPS, 133, 5, 3, 1)
BOTTLENECK_TOL = {"float32": 1e-4, "bfloat16": 3e-2}   # x max|ref|
EXTRACT_IMAGES, EXTRACT_BATCH = 70, 32
# bf16 features of the kernel route (f32 epilogues) against the cuDNN
# route (BN in bf16), 33 bottlenecks deep: x max|ref|
EXTRACT_ROUTE_TOL = 5e-2
# the roi feature mode's trunk and detector sizes (the data config's)
ROI_TRUNK, ROI_DETECT = 448, 320
# Faster R-CNN: its preset, canvas, crops a batch (32 images x the whole
# image and 36 detections), and the float32 features of kernel #4's route
# against cuDNN's, 33 bottlenecks deep: x max|ref|
FRCNN_PRESET = "maxlen49_36obj_1wordCount_frcnn_256_25b_32h"
FRCNN_CANVAS = 800
FRCNN_CROPS = 32 * 37
FRCNN_ROUTE_TOL = 1e-3
# the synthetic COCO tree of the features phase: JPEGs per split, captions
# an image, and the lexicon the captions are drawn from
COCO_IMAGES = {"train": 96, "val": 64}
COCO_CAPTIONS = 5
LEXICON = ("a", "an", "the", "two", "man", "woman", "dog", "cat", "horse",
           "bus", "train", "plate", "pizza", "table", "street", "field",
           "beach", "kitchen", "red", "white", "small", "large", "young",
           "sits", "stands", "runs", "rides", "holds", "eats", "on", "in",
           "near", "with", "of", "at", "next", "to", "down", "grass",
           "water")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Attention inputs at the slice's shapes
# ---------------------------------------------------------------------------

def slot_pad(batch: int, slots: int, rng, zero_items=()):
    """[batch, slots] bool: the all-zero slots of features drawn as the
    tests' make_fake_batch draws them (slot 0 is the whole image)."""
    n_obj = rng.randint(1, slots - 1, size=batch)
    pad = np.arange(slots)[None, :] > n_obj[:, None]
    pad[list(zero_items)] = True
    return pad


def encoder_mask(pad: np.ndarray) -> np.ndarray:
    """Key-pad OR causal, [B, S, S] (captioner.py's encode_mask quirk)."""
    s = pad.shape[1]
    return pad[:, None, :] | np.triu(np.ones((s, s), bool), 1)[None]


def pair_mask(pad: np.ndarray, block: slice = slice(None)) -> np.ndarray:
    """The split_image_objects pair block's mask, [B*n, 2, 2], over the
    n slots of ``block``: token 0 is the whole image (slot 0), token 1
    the object."""
    objects = pad[:, block]
    b, n = objects.shape
    pair = np.stack([np.repeat(pad[:, :1], n, axis=1), objects], axis=2)
    return encoder_mask(pair.reshape(b * n, 2))


def attention_case(name, b, h, lq, lk, dh, mask, seed):
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(b, h, n, dh).astype(np.float32)
               for n in (lq, lk, lk))
    return {"name": name, "shape": [b, h, lq, lk, dh], "q": q, "k": k,
            "v": v, "mask": mask.astype(np.int8)}


def kernel_cases(batch: int = 32):
    """The flagship's encoder and pair-block attention at ``batch`` images
    (37 slots, 32 heads of 8), and a ragged case."""
    slots, heads, head_dim = 37, 32, 8
    rng = np.random.RandomState(0)
    pad = slot_pad(batch, slots, rng, zero_items=(3, 17))
    ragged = rng.rand(3, 5, 70) > 0.5
    ragged[0, 2] = True                  # one fully masked row
    ragged[2] = True                     # one fully masked item
    # rows too long for one block's shared memory: the kernel walks key
    # tiles, or query tiles, with the same running state
    long_keys = rng.rand(2, 3, 30000) > 0.3
    long_keys[1, 1] = True
    long_queries = rng.rand(1, 300000, 2) > 0.6
    return [
        attention_case("a_encoder", batch, heads, slots, slots, head_dim,
                       encoder_mask(pad), 1),
        attention_case("b_pair", batch * slots, heads, 2, 2, head_dim,
                       pair_mask(pad), 2),
        attention_case("c_ragged", 3, 4, 5, 70, 16, ragged, 3),
        attention_case("f_long_keys", 2, 2, 3, 30000, 8, long_keys, 4),
        attention_case("g_long_queries", 1, 1, 300000, 2, 8, long_queries,
                       5),
    ]


def on(case, device, dtype):
    import torch
    t = {n: torch.from_numpy(case[n]).to(device) for n in "qkv"}
    return (t["q"].to(dtype), t["k"].to(dtype), t["v"].to(dtype),
            torch.from_numpy(case["mask"]).to(device),
            float(np.sqrt(case["shape"][-1])))


# ---------------------------------------------------------------------------
# Phases 3-4: kernels against their plain versions, gradients
# ---------------------------------------------------------------------------

def check_kernel(device) -> float:
    """Every case, and the decoder's two training shapes, in float32 and
    bfloat16; returns the largest float32 error.  Tolerance: |kernel -
    plain| <= tol + tol*|plain|, the plain version run on the same inputs in
    the same dtype."""
    import torch
    from image_caption_tpu_torch.ops.attention import (attention_reference,
                                                       fused_attention)
    worst_f32 = 0.0
    for case in (kernel_cases() + training_cases()[2:4] + tp_cases()
                 + sp_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, t = on(case, device, dtype)
            got = fused_attention(q, k, v, m, t)
            want = attention_reference(q, k, v, m != 0, t)[0]
            if device != "cpu":
                torch.cuda.synchronize()
            tol = TOL[str(dtype).split(".")[1]]
            err = (got.float() - want.float()).abs()
            bad = err > tol + tol * want.float().abs()
            dead = (m != 0).all(dim=-1)                  # [B, Lq]
            dead_out = got[dead[:, None, :, None].expand_as(got)]
            print(f"kernel check {case['name']} {tuple(case['shape'])} "
                  f"{dtype}: max_abs_err {err.max().item():.3e} "
                  f"(tol {tol:g}), fully masked rows "
                  f"{int(dead.sum())} x {case['shape'][1]} heads",
                  flush=True)
            if bad.any():
                raise AssertionError(
                    f"fused_attention disagrees with attention_reference "
                    f"on {case['name']} {dtype}: max error "
                    f"{err.max().item():.3e}")
            if dead.any() and not bool((dead_out == 0).all()):
                raise AssertionError(
                    f"fully masked rows not exactly zero on {case['name']}")
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, err.max().item())
    return worst_f32


def training_cases(batch: int = 32, heads: int = 32):
    """Kernel #2's inputs at the XE preset's training shapes (batch 32, 37
    slots, 50 caption tokens, 32 heads of 8), each with an output gradient
    dO, and the ragged case.  Items 3 and 17 are all-zero images, whose rows
    are fully masked in the encoder, pair and cross attention."""
    slots, tokens, head_dim = 37, 50, 8
    rng = np.random.RandomState(5)
    pad = slot_pad(batch, slots, rng, zero_items=(3, 17))
    lengths = rng.randint(3, tokens, size=batch)
    tok_pad = np.arange(tokens)[None, :] > lengths[:, None]      # [B, T]
    causal = np.triu(np.ones((tokens, tokens), bool), 1)[None]
    cases = [
        attention_case("a_encoder", batch, heads, slots, slots, head_dim,
                       encoder_mask(pad), 11),
        attention_case("b_pair", batch * slots, heads, 2, 2, head_dim,
                       pair_mask(pad), 12),
        attention_case("d_decoder_self", batch, heads, tokens, tokens,
                       head_dim, tok_pad[:, None, :] | causal, 13),
        attention_case("e_decoder_cross", batch, heads, tokens, slots,
                       head_dim, np.repeat(pad[:, None, :], tokens, axis=1),
                       14),
        dict(kernel_cases()[2], name="c_ragged"),
    ]
    for i, case in enumerate(cases):
        b, h, lq, _, dh = case["shape"]
        case["do"] = np.random.RandomState(20 + i).randn(
            b, h, lq, dh).astype(np.float32)
    return cases


def tp_cases():
    """The four training shapes at 16 heads: what one rank of a model
    group of two runs (``parallel.tensor``), the same masks."""
    return [dict(c, name=f"{c['name']}_h16")
            for c in training_cases(heads=TP_HEADS)[:4]]


def sp_cases(batch: int = 32):
    """Kernels #1 and #2 at the shapes sequence index 1 of the sequence-3
    phase launches, each with an output gradient: its 7 of the XE
    preset's 21 slots against all 21 (16 heads), its 12 of the RL
    flagship's 36 against all 36 (32 heads), and its 12 slots' pairs, with
    the rows of the full masks at the block's offsets (items 3 and 17
    all-zero)."""
    rng = np.random.RandomState(8)
    cases, pad = [], None
    for name, slots, heads in (("l_sp_encoder", 21, 16),
                               ("m_sp_encoder36", 36, 32)):
        pad = slot_pad(batch, slots, rng, zero_items=(3, 17))
        n = slots // SP_WORLD
        cases.append(attention_case(name, batch, heads, n, slots, 8,
                                    encoder_mask(pad)[:, n:2 * n],
                                    50 + len(cases)))
    cases.append(attention_case("n_sp_pair", batch * 12, 32, 2, 2, 8,
                                pair_mask(pad, slice(12, 24)), 52))
    for i, case in enumerate(cases):
        b, h, lq, _, dh = case["shape"]
        case["do"] = np.random.RandomState(60 + i).randn(
            b, h, lq, dh).astype(np.float32)
    return cases


def bwd_edge_cases():
    """Kernel #2's other block layouts: the largest square tiles one block
    takes at head dims 8 and 5 (``bwd_shared_bytes``), head dims whose rows
    pad to 6 floats (read 2 at a time) in packed and single-unit blocks, odd
    row counts that leave staged rows off 16-byte boundaries; one fully
    masked row each."""
    rng = np.random.RandomState(6)
    shapes = [("h_bwd_largest", 2, 2, 162, 162, 8),
              ("i_bwd_head5_largest", 2, 2, 163, 164, 5),
              ("j_bwd_head6_packed", 64, 16, 13, 20, 6),
              ("k_bwd_head6_odd_rows", 3, 5, 7, 9, 6)]
    cases = []
    for i, (name, b, h, lq, lk, dh) in enumerate(shapes):
        mask = rng.rand(b, lq, lk) > 0.7
        mask[b - 1, lq // 2] = True
        case = attention_case(name, b, h, lq, lk, dh, mask, 30 + i)
        case["do"] = np.random.RandomState(40 + i).randn(
            b, h, lq, dh).astype(np.float32)
        cases.append(case)
    return cases


def check_kernel_bwd(device) -> float:
    """Kernel #2 against ``attention_bwd_reference`` on every training case
    and every edge case in float32 and bfloat16, the tolerance of
    ``check_kernel``; fully masked rows must give exactly zero dq and every
    gradient must be finite.  Returns the largest float32 error."""
    import torch
    from image_caption_tpu_torch.ops.attention import (
        attention_bwd_reference, fused_attention_bwd)
    worst_f32 = 0.0
    for case in (training_cases() + bwd_edge_cases() + tp_cases()
                 + sp_cases()):
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, m, t = on(case, device, dtype)
            do = torch.from_numpy(case["do"]).to(device).to(dtype)
            got = fused_attention_bwd(q, k, v, m, do, t)
            want = attention_bwd_reference(q, k, v, m, do, t)
            if device != "cpu":
                torch.cuda.synchronize()
            tol = TOL[str(dtype).split(".")[1]]
            errs = []
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                err = (g.float() - w.float()).abs()
                errs.append(err.max().item())
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"non-finite {name} on "
                                         f"{case['name']} {dtype}")
                if bool((err > tol + tol * w.float().abs()).any()):
                    raise AssertionError(
                        f"fused_attention_bwd disagrees with "
                        f"attention_bwd_reference on {case['name']} {dtype} "
                        f"{name}: max error {err.max().item():.3e}")
            dead = (m != 0).all(dim=-1)                  # [B, Lq]
            dq_dead = got[0][dead[:, None, :, None].expand_as(got[0])]
            if not bool((dq_dead == 0).all()):
                raise AssertionError(f"fully masked rows give nonzero dq on "
                                     f"{case['name']} {dtype}")
            print(f"kernel check bwd {case['name']} {tuple(case['shape'])} "
                  f"{dtype}: max_abs_err dq {errs[0]:.3e} dk {errs[1]:.3e} "
                  f"dv {errs[2]:.3e} (tol {tol:g}), fully masked rows "
                  f"{int(dead.sum())} x {case['shape'][1]} heads with dq 0",
                  flush=True)
            if dtype == torch.float32:
                worst_f32 = max(worst_f32, *errs)
    return worst_f32


def check_gradients(device) -> float:
    """``torch.autograd.grad`` through ``sdp_attention`` on the kernel route
    (no weights wanted) and on the plain path (weights wanted), encoder
    case in float32 (items 3 and 17 fully masked): the q, k and v gradients
    must agree within ``check_kernel``'s tolerance, and on the card the
    kernel route must launch the backward kernel.  Returns the largest
    error."""
    import torch
    from image_caption_tpu_torch.ops.attention import (fused_attention_bwd,
                                                       sdp_attention)
    case = training_cases()[0]
    q, k, v, m, t = on(case, device, torch.float32)
    do = torch.from_numpy(case["do"]).to(device)
    grads = {}
    for kernel in (True, False):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = fused_attention_bwd.launches
        out, _ = sdp_attention(*leaves, m != 0, t, need_weights=not kernel)
        grads[kernel] = torch.autograd.grad(out, leaves, do)
        launched = fused_attention_bwd.launches - before
        if device != "cpu" and launched != int(kernel):
            raise AssertionError(f"need_weights={not kernel}: {launched} "
                                 f"backward kernel launches")
    if device != "cpu":
        torch.cuda.synchronize()
    tol = TOL["float32"]
    worst = 0.0
    for name, g, w in zip("qkv", grads[True], grads[False]):
        err = (g - w).abs()
        worst = max(worst, err.max().item())
        if bool((err > tol + tol * w.abs()).any()) or \
                not bool(torch.isfinite(g).all()):
            raise AssertionError(f"d{name} through the kernels differs from "
                                 f"the plain path by {err.max().item():.3e}")
    print(f"gradient check {tuple(case['shape'])} float32: autograd through "
          f"sdp_attention, kernels vs plain path, max_abs_err {worst:.3e} "
          f"(tol {tol:g})", flush=True)
    return worst


def check_attention_determinism(device):
    """Two launches of kernel #1 and two of kernel #2 on the same float32
    inputs at each training shape, at its 16-head shape and at the
    sequence-3 phase's shapes, give the same bits: every sum runs in an
    order fixed by the shape, with no atomics."""
    import torch
    from image_caption_tpu_torch.ops.attention import (fused_attention,
                                                       fused_attention_bwd)
    for case in training_cases()[:4] + tp_cases() + sp_cases():
        q, k, v, m, t = on(case, device, torch.float32)
        do = torch.from_numpy(case["do"]).to(device)
        runs = [(fused_attention(q, k, v, m, t),
                 *fused_attention_bwd(q, k, v, m, do, t)) for _ in range(2)]
        differ = {name: int((a.view(torch.int32) != b.view(torch.int32)).sum())
                  for name, a, b in zip(("out", "dq", "dk", "dv"), *runs)}
        print(f"kernel check attention determinism {case['name']} "
              f"{tuple(case['shape'])} float32: elements that differ in their "
              f"bits between two launches {differ} (want 0)", flush=True)
        if any(differ.values()):
            raise AssertionError(f"attention kernels are not deterministic "
                                 f"on {case['name']}: {differ}")


# ---------------------------------------------------------------------------
# Phase 5: times
# ---------------------------------------------------------------------------

def call_ms(fn, warmup: int = 10, reps: int = 50) -> float:
    """Median over ``reps`` calls of the time between events recorded just
    before and just after one call: the device time plus whatever the host
    takes to launch the call, when the device waits for it."""
    import torch
    for _ in range(warmup):
        fn()
    events = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        events.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms(fn, per_graph: int = 20, warmup: int = 10,
              reps: int = 50) -> float:
    """One call's device time: ``per_graph`` calls captured in a CUDA
    graph, whose replays are timed by events (10 warm-up replays, median
    of 50), over ``per_graph``.  No host launch cost is in it."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    return call_ms(graph.replay, warmup, reps) / per_graph


def bound(case, elem_bytes: int):
    """Least time for the function: each input read once, the output
    written once, against the float32 operations the unmasked scores need
    (q.k and p.v, 2*Dh each, per unmasked pair and head)."""
    b, h, lq, lk, dh = case["shape"]
    nbytes = elem_bytes * b * h * dh * (2 * lq + 2 * lk) + b * lq * lk
    flops = 4 * dh * h * int((case["mask"] == 0).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def time_kernel(card: str):
    import torch
    import torch.nn.functional as F
    from image_caption_tpu_torch.ops.attention import (attention_reference,
                                                       fused_attention)
    rows = {}
    # the serving shapes, the decoder's training shapes, a larger batch,
    # the training shapes at a tensor-parallel rank's 16 heads, a
    # sequence-parallel rank's shapes
    cases = kernel_cases()[:2] + training_cases()[2:4] + [
        dict(kernel_cases(batch=128)[0], name="a_encoder_B128")] + \
        tp_cases() + sp_cases()
    for case in cases:
        q, k, v, m, t = on(case, "cuda", torch.float32)
        boolmask = m != 0
        additive = torch.zeros(m.shape, device="cuda").masked_fill(
            boolmask, float("-inf"))[:, None]
        def kernel():
            return fused_attention(q, k, v, m, t)

        def plain():
            return attention_reference(q, k, v, boolmask, t)

        def library():
            return F.scaled_dot_product_attention(q, k, v, attn_mask=additive,
                                                  scale=1.0 / t)

        row = {"shape": case["shape"], "ms": device_ms(kernel),
               "plain_ms": device_ms(plain), "library_ms": device_ms(library),
               "call_ms": call_ms(kernel)}
        row["bound_ms"], row["bound_by"], row["bytes"] = bound(case, 4)
        rows[case["name"]] = row
        print(f"time {case['name']} {tuple(case['shape'])} float32: "
              f"kernel {row['ms']:.5f} ms on the device "
              f"({row['call_ms']:.5f} ms a call with its launch), bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
              f"{row['bytes']} B), plain {row['plain_ms']:.5f} ms, sdpa "
              f"{row['library_ms']:.5f} ms [{card}]", flush=True)
    return rows


def bound_bwd(case, elem_bytes: int):
    """Least time for the backward: q, k, v, dO and the mask read once, dq,
    dk and dv written once, against the float32 operations the unmasked
    pairs need (S, dP, dV, dQ and dK, 2*Dh each per pair and head)."""
    b, h, lq, lk, dh = case["shape"]
    nbytes = elem_bytes * b * h * dh * (3 * lq + 4 * lk) + b * lq * lk
    flops = 10 * dh * h * int((case["mask"] == 0).sum())
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def time_kernel_bwd(card: str):
    """Kernel #2 at the four training shapes in float32, the encoder's at
    batch 128, the four at 16 heads and the sequence-3 phase's: its
    device time and call time,
    the plain version's, and the library yardstick, the backward of
    ``scaled_dot_product_attention`` (forward plus backward, minus
    forward; never called by the port)."""
    import torch
    import torch.nn.functional as F
    from image_caption_tpu_torch.ops.attention import (
        attention_bwd_reference, fused_attention_bwd)
    rows = {}
    big = dict(training_cases(batch=128)[0], name="a_encoder_B128")
    for case in training_cases()[:4] + [big] + tp_cases() + sp_cases():
        q, k, v, m, t = on(case, "cuda", torch.float32)
        do = torch.from_numpy(case["do"]).cuda()
        additive = torch.zeros(m.shape, device="cuda").masked_fill(
            m != 0, float("-inf"))[:, None]
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]

        def kernel():
            return fused_attention_bwd(q, k, v, m, do, t)

        def plain():
            return attention_bwd_reference(q, k, v, m, do, t)

        def lib_fwd():
            return F.scaled_dot_product_attention(
                *leaves, attn_mask=additive, scale=1.0 / t)

        def lib_fwd_bwd():
            return torch.autograd.grad(lib_fwd(), leaves, do)

        fwd_ms = device_ms(lib_fwd)
        row = {"shape": case["shape"], "ms": device_ms(kernel),
               "plain_ms": device_ms(plain),
               "library_ms": device_ms(lib_fwd_bwd) - fwd_ms,
               "call_ms": call_ms(kernel)}
        row["bound_ms"], row["bound_by"], row["bytes"] = bound_bwd(case, 4)
        rows[case["name"]] = row
        print(f"time bwd {case['name']} {tuple(case['shape'])} float32: "
              f"kernel {row['ms']:.5f} ms on the device "
              f"({row['call_ms']:.5f} ms a call with its launch), bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
              f"{row['bytes']} B), plain {row['plain_ms']:.5f} ms, sdpa "
              f"backward {row['library_ms']:.5f} ms (fwd+bwd minus fwd "
              f"{fwd_ms:.5f}) [{card}]", flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phase 5b: the mla_moe decode step's latent attention (csrc/mla_decode.cu)
# ---------------------------------------------------------------------------

# the kimi_vl_a3b cell's step: batch 1024, 87 cache rows (37 slots + 51
# tokens - 1); the first step's position, a middle one and the last
MLA_BATCH, MLA_ROWS = 1024, 87
MLA_POSITIONS = (38, 62, 86)
# the cell's share of valid region slots: 1 to 35 objects, uniformly, and
# the whole-image slot, of 37 (benchmark/data/split.make_split)
MLA_KEEP = 19 / 37
# input sets a timed run cycles through: four caches of up to 103 MB
# outrun the 50 MB L2, as the experts' weight reads between two layers'
# attention do in the step
MLA_SETS = 4


def card_tests():
    """The module of kernel #5's card tests, loaded from its file
    (``tests/test_torch_latent_attention.py``; another ``tests`` package
    may come first on the path): phase 5b takes its input builder, its copy
    of the parent's chain and its tolerance."""
    import importlib.util
    mod = sys.modules.get("test_torch_latent_attention")
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            "test_torch_latent_attention",
            os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "tests", "test_torch_latent_attention.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        sys.modules[spec.name] = mod
    return mod


def mla_case(pos: int, seed: int):
    """One step's inputs at ``pos`` on the card, as the card tests build
    them (``case``), with the cell's share of pad slots."""
    import torch
    from image_caption_tpu_torch.ops import latent_attention as LA
    return card_tests().case(MLA_BATCH, LA.HEADS, LA.LATENT, LA.ROPE,
                             MLA_ROWS, pos, torch.bfloat16, device="cuda",
                             seed=seed, keep=MLA_KEEP)


def mla_bound(visible, pos: int):
    """The least time of one launch at ``pos`` over ``visible`` [B, T]
    (ms), what bounds it, the bytes, and the share of the cache rows the
    kernel loads that are pad rows: the visible rows, q and the output
    moved once at 3.35 TB/s, or the two products over those rows at 989
    TFLOP/s.  The kernel loads every row up to pos; a pad row among them
    is no work of the function's."""
    b, rows = visible.shape[0], int(visible.sum())
    loaded = b * (pos + 1)
    nbytes = 2 * (rows * 576 + b * 16 * (512 + 576))
    flops = 2 * 16 * rows * (512 + 576)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_BF16_FLOPS
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes,
            1 - rows / loaded)


def check_mla_decode() -> float:
    """The kernel against the plain version on the CPU at each position,
    within the card tests' tolerance (``assert_close_to_plain``: max|c| /
    128 + |plain| / 64).  Returns the largest error."""
    from image_caption_tpu_torch.ops import latent_attention as LA
    tests = card_tests()
    worst = 0.0
    for pos in MLA_POSITIONS:
        args = mla_case(pos, pos)
        got = LA.latent_attention(*args)
        want = tests.plain_on_the_cpu(args)
        tests.assert_close_to_plain(got, want, args[2])
        err = float((got.cpu().float() - want.float()).abs().max())
        worst = max(worst, err)
        print(f"kernel check mla_decode B {MLA_BATCH} T {MLA_ROWS} pos "
              f"{pos} bf16: max |kernel - plain| {err:.3e} (max|out| "
              f"{float(want.float().abs().max()):.3f})", flush=True)
    return worst


def time_mla_decode(card: str):
    """The kernel, the plain version and the parent's chain (the card
    tests' ``inline_core``: two bf16 bmms and the passes between) at each
    position, cycling through ``MLA_SETS`` input sets (the cache read from
    device memory, not L2), beside the bound."""
    from image_caption_tpu_torch.ops import latent_attention as LA
    inline_core = card_tests().inline_core

    def parent_chain(q_lat, q_pe, cache, visible, pos, scale):
        return inline_core(q_lat, q_pe, cache, visible, scale)
    rows = {}
    for pos in MLA_POSITIONS:
        sets = [mla_case(pos, 10 * pos + i) for i in range(MLA_SETS)]

        def cycling(fn):
            calls = [0]

            def call():
                calls[0] += 1
                return fn(*sets[calls[0] % MLA_SETS])
            return call
        kernel = cycling(LA.latent_attention)
        row = {"shape": (MLA_BATCH, 16, MLA_ROWS, pos),
               "ms": device_ms(kernel), "call_ms": call_ms(kernel),
               "plain_ms": device_ms(cycling(
                   LA.latent_attention_reference)),
               "library_ms": device_ms(cycling(parent_chain))}
        bounds = [mla_bound(s[3], pos) for s in sets]
        row["bound_ms"] = statistics.fmean(x[0] for x in bounds)
        row["bound_by"] = bounds[0][1]
        row["bytes"] = round(statistics.fmean(x[2] for x in bounds))
        row["pad_share"] = statistics.fmean(x[3] for x in bounds)
        rows[f"pos{pos}"] = row
        print(f"time mla_decode (B,H,T,pos) {row['shape']} bf16: kernel "
              f"{row['ms'] * 1e3:.2f} us on the device ({row['call_ms']:.5f}"
              f" ms a call with its launch), bound "
              f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}, "
              f"{row['bytes']} B, visible rows only; pad rows are "
              f"{100 * row['pad_share']:.1f}% of the cache rows loaded): "
              f"{100 * row['bound_ms'] / row['ms']:.1f}% of it; plain "
              f"{row['plain_ms']:.5f} ms, the parent's chain "
              f"{row['library_ms']:.5f} ms [{card}]", flush=True)
        del sets
    return rows


def drive_mla_decode(card: str):
    """Phase 5b: (the largest error, the timed rows)."""
    return check_mla_decode(), time_mla_decode(card)


# ---------------------------------------------------------------------------
# Phase 5c: the kimi_vl_a3b captioner's decode, as the benchmark's cell does
# ---------------------------------------------------------------------------

KIMI_CELL = "kimi_vl_a3b.decode_greedy"
KIMI_SEED = 2 ** 31 + 19


def drive_kimi_decode(card: str) -> int:
    """Phase 5c: the cell's model (``benchmark/configs/kimi_vl_a3b.json``
    at full size, built on ``meta`` and filled on the card from the
    benchmark's seeded bf16 weights) decodes one batch of 1024 of the
    cell's region features through ``serve.decode_split``; kernel #5's
    launches are counted over that batch (the first step eager, then each
    segment captured; the later steps replay graphs and launch nothing
    through the wrapper) and over a second batch on the same model (none).
    Then the first step again, eagerly, from the same features and token,
    with the plain version in the kernel's place: at each layer the kernel
    runs on the same inputs too and must lie within the card tests'
    tolerance of it (``assert_close_to_plain``).  The decode's first-step
    logits beside this pass's are printed, not held to a limit: a weight P
    one bf16 ulp apart in a few rows can flip a router's near-tie, which
    changes that row's experts and logits (the rows whose experts moved
    are counted).  Returns the first batch's launches; the caller collects
    the model (its step state holds cycles)."""
    import torch
    from benchmark import harness
    from benchmark.data.split import make_split
    from benchmark.drivers.caption import vocabulary
    from benchmark.drivers.decode_features import program_config, split_of
    from benchmark.reference import kimi_vl as RK
    from image_caption_tpu_torch import serve
    from image_caption_tpu_torch.config import START_IDX
    from image_caption_tpu_torch.models import lm as LM
    from image_caption_tpu_torch.ops import latent_attention as LA
    cell = harness.resolve(KIMI_CELL)
    c, b = cell.config, cell.traffic["batch"]
    cfg = program_config(c)
    m = cfg.model
    t0 = time.perf_counter()
    model = LM.LMCaptioner.from_state_dict(
        cfg, RK.state_dict(c, KIMI_SEED, "cuda"), device="cuda")
    feats, poss, _, _ = make_split(
        {"num_objects": m.num_objects, "max_length": m.max_length,
         "dim_features": m.dim_features, "dim_positions": m.dim_positions,
         "num_vocab": m.num_vocab}, b, 1, KIMI_SEED + 1, "cuda")
    words = vocabulary(m.num_vocab)
    print(f"kimi decode: {KIMI_CELL}'s model and one batch of its features "
          f"on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    first = {}
    real_step = model.run_step

    def tapped(st):
        if not first:
            first["token"] = st.token.clone()
        out = real_step(st)
        if "logits" not in first:
            first["logits"] = out.clone()
            first["idx"] = {i: x.sort(-1)[0] for i, x in st.idx.items()}
        return out
    model.run_step = tapped
    LA.latent_attention.launches = 0
    t0 = time.perf_counter()
    serve.decode_split(model, cfg, split_of(feats, poss, b), b, words,
                       device="cuda")
    launches = LA.latent_attention.launches
    t1 = time.perf_counter()
    serve.decode_split(model, cfg, split_of(feats, poss, b), b, words,
                       device="cuda")
    again = LA.latent_attention.launches - launches
    t2 = time.perf_counter()
    del model.run_step
    layers = len(model.layers)
    print(f"kimi decode: kernel #5 launched {launches} times over the "
          f"first batch of {b} ({t1 - t0:.2f} s, captures included), "
          f"{again} over the second ({t2 - t1:.2f} s) [{card}]", flush=True)
    if launches != 2 * layers or again != 0:
        raise AssertionError(f"kernel #5: {launches} and {again} launches, "
                             f"expected {2 * layers} (the eager first step "
                             f"and the capture) and 0")
    # the first step again, eager, the plain version in the kernel's place
    # and the kernel beside it on the same inputs
    tests = card_tests()
    errs = []

    def both(q_lat, q_pe, cache, visible, pos, scale):
        got = LA.latent_attention(q_lat, q_pe, cache, visible, pos, scale)
        want = LA.latent_attention_reference(q_lat, q_pe, cache, visible,
                                             pos, scale)
        tests.assert_close_to_plain(got, want.cpu(), cache)
        errs.append(float((got.float() - want.float()).abs().max()))
        return want
    st = LM.StepState(model, b)
    f = torch.as_tensor(feats, device="cuda")
    p = torch.as_tensor(poss, device="cuda")
    model.prefill(f, p, torch.full((b,), START_IDX, device="cuda"),
                  st.cache)
    st.token.copy_(first["token"])
    st.pos.fill_(model.prefix)
    LM.latent_attention = both
    try:
        with torch.no_grad():
            for _, fn, _ in st.segments:
                fn()
    finally:
        LM.latent_attention = LA.latent_attention
    print(f"kimi decode: the first step, {len(errs)} layers: the kernel "
          f"within the card tests' tolerance of the plain version on each "
          f"layer's inputs, max |kernel - plain| {max(errs):.3e}", flush=True)
    got, want = first["logits"], st.logits
    rows = ((got - want).pow(2).mean(-1).sqrt()
            / want.pow(2).mean(-1).sqrt())
    moved = torch.zeros(b, dtype=torch.bool, device="cuda")
    for i, x in st.idx.items():
        moved |= (x.sort(-1)[0] != first["idx"][i]).any(-1)
    differ, kept = rows > 0, rows[~moved]
    same = float((got.argmax(-1) == want.argmax(-1)).float().mean())
    print(f"kimi decode: the first step's logits, the decode (kernel) "
          f"against the plain pass: {int(differ.sum())} of {b} rows differ "
          f"(relative RMS median {float(rows.median()):.3e}, max "
          f"{float(rows.max()):.3e}; the same argmax in {100 * same:.2f}% "
          f"of rows); {int(moved.sum())} rows routed to other experts at "
          f"some layer, {int((differ & moved).sum())} of them differ; the "
          f"rows routed alike differ by at most "
          f"{float(kept.max()) if len(kept) else 0.0:.3e}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 6: the serving slice at full width
# ---------------------------------------------------------------------------

def make_split(m, n_images: int, seed: int):
    """An in-memory split drawn as make_fake_batch draws a batch; image 5 is
    all zero and image 6 a copy of image 0, both in the first batch."""
    from image_caption_tpu_torch.data.dataset import CocoSplit
    rng = np.random.RandomState(seed)
    s = m.num_slots
    feats = rng.randn(n_images, s, m.dim_features).astype(np.float32)
    pos = rng.rand(n_images, s, m.dim_positions).astype(np.float32)
    n_obj = rng.randint(1, s - 1, size=n_images)
    for i in range(n_images):
        feats[i, n_obj[i] + 1:] = 0.0
        pos[i, n_obj[i] + 1:] = 0.0
        pos[i, 0, :4] = [0, 0, 1, 1]
        pos[i, 0, 4:] = 0.0
    feats[5], pos[5] = 0.0, 0.0
    feats[6], pos[6] = feats[0], pos[0]
    caps = rng.randint(4, m.num_vocab, size=(n_images, m.max_length))
    lengths = rng.randint(3, m.max_length - 2, size=n_images)
    for i in range(n_images):
        caps[i, 0] = 1
        caps[i, lengths[i]] = 2
        caps[i, lengths[i] + 1:] = 0
    return CocoSplit(features=feats, positions=pos,
                     captions=caps.astype(np.int32),
                     image_idxs=np.arange(n_images),
                     file_names=np.array([f"{i}.jpg" for i in
                                          range(n_images)]))


def vocabulary(num_vocab: int):
    from image_caption_tpu_torch.config import (END_TOKEN, NULL_TOKEN,
                                                START_TOKEN, UNK_TOKEN)
    words = [NULL_TOKEN, START_TOKEN, END_TOKEN, UNK_TOKEN]
    return {i: (words[i] if i < 4 else f"w{i}") for i in range(num_vocab)}


def drive_slice(cfg, device, card: str, *, n_images: int = 70,
                batch_size: int = 32):
    """Decode a split greedily and with beam 3 on ``device``; returns the
    kernel launches counted over that run."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.ops.attention import fused_attention
    from image_caption_tpu_torch.serve import decode_split

    m = cfg.model
    model = Captioner(m, device=device,
                      generator=torch.Generator().manual_seed(0))
    split = make_split(m, n_images, seed=0)
    idx_to_word = vocabulary(m.num_vocab)
    n_batches = -(-n_images // batch_size)
    warm = make_split(m, batch_size, seed=1)
    for beam in (None, 3):                # first-call set-up, not counted
        decode_split(model, cfg, warm, batch_size, idx_to_word,
                     beam_size=beam, device=device)

    fused_attention.launches = 0
    results = {}
    for label, beam in (("greedy", None), ("beam3", 3)):
        before = fused_attention.launches
        t0 = time.perf_counter()
        caps = decode_split(model, cfg, split, batch_size, idx_to_word,
                            beam_size=beam, device=device)
        seconds = time.perf_counter() - t0
        launched = fused_attention.launches - before
        results[label] = (caps, seconds)
        if device != "cpu" and launched != 3 * n_batches:
            raise AssertionError(f"{label}: {launched} kernel launches for "
                                 f"{n_batches} batches, want 3 per batch")
        if len(caps) != n_images or not all(isinstance(c, str)
                                            for c in caps):
            raise AssertionError(f"{label}: an image got no caption")
        print(f"slice {label}: fused_attention launches {launched} over "
              f"{n_batches} batches", flush=True)
    launches = fused_attention.launches
    print(f"sample captions: greedy {results['greedy'][0][0]!r}; beam3 "
          f"{results['beam3'][0][0]!r}", flush=True)

    for label, beam in (("greedy", None), ("beam3", 3)):
        runs = [results[label][1]]
        for _ in range(2):
            t0 = time.perf_counter()
            decode_split(model, cfg, split, batch_size, idx_to_word,
                         beam_size=beam, device=device)
            runs.append(time.perf_counter() - t0)
        seconds = statistics.median(runs)
        print(f"slice {label}: {n_images} images in {seconds:.4f} s "
              f"(median of {len(runs)} runs: "
              f"{', '.join(f'{r:.4f}' for r in runs)}), "
              f"{n_images / seconds:.2f} images/s at batch {batch_size} "
              f"[{card}]", flush=True)
    if device != "cpu":
        profile_batch(model, cfg, warm, batch_size, idx_to_word, card)

    check_against_cpu(model, cfg, split, batch_size)
    return launches


def device_kernels(prof):
    """The kernels alone from a profile: rows on the device that are not a
    user annotation (``Optimizer.step``'s range on the device timeline
    repeats the time of the kernels inside it)."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def profile_batch(model, cfg, split, batch_size, idx_to_word, card):
    """One batch of each decode under torch.profiler: the device's busy
    time (the kernels' own time) against the batch's time on the host
    clock without the profiler, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from image_caption_tpu_torch.serve import decode_split
    for label, beam in (("greedy", None), ("beam3", 3)):
        def run():
            decode_split(model, cfg, split, batch_size, idx_to_word,
                         beam_size=beam)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            run()
            walls.append(time.perf_counter() - t0)
        wall_ms = 1e3 * statistics.median(walls)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        stats = device_kernels(prof)
        busy_ms = sum(e.self_device_time_total for e in stats) / 1e3
        if busy_ms <= 0:
            print(f"profile {label}: the profiler saw no device time; "
                  f"device busy share not measured", flush=True)
            continue
        top = sorted(stats, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        print(f"profile {label}, one batch of {batch_size}: {wall_ms:.2f} ms "
              f"on the host clock, device busy {busy_ms:.2f} ms, idle share "
              f"{1 - busy_ms / wall_ms:.4f} [{card}]", flush=True)
        ours = [e for e in stats if "fused_attention" in e.key]
        for e in top + [e for e in ours if e not in top]:
            print(f"profile {label}:   {e.self_device_time_total / 1e3:9.3f}"
                  f" ms  x{e.count:<6d} {e.key[:90]}", flush=True)


def check_against_cpu(model, cfg, split, batch_size: int):
    """The first batch through the plain path on the CPU, same weights:
    teacher-forced logits within 2e-4, greedy tokens equal except after a
    step where the CPU's top-2 logit margin is below 1e-4."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.models.decoding import greedy_decode

    m = cfg.model
    cpu = Captioner(m, device="cpu")
    cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    f = split.features[:batch_size]
    p = split.positions[:batch_size]
    c = split.captions[:batch_size]
    got = model.logits(f, p, c).cpu()
    want = cpu.logits(f, p, c)
    err = (got - want).abs().max().item()
    print(f"cpu check: teacher-forced logits {tuple(want.shape)} max_abs_err "
          f"{err:.3e} (tol 2e-4)", flush=True)
    if not err <= 2e-4:
        raise AssertionError(f"card and CPU logits differ by {err:.3e}")

    tok_gpu = greedy_decode(model, f, p, device=model.device)[0].cpu()
    tok_cpu = greedy_decode(cpu, f, p, device="cpu")[0]
    # the CPU's logits at every greedy step, teacher-forced on its tokens
    step_logits = cpu.logits(f, p, tok_cpu[:, :m.max_length])
    top2 = step_logits.topk(2, dim=-1).values
    margin = top2[..., 0] - top2[..., 1]            # [B, steps]
    rows = (tok_gpu != tok_cpu).any(dim=1).nonzero()[:, 0].tolist()
    for r in rows:
        first = int((tok_gpu[r] != tok_cpu[r]).nonzero()[0, 0])
        step_margin = margin[r, first - 1].item()
        print(f"cpu check: row {r} differs from token {first}, CPU top-2 "
              f"margin there {step_margin:.3e}", flush=True)
        if not step_margin < 1e-4:
            raise AssertionError(
                f"greedy tokens differ at row {r}, token {first}, where "
                f"the CPU's top-2 margin is {step_margin:.3e}")
    print(f"cpu check: greedy tokens equal on {tok_cpu.shape[0] - len(rows)}"
          f" of {tok_cpu.shape[0]} rows", flush=True)


# ---------------------------------------------------------------------------
# Phases 7-9: training at full width
# ---------------------------------------------------------------------------

def train_batch(m, batch_size: int, seed: int):
    """One train batch drawn as ``make_split`` draws a split."""
    split = make_split(m, batch_size, seed)
    return split.features, split.positions, split.captions


def drive_train(cfg, card: str, device: str = "cuda"):
    """20 ``Trainer.train_step`` calls on one batch; returns each kernel's
    launches over them and the steps per second."""
    from image_caption_tpu_torch.ops.attention import (fused_attention,
                                                       fused_attention_bwd)
    from image_caption_tpu_torch.train.loop import Trainer
    trainer = Trainer(cfg, device=device)
    batch = train_batch(cfg.model, cfg.train.batch_size, seed=2)
    fused_attention.launches = fused_attention_bwd.launches = 0
    losses, seconds = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        losses.append(trainer.train_step(*batch)["loss"])
        seconds.append(time.perf_counter() - t0)
    launches = {"fused_attention": fused_attention.launches,
                "fused_attention_bwd": fused_attention_bwd.launches}
    print(f"train: losses {' '.join(f'{x:.4f}' for x in losses)}",
          flush=True)
    print(f"train: launches over {TRAIN_STEPS} steps {launches}, want "
          f"{LAUNCHES_PER_STEP} x {TRAIN_STEPS} each", flush=True)
    want = LAUNCHES_PER_STEP * TRAIN_STEPS
    if device != "cpu" and any(n != want for n in launches.values()):
        raise AssertionError(f"kernel launches {launches}, want {want}")
    if not np.all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses[0]} -> "
                             f"{losses[-1]}")
    steady = seconds[1:]
    sps = len(steady) / sum(steady)
    print(f"train: {sps:.3f} steps/s at batch {cfg.train.batch_size} over "
          f"steps 2-{TRAIN_STEPS} (first step {seconds[0]:.3f} s, median "
          f"{statistics.median(steady) * 1e3:.2f} ms) [{card}]", flush=True)
    if device != "cpu":
        profile_train_step(trainer, batch, card)
    return launches, sps


def profile_train_step(trainer, batch, card: str):
    """One train step under torch.profiler: the device's busy time (the
    kernels' own time) against the step's time on the host clock without
    the profiler, and the kernels that take the most."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        trainer.train_step(*batch)
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * statistics.median(walls)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(*batch)
        torch.cuda.synchronize()
    stats = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in stats) / 1e3
    if busy_ms <= 0:
        print("profile train step: the profiler saw no device time; device "
              "busy share not measured", flush=True)
        return
    print(f"profile train step, batch {trainer.cfg.train.batch_size}: "
          f"{wall_ms:.2f} ms on the host clock, device busy {busy_ms:.2f} "
          f"ms, idle share {1 - busy_ms / wall_ms:.4f} [{card}]", flush=True)
    top = sorted(stats, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    ours = [e for e in stats if "fused_attention" in e.key]
    for e in top + [e for e in ours if e not in top]:
        print(f"profile train step:   {e.self_device_time_total / 1e3:9.3f}"
              f" ms  x{e.count:<6d} {e.key[:90]}", flush=True)


def drive_train_loop(cfg, card: str, device: str = "cuda", *,
                     label: str = "train loop", then=None):
    """One epoch of ``train()`` on a synthetic dataset (feature files as
    ``.npy``: the card's machine may lack ``h5py``), then a second call that
    resumes from its checkpoint and trains epoch 2.  The model is ``cfg``'s
    at full width, with the dataset's vocabulary.  ``then(run, data, out)``
    runs last, before the dataset is removed."""
    from image_caption_tpu_torch.data.synthetic import \
        generate_synthetic_dataset
    from image_caption_tpu_torch.train.checkpoint import CheckpointManager
    from image_caption_tpu_torch.train.loop import train
    from image_caption_tpu_torch.utils.io import load_pickle
    with tempfile.TemporaryDirectory() as tmp:
        data, out = os.path.join(tmp, "data"), os.path.join(tmp, "out")
        vocab = generate_synthetic_dataset(data, feature_format="npy")
        # the model's vocabulary is the dataset's (36 words)
        run = cfg.with_overrides(**{"model.num_vocab": len(vocab),
                                    "data.data_path": data,
                                    "data.output_path": out,
                                    "train.log_every": 2,
                                    "train.sample_every": 4})
        steps_per_epoch = -(-120 // run.train.batch_size)
        for epochs in (1, 2):
            t0 = time.perf_counter()
            state = train(run, num_epochs=epochs, device=device)
            seconds = time.perf_counter() - t0
            with open(os.path.join(out, "valid_scores.txt")) as f:
                scores = f.read()
            caps = load_pickle(os.path.join(
                out, "candidates", "valid.candidate.captions.pkl"))
            saved = CheckpointManager(os.path.join(out, "model")).all_epochs()
            print(f"{label}: epoch {epochs} in {seconds:.2f} s, step "
                  f"{state.step}, checkpoints {saved}, {len(caps)} valid "
                  f"captions, scores file epochs "
                  f"{scores.count('Epoch ')} [{card}]", flush=True)
            if (state.step != epochs * steps_per_epoch
                    or saved != list(range(1, epochs + 1))
                    or scores.count("Epoch ") != epochs or len(caps) != 8
                    or "valid_CIDEr" not in scores):
                raise AssertionError(f"train() after {epochs} epoch(s): "
                                     f"step {state.step}, checkpoints "
                                     f"{saved}, scores:\n{scores}")
        print(f"{label}: scores of epoch 2: "
              + "; ".join(scores.split("Epoch 2")[1].strip().splitlines()),
              flush=True)
        if then is not None:
            then(run, data, out)


def train_against_cpu(cfg, card: str, device: str = "cuda"):
    """The same initial weights with all dropout off: 3 train steps on the
    card (the kernels) and on the CPU (the plain path).  Step-1 gradients
    within 1e-4 norm-relative per tensor, the three losses within 2e-4."""
    import torch
    from image_caption_tpu_torch.train.loop import Trainer
    from image_caption_tpu_torch.train.step import train_step
    off = cfg.with_overrides(**{"model.dropout": 0.0,
                                "model.attention_dropout": 0.0})
    gpu = Trainer(off, device=device, seed=3)
    cpu = Trainer(off, device="cpu", seed=3)
    cpu.state.model.load_state_dict(
        {k: v.cpu() for k, v in gpu.state.model.state_dict().items()})
    batch = train_batch(off.model, off.train.batch_size, seed=4)
    worst_grad, worst_loss = 0.0, 0.0
    for step in range(3):
        lg = train_step(gpu.state, gpu.to_device(batch),
                        seed=0)["loss"].item()
        lc = train_step(cpu.state, cpu.to_device(batch),
                        seed=0)["loss"].item()
        worst_loss = max(worst_loss, abs(lg - lc))
        print(f"card vs cpu: step {step + 1} loss {lg:.6f} vs {lc:.6f}",
              flush=True)
        if step == 0:
            want = dict(cpu.state.model.named_parameters())
            for name, p in gpu.state.model.named_parameters():
                g, w = p.grad.cpu(), want[name].grad
                rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
                worst_grad = max(worst_grad, rel)
                if not rel <= 1e-4:
                    raise AssertionError(f"step-1 gradient of {name}: "
                                         f"norm-relative error {rel:.3e}")
    print(f"card vs cpu: step-1 gradients norm-relative max {worst_grad:.3e}"
          f" (tol 1e-4), losses max_abs_err {worst_loss:.3e} (tol 2e-4) "
          f"[{card}]", flush=True)
    if not worst_loss <= 2e-4:
        raise AssertionError(f"card and CPU losses differ by {worst_loss}")


# ---------------------------------------------------------------------------
# Phases 10-13: self-critical (SCST) fine-tuning at full width
# ---------------------------------------------------------------------------

def scst_trainer(cfg, data_path: str, device: str, seed: int = 0, **over):
    """An RLTrainer over the 12,000-word smoke vocabulary whose frozen
    CIDEr df lies under ``data_path``; its host scoring is timed into the
    trainer's ``score_s`` list, and the last rewards kept in
    ``last_rewards``."""
    from image_caption_tpu_torch.train.loop import RLTrainer
    words = vocabulary(cfg.model.num_vocab)
    run = cfg.with_overrides(**{"data.data_path": data_path}, **over)
    trainer = RLTrainer(run, {w: i for i, w in words.items()},
                        device=device, seed=seed)
    score = trainer._host_rewards
    trainer.score_s = []

    def timed(sample_seq, captions):
        t0 = time.perf_counter()
        out = score(sample_seq, captions)
        trainer.score_s.append(time.perf_counter() - t0)
        trainer.last_rewards = out[0]
        return out

    trainer._host_rewards = timed
    return trainer


def write_batch_df(m, batch, directory: str):
    """coco-val-df.p over the batch's captions, one document an image."""
    from image_caption_tpu_torch.data.vocab import decode_captions
    from image_caption_tpu_torch.metrics.cider import (build_doc_frequency,
                                                       save_doc_frequency)
    caps = decode_captions(batch[2], vocabulary(m.num_vocab))
    save_doc_frequency(build_doc_frequency([c] for c in caps),
                       os.path.join(directory, "coco-val-df.p"))


def synchronize(device: str):
    import torch
    if device != "cpu":
        torch.cuda.synchronize(device)


def scst_batch(m, batch_size: int, seed: int, captions: int = 4):
    """A train batch drawn as ``make_split`` draws one, but whose images
    share ``captions`` captions of 8-16 words from 40 of the vocabulary,
    round-robin, so that a short XE warm-up (``xe_warm_weights``) teaches
    them and SCST starts, as users start it, from a model whose samples
    earn rewards."""
    f, p, _ = train_batch(m, batch_size, seed)
    rng = np.random.RandomState(seed + 100)
    distinct = np.zeros((captions, m.max_length), np.int32)
    for i in range(captions):
        n = rng.randint(8, 17)
        distinct[i, 0] = 1
        distinct[i, 1:n + 1] = rng.randint(4, 44, size=n)
        distinct[i, n + 1] = 2
    return f, p, distinct[np.arange(batch_size) % captions]


def xe_warm_weights(cfg, batch, device: str, steps: int = 40):
    """The weights (seed 0) after ``steps`` XE updates of ``cfg``'s model
    on ``batch`` with dropout off at learning rate 1e-3, as CPU tensors
    (at the preset's dropout 0.3 and 5e-4 the full-depth model has not
    learnt the captions after 40 updates)."""
    from image_caption_tpu_torch.train.loop import Trainer
    warm = cfg.with_overrides(caption_model="Transformer", **{
        "model.dropout": 0.0, "train.learning_rate": 1e-3})
    trainer = Trainer(warm, device=device, seed=0)
    for _ in range(steps):
        trainer.train_step(*batch)
    return {k: v.detach().cpu().clone()
            for k, v in trainer.state.model.state_dict().items()}


def drive_scst(cfg, card: str, device: str = "cuda"):
    """20 SCST updates on one batch from the same weights, four times: the
    pipelined schedule, the serial one, the serial and the pipelined
    again (the order evens out drift on the host).  Returns each kernel's
    launches over the first pipelined run, and the weights it started
    from."""
    from image_caption_tpu_torch.ops.attention import (fused_attention,
                                                       fused_attention_bwd)
    m = cfg.model
    batch = scst_batch(m, cfg.train.batch_size, seed=2)
    t0 = time.perf_counter()
    start = xe_warm_weights(cfg, batch, device)
    print(f"scst: start from 40 XE updates on the batch "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    order = ("pipelined", "serial", "serial", "pipelined")
    with tempfile.TemporaryDirectory() as tmp:
        write_batch_df(m, batch, tmp)
        trainers = [scst_trainer(cfg, tmp, device, **{
            "rl.pipeline_depth": int(label == "pipelined")})
            for label in order]
        warm = scst_trainer(cfg, tmp, device, seed=1)
    for trainer in trainers:
        trainer.state.model.load_state_dict(start)
    rc = trainers[0].reward_computer
    print(f"scst: reward scorer {rc.backend}, frozen df "
          f"{rc.uses_frozen_df}", flush=True)
    if rc.backend != "native" or not rc.uses_frozen_df:
        raise AssertionError("the SCST rewards must come from the native "
                             "scorer over the frozen df")
    # first-use set-up (cuBLAS, the allocator) outside the timed runs
    for _ in range(2):
        warm.train_step(*batch)
    dev_batch = warm.to_device(batch)
    runs, rates = [], {"pipelined": [], "serial": []}
    for label, trainer in zip(order, trainers):
        synchronize(device)
        fused_attention.launches = fused_attention_bwd.launches = 0
        t0 = time.perf_counter()
        metrics = [trainer.train_step_device(dev_batch)
                   for _ in range(TRAIN_STEPS)] + [trainer.flush()]
        synchronize(device)
        seconds = time.perf_counter() - t0
        launches = {"fused_attention": fused_attention.launches,
                    "fused_attention_bwd": fused_attention_bwd.launches}
        runs.append(launches)
        rates[label].append(TRAIN_STEPS / seconds)
        metrics = [{k: float(v) for k, v in x.items()} for x in metrics
                   if x is not None]
        rewards = trainer.last_rewards
        score_ms = 1e3 * statistics.median(trainer.score_s)
        print(f"scst {label}: losses "
              f"{' '.join(f'{x['loss']:.4f}' for x in metrics)}",
              flush=True)
        print(f"scst {label}: mean reward "
              f"{' '.join(f'{x['reward']:.4f}' for x in metrics)}; last "
              f"step {int((rewards > 0).sum())} of {rewards.size} rows with "
              f"a non-zero reward, {int((rewards > 1e-3).sum())} above "
              f"1e-3, max {rewards.max():.4f}", flush=True)
        print(f"scst {label}: {TRAIN_STEPS / seconds:.3f} steps/s at batch "
              f"{cfg.train.batch_size} ({TRAIN_STEPS} steps in "
              f"{seconds:.3f} s, to the last update); scoring "
              f"{score_ms:.3f} ms a step on the host (median) [{card}]",
              flush=True)
        print(f"scst {label}: launches over {TRAIN_STEPS} steps "
              f"{launches}, want {LAUNCHES_PER_STEP} x {TRAIN_STEPS} each",
              flush=True)
        if len(metrics) != TRAIN_STEPS or not np.all(np.isfinite(
                [v for x in metrics for v in x.values()])):
            raise AssertionError(f"scst {label}: {len(metrics)} steps, "
                                 f"metrics {metrics}")
        want = LAUNCHES_PER_STEP * TRAIN_STEPS
        if device != "cpu" and any(n != want for n in launches.values()):
            raise AssertionError(f"scst {label}: launches {launches}, "
                                 f"want {want}")
    in_order = rates["pipelined"][:1] + rates["serial"] + \
        rates["pipelined"][1:]
    print(f"scst: steps/s in order {', '.join(order)}: "
          f"{', '.join(f'{r:.3f}' for r in in_order)}; pipelined / serial "
          f"{sum(rates['pipelined']) / sum(rates['serial']):.4f} [{card}]",
          flush=True)
    worst = 0.0
    want = dict(trainers[1].state.model.named_parameters())
    for name, p in trainers[0].state.model.named_parameters():
        w = want[name].detach()
        rel = ((p.detach() - w).norm() / w.norm().clamp_min(1e-30)).item()
        worst = max(worst, rel)
    print(f"scst: pipelined vs serial parameters after {TRAIN_STEPS} "
          f"steps, norm-relative max {worst:.3e} (tol 1e-5)", flush=True)
    if not worst <= 1e-5:
        raise AssertionError(f"the two schedules' parameters differ by "
                             f"{worst:.3e}")
    if device != "cpu":
        profile_scst_step(trainers[2], batch, card)
    return runs[0], start


def profile_scst_step(trainer, batch, card: str):
    """One blocking SCST step under torch.profiler: device busy against
    the step's host-clock time without the profiler, the kernels that take
    the most, and the host scoring's share of the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls, scores = [], []
    for _ in range(3):
        n = len(trainer.score_s)
        t0 = time.perf_counter()
        trainer.train_step(*batch)
        walls.append(time.perf_counter() - t0)
        scores.append(sum(trainer.score_s[n:]))
    wall_ms = 1e3 * statistics.median(walls)
    score_ms = 1e3 * statistics.median(scores)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        trainer.train_step(*batch)
        torch.cuda.synchronize()
    stats = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in stats) / 1e3
    print(f"profile scst step: scoring {score_ms:.3f} ms of {wall_ms:.2f} ms"
          f" on the host clock (share {score_ms / wall_ms:.4f}) [{card}]",
          flush=True)
    if busy_ms <= 0:
        print("profile scst step: the profiler saw no device time; device "
              "busy share not measured", flush=True)
        return
    print(f"profile scst step, batch {trainer.cfg.train.batch_size}: "
          f"{wall_ms:.2f} ms on the host clock, device busy {busy_ms:.2f} "
          f"ms, idle share {1 - busy_ms / wall_ms:.4f} [{card}]", flush=True)
    top = sorted(stats, key=lambda e: e.self_device_time_total,
                 reverse=True)[:8]
    ours = [e for e in stats if "fused_attention" in e.key]
    for e in top + [e for e in ours if e not in top]:
        print(f"profile scst step:   {e.self_device_time_total / 1e3:9.3f}"
              f" ms  x{e.count:<6d} {e.key[:90]}", flush=True)


def drive_scst_loop(cfg, card: str, device: str = "cuda"):
    """``train()`` of the RL preset (one epoch, then a resumed second) on
    the synthetic dataset with its frozen CIDEr df, then the ``evaluation``
    verb on the checkpoint through ``main.main``, beam 3."""
    import dataclasses
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.main import main as cli_main
    from image_caption_tpu_torch.ops.attention import fused_attention
    from image_caption_tpu_torch.utils.io import load_pickle

    def evaluate(run, data, out):
        # the flags that turn the preset into run's model
        preset = dataclasses.asdict(get_preset(run.name).model)
        sets = [f"--set=model.{k}={v}"
                for k, v in dataclasses.asdict(run.model).items()
                if preset[k] != v]
        fused_attention.launches = 0
        t0 = time.perf_counter()
        cli_main(["--device", device, "--preset", run.name, *sets,
                  "--data-path", data, "--output-path", out,
                  "evaluation", "--split", "test", "--beam-size", "3"])
        seconds = time.perf_counter() - t0
        caps = load_pickle(os.path.join(
            out, "candidates", "test.candidate.captions.pkl"))
        with open(os.path.join(out, "test_scores.txt")) as f:
            scores = f.read()
        print(f"scst loop: evaluation of epoch 2 in {seconds:.2f} s, "
              f"{len(caps)} test captions, fused_attention launches "
              f"{fused_attention.launches} [{card}]", flush=True)
        if (len(caps) != 8 or not scores.startswith("Epoch 2\n")
                or "test_CIDEr" not in scores
                or (device != "cpu" and fused_attention.launches != 3)):
            raise AssertionError(f"evaluation: {len(caps)} captions, "
                                 f"scores:\n{scores}")

    drive_train_loop(cfg, card, device, label="scst loop", then=evaluate)


@contextlib.contextmanager
def recorded_attention_calls(device: str):
    """Inside it, the inputs of every kernel #1 and #2 call on ``device``
    are kept: yields {"fwd": [(q, k, v, mask, t)], "bwd": [(q, k, v, mask,
    dO, t)]}.  The kernels' launch counts go on as without it."""
    from image_caption_tpu_torch.ops import attention as A
    fwd, bwd = A._fused_forward, A.fused_attention_bwd
    calls = {"fwd": [], "bwd": []}

    def keep(kind, args):
        if args[0].device.type == device:
            calls[kind].append([a.detach().clone() for a in args[:-1]]
                               + [args[-1]])

    def rec_fwd(*args):
        keep("fwd", args)
        return fwd(*args)

    def rec_bwd(*args):
        keep("bwd", args)
        return bwd(*args)

    rec_bwd.launches = bwd.launches      # the wrapper counts by this name
    A._fused_forward, A.fused_attention_bwd = rec_fwd, rec_bwd
    try:
        yield calls
    finally:
        bwd.launches = rec_bwd.launches
        A._fused_forward, A.fused_attention_bwd = fwd, bwd


def attention_f64(q, k, v, mask_i8, t):
    """The attention forward and its backward's (dq, dk, dv) as functions
    of float64 copies of the inputs: the exact values the f32 kernels and
    plain versions approximate."""
    import torch
    from image_caption_tpu_torch.ops.attention import masked_softmax
    qd, kd, vd = (x.double() for x in (q, k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", qd / t, kd)
    p = masked_softmax(s.masked_fill((mask_i8 != 0)[:, None],
                                     float("-inf")))
    out = torch.einsum("bhqk,bhkd->bhqd", p, vd)

    def bwd(d_out):
        do = d_out.double()
        dv = torch.einsum("bhqk,bhqd->bhkd", p, do)
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vd)
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        return (torch.einsum("bhqk,bhkd->bhqd", ds, kd) / t,
                torch.einsum("bhqk,bhqd->bhkd", ds, qd) / t, dv)

    return out, bwd


def check_attention_against_f64(calls, card: str):
    """Each recorded kernel #1 and #2 call, and its f32 plain version on
    the same inputs, against float64: the norm-relative error of every
    output.  A gradient that the loss barely feels (near-uniform attention
    gives a dq a thousandth of its neighbours') is computed only to about
    1e-4 by any f32 formula, so the bar is the plain version's own error:
    the kernel's may be at most twice it, plus 1e-6."""
    from image_caption_tpu_torch.ops import attention as A

    def rel(a, b):
        return ((a.double() - b).norm() / b.norm().clamp_min(1e-300)).item()

    rows = []
    for q, k, v, mask, t in calls["fwd"]:
        want, _ = attention_f64(q, k, v, mask, t)
        rows.append(("fwd out", tuple(q.shape), want.norm().item(),
                     rel(A._fused_forward(q, k, v, mask, t), want),
                     rel(A.attention_reference(q, k, v, mask != 0, t)[0],
                         want)))
    for q, k, v, mask, d_out, t in calls["bwd"]:
        want = attention_f64(q, k, v, mask, t)[1](d_out)
        got = A.fused_attention_bwd(q, k, v, mask, d_out, t)
        plain = A.attention_bwd_reference(q, k, v, mask, d_out, t)
        for name, g, pl, w in zip(("dq", "dk", "dv"), got, plain, want):
            rows.append((f"bwd {name}", tuple(q.shape), w.norm().item(),
                         rel(g, w), rel(pl, w)))
    worst = max(rows, key=lambda r: r[3] / (2 * r[4] + 1e-6))
    for name in ("fwd out", "bwd dq", "bwd dk", "bwd dv"):
        mine = [r for r in rows if r[0] == name]
        print(f"scst card vs cpu: {name} against float64 over "
              f"{len(mine)} calls: kernel max {max(r[3] for r in mine):.3e},"
              f" plain max {max(r[4] for r in mine):.3e} (norms "
              f"{min(r[2] for r in mine):.3e}-{max(r[2] for r in mine):.3e})"
              f" [{card}]", flush=True)
    if not worst[3] <= 2 * worst[4] + 1e-6:
        raise AssertionError(f"{worst[0]} at {worst[1]}: kernel error "
                             f"{worst[3]:.3e} against float64, plain "
                             f"{worst[4]:.3e}")


def scst_against_cpu(cfg, weights, card: str, device: str = "cuda"):
    """All dropout off, 3 SCST steps (argmax) on the ``scst`` batch on the
    card (the kernels) and on the CPU (the plain path), from two starts:
    fresh weights (seed 3) and ``weights`` (the ``scst`` phase's start,
    whose samples earn rewards).  Sampled tokens equal except where the
    CPU's top-2 log-prob margin is below 1e-4, the rewards of equal rows
    equal; both then update with the CPU's sample and rewards: the three
    losses within 2e-4.  From the fresh start, step-1 gradients within
    1e-4 norm-relative per tensor; from ``weights``, whose trained
    cross-attention leaves some gradients a thousandth of the others',
    step 1's kernel calls against float64 beside their plain versions
    (``check_attention_against_f64``)."""
    import dataclasses
    import torch
    from image_caption_tpu_torch.rl.step import rl_sample, rl_update
    off = cfg.with_overrides(**{"model.dropout": 0.0,
                                "model.attention_dropout": 0.0})
    assert off.rl.sample_mode == "argmax"
    m = off.model
    batch = scst_batch(m, off.train.batch_size, seed=2)
    for start in ("fresh", "xe-warm"):
        with tempfile.TemporaryDirectory() as tmp:
            write_batch_df(m, batch, tmp)
            gpu = scst_trainer(off, tmp, device, seed=3)
            cpu = scst_trainer(off, tmp, "cpu")
        if start == "xe-warm":
            gpu.state.model.load_state_dict(weights)
        cpu.state.model.load_state_dict(
            {k: v.cpu() for k, v in gpu.state.model.state_dict().items()})
        worst_grad, worst_loss, differ, rewarded = 0.0, 0.0, 0, 0
        for step in range(3):
            with recorded_attention_calls(device) as calls:
                sg = rl_sample(gpu.state, gpu.to_device(batch), off, seed=0)
                sc = rl_sample(cpu.state, cpu.to_device(batch), off, seed=0)
                (seq_g, caps), (seq_c, _) = sg.host(), sc.host()
                lp = torch.log_softmax(sc.logits.detach(), dim=-1)
                top2 = lp.topk(2, dim=-1).values
                margin = (top2[..., 0] - top2[..., 1]).numpy()   # [B, T]
                diff = seq_g[:, 0] != seq_c[:, 0]
                if np.any(diff & (margin >= 1e-4)):
                    r, t = np.argwhere(diff & (margin >= 1e-4))[0]
                    raise AssertionError(
                        f"{start} step {step + 1}: sampled token ({r}, {t})"
                        f" differs where the CPU margin is "
                        f"{margin[r, t]:.3e}")
                rows = ~diff.any(axis=1)
                differ += int((~rows).sum())
                rw_g, sc_g = gpu._host_rewards(seq_g, caps)
                rw_c, sc_c = cpu._host_rewards(seq_c, caps)
                if not (np.array_equal(rw_g[rows], rw_c[rows])
                        and np.array_equal(sc_g[rows], sc_c[rows])):
                    raise AssertionError(f"{start} step {step + 1}: "
                                         "rewards of equal rows differ")
                rewarded += int((rw_c > 1e-3).sum())
                sg = dataclasses.replace(sg, seq=sc.seq.to(device))
                mg = rl_update(gpu.state, sg, rw_c, sc_c, off)
                mc = rl_update(cpu.state, sc, rw_c, sc_c, off)
            for key in ("loss", "language_model_loss", "structure_loss"):
                worst_loss = max(worst_loss,
                                 abs(mg[key].item() - mc[key].item()))
            print(f"scst card vs cpu: {start} step {step + 1} loss "
                  f"{mg['loss'].item():.6f} vs {mc['loss'].item():.6f}, "
                  f"reward {mg['reward'].item():.6f} vs "
                  f"{mc['reward'].item():.6f}, {int(rows.sum())} of "
                  f"{rows.size} rows sampled equal", flush=True)
            if step > 0:
                continue
            want = dict(cpu.state.model.named_parameters())
            for name, p in gpu.state.model.named_parameters():
                g, w = p.grad.cpu(), want[name].grad
                rel = ((g - w).norm() / w.norm().clamp_min(1e-30)).item()
                worst_grad = max(worst_grad, rel)
                if start == "fresh" and not rel <= 1e-4:
                    raise AssertionError(f"step-1 gradient of {name}: "
                                         f"norm-relative error {rel:.3e}")
            if start == "xe-warm":
                check_attention_against_f64(calls, card)
        print(f"scst card vs cpu: {start}: step-1 gradients norm-relative "
              f"max {worst_grad:.3e}"
              + (" (tol 1e-4)" if start == "fresh" else
                 " (held against float64 call by call above)")
              + f", losses max_abs_err {worst_loss:.3e} (tol 2e-4), "
              f"{differ} row-steps sampled differently (all at CPU margins "
              f"below 1e-4), {rewarded} of {3 * len(batch[2])} row-steps "
              f"rewarded above 1e-3 [{card}]", flush=True)
        if not worst_loss <= 2e-4:
            raise AssertionError(f"card and CPU SCST losses differ by "
                                 f"{worst_loss}")


# ---------------------------------------------------------------------------
# Phases 14-15: the bottleneck kernels (#3, #4), checked and timed
# ---------------------------------------------------------------------------

def bottleneck_weights(run, seed: int, device):
    """Stacked weights for one identity run (name, H, C, Wd, blocks):
    kaiming-normal convs and random folded BN as a trained net has them
    (the expand BN's scale small), f32 as the parameters are kept."""
    import torch
    _, _, c, wd, nblk = run
    g = torch.Generator().manual_seed(seed)
    w1 = torch.randn(nblk, wd, c, generator=g) * (2.0 / wd) ** 0.5
    w2 = torch.randn(nblk, wd, wd, 3, 3, generator=g) * (2.0 / (9 * wd)) ** 0.5
    w3 = torch.randn(nblk, c, wd, generator=g) * (2.0 / c) ** 0.5

    def sb(n, lo, span):
        return torch.stack([torch.rand(nblk, n, generator=g) * span + lo,
                            torch.randn(nblk, n, generator=g) * 0.1], 1)
    return [t.to(device) for t in (w1, sb(wd, 0.5, 1.0), w2, sb(wd, 0.5, 1.0),
                                   w3, sb(c, 0.0, 0.2), )]


def bottleneck_input(run, n: int, seed: int, device, dtype):
    """Post-relu activations [n, C, H, H] in channels_last memory."""
    import torch
    _, h, c, _, _ = run
    g = torch.Generator().manual_seed(seed)
    x = torch.relu(torch.randn(n, c, h, h, generator=g)).to(dtype)
    return x.to(device).contiguous(memory_format=torch.channels_last)


def block_args(ws, i: int = 0):
    """fused_bottleneck's arguments for block ``i`` of stacked weights."""
    w1, sb1, w2, sb2, w3, sb3 = ws
    return (w1[i], sb1[i, 0], sb1[i, 1], w2[i], sb2[i, 0], sb2[i, 1], w3[i],
            sb3[i, 0], sb3[i, 1])


def check_bottleneck(device, runs=RESNET101_RUNS, crops=CHECK_CROPS):
    """Kernels #3 (the run's first block) and #4 (the whole run) against
    ``bottleneck_reference`` and ``stage_reference`` on the same inputs,
    every identity run of ResNet-101 at ``crops`` crops, in float32 and
    bfloat16.  Tolerance: max error <= tol x max|ref|.  Returns each
    kernel's largest float32 error."""
    import torch
    from image_caption_tpu_torch.vision import bottleneck as B
    worst = {"fused_bottleneck": 0.0, "fused_stage": 0.0}
    for k, run in enumerate(runs):
        ws = bottleneck_weights(run, 100 + k, device)
        for n in crops:
            for dtype in (torch.float32, torch.bfloat16):
                x = bottleneck_input(run, n, 200 + k, device, dtype)
                pairs = {"fused_stage": (B.fused_stage(x, *ws),
                                         B.stage_reference(x, *ws)),
                         "fused_bottleneck": (
                             B.fused_bottleneck(x, *block_args(ws)),
                             B.bottleneck_reference(x, *block_args(ws)))}
                if device != "cpu":
                    torch.cuda.synchronize()
                tol = BOTTLENECK_TOL[str(dtype).split(".")[1]]
                parts = []
                for name, (got, want) in pairs.items():
                    err = (got.float() - want.float()).abs().max().item()
                    ref = want.float().abs().max().item()
                    parts.append(f"{name} max_abs_err {err:.3e} (max|ref| "
                                 f"{ref:.3e}, rel {err / ref:.3e})")
                    if not (err <= tol * ref and bool(torch.isfinite(got)
                                                       .all())):
                        raise AssertionError(
                            f"{name} disagrees with its plain version on "
                            f"{run[0]} N={n} {dtype}: {err:.3e} > {tol:g} x "
                            f"{ref:.3e}")
                    if dtype == torch.float32:
                        worst[name] = max(worst[name], err)
                print(f"kernel check bottleneck {run[0]} N={n} C={run[2]} "
                      f"H=W={run[1]} Wd={run[3]} blocks={run[4]} {dtype}: "
                      f"{'; '.join(parts)} (tol {tol:g} x max|ref|)",
                      flush=True)
    return worst


def check_determinism(device, run=RESNET101_RUNS[2], n=CROPS,
                      dtype_name="bfloat16"):
    """Two launches of kernel #4 over ``run`` on n crops in the dtype, and a
    third on half the SMs' worth of CTAs, give the same bits: every output
    element has one owner and one summation order whatever the grid, so a
    difference means a race (the grid barrier, the ring's proxy fences)."""
    import torch
    from image_caption_tpu_torch.vision import bottleneck as B
    dtype = getattr(torch, dtype_name)
    ws = bottleneck_weights(run, 102, device)
    x = bottleneck_input(run, n, 202, device, dtype)
    first, second = B.fused_stage(x, *ws), B.fused_stage(x, *ws)
    if x.is_cuda:
        ctas = torch.cuda.get_device_properties(x.device).multi_processor_count
        ctas //= 2
        half = B._launch("fused_stage", x, *ws, max_ctas=ctas)
    else:                             # a rehearsal: the plain version
        ctas, half = 0, B.fused_stage(x, *ws)
    word = torch.int16 if dtype == torch.bfloat16 else torch.int32
    bits = first.view(word)
    differ = int((bits != second.view(word)).sum())
    differ_grid = int((bits != half.view(word)).sum())
    print(f"kernel check bottleneck determinism {run[0]} N={n} blocks="
          f"{run[4]} {dtype_name}: two launches, {differ} of {first.numel()} "
          f"elements differ in their bits; on {ctas} CTAs, {differ_grid} "
          f"differ (want 0 and 0)", flush=True)
    if differ or differ_grid:
        raise AssertionError(f"fused_stage is not deterministic in "
                             f"{dtype_name}")


def bottleneck_bound(run, n: int, nblk: int, elem: int):
    """Least time for ``nblk`` blocks of a run on n crops: x read and y
    written once, the weights read once, against the multiply-adds of the
    three convs at the dtype's peak (bf16 on the tensor cores; float32 as
    three TF32 passes on them, 495 / 3 = 165 TFLOP/s)."""
    _, h, c, wd, _ = run
    nbytes = (2 * n * h * h * c * elem
              + nblk * ((2 * c * wd + 9 * wd * wd) * elem + 4 * (4 * wd + 2 * c)))
    flops = 2 * n * h * h * nblk * (2 * c * wd + 9 * wd * wd)
    peak = PEAK_BF16_FLOPS if elem == 2 else PEAK_TF32_FLOPS / TF32_PASSES
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / peak
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes, flops)


def scratch_bytes(run, n: int, nblk: int, elem: int) -> int:
    """The design's own activation traffic for ``nblk`` blocks on n crops,
    outside the bound: per block the reduce reads x and writes h1, the 3x3
    reads h1 (each element once, its other taps from L2) and writes h2,
    the expand reads h2 and the residual and writes y: elem x N*H*W x
    (3 C + 4 Wd) bytes, through HBM where a phase's tensors outgrow L2."""
    _, h, c, wd, _ = run
    return elem * n * h * h * (3 * c + 4 * wd) * nblk


def time_bottleneck(card: str):
    """Per identity run at N=192 crops: kernels #4 over the run and #3
    over its first block, each in bf16 and f32; each beside its bound
    (with its TFLOP/s and its time as a multiple of the bound), its plain
    version, the cuDNN yardstick (the same blocks as three channels-last
    ``F.conv2d`` with the epilogues each, the route of
    ``cudnn_identity_runs``).  Device time by CUDA-graph
    replay (one call per graph, 2 warm-up and 5 timed replays)."""
    import torch
    from image_caption_tpu_torch.vision import bottleneck as B
    from image_caption_tpu_torch.vision.resnet import _bottleneck
    rows = {"fused_stage": {}, "fused_bottleneck": {}}
    timing = dict(warmup=2, reps=5)
    for k, run in enumerate(RESNET101_RUNS):
        ws = bottleneck_weights(run, 100 + k, "cuda")
        blocks = [{"conv1": ws[0][i][:, :, None, None],
                   "bn1": {"scale": ws[1][i, 0], "bias": ws[1][i, 1]},
                   "conv2": ws[2][i],
                   "bn2": {"scale": ws[3][i, 0], "bias": ws[3][i, 1]},
                   "conv3": ws[4][i][:, :, None, None],
                   "bn3": {"scale": ws[5][i, 0], "bias": ws[5][i, 1]}}
                  for i in range(run[4])]
        cases = [("fused_stage", torch.bfloat16, run[4]),
                 ("fused_stage", torch.float32, run[4]),
                 ("fused_bottleneck", torch.bfloat16, 1),
                 ("fused_bottleneck", torch.float32, 1)]
        for name, dtype, nblk in cases:
            x = bottleneck_input(run, CROPS, 300 + k, "cuda", dtype)
            if name == "fused_stage":
                def kernel():
                    return B.fused_stage(x, *ws)

                def plain():
                    return B.stage_reference(x, *ws)
            else:
                def kernel():
                    return B.fused_bottleneck(x, *block_args(ws))

                def plain():
                    return B.bottleneck_reference(x, *block_args(ws))

            def cudnn():
                y = x
                for blk in blocks[:nblk]:
                    y = _bottleneck(blk, y, 1)
                return y
            row = {"shape": [CROPS, run[2], run[1], run[1], run[3], nblk],
                   "dtype": str(dtype).split(".")[1],
                   "ms": device_ms(kernel, per_graph=1, **timing),
                   "call_ms": call_ms(kernel, **timing),
                   "plain_ms": device_ms(plain, per_graph=1, **timing),
                   "cudnn_ms": device_ms(cudnn, per_graph=1, **timing),
                   "library_ms": None}
            (row["bound_ms"], row["bound_by"], row["bytes"],
             row["flops"]) = bottleneck_bound(run, CROPS, nblk,
                                              x.element_size())
            row["scratch_bytes"] = scratch_bytes(run, CROPS, nblk,
                                                 x.element_size())
            row["tflops"] = row["flops"] / row["ms"] / 1e9
            row["x_bound"] = row["ms"] / row["bound_ms"]
            rows[name][f"{run[0]}_{row['dtype']}"] = row
            print(f"time {name} {run[0]} (N, C, H, W, Wd, blocks)="
                  f"{tuple(row['shape'])} {row['dtype']}: kernel "
                  f"{row['ms']:.4f} ms on the device ({row['call_ms']:.4f} ms "
                  f"a call), {row['tflops']:.1f} TFLOP/s, bound "
                  f"{row['bound_ms']:.4f} ms ({row['bound_by']}; "
                  f"{row['flops'] / 1e9:.1f} GFLOP, {row['bytes'] / 1e6:.1f}"
                  f" MB), {row['x_bound']:.2f}x the bound, scratch "
                  f"{row['scratch_bytes'] / 1e9:.2f} GB, plain "
                  f"{row['plain_ms']:.4f} ms, cuDNN {row['cudnn_ms']:.4f} ms, "
                  f"kernel/cuDNN {row['ms'] / row['cudnn_ms']:.2f}x [{card}]",
                  flush=True)
    return rows


# ---------------------------------------------------------------------------
# Phases 16-18: extraction and captioning from images at full width
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def cudnn_identity_runs():
    """ResNet's identity runs on cuDNN in this process: ``resnet_features``
    hands each run to ``fused_stage`` (kernel #4 on the card); inside this
    context each block of the run goes through ``resnet._bottleneck``
    instead (three channels-last ``F.conv2d``, BN in the compute dtype),
    the yardstick the extraction phases time #4 against and compare its
    features with."""
    from image_caption_tpu_torch.vision import resnet as R

    def blocks_on_cudnn(x, run):
        for block in run:
            x = R._bottleneck(block, x, 1)
        return x

    real = R.stack_identity_blocks, R.fused_stage
    R.stack_identity_blocks = lambda run: (run,)
    R.fused_stage = blocks_on_cudnn
    try:
        yield
    finally:
        R.stack_identity_blocks, R.fused_stage = real


def letterboxed_canvases(n: int, seed: int, size: int = 640):
    """``n`` uint8 ``size``-px canvases letterboxed as the loader does
    (content centred on gray 114) from random images of 300-640 px a side,
    with their metas [n, 3] and original sizes [n, 2]."""
    from image_caption_tpu_torch.vision.ops import letterbox_params
    rng = np.random.RandomState(seed)
    canvases = np.full((n, size, size, 3), 114, np.uint8)
    metas, sizes = [], []
    for i in range(n):
        h, w = rng.randint(300, 641, size=2)
        r, nh, nw, top, left = letterbox_params(h, w, size)
        canvases[i, top:top + nh, left:left + nw] = rng.randint(
            0, 256, (nh, nw, 3))
        metas.append([r, top, left])
        sizes.append([h, w])
    return canvases, np.asarray(metas, np.float32), np.asarray(sizes,
                                                                np.float32)


def padded_batches(canvases, metas, sizes, batch: int):
    """Batches of ``batch``; the last one padded with copies of its first
    row, as ``stream_extracted_batches`` pads."""
    out = []
    for s in range(0, len(canvases), batch):
        parts = [a[s:s + batch] for a in (canvases, metas, sizes)]
        real = len(parts[0])
        if real < batch:
            parts = [np.concatenate([a, np.repeat(a[:1], batch - real, 0)])
                     for a in parts]
        out.append((parts, real))
    return out


def drive_extract(params, cfg, card: str, device="cuda"):
    """``extract_features_batch`` at full width (YOLOv5x at 640, ResNet-101
    on 224-px crops) on the flagship's slot contract, bf16, batch 32, 70
    images in 3 batches, on both ResNet routes; returns the kernel launches
    of one pass of the kernel route and the features of both routes."""
    import torch
    from image_caption_tpu_torch.vision import bottleneck as B
    from image_caption_tpu_torch.vision.pipeline import extract_features_batch
    m, d = cfg.model, cfg.data
    batches = padded_batches(*letterboxed_canvases(EXTRACT_IMAGES, 7),
                             EXTRACT_BATCH)

    def run_pass(kernel):
        outs = []
        with (contextlib.nullcontext() if kernel
              else cudnn_identity_runs()):
            for (c, mt, sz), real in batches:
                f, p, bx = extract_features_batch(
                    params, c, mt, sz, num_objects=m.num_objects,
                    max_obj=d.max_obj, device=device)
                outs.append((f[:real], p[:real], bx[:real]))
        if device != "cpu":
            torch.cuda.synchronize()
        return [torch.cat(t) for t in zip(*outs)]

    for kernel in (True, False):               # set-up, not counted
        run_pass(kernel)
    B.fused_stage.launches = B.fused_bottleneck.launches = 0
    results = {True: run_pass(True)}
    launches = {"fused_stage": B.fused_stage.launches,
                "fused_bottleneck": B.fused_bottleneck.launches}
    results[False] = run_pass(False)
    print(f"extract: launches over {len(batches)} batches {launches}, want "
          f"fused_stage 4 per batch and fused_bottleneck 0", flush=True)
    if device != "cpu" and launches != {"fused_stage": 4 * len(batches),
                                        "fused_bottleneck": 0}:
        raise AssertionError(f"extract launched {launches}")
    seconds = {True: [], False: []}
    for kernel in (True, False, False, True, True, False):
        t0 = time.perf_counter()
        run_pass(kernel)
        seconds[kernel].append(time.perf_counter() - t0)
    for kernel, label in ((True, "kernel"), (False, "cuDNN")):
        s = statistics.median(seconds[kernel])
        print(f"extract {label} route: {EXTRACT_IMAGES} images in {s:.4f} s "
              f"(median of 3: {', '.join(f'{x:.4f}' for x in seconds[kernel])}"
              f"), {EXTRACT_IMAGES / s:.2f} images/s at batch "
              f"{EXTRACT_BATCH}, bf16 [{card}]", flush=True)

    (fk, pk, bk), (fp, pp, bp) = results[True], results[False]
    same_det = torch.equal(pk, pp) and torch.equal(bk, bp)
    err = (fk - fp).abs().max().item()
    ref = fp.abs().max().item()
    print(f"extract: features {tuple(fk.shape)} kernel route vs cuDNN route "
          f"max_abs_err {err:.3e} (max|ref| {ref:.3e}, rel {err / ref:.3e}, "
          f"tol {EXTRACT_ROUTE_TOL:g} x max|ref|); detections and positions "
          f"equal: {same_det}", flush=True)
    if not (same_det and err <= EXTRACT_ROUTE_TOL * ref
            and bool(torch.isfinite(fk).all())):
        raise AssertionError("the two ResNet routes disagree")
    if device != "cpu":
        profile_extract(lambda: extract_features_batch(
            params, *batches[0][0], num_objects=m.num_objects,
            max_obj=d.max_obj), card)
    return launches


def profile_extract(run, card: str, label: str = "extract"):
    """One extraction batch (``run()``) under torch.profiler: device busy
    against the batch's median host-clock time without the profiler, the
    idle share, and the top device ops.  Returns the idle share, or None
    when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def timed():
        run()
        torch.cuda.synchronize()
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        timed()
        walls.append(time.perf_counter() - t0)
    wall_ms = 1e3 * statistics.median(walls)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        timed()
    stats = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in stats) / 1e3
    if busy_ms <= 0:
        print(f"profile {label}: the profiler saw no device time; device "
              "busy share not measured", flush=True)
        return None
    idle = 1 - busy_ms / wall_ms
    print(f"profile {label}, one batch of {EXTRACT_BATCH} images: "
          f"{wall_ms:.2f} ms on the host clock, device busy {busy_ms:.2f} ms,"
          f" idle share {idle:.4f} [{card}]", flush=True)
    top = sorted(stats, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    for e in top:
        print(f"profile {label}:   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)
    return idle


def write_jpegs(directory: str, n: int, seed: int):
    """``n`` JPEGs of 300-640 px a side (smooth random colour fields)."""
    from PIL import Image
    rng = np.random.RandomState(seed)
    paths = []
    for i in range(n):
        h, w = rng.randint(300, 641, size=2)
        small = rng.randint(0, 256, (h // 16 + 1, w // 16 + 1, 3), np.uint8)
        img = Image.fromarray(small).resize((w, h), Image.BILINEAR)
        paths.append(os.path.join(directory, f"img{i:03d}.jpg"))
        img.save(paths[-1], quality=90)
    return paths


def drive_caption(params, cfg, card: str, device="cuda"):
    """``caption_images`` on 70 JPEGs with the flagship captioner at full
    width (random weights, seed 0), greedy and beam 3, batch 32: images/s
    end to end (decode, extraction, captioning) and the launches of
    kernels #1 and #4.  Returns the launches of one greedy and one beam
    pass."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.ops.attention import fused_attention
    from image_caption_tpu_torch.serve import caption_images
    from image_caption_tpu_torch.vision import bottleneck as B
    m = cfg.model
    model = Captioner(m, device=device,
                      generator=torch.Generator().manual_seed(0))
    idx_to_word = vocabulary(m.num_vocab)
    n_batches = -(-EXTRACT_IMAGES // EXTRACT_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_jpegs(tmp, EXTRACT_IMAGES, 11)

        def run(beam):
            return caption_images(cfg, paths, model, idx_to_word,
                                  extractor_params=params, beam_size=beam,
                                  batch_size=EXTRACT_BATCH,
                                  max_obj=cfg.data.max_obj, device=device)
        for beam in (None, 3):                  # set-up, not counted
            run(beam)
        launches = {"fused_attention": 0, "fused_stage": 0}
        for label, beam in (("greedy", None), ("beam3", 3)):
            fused_attention.launches = B.fused_stage.launches = 0
            caps = run(beam)
            got = {"fused_attention": fused_attention.launches,
                   "fused_stage": B.fused_stage.launches}
            for k in launches:
                launches[k] += got[k]
            print(f"caption {label}: launches over {n_batches} batches {got},"
                  f" want 3 and 4 per batch; first caption {caps[0]!r}",
                  flush=True)
            if device != "cpu" and got != {"fused_attention": 3 * n_batches,
                                           "fused_stage": 4 * n_batches}:
                raise AssertionError(f"caption {label} launched {got}")
            if len(caps) != EXTRACT_IMAGES or not all(
                    isinstance(c, str) for c in caps):
                raise AssertionError(f"caption {label}: an image got no "
                                     f"caption")
            runs = []
            for _ in range(3):
                t0 = time.perf_counter()
                run(beam)
                runs.append(time.perf_counter() - t0)
            s = statistics.median(runs)
            print(f"caption {label}: {EXTRACT_IMAGES} JPEGs in {s:.4f} s "
                  f"(median of 3: {', '.join(f'{r:.4f}' for r in runs)}), "
                  f"{EXTRACT_IMAGES / s:.2f} images/s end to end at batch "
                  f"{EXTRACT_BATCH} [{card}]", flush=True)
            if device != "cpu" and beam is None:
                profile_caption(lambda: run(None), s, card)
    return launches


def profile_caption(run, wall_s: float, card: str):
    """One greedy ``caption_images`` run under torch.profiler: the device's
    busy time against the run's median host-clock time without the
    profiler, and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    stats = device_kernels(prof)
    busy_ms = sum(e.self_device_time_total for e in stats) / 1e3
    if busy_ms <= 0:
        print("profile caption: the profiler saw no device time; device "
              "busy share not measured", flush=True)
        return
    print(f"profile caption greedy, {EXTRACT_IMAGES} JPEGs: {wall_s * 1e3:.2f}"
          f" ms on the host clock, device busy {busy_ms:.2f} ms, idle share "
          f"{1 - busy_ms / (wall_s * 1e3):.4f} [{card}]", flush=True)
    top = sorted(stats, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    for e in top:
        print(f"profile caption:   {e.self_device_time_total / 1e3:9.3f} ms  "
              f"x{e.count:<6d} {e.key[:90]}", flush=True)


def smoke_extractor(seed: int, device):
    """``init_extractor``'s random weights made to behave like trained ones.
    As initialised (the JAX package's init), YOLOv5x's activations shrink
    layer by layer until every cell scores the same 0.25, and ResNet-101's
    grow to 1e5.  So each YOLO conv's folded BN takes the mean and spread of
    its output over one batch of the smoke's canvases (what BatchNorm's
    running statistics hold), and each ResNet block's last BN scale is 0.2
    (trained nets keep the residual branch small)."""
    import torch
    import torch.nn.functional as F
    from image_caption_tpu_torch.vision import yolov5 as Y
    from image_caption_tpu_torch.vision.pipeline import init_extractor
    params = init_extractor(seed=seed, device=device)
    plain = Y._convbn

    def calibrate(p, x, stride=1):
        k = p["conv"].shape[-1]
        pad = k // 2 if k % 2 == 1 else k // 2 - 1
        y = F.conv2d(x, p["conv"], stride=stride, padding=pad)
        mean = y.mean(dim=(0, 2, 3))
        std = y.std(dim=(0, 2, 3)) + 1e-3
        p["bn"] = {"scale": 1.0 / std, "bias": -mean / std}
        return plain(p, x, stride)
    canvases = torch.from_numpy(letterboxed_canvases(8, 3)[0]).to(device)
    Y._convbn = calibrate
    try:
        with torch.no_grad():
            Y.yolov5_raw(params.yolo, canvases.float() / 255.0)
    finally:
        Y._convbn = plain
    for blocks in params.resnet["layers"]:
        for block in blocks:
            block["bn3"]["scale"] = block["bn3"]["scale"] * 0.2
    return params


def pick_margins(boxes, scores, classes, max_det: int, iou_thres=0.45,
                 conf_thres=0.01, pre_nms=512):
    """The greedy scan of ``nms_fixed`` for one image, returning at each
    step the picked score minus the runner-up's among the candidates still
    available: how close the pick came to going the other way."""
    import torch
    from image_caption_tpu_torch.models.decoding import topk_lowest_index
    from image_caption_tpu_torch.vision.nms import iou_matrix
    k = min(pre_nms, scores.shape[0])
    top, idx = topk_lowest_index(torch.where(scores > conf_thres, scores,
                                             torch.full_like(scores, -1.0)),
                                 k)
    span = boxes.max() - boxes.min() + 1.0
    shifted = boxes[idx] + classes[idx].float()[:, None] * span
    iou = iou_matrix(shifted, shifted)
    avail = top > conf_thres
    margins = []
    for _ in range(max_det):
        score_m = torch.where(avail, top, torch.full_like(top, -2.0))
        best = score_m.topk(2).values
        margins.append((best[0] - best[1]).item())
        i = int(torch.argmax(score_m))
        avail = avail & ~(iou[i] > iou_thres)
        avail[i] = False
    return margins


def first_difference(got, want):
    """Index of the first detection that differs (validity, class, or a box
    coordinate by more than 1e-3 px), or None."""
    for j in range(len(want.valid)):
        if (bool(got.valid[j]) != bool(want.valid[j])
                or int(got.classes[j]) != int(want.classes[j])
                or float((got.boxes[j] - want.boxes[j]).abs().max()) > 1e-3):
            return j
    return None


def check_extract_against_cpu(params, cfg, card: str, device="cuda",
                              roi: bool = False):
    """Two images at full width in float32: the card against the CPU, the
    same weights; crop mode on the kernel route (the CPU on the plain
    route), or with ``roi`` the shared-trunk mode at trunk ``ROI_TRUNK``,
    detecting at ``ROI_DETECT``.  Detections equal, except after a pick
    where the CPU's score margin (its pick's score against the nearest
    other candidate score of the image) is below 1e-4; features of slot 0
    (the whole image) and of every image whose detections agree within
    1e-3 x max|ref|.  Every pick's margin over the runner-up is printed."""
    import torch
    from image_caption_tpu_torch.vision import yolov5 as Y
    from image_caption_tpu_torch.vision.ops import resize
    from image_caption_tpu_torch.vision.pipeline import (
        _detect_and_select, extract_features_batch, extract_features_roi)
    m, d = cfg.model, cfg.data
    label = "cpu check roi" if roi else "cpu check extract"
    c, mt, sz = letterboxed_canvases(2, 7)
    cpu_params = params.to("cpu")
    kw = dict(num_objects=m.num_objects, max_obj=d.max_obj,
              compute_dtype=torch.float32)
    det_size = ROI_DETECT if roi else 640

    def extract(p, dev):
        if roi:
            return extract_features_roi(p, c, mt, sz, trunk_size=ROI_TRUNK,
                                        detect_size=ROI_DETECT, device=dev,
                                        **kw)
        return extract_features_batch(p, c, mt, sz, device=dev, **kw)

    def det_view(t):               # the detector's input, as the mode has it
        return t if det_size == 640 else resize(t, det_size, det_size)

    fg, pg, _ = (t.cpu() for t in extract(params, device))
    fc, pc, _ = extract(cpu_params, "cpu")
    sel = {}
    for dev, p in ((device, params), ("cpu", cpu_params)):
        t = [torch.as_tensor(a, device=dev).float() for a in (c, mt, sz)]
        s = _detect_and_select(p, det_view(t[0]), *t[1:],
                               num_objects=m.num_objects, cap_half=True,
                               max_obj=d.max_obj, num_classes=80,
                               compute_dtype=torch.float32,
                               det_scale=det_size / 640)
        sel[dev] = Y.Detections(*(a.cpu() for a in s.det))
    agree = []
    for i in range(2):
        got = Y.Detections(*(a[i] for a in sel[device]))
        want = Y.Detections(*(a[i] for a in sel["cpu"]))
        raw = Y.yolov5_raw(cpu_params.yolo, det_view(
            torch.from_numpy(c[i:i + 1]).float()) / 255.0)
        boxes, scores, classes = Y.decode_boxes_scores(cpu_params.yolo, raw)
        margins = pick_margins(boxes[0], scores[0], classes[0],
                               m.num_objects)
        n_valid = int(want.valid.sum())
        j = first_difference(got, want)
        agree.append(j is None)
        if j is None:
            print(f"{label}: image {i}: {n_valid} detections equal; "
                  f"smallest CPU margin over the runner-up "
                  f"{min(margins[:max(n_valid, 1)]):.3e}", flush=True)
            continue
        print(f"{label}: image {i} differs from detection {j}, CPU score "
              f"margin over the runner-up there {margins[j]:.3e}",
              flush=True)
        if not margins[j] < 1e-4:
            raise AssertionError(f"{label}: detections differ at image {i},"
                                 f" pick {j}, where the CPU's margin is "
                                 f"{margins[j]:.3e}")
    slots = [slice(None) if ok else slice(0, 1) for ok in agree]
    err = max((fg[i, s] - fc[i, s]).abs().max().item()
              for i, s in enumerate(slots))
    ref = max(fc[i, s].abs().max().item() for i, s in enumerate(slots))
    route = ("card vs CPU, no kernel on this path" if roi
             else "card kernel route vs CPU plain route")
    print(f"{label}: features {tuple(fc.shape)} float32, {route} "
          f"max_abs_err {err:.3e} (max|ref| {ref:.3e}, tol 1e-3 x max|ref|),"
          f" positions max_abs_err {(pg - pc).abs().max().item():.3e} "
          f"[{card}]", flush=True)
    if not err <= 1e-3 * ref:
        raise AssertionError(f"{label}: card and CPU features differ by "
                             f"{err:.3e}")


# ---------------------------------------------------------------------------
# Phases 19-21: the offline dataset build, roi mode and the demo
# ---------------------------------------------------------------------------

def write_coco_tree(root: str, seed: int = 13):
    """A COCO-layout tree: ``annotations/captions_{train,val}2017.json``
    with ``COCO_CAPTIONS`` captions an image drawn from ``LEXICON`` (with
    capitals and punctuation the ETL strips), and
    ``image/{train,val}2017/`` JPEGs of 300-640 px a side
    (``write_jpegs``); image ids out of file order."""
    rng = np.random.RandomState(seed)
    ann_id = 0
    for split, n in COCO_IMAGES.items():
        image_dir = os.path.join(root, "image", f"{split}2017")
        os.makedirs(image_dir)
        paths = write_jpegs(image_dir, n, seed + len(split))
        ids = rng.permutation(n) + (1 if split == "train" else 100000)
        images, anns = [], []
        for path, image_id in zip(paths, ids):
            images.append({"id": int(image_id),
                           "file_name": os.path.basename(path)})
            for _ in range(COCO_CAPTIONS):
                words = list(rng.choice(LEXICON, rng.randint(6, 14)))
                words[0] = words[0].capitalize()
                anns.append({"id": ann_id, "image_id": int(image_id),
                             "caption": " ".join(words) + "."})
                ann_id += 1
        os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
        with open(os.path.join(root, "annotations",
                               f"captions_{split}2017.json"), "w") as f:
            json.dump({"images": images, "annotations": anns}, f)


def run_features_verb(params, data_path: str, coco_root: str, fmt: str,
                      splits=None, device: str = "cuda",
                      preset: str = FLAGSHIP):
    """The ``features`` verb through ``main.main`` on the card with
    ``preset`` (the flagship's widths by default), extracting with
    ``params`` (passed to ``run_etl`` as ``extractor_params``).  Returns
    (its standard output, seconds, kernel #4 launches, kernel #3
    launches)."""
    import io
    from image_caption_tpu_torch import main as M
    from image_caption_tpu_torch.vision import bottleneck as B
    from image_caption_tpu_torch.vision import etl
    argv = ["--device", device, "--preset", preset, "--data-path",
            data_path, "features", "--coco-root", coco_root, "--batch-size",
            str(EXTRACT_BATCH), "--format", fmt]
    if splits:
        argv += ["--splits", *splits]
    plain = etl.run_etl
    out = io.StringIO()
    B.fused_stage.launches = B.fused_bottleneck.launches = 0
    etl.run_etl = lambda *a, **kw: plain(*a, extractor_params=params, **kw)
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            M.main(argv)
        synchronize(device)
        seconds = time.perf_counter() - t0
    finally:
        etl.run_etl = plain
    for line in out.getvalue().splitlines():
        print(f"features verb: {line}", flush=True)
    return (out.getvalue(), seconds, B.fused_stage.launches,
            B.fused_bottleneck.launches)


def feature_file(data_path: str, split: str, kind: str, fmt: str):
    path = os.path.join(data_path, split, f"{split}.{kind}.{fmt}")
    if fmt == "npy":
        return np.load(path)
    from image_caption_tpu_torch.utils.io import load_hkl
    return load_hkl(path)


def drive_features(params, cfg, card: str, workdir: str,
                   device: str = "cuda"):
    """``features`` on a synthetic COCO tree (96 train and 64 val JPEGs of
    300-640 px) at full width, bf16, batch 32, extracting with ``params``:
    the train split alone timed (images/s, exactly 4 launches of kernel #4
    a batch), again under the profiler after its files are removed (the
    device's idle share over the split), then every split (valid and test
    extracted, train skipped), then every split once more (all skipped, no
    launch).  The train split's feature rows must equal
    ``extract_features_batch`` on the loader's canvases in the same padded
    batches bit for bit.  Returns (data path, launches of the counted
    runs, the train JPEGs)."""
    import importlib.util
    from torch.profiler import ProfilerActivity, profile
    from image_caption_tpu_torch.utils.io import load_pickle
    from image_caption_tpu_torch.vision.loader import (
        load_letterboxed_batch, native_available)
    from image_caption_tpu_torch.vision.pipeline import extract_features_batch
    m, d = cfg.model, cfg.data
    coco_root = os.path.join(workdir, "coco")
    data_path = os.path.join(workdir, "data")
    t0 = time.perf_counter()
    write_coco_tree(coco_root)
    # the card's machine may lack h5py: .npy then, which load_split reads
    fmt = "hkl" if importlib.util.find_spec("h5py") else "npy"
    route = "native" if native_available() else "PIL"
    print(f"features: COCO tree of {COCO_IMAGES} JPEGs written in "
          f"{time.perf_counter() - t0:.1f} s; feature files .{fmt}; loader "
          f"route {route}", flush=True)
    n_train = COCO_IMAGES["train"]
    batches = {"train": -(-n_train // EXTRACT_BATCH)}
    half = COCO_IMAGES["val"] // 2
    batches["valid"] = -(-half // EXTRACT_BATCH)
    batches["test"] = -(-(COCO_IMAGES["val"] - half) // EXTRACT_BATCH)

    _, secs, stage, block = run_features_verb(params, data_path, coco_root,
                                              fmt, ["train"], device)
    launches = {"fused_stage": stage, "fused_bottleneck": block}
    print(f"features train: {n_train} JPEGs in {secs:.4f} s, "
          f"{n_train / secs:.2f} images/s end to end (captions, loading, "
          f"extraction, writing) at batch {EXTRACT_BATCH}, bf16, loader "
          f"{route}; launches {launches} over {batches['train']} batches, "
          f"want fused_stage 4 per batch [{card}]", flush=True)
    if device != "cpu" and launches != {"fused_stage": 4 * batches["train"],
                                        "fused_bottleneck": 0}:
        raise AssertionError(f"features launched {launches}")

    for kind in ("features", "positions"):
        os.remove(os.path.join(data_path, "train", f"train.{kind}.{fmt}"))
    with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
          if device != "cpu" else contextlib.nullcontext()) as prof:
        _, psecs, *_ = run_features_verb(params, data_path, coco_root, fmt,
                                         ["train"], device)
    busy_ms = sum(e.self_device_time_total
                  for e in device_kernels(prof)) / 1e3 if prof else 0.0
    if busy_ms > 0:
        print(f"profile features train: {secs * 1e3:.2f} ms on the host "
              f"clock without the profiler ({psecs * 1e3:.2f} ms with it), "
              f"device busy {busy_ms:.2f} ms, idle share "
              f"{1 - busy_ms / (secs * 1e3):.4f} [{card}]", flush=True)
    else:
        print("profile features train: the profiler saw no device time; "
              "device busy share not measured", flush=True)

    out, _, stage, block = run_features_verb(params, data_path, coco_root,
                                             fmt, device=device)
    want = 4 * (batches["valid"] + batches["test"])
    launches["fused_stage"] += stage
    launches["fused_bottleneck"] += block
    if out.count("fingerprint matches — skipping") != 1 or (
            device != "cpu" and (stage, block) != (want, 0)):
        raise AssertionError(f"features over every split launched "
                             f"{stage} + {block}, want {want} (train "
                             f"skipped)")
    for split in ("train", "valid", "test"):
        n = len(load_pickle(os.path.join(data_path, split,
                                         f"{split}.file.names.pkl")))
        shapes = [feature_file(data_path, split, kind, fmt).shape
                  for kind in ("features", "positions")]
        print(f"features {split}: {n} images, features {shapes[0]}, "
              f"positions {shapes[1]}", flush=True)
        if shapes != [(n, m.num_slots, 2048), (n, m.num_slots, 84)]:
            raise AssertionError(f"features {split}: shapes {shapes}")

    out, _, stage, block = run_features_verb(params, data_path, coco_root,
                                             fmt, device=device)
    skips = out.count("fingerprint matches — skipping")
    print(f"features rerun: {skips} splits skipped on their fingerprint, "
          f"launches {stage} + {block}, want 3 and 0", flush=True)
    if skips != 3 or stage or block:
        raise AssertionError("a rerun of features extracted again")

    paths = list(load_pickle(os.path.join(data_path, "train",
                                          "train.file.names.pkl")))
    # the loader alone, as the ETL's stream calls it (8 decode threads)
    with ThreadPoolExecutor(8) as pool:
        t0 = time.perf_counter()
        canvases, metas, sizes = load_letterboxed_batch(
            paths, 640, nthreads=8, io_pool=pool)
        secs = time.perf_counter() - t0
    print(f"features loader: {len(paths)} JPEGs decoded and letterboxed in "
          f"{secs:.4f} s, {len(paths) / secs:.2f} images/s on 8 threads, "
          f"route {route}", flush=True)
    want_f = feature_file(data_path, "train", "features", fmt)
    want_p = feature_file(data_path, "train", "positions", fmt)
    for (parts, real), start in zip(
            padded_batches(canvases, metas, sizes, EXTRACT_BATCH),
            range(0, len(paths), EXTRACT_BATCH)):
        f, p, _ = extract_features_batch(params, *parts,
                                         num_objects=m.num_objects,
                                         max_obj=d.max_obj, device=device)
        rows = slice(start, start + real)
        if not (np.array_equal(f[:real].cpu().numpy(), want_f[rows])
                and np.array_equal(p[:real, :, :84].cpu().numpy(),
                                   want_p[rows])):
            raise AssertionError(f"features train rows {rows} differ from "
                                 "extract_features_batch")
    print(f"features: the train split's {len(paths)} rows equal "
          f"extract_features_batch on the same canvases and batches bit "
          f"for bit", flush=True)
    return data_path, launches, paths


def drive_roi(params, cfg, card: str, device: str = "cuda"):
    """``extract_features_roi`` at full width (YOLOv5x detecting at
    ``ROI_DETECT``, ResNet-101's trunk at ``ROI_TRUNK``), bf16, on phase
    16's 70 canvases in batches of 32: images/s (median of 3 passes), one
    batch under the profiler, then the card against the CPU in float32.
    No kernel runs on this path; returns its launches of kernel #4."""
    import torch
    from image_caption_tpu_torch.vision import bottleneck as B
    from image_caption_tpu_torch.vision.pipeline import extract_features_roi
    m, d = cfg.model, cfg.data
    batches = padded_batches(*letterboxed_canvases(EXTRACT_IMAGES, 7),
                             EXTRACT_BATCH)
    kw = dict(num_objects=m.num_objects, max_obj=d.max_obj,
              trunk_size=ROI_TRUNK, detect_size=ROI_DETECT, device=device)

    def run_pass():
        outs = [extract_features_roi(params, *parts, **kw)[0][:real]
                for parts, real in batches]
        synchronize(device)
        return torch.cat(outs)
    run_pass()                                 # set-up, not counted
    B.fused_stage.launches = B.fused_bottleneck.launches = 0
    feats = run_pass()
    launches = B.fused_stage.launches + B.fused_bottleneck.launches
    if launches or not bool(torch.isfinite(feats).all()) or \
            feats.shape != (EXTRACT_IMAGES, m.num_slots, 2048):
        raise AssertionError(f"roi: {launches} kernel launches, features "
                             f"{tuple(feats.shape)}")
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        run_pass()
        runs.append(time.perf_counter() - t0)
    sec = statistics.median(runs)
    print(f"roi: {EXTRACT_IMAGES} images in {sec:.4f} s (median of 3: "
          f"{', '.join(f'{r:.4f}' for r in runs)}), "
          f"{EXTRACT_IMAGES / sec:.2f} images/s at batch {EXTRACT_BATCH}, "
          f"trunk {ROI_TRUNK}, detect {ROI_DETECT}, bf16 [{card}]",
          flush=True)
    if device != "cpu":
        profile_extract(lambda: extract_features_roi(
            params, *batches[0][0], **kw), card, "roi")
    check_extract_against_cpu(params, cfg, card, device, roi=True)
    return launches


def encoder_launches(m) -> int:
    """Kernel #1's launches in one decode call: the encoder's blocks, and
    the pair block where image and objects are encoded apart."""
    return m.encode_num_blocks + int(m.split_image_objects)


def drive_demo(params, cfg, card: str, data_path: str, image: str,
               workdir: str, device: str = "cuda", preset: str = FLAGSHIP):
    """The ``demo`` verb through ``main.main`` on the card, greedy with
    ``--save-img`` and then with ``--beam-size 3``, on one of phase 19's
    JPEGs: ``preset``'s captioner (``cfg``; the flagship's by default) at
    full width with random weights from seed 0 (its vocabulary the size of
    the ``word_index.pkl`` under ``data_path``), saved through the port's
    checkpoint manager, and ``params`` as the extractor of
    ``cfg.data.image_model``.  Each run: its caption line, the overlay
    files, the encoder's launches of kernel #1 (one decode call: 3 for the
    flagship) and 4 of kernel #4 (one extraction).  Returns the launches
    of both runs."""
    import io
    from image_caption_tpu_torch import main as M
    from image_caption_tpu_torch.ops.attention import fused_attention
    from image_caption_tpu_torch.train.checkpoint import CheckpointManager
    from image_caption_tpu_torch.train.state import create_train_state
    from image_caption_tpu_torch.utils.io import load_pickle
    from image_caption_tpu_torch.vision import bottleneck as B
    from image_caption_tpu_torch.vision import pipeline as P
    vocab = len(load_pickle(os.path.join(data_path, "train",
                                         "word_index.pkl")))
    over = ["--set", f"model.num_vocab={vocab}"]
    demo_cfg = cfg.with_overrides(**{"model.num_vocab": vocab})
    out_path = os.path.join(workdir, "out")
    state = create_train_state(demo_cfg, device=device, seed=0)
    CheckpointManager(os.path.join(out_path, "model")).save(1, state)
    weights = os.path.join(workdir, "weights")
    image_model = cfg.data.image_model
    key = (weights, device) + (() if image_model == "YOLOv5"
                               else (image_model,))
    P._EXTRACTORS[key] = params                   # the calibrated weights
    stem = os.path.splitext(os.path.basename(image))[0]
    want_launches = {"fused_attention": encoder_launches(cfg.model),
                     "fused_stage": 4}
    phase = "demo" if image_model == "YOLOv5" else "frcnn demo"
    launches = {"fused_attention": 0, "fused_stage": 0}
    cwd = os.getcwd()
    os.chdir(workdir)                 # the overlays go under ./demo/
    try:
        for label, extra in (("greedy", []), ("beam3", ["--beam-size",
                                                          "3"])):
            fused_attention.launches = B.fused_stage.launches = 0
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                M.main(["--device", device, "--preset", preset, *over,
                        "--data-path", data_path, "--output-path",
                        out_path, "demo", "--image-path", image,
                        "--save-img", "--weights-dir", weights, *extra])
            secs = time.perf_counter() - t0
            got = {"fused_attention": fused_attention.launches,
                   "fused_stage": B.fused_stage.launches}
            files = sorted(os.listdir(os.path.join("demo", stem,
                                                   image_model)))
            caption = buf.getvalue().splitlines()[0]
            print(f"{phase} {label}: {caption!r} in {secs:.2f} s; launches "
                  f"{got}, want {want_launches}; overlays {len(files)} "
                  f"files [{card}]", flush=True)
            if device != "cpu" and got != want_launches:
                raise AssertionError(f"{phase} {label} launched {got}")
            want = {f"det_{stem}.jpg", f"labels_{stem}.txt"}
            if not want <= set(files) or (label == "greedy" and not any(
                    f.startswith("0_") for f in files)) or not caption:
                raise AssertionError(f"{phase} {label}: caption "
                                     f"{caption!r}, overlays {files}")
            for k in launches:
                launches[k] += got[k]
    finally:
        os.chdir(cwd)
        P._EXTRACTORS.clear()
    return launches


# ---------------------------------------------------------------------------
# Phases 22-26: Faster R-CNN (ResNet-50-FPN) extraction in float32
# ---------------------------------------------------------------------------

def smoke_frcnn_extractor(seed: int, device):
    """``init_frcnn_extractor``'s random weights made to behave like trained
    ones: each ResNet block's last BN scale is 0.2 in both ResNets (as in
    ``smoke_extractor``), and four heads are scaled by their outputs over
    one batch of 8 of the smoke's canvases: the RPN's objectness logits to
    std 1 (as initialised they reach the hundreds and the sigmoid rounds
    most of them to exactly 1.0, ties the index alone breaks), the box
    deltas of the RPN to std 0.3 and of the box head to std 1 (deltas of
    tens clip every box to the canvas), and the classifier's logits to std
    2 (as initialised every class scores about 1/91, under the 0.05
    threshold, and nothing is detected)."""
    import torch
    from image_caption_tpu_torch.vision import frcnn as FR
    from image_caption_tpu_torch.vision.pipeline import (
        _cudnn_f32, init_frcnn_extractor)
    from image_caption_tpu_torch.vision.resnet import (
        IMAGENET_MEAN, IMAGENET_STD, resnet_feature_maps)
    params = init_frcnn_extractor(seed=seed, device=device)
    for net in (params.frcnn["backbone"], params.resnet):
        for blocks in net["layers"]:
            for block in blocks:
                block["bn3"]["scale"] = block["bn3"]["scale"] * 0.2
    canvases = torch.from_numpy(letterboxed_canvases(
        8, 3, FRCNN_CANVAS)[0]).to(device).float()
    mean = torch.from_numpy(IMAGENET_MEAN).to(device)
    std = torch.from_numpy(IMAGENET_STD).to(device)
    p = params.frcnn

    def scale(head, out, target):
        k = target / float(out.std())
        head["weight"] = head["weight"] * k
        head["bias"] = head["bias"] * k
    with torch.no_grad(), _cudnn_f32():
        pm = FR.fpn_apply(p["fpn"], resnet_feature_maps(
            p["backbone"], (canvases / 255.0 - mean) / std))
        t = [torch.relu(FR._convb(p["rpn"]["conv"], m)) for m in pm]
        for head, target in (("cls", 1.0), ("bbox", 0.3)):
            scale(p["rpn"][head], torch.cat(
                [FR._convb(p["rpn"][head], u).flatten() for u in t]), target)
        props = FR.rpn_proposals(p["rpn"], pm, FRCNN_CANVAS)
        logits, deltas = FR.box_head_apply(p["box_head"],
                                           FR.roi_align(pm, props))
        scale(p["box_head"]["cls_score"], logits, 2.0)
        scale(p["box_head"]["bbox_pred"], deltas, 1.0)
    return params


def valid_slots(poss) -> list:
    """Valid detection slots per image of position rows [B, S, P]."""
    return (poss[:, 1:, 4:].amax(dim=-1) > 0).sum(dim=1).tolist()


def drive_frcnn_extract(params, cfg, card: str, device="cuda"):
    """``extract_features_frcnn`` at full width (ResNet-50-FPN at 800, 256
    proposals, 36 detections, ResNet-101 on 37 crops of 224 px an image)
    in float32, 70 letterboxed canvases in batches of 32, the last ragged:
    images/s on both ResNet routes (kernel #4's float32 route, cuDNN
    float32), exactly 4 launches of kernel #4 a batch, the routes'
    detections equal and features within ``FRCNN_ROUTE_TOL`` x max|ref|,
    valid slots per image (a run where no image detects anything fails),
    peak device memory over one batch and that batch under the profiler.
    Returns the launches of one pass of the kernel route."""
    import torch
    from image_caption_tpu_torch.vision import bottleneck as B
    from image_caption_tpu_torch.vision.pipeline import extract_features_frcnn
    m = cfg.model
    batches = padded_batches(*letterboxed_canvases(EXTRACT_IMAGES, 17,
                                                   FRCNN_CANVAS),
                             EXTRACT_BATCH)

    def run_pass(kernel):
        outs = []
        with (contextlib.nullcontext() if kernel
              else cudnn_identity_runs()):
            for parts, real in batches:
                f, p, bx = extract_features_frcnn(
                    params, *parts, num_objects=m.num_objects,
                    device=device)
                outs.append((f[:real], p[:real], bx[:real]))
        synchronize(device)
        return [torch.cat(t) for t in zip(*outs)]

    for kernel in (True, False):               # set-up, not counted
        run_pass(kernel)
    B.fused_stage.launches = B.fused_bottleneck.launches = 0
    results = {True: run_pass(True)}
    launches = {"fused_stage": B.fused_stage.launches,
                "fused_bottleneck": B.fused_bottleneck.launches}
    results[False] = run_pass(False)
    print(f"frcnn extract: launches over {len(batches)} batches {launches}, "
          f"want fused_stage 4 per batch and fused_bottleneck 0", flush=True)
    if device != "cpu" and launches != {"fused_stage": 4 * len(batches),
                                        "fused_bottleneck": 0}:
        raise AssertionError(f"frcnn extract launched {launches}")
    seconds = {True: [], False: []}
    for kernel in (True, False, False, True):
        t0 = time.perf_counter()
        run_pass(kernel)
        seconds[kernel].append(time.perf_counter() - t0)
    rates = {}
    for kernel, label in ((True, "kernel #4 f32"), (False, "cuDNN f32")):
        s = statistics.median(seconds[kernel])
        rates[label] = EXTRACT_IMAGES / s
        print(f"frcnn extract {label} route: {EXTRACT_IMAGES} images in "
              f"{s:.4f} s (median of 2: "
              f"{', '.join(f'{x:.4f}' for x in seconds[kernel])}), "
              f"{rates[label]:.2f} images/s at batch {EXTRACT_BATCH}, "
              f"float32 [{card}]", flush=True)

    (fk, pk, bk), (fp, pp, bp) = results[True], results[False]
    slots = valid_slots(pk)
    same_det = torch.equal(pk, pp) and torch.equal(bk, bp)
    err = (fk - fp).abs().max().item()
    ref = fp.abs().max().item()
    print(f"frcnn extract: features {tuple(fk.shape)}, positions "
          f"{tuple(pk.shape)}; valid slots per image (of {m.num_objects}) "
          f"{slots}; kernel route vs cuDNN route max_abs_err {err:.3e} "
          f"(max|ref| {ref:.3e}, tol {FRCNN_ROUTE_TOL:g} x max|ref|); "
          f"detections and positions equal: {same_det}", flush=True)
    if not any(slots):
        raise AssertionError("frcnn extract: no image detected anything")
    if not (same_det and err <= FRCNN_ROUTE_TOL * ref
            and bool(torch.isfinite(fk).all())):
        raise AssertionError("frcnn extract: the two ResNet routes disagree")
    if device != "cpu":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        extract_features_frcnn(params, *batches[0][0],
                               num_objects=m.num_objects)
        synchronize(device)
        print(f"frcnn extract: peak device memory over one batch of "
              f"{EXTRACT_BATCH}: {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB allocated [{card}]", flush=True)
        profile_extract(lambda: extract_features_frcnn(
            params, *batches[0][0], num_objects=m.num_objects), card,
            "frcnn extract")
    return launches


def level_cut_gaps(p_rpn, pmaps, k: int = 200):
    """Per image, the smallest gap over the levels between the k-th and the
    (k+1)-th objectness logit: how close the per-level top-k came to
    taking another anchor."""
    import torch
    from image_caption_tpu_torch.vision import frcnn as FR
    gaps = []
    for fm in pmaps:
        t = torch.relu(FR._convb(p_rpn["conv"], fm))
        lg = FR._convb(p_rpn["cls"], t).reshape(fm.shape[0], -1)
        if lg.shape[1] > k:
            s = torch.sort(lg, dim=1, descending=True).values
            gaps.append(s[:, k - 1] - s[:, k])
    return torch.stack(gaps).amin(dim=0).tolist()


def check_frcnn_against_cpu(params, cfg, card: str, device="cuda"):
    """Two images at full width in float32: the card (kernel route) against
    the CPU (plain route), the same weights.  Per image the detector's
    stages are compared as a pick sequence: the proposals, which may differ
    first at an RPN pick whose CPU margin (``pick_margins``, IoU 0.7) or
    per-level top-k gap is below 1e-4, then the detections, which may
    differ first at a pick whose CPU margin is below 1e-4.  Where both
    agree, features within 1e-3 x max|ref| and positions within 1e-5;
    otherwise slot 0 (the whole image) only."""
    import torch
    from image_caption_tpu_torch.vision import frcnn as FR
    from image_caption_tpu_torch.vision.nms import Detections, nms_fixed
    from image_caption_tpu_torch.vision.pipeline import (
        _cudnn_f32, extract_features_frcnn)
    from image_caption_tpu_torch.vision.resnet import (
        IMAGENET_MEAN, IMAGENET_STD, resnet_feature_maps)
    m = cfg.model
    c, mt, sz = letterboxed_canvases(2, 7, FRCNN_CANVAS)
    cpu_params = params.to("cpu")
    fg, pg, _ = (t.cpu() for t in extract_features_frcnn(
        params, c, mt, sz, num_objects=m.num_objects, device=device))
    fc, pc, _ = extract_features_frcnn(cpu_params, c, mt, sz,
                                       num_objects=m.num_objects,
                                       device="cpu")
    st = {}
    for dev, p in ((device, params.frcnn), ("cpu", cpu_params.frcnn)):
        mean = torch.from_numpy(IMAGENET_MEAN).to(dev)
        std = torch.from_numpy(IMAGENET_STD).to(dev)
        x = (torch.from_numpy(c).to(dev).float() / 255.0 - mean) / std
        with torch.no_grad(), _cudnn_f32():
            pm = FR.fpn_apply(p["fpn"], resnet_feature_maps(p["backbone"], x))
            props = FR.rpn_proposals(p["rpn"], pm, FRCNN_CANVAS)
            cand = FR.detection_candidates(p, pm, props, FRCNN_CANVAS)
            det = nms_fixed(*cand, iou_thres=0.5, conf_thres=0.05,
                            max_det=m.num_objects, pre_nms=1024)
            st[dev] = {"props": props.cpu(), "cand": [t.cpu() for t in cand],
                       "det": [t.cpu() for t in det]}
            if dev == "cpu":
                st[dev]["rpn"] = FR.rpn_candidates(p["rpn"], pm, FRCNN_CANVAS)
                st[dev]["gaps"] = level_cut_gaps(p["rpn"], pm)
    agree = []
    for i in range(2):
        rb, rs = (t[i] for t in st["cpu"]["rpn"])
        gp, cp = st[device]["props"][i], st["cpu"]["props"][i]
        differ = ((gp - cp).abs().amax(dim=1) > 1e-2).nonzero().flatten()
        if len(differ):
            j = int(differ[0])
            margins = pick_margins(rb, rs, torch.zeros_like(
                rs, dtype=torch.int32), len(cp), iou_thres=0.7,
                conf_thres=0.0, pre_nms=len(rs))
            gap = st["cpu"]["gaps"][i]
            print(f"frcnn check: image {i}: proposals differ from pick {j},"
                  f" CPU margin there {margins[j]:.3e}, smallest level "
                  f"top-k gap {gap:.3e}", flush=True)
            if not min(margins[j], gap) < 1e-4:
                raise AssertionError(f"frcnn check: proposals differ at "
                                     f"image {i}, pick {j}")
            agree.append(False)
            continue
        cb, cs, cl = (t[i] for t in st["cpu"]["cand"])
        margins = pick_margins(cb, cs, cl, m.num_objects, iou_thres=0.5,
                               conf_thres=0.05, pre_nms=1024)
        got = Detections(*(t[i] for t in st[device]["det"]))
        want = Detections(*(t[i] for t in st["cpu"]["det"]))
        n_valid = int(want.valid.sum())
        j = first_difference(got, want)
        agree.append(j is None)
        if j is None:
            print(f"frcnn check: image {i}: {len(cp)} proposals and "
                  f"{n_valid} detections equal; smallest CPU margin over "
                  f"the runner-up {min(margins[:max(n_valid, 1)]):.3e}",
                  flush=True)
            continue
        print(f"frcnn check: image {i} differs from detection {j}, CPU "
              f"score margin over the runner-up there {margins[j]:.3e}",
              flush=True)
        if not margins[j] < 1e-4:
            raise AssertionError(f"frcnn check: detections differ at image "
                                 f"{i}, pick {j}, where the CPU's margin is "
                                 f"{margins[j]:.3e}")
    slots = [slice(None) if ok else slice(0, 1) for ok in agree]
    err = max((fg[i, s] - fc[i, s]).abs().max().item()
              for i, s in enumerate(slots))
    ref = max(fc[i, s].abs().max().item() for i, s in enumerate(slots))
    perr = max((pg[i, s] - pc[i, s]).abs().max().item()
               for i, s in enumerate(slots))
    print(f"frcnn check: features {tuple(fc.shape)} float32, card kernel "
          f"route vs CPU plain route max_abs_err {err:.3e} (max|ref| "
          f"{ref:.3e}, tol 1e-3 x max|ref|), positions max_abs_err "
          f"{perr:.3e} (tol 1e-5); images compared in full: {agree} "
          f"[{card}]", flush=True)
    if not (err <= 1e-3 * ref and perr <= 1e-5):
        raise AssertionError(f"frcnn check: card and CPU differ: features "
                             f"{err:.3e}, positions {perr:.3e}")


def drive_frcnn_caption(params, cfg, card: str, device="cuda"):
    """``caption_images`` on 70 JPEGs with the FRCNN preset's captioner at
    full width (random weights, seed 0), greedy and beam 3, batch 32: the
    launches of kernels #1 (the encoder's, a batch) and #4 (4 a batch) and
    images/s end to end.  Returns the launches of both runs."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.ops.attention import fused_attention
    from image_caption_tpu_torch.serve import caption_images
    from image_caption_tpu_torch.vision import bottleneck as B
    m = cfg.model
    model = Captioner(m, device=device,
                      generator=torch.Generator().manual_seed(0))
    idx_to_word = vocabulary(m.num_vocab)
    n_batches = -(-EXTRACT_IMAGES // EXTRACT_BATCH)
    want = {"fused_attention": encoder_launches(m) * n_batches,
            "fused_stage": 4 * n_batches}
    launches = {"fused_attention": 0, "fused_stage": 0}
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_jpegs(tmp, EXTRACT_IMAGES, 19)
        for label, beam in (("greedy", None), ("beam3", 3)):
            fused_attention.launches = B.fused_stage.launches = 0
            t0 = time.perf_counter()
            caps = caption_images(cfg, paths, model, idx_to_word,
                                  extractor_params=params, beam_size=beam,
                                  batch_size=EXTRACT_BATCH, device=device)
            s = time.perf_counter() - t0
            got = {"fused_attention": fused_attention.launches,
                   "fused_stage": B.fused_stage.launches}
            for k in launches:
                launches[k] += got[k]
            print(f"frcnn caption {label}: {EXTRACT_IMAGES} JPEGs in "
                  f"{s:.4f} s, {EXTRACT_IMAGES / s:.2f} images/s end to end "
                  f"at batch {EXTRACT_BATCH}; launches {got}, want {want}; "
                  f"first caption {caps[0]!r} [{card}]", flush=True)
            if device != "cpu" and got != want:
                raise AssertionError(f"frcnn caption {label} launched {got}")
            if len(caps) != EXTRACT_IMAGES or not all(
                    isinstance(c, str) for c in caps):
                raise AssertionError(f"frcnn caption {label}: an image got "
                                     f"no caption")
    return launches


def drive_frcnn_features(params, cfg, card: str, workdir: str,
                         device: str = "cuda"):
    """The ``features`` verb with the FRCNN preset on phase 19's COCO tree
    (under ``workdir``) into its own data path, every split, batch 32,
    float32: images/s end to end, 4 launches of kernel #4 a batch, the
    artifacts [N, 37, 2048] and [N, 37, 95], then a rerun that skips every
    split on its fingerprint and launches nothing.  Returns (data path,
    launches of the first run)."""
    import importlib.util
    from image_caption_tpu_torch.utils.io import load_pickle
    m = cfg.model
    coco_root = os.path.join(workdir, "coco")
    data_path = os.path.join(workdir, "frcnn_data")
    fmt = "hkl" if importlib.util.find_spec("h5py") else "npy"
    n_val = COCO_IMAGES["val"] // 2
    n_batches = (-(-COCO_IMAGES["train"] // EXTRACT_BATCH)
                 + -(-n_val // EXTRACT_BATCH)
                 + -(-(COCO_IMAGES["val"] - n_val) // EXTRACT_BATCH))
    _, secs, stage, block = run_features_verb(
        params, data_path, coco_root, fmt, device=device,
        preset=FRCNN_PRESET)
    n = sum(COCO_IMAGES.values())
    launches = {"fused_stage": stage, "fused_bottleneck": block}
    print(f"frcnn features: {n} JPEGs over three splits in {secs:.4f} s, "
          f"{n / secs:.2f} images/s end to end at batch {EXTRACT_BATCH}, "
          f"float32; launches {launches}, want fused_stage 4 per batch over "
          f"{n_batches} batches [{card}]", flush=True)
    if device != "cpu" and launches != {"fused_stage": 4 * n_batches,
                                        "fused_bottleneck": 0}:
        raise AssertionError(f"frcnn features launched {launches}")
    for split in ("train", "valid", "test"):
        rows = len(load_pickle(os.path.join(data_path, split,
                                            f"{split}.file.names.pkl")))
        shapes = [feature_file(data_path, split, kind, fmt).shape
                  for kind in ("features", "positions")]
        print(f"frcnn features {split}: {rows} images, features "
              f"{shapes[0]}, positions {shapes[1]}", flush=True)
        if shapes != [(rows, m.num_slots, 2048), (rows, m.num_slots, 95)]:
            raise AssertionError(f"frcnn features {split}: shapes {shapes}")
    out, _, stage, block = run_features_verb(
        params, data_path, coco_root, fmt, device=device,
        preset=FRCNN_PRESET)
    skips = out.count("fingerprint matches — skipping")
    print(f"frcnn features rerun: {skips} splits skipped on their "
          f"fingerprint, launches {stage} + {block}, want 3 and 0",
          flush=True)
    if skips != 3 or stage or block:
        raise AssertionError("a rerun of frcnn features extracted again")
    return data_path, launches


def check_stage_f32_frcnn(card: str):
    """Kernel #4's float32 route at the FRCNN batch's N = 32 x 37 = 1184
    crops, each ResNet-101 identity run: against ``stage_reference``
    (1e-4 x max|ref|), then its device time beside its bound, the plain
    version and the cuDNN float32 sequence (CUDA-graph replay, one call a
    graph, 1 warm-up and 3 timed replays; the call time by events around
    one call, median of 3), with the design's scratch traffic beside it.
    Returns (the largest error, rows keyed ``<run>_float32_n1184``)."""
    import torch
    from image_caption_tpu_torch.vision import bottleneck as B
    from image_caption_tpu_torch.vision.resnet import _bottleneck
    worst, rows = 0.0, {}
    timing = dict(warmup=1, reps=3)
    for k, run in enumerate(RESNET101_RUNS):
        ws = bottleneck_weights(run, 100 + k, "cuda")
        x = bottleneck_input(run, FRCNN_CROPS, 400 + k, "cuda", torch.float32)
        got, want = B.fused_stage(x, *ws), B.stage_reference(x, *ws)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        ref = want.abs().max().item()
        worst = max(worst, err)
        print(f"kernel check bottleneck fused_stage {run[0]} N={FRCNN_CROPS} "
              f"blocks={run[4]} float32: max_abs_err {err:.3e} (max|ref| "
              f"{ref:.3e}, rel {err / ref:.3e}, tol 1e-4 x max|ref|)",
              flush=True)
        if not (err <= BOTTLENECK_TOL["float32"] * ref
                and bool(torch.isfinite(got).all())):
            raise AssertionError(f"fused_stage disagrees at {run[0]} "
                                 f"N={FRCNN_CROPS} float32")
        del got, want
        blocks = [{"conv1": ws[0][i][:, :, None, None],
                   "bn1": {"scale": ws[1][i, 0], "bias": ws[1][i, 1]},
                   "conv2": ws[2][i],
                   "bn2": {"scale": ws[3][i, 0], "bias": ws[3][i, 1]},
                   "conv3": ws[4][i][:, :, None, None],
                   "bn3": {"scale": ws[5][i, 0], "bias": ws[5][i, 1]}}
                  for i in range(run[4])]

        def cudnn():
            y = x
            for blk in blocks:
                y = _bottleneck(blk, y, 1)
            return y
        row = {"shape": [FRCNN_CROPS, run[2], run[1], run[1], run[3],
                         run[4]],
               "dtype": "float32",
               "ms": device_ms(lambda: B.fused_stage(x, *ws), per_graph=1,
                               **timing),
               "call_ms": call_ms(lambda: B.fused_stage(x, *ws), **timing),
               "plain_ms": device_ms(lambda: B.stage_reference(x, *ws),
                                     per_graph=1, **timing),
               "cudnn_ms": device_ms(cudnn, per_graph=1, **timing),
               "library_ms": None}
        (row["bound_ms"], row["bound_by"], row["bytes"],
         row["flops"]) = bottleneck_bound(run, FRCNN_CROPS, run[4], 4)
        row["scratch_bytes"] = scratch_bytes(run, FRCNN_CROPS, run[4], 4)
        row["tflops"] = row["flops"] / row["ms"] / 1e9
        row["x_bound"] = row["ms"] / row["bound_ms"]
        rows[f"{run[0]}_float32_n{FRCNN_CROPS}"] = row
        print(f"time fused_stage {run[0]} (N, C, H, W, Wd, blocks)="
              f"{tuple(row['shape'])} float32: kernel {row['ms']:.4f} ms on "
              f"the device ({row['call_ms']:.4f} ms a call), "
              f"{row['tflops']:.1f} TFLOP/s, bound "
              f"{row['bound_ms']:.4f} ms ({row['bound_by']}; float32 as "
              f"{TF32_PASSES} TF32 passes), {row['x_bound']:.2f}x the bound, "
              f"scratch {row['scratch_bytes'] / 1e9:.2f} GB "
              f"({1e3 * row['scratch_bytes'] / PEAK_BYTES_PER_S:.2f} ms at "
              f"HBM rate), plain {row['plain_ms']:.4f} "
              f"ms, cuDNN {row['cudnn_ms']:.4f} ms, kernel/cuDNN "
              f"{row['ms'] / row['cudnn_ms']:.2f}x [{card}]", flush=True)
        del x
        torch.cuda.empty_cache()
    return worst, rows


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Phases 27-30: data parallelism over torch.distributed, train --profile
# ---------------------------------------------------------------------------

DP_STEPS = 3
DP_WORLD = 2
# the bars of PERF.md §2: losses, gradients (norm-relative per tensor), and
# the top-2 margin under which a sampled or decoded token may flip
LOSS_TOL, GRAD_TOL, MARGIN = 2e-4, 1e-4, 1e-4


def join_group(tmp: str, world: int, rank: int, backend: str):
    """This process as rank ``rank`` of ``world`` through a rendezvous
    file under ``tmp``."""
    from image_caption_tpu_torch.parallel import distributed
    distributed.initialize("file://" + os.path.join(tmp, "rendezvous"),
                           world, rank, backend=backend, timeout=600)


def launch_counts():
    from image_caption_tpu_torch.ops.attention import (fused_attention,
                                                       fused_attention_bwd)
    return {"fused_attention": fused_attention.launches,
            "fused_attention_bwd": fused_attention_bwd.launches}


def zero_launch_counts():
    from image_caption_tpu_torch.ops.attention import (fused_attention,
                                                       fused_attention_bwd)
    from image_caption_tpu_torch.vision import bottleneck as B
    fused_attention.launches = fused_attention_bwd.launches = 0
    B.fused_stage.launches = B.fused_bottleneck.launches = 0


def params_digest(model) -> str:
    """sha1 of every parameter's bytes in the full layout (gathered from
    the shards under tensor parallelism, a collective then), in order:
    equal digests are bitwise-equal weights."""
    import hashlib
    from image_caption_tpu_torch.parallel.tensor import full_state_dict
    h = hashlib.sha1()
    for p in full_state_dict(model).values():
        h.update(p.detach().float().cpu().numpy().tobytes())
    return h.hexdigest()


def norm_rel(got, want) -> float:
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


# world 1's overhead: DP and plain steps timed in alternating blocks (the
# order flipped every round, so a drift of the host's speed cancels), the
# median of the rounds' time ratios
DP_BLOCK_STEPS, DP_ROUNDS = 10, 10


def drive_dp_world1(cfg, card: str, device: str = "cuda"):
    """An NCCL group of one rank in this process (gloo on the CPU): 20
    data-parallel ``Trainer`` steps on one batch against 20 steps of a
    plain ``Trainer`` from the same weights and dropout stream, before and
    after it; then both trainers' steps in alternating blocks for the DP
    overhead.  Returns the DP run's kernel launches, the steps/s of both
    and the median overhead, and the gradient all-reduce's ms at the
    model's parameter bytes."""
    import torch
    from image_caption_tpu_torch.parallel import distributed
    from image_caption_tpu_torch.parallel.mesh import (all_reduce_grads,
                                                       make_mesh)
    from image_caption_tpu_torch.train.loop import Trainer
    batch = train_batch(cfg.model, cfg.train.batch_size, seed=2)

    def run(trainer):
        losses = [trainer.train_step(*batch)["loss"]
                  for _ in range(TRAIN_STEPS)]
        weights = {k: v.detach().clone()
                   for k, v in trainer.state.model.state_dict().items()}
        return losses, weights

    def block(trainer) -> float:
        synchronize(device)
        t0 = time.perf_counter()
        for _ in range(DP_BLOCK_STEPS):
            trainer.train_step(*batch)
        synchronize(device)
        return time.perf_counter() - t0

    plain_trainer = Trainer(cfg, device=device, seed=0)
    plain_a = run(plain_trainer)
    with tempfile.TemporaryDirectory() as tmp:
        join_group(tmp, 1, 0, "gloo" if device == "cpu" else "nccl")
        try:
            mesh = make_mesh([device] if device == "cpu" else None)
            trainer = Trainer(cfg, mesh=mesh, seed=0)
            zero_launch_counts()
            dp = run(trainer)
            launches = launch_counts()
            params = list(trainer.state.model.parameters())
            nbytes = sum(p.numel() * p.element_size() for p in params)
            all_reduce_grads(mesh, params)            # first use
            synchronize(device)
            t0 = time.perf_counter()
            for _ in range(TRAIN_STEPS):
                all_reduce_grads(mesh, params)
            synchronize(device)
            reduce_ms = 1e3 * (time.perf_counter() - t0) / TRAIN_STEPS
            backend = torch.distributed.get_backend()
            plain_s, dp_s, ratios = [], [], []
            for i in range(DP_ROUNDS):
                if i % 2 == 0:
                    plain_s.append(block(plain_trainer))
                    dp_s.append(block(trainer))
                else:
                    dp_s.append(block(trainer))
                    plain_s.append(block(plain_trainer))
                ratios.append(dp_s[-1] / plain_s[-1])
        finally:
            distributed.shutdown()
    plain_b = run(Trainer(cfg, device=device, seed=0))
    want = LAUNCHES_PER_STEP * TRAIN_STEPS
    print(f"dp world 1: {backend} group of one rank, launches over "
          f"{TRAIN_STEPS} steps {launches}, want {want} each", flush=True)
    if device != "cpu" and any(n != want for n in launches.values()):
        raise AssertionError(f"dp world 1 launched {launches}")
    deterministic = all(torch.equal(plain_a[1][k], plain_b[1][k])
                        for k in plain_a[1])
    bitwise = all(torch.equal(dp[1][k], plain_a[1][k]) for k in dp[1])
    worst = max(norm_rel(dp[1][k].float(), plain_a[1][k].float())
                for k in dp[1])
    loss_err = max(abs(a - b) for a, b in zip(dp[0], plain_a[0]))
    print(f"dp world 1: parameters after {TRAIN_STEPS} steps bitwise equal "
          f"to Trainer's: {bitwise} (norm-relative max {worst:.3e}); two "
          f"plain Trainer runs bitwise equal: {deterministic}; losses "
          f"max_abs_err {loss_err:.3e}", flush=True)
    if deterministic and not bitwise:
        raise AssertionError("data-parallel world 1 differs from Trainer "
                             "though Trainer repeats itself bitwise")
    if not (worst <= 1e-6 and loss_err <= LOSS_TOL):
        raise AssertionError(f"dp world 1: parameters {worst:.3e}, losses "
                             f"{loss_err:.3e} from Trainer's")
    steps = DP_BLOCK_STEPS * DP_ROUNDS
    overhead = statistics.median(ratios) - 1
    rates = (steps / sum(plain_s), steps / sum(dp_s), overhead)
    print(f"dp world 1: {DP_ROUNDS} rounds of {DP_BLOCK_STEPS} Trainer and "
          f"{DP_BLOCK_STEPS} DP steps, alternating, at batch "
          f"{cfg.train.batch_size}: steps/s Trainer {rates[0]:.3f}, DP "
          f"{rates[1]:.3f}; DP overhead, median of the rounds' time ratios, "
          f"{overhead:+.4f} of a step (rounds {min(ratios) - 1:+.4f} to "
          f"{max(ratios) - 1:+.4f}) [{card}]", flush=True)
    print(f"dp world 1: gradient all-reduce over one flat buffer "
          f"{reduce_ms:.4f} ms a step over {nbytes / 1e6:.3f} MB of float32 "
          f"gradients ({backend}, one rank: the flatten, the collective and "
          f"the copy back) [{card}]", flush=True)
    return launches, rates, reduce_ms


def dp_inputs(xe_cfg, rl_cfg, scst_weights, tmp: str):
    """The world-2 phase's inputs: configurations, weights and global
    batches (all dropout off in training), with the frozen df written to
    ``tmp``."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    off = {"model.dropout": 0.0, "model.attention_dropout": 0.0}
    xe = xe_cfg.with_overrides(**off)
    xe_weights = Captioner(xe.model, device="cpu",
                           generator=torch.Generator().manual_seed(3))
    rl_batch = scst_batch(rl_cfg.model, rl_cfg.train.batch_size, seed=2)
    write_batch_df(rl_cfg.model, rl_batch, tmp)
    rl_over = dict(off, **{"data.data_path": tmp, "rl.pipeline_depth": 1})
    decode = Captioner(rl_cfg.model, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    return {
        "xe": {"cfg": xe, "weights": xe_weights.state_dict(),
               "batch": train_batch(xe.model, xe.train.batch_size, seed=4)},
        "scst": {"cfg": rl_cfg.with_overrides(**rl_over),
                 "weights": scst_weights, "batch": rl_batch},
        "decode": {"cfg": rl_cfg, "weights": decode.state_dict(),
                   "images": EXTRACT_IMAGES, "batch_size": EXTRACT_BATCH}}


def dp_worker(rank: int, world: int, workdir: str, model: int = 1) -> int:
    """``python chip_smoke.py dp-worker RANK WORLD DIR``: one rank of the
    world-2 phase, on ``cuda:0`` over gloo, with every count and result
    written to ``DIR/rank{RANK}.pt``; ``tp-worker`` runs it with a model
    axis of ``world`` (tensor parallelism: gradients and weights gathered
    in the full layout, the XE state saved as a checkpoint under
    ``DIR/ckpt``)."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.parallel import distributed
    from image_caption_tpu_torch.parallel.mesh import make_mesh
    from image_caption_tpu_torch.parallel.tensor import (full_state_dict,
                                                         gather_full)
    from image_caption_tpu_torch.serve import decode_split
    from image_caption_tpu_torch.train.checkpoint import CheckpointManager
    from image_caption_tpu_torch.train.loop import Trainer
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    cfgs = {k: v["cfg"] for k, v in inputs.items()}
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    join_group(workdir, world, rank, "gloo")
    out = {}
    try:
        mesh = make_mesh([device], model=model)
        # XE: 3 steps on the global batch
        xe = Trainer(cfgs["xe"], mesh=mesh, seed=3)
        xe.load_state_dict(inputs["xe"]["weights"])
        zero_launch_counts()
        losses, grads = [], None
        synchronize(device)
        t0 = time.perf_counter()
        for step in range(DP_STEPS):
            losses.append(xe.train_step(*inputs["xe"]["batch"])["loss"])
            if step == 0:
                grads = {n: g.cpu() for n, g in gather_full(
                    xe.state.model, {n: p.grad for n, p in
                                     xe.state.model.named_parameters()})
                         .items()}
        synchronize(device)
        seconds = time.perf_counter() - t0
        out["xe"] = {"losses": losses, "grads": grads if rank == 0 else None,
                     "seconds": seconds,
                     "digest": params_digest(xe.state.model),
                     "launches": launch_counts()}
        if model > 1:
            CheckpointManager(os.path.join(workdir, "ckpt")).save(
                1, xe.state, mesh)
            out["xe"]["weights"] = {k: v.cpu() for k, v in
                                    full_state_dict(xe.state.model).items()}
        del xe
        out["scst"] = worker_scst(inputs["scst"], mesh, device)
        # decode_split of the 70-image split, each rank its rows
        m, dec = cfgs["decode"].model, inputs["decode"]
        model = Captioner(m, device=device)
        model.load_state_dict(dec["weights"])
        split = make_split(m, dec["images"], seed=0)
        out["decode"] = {}
        for label, beam in (("greedy", None), ("beam3", 3)):
            zero_launch_counts()
            caps = decode_split(model, cfgs["decode"], split,
                                dec["batch_size"], vocabulary(m.num_vocab),
                                beam_size=beam, device=device, mesh=mesh)
            out["decode"][label] = {"captions": caps,
                                    "launches": launch_counts()}
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


def worker_scst(case, mesh, device: str):
    """A rank's 3 pipelined SCST steps of ``case`` (cfg, weights, batch)
    over ``mesh``: the metrics, the sampled sequences, the seconds, the
    weights' digest, the launches and whether the frozen df was used."""
    from image_caption_tpu_torch.train.loop import RLTrainer
    cfg = case["cfg"]
    words = vocabulary(cfg.model.num_vocab)
    rl = RLTrainer(cfg, {w: i for i, w in words.items()}, mesh=mesh, seed=0)
    rl.load_state_dict(case["weights"])
    score, samples = rl._host_rewards, []

    def kept(sample_seq, captions):
        samples.append(sample_seq.copy())
        return score(sample_seq, captions)
    rl._host_rewards = kept
    batch = rl.to_device(case["batch"])
    zero_launch_counts()
    synchronize(device)
    t0 = time.perf_counter()
    metrics = [rl.train_step_device(batch)
               for _ in range(DP_STEPS)] + [rl.flush()]
    synchronize(device)
    return {"metrics": [{k: float(v) for k, v in m.items()}
                        for m in metrics if m is not None],
            "samples": samples, "seconds": time.perf_counter() - t0,
            "digest": params_digest(rl.state.model),
            "launches": launch_counts(),
            "frozen_df": rl.reward_computer.uses_frozen_df}


def reference_scst(cfg, weights, batch, device: str):
    """The single-process run of the world-2 phase's SCST steps (serial,
    the trajectory of the pipelined schedule): each step's samples, the
    CPU-side top-2 margins of their log-probs, and the metrics."""
    import torch
    from image_caption_tpu_torch.rl.step import rl_sample, rl_update
    from image_caption_tpu_torch.train.loop import RLTrainer
    words = vocabulary(cfg.model.num_vocab)
    trainer = RLTrainer(cfg, {w: i for i, w in words.items()},
                        device=device, seed=0)
    trainer.state.model.load_state_dict(weights)
    dev_batch = trainer.to_device(batch)
    steps = []
    for _ in range(DP_STEPS):
        s = rl_sample(trainer.state, dev_batch, cfg, seed=trainer.step_seed)
        seq, caps = s.host()
        top2 = torch.log_softmax(s.logits.detach(), -1).topk(2, -1).values
        margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        rewards, self_cider = trainer._host_rewards(seq, caps)
        m = rl_update(trainer.state, s, rewards, self_cider, cfg)
        steps.append({"samples": seq.copy(), "margins": margin,
                      "metrics": {k: float(v) for k, v in m.items()}})
    return steps


def caption_ties(model, cfg, split, want, got, beam, label: str):
    """Images whose captions differ between ``want`` (single process) and
    ``got``: each difference must be a near-tie of the single process's
    model.  Greedy: at the first differing word, its teacher-forced top-2
    margin on its own tokens is below MARGIN.  Beam: the two captions'
    summed log-probabilities (teacher-forced, the RL preset's beam score)
    differ by less than MARGIN.  Returns the differing count."""
    import torch
    words = vocabulary(cfg.model.num_vocab)
    index = {w: i for i, w in words.items()}
    t = cfg.model.max_length

    def tokens(caption):
        seq = [1] + [index[w] for w in caption.split() if w != "."]
        if caption.endswith("."):
            seq.append(2)
        return (seq + [0] * t)[:t]

    rows = [i for i, (a, b) in enumerate(zip(want, got)) if a != b]
    for i in rows:
        f = split.features[i:i + 1]
        p = split.positions[i:i + 1]
        caps = torch.tensor([tokens(want[i]), tokens(got[i])])
        lp = torch.log_softmax(model.logits(
            np.repeat(f, 2, 0), np.repeat(p, 2, 0), caps).float(),
            -1).cpu()
        if beam is None:
            a, b = want[i].split(), got[i].split()
            k = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y),
                     min(len(a), len(b)))
            top2 = lp[0, min(k, t - 2)].topk(2).values
            gap = (top2[0] - top2[1]).item()
        else:
            picked = lp.gather(2, caps[:, 1:, None])[..., 0]
            keep = (caps[:, 1:] != 0).float()
            score = (picked * keep).sum(1)
            gap = abs(score[0] - score[1]).item()
        print(f"{label}: image {i} {'beam' if beam else 'greedy'} "
              f"caption differs; single-process gap {gap:.3e}", flush=True)
        if not gap < MARGIN:
            raise AssertionError(f"image {i}: captions {want[i]!r} and "
                                 f"{got[i]!r} differ at a gap of {gap:.3e}")
    return len(rows)


def world2_references(inputs, scst_weights, device: str):
    """The single-process runs the world-2 phases are held against, on
    this process's card: 3 XE steps (losses, step-1 gradients), 3 SCST
    steps (``reference_scst``) and ``decode_split`` of the 70-image split
    greedy and beam 3."""
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.serve import decode_split
    from image_caption_tpu_torch.train.loop import Trainer
    cfgs = {k: v["cfg"] for k, v in inputs.items()}
    plain = Trainer(cfgs["xe"], device=device, seed=3)
    plain.state.model.load_state_dict(inputs["xe"]["weights"])
    want_xe, want_grads = [], None
    for step in range(DP_STEPS):
        want_xe.append(plain.train_step(*inputs["xe"]["batch"])["loss"])
        if step == 0:
            want_grads = {n: p.grad.cpu() for n, p in
                          plain.state.model.named_parameters()}
    del plain
    want_scst = reference_scst(cfgs["scst"], scst_weights,
                               inputs["scst"]["batch"], device)
    m = cfgs["decode"].model
    model = Captioner(m, device=device)
    model.load_state_dict(inputs["decode"]["weights"])
    split = make_split(m, EXTRACT_IMAGES, seed=0)
    want_caps = {label: decode_split(
        model, cfgs["decode"], split, EXTRACT_BATCH, vocabulary(m.num_vocab),
        beam_size=beam, device=device)
        for label, beam in (("greedy", None), ("beam3", 3))}
    return {"xe": want_xe, "grads": want_grads, "scst": want_scst,
            "caps": want_caps, "model": model, "split": split}


def start_world2(kind: str, tmp: str, world: int = DP_WORLD):
    """``world`` (two) ``chip_smoke.py kind`` ranks on this card over
    gloo, their output under ``tmp``."""
    procs = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), kind, str(r),
                 str(world), tmp], stdout=log, stderr=subprocess.STDOUT))
    return procs


def finish_world2(label: str, procs, tmp: str):
    """Wait for the ranks; each one's results, or raise with its log."""
    import torch
    for p in procs:
        p.wait(timeout=900)
    for r, p in enumerate(procs):
        if p.returncode != 0:
            with open(os.path.join(tmp, f"rank{r}.log")) as f:
                log = f.read()
            raise AssertionError(f"{label} rank {r} exited {p.returncode}:"
                                 f"\n{log[-3000:]}")
    return [torch.load(os.path.join(tmp, f"rank{r}.pt"), weights_only=False)
            for r in range(len(procs))]


def check_xe_ranks(label: str, ranks, want, want_grads, key: str = "xe"):
    """Every rank's XE losses against one process's ``want``, rank 0's
    step-1 gradients (full layout) against ``want_grads``, the ranks'
    weights bitwise equal."""
    loss_err = max(abs(a - b) for r in ranks
                   for a, b in zip(r[key]["losses"], want))
    grad_err = max(norm_rel(g, want_grads[n])
                   for n, g in ranks[0][key]["grads"].items())
    same = len({r[key]["digest"] for r in ranks}) == 1
    steps = len(want)
    print(f"{label} {key}: losses "
          f"{' '.join(f'{x:.6f}' for x in want)} (single process), "
          f"max_abs_err {loss_err:.3e} (tol {LOSS_TOL:g}); step-1 gradients "
          f"norm-relative max {grad_err:.3e} (tol {GRAD_TOL:g}); ranks' "
          f"weights bitwise equal after {steps} steps: {same}",
          flush=True)
    if not (loss_err <= LOSS_TOL and grad_err <= GRAD_TOL and same):
        raise AssertionError(f"{label} {key} disagrees with one process")


def check_scst_ranks(label: str, ranks, want_steps, rows):
    """Every rank's SCST samples (rank ``r``'s are the reference's
    ``rows(r)``, equal but at a top-2 margin below MARGIN) and metrics
    against one process's, the frozen df used, the ranks' weights bitwise
    equal."""
    if not all(r["scst"]["frozen_df"] for r in ranks):
        raise AssertionError(f"{label} scst: the frozen df was not used")
    flips, compared, worst = 0, 0, 0.0
    for step, want in enumerate(want_steps):
        differ = 0
        for rank, r in enumerate(ranks):
            got = r["scst"]["samples"][step][:, 0]
            diff = got != want["samples"][rows(rank), 0]
            bad = diff & (want["margins"][rows(rank)] >= MARGIN)
            if bad.any():
                i, t = np.argwhere(bad)[0]
                raise AssertionError(
                    f"{label} scst step {step + 1}: rank {rank} sampled "
                    f"({i}, {t}) differently at a margin of "
                    f"{want['margins'][rows(rank)][i, t]:.3e}")
            differ += int(diff.any(axis=1).sum())
        flips += differ
        if flips:
            continue             # past a tie the trajectories part
        compared += 1
        for r in ranks:
            for k, v in r["scst"]["metrics"][step].items():
                worst = max(worst, abs(v - want["metrics"][k]))
    same = len({r["scst"]["digest"] for r in ranks}) == 1
    print(f"{label} scst: losses "
          f"{' '.join(f'{s['metrics']['loss']:.6f}' for s in want_steps)} "
          f"(single process), metrics max_abs_err {worst:.3e} over "
          f"{compared} steps (tol {LOSS_TOL:g}); {flips} row-steps sampled "
          f"differently, all at margins below {MARGIN:g}; ranks' weights "
          f"bitwise equal: {same}", flush=True)
    if not (worst <= LOSS_TOL and same and compared >= 1):
        raise AssertionError(f"{label} SCST disagrees with one process")


def check_decode_ranks(label: str, ranks, refs, cfg):
    """Every rank's ``decode_split`` captions, greedy and beam 3, the same
    list, equal to one process's but at ties of ``refs["model"]``."""
    for name, beam in (("greedy", None), ("beam3", 3)):
        got = ranks[0]["decode"][name]["captions"]
        if any(r["decode"][name]["captions"] != got for r in ranks[1:]):
            raise AssertionError(f"{label} {name}: the ranks' caption "
                                 "lists differ")
        n = caption_ties(refs["model"], cfg, refs["split"],
                         refs["caps"][name], got, beam, label)
        print(f"{label} decode {name}: {EXTRACT_IMAGES - n} of "
              f"{EXTRACT_IMAGES} captions equal to one process's, the "
              f"rest at ties", flush=True)


def rank_launches(r):
    """A rank's launches of #1 and #2 on its train, SCST and decode
    paths."""
    return {"train": r["xe"]["launches"], "scst": r["scst"]["launches"],
            "decode": {k: sum(r["decode"][lb]["launches"][k]
                              for lb in ("greedy", "beam3"))
                       for k in ("fused_attention", "fused_attention_bwd")}}


def check_launches(label: str, counts, want: dict):
    """``counts`` (``rank_launches``) against ``want``: path -> launches
    of #1 and #2."""
    for path, n in want.items():
        if counts[path] != {"fused_attention": n[0],
                            "fused_attention_bwd": n[1]}:
            raise AssertionError(f"{label} {path} launched {counts[path]},"
                                 f" want {n}")


def check_world2(label: str, ranks, refs, rl_cfg, rows, card: str,
                 device: str):
    """The ranks of a world-2 phase against ``refs`` (one process): XE
    losses and step-1 gradients (full layout), SCST samples (rank ``r``'s
    are the reference's ``rows(r)``, equal but at a top-2 margin below
    MARGIN) and metrics, the ranks' weights bitwise equal, decode's
    captions equal but at ties; then each rank's launches.  Returns
    them per rank."""
    check_xe_ranks(label, ranks, refs["xe"], refs["grads"])
    check_scst_ranks(label, ranks, refs["scst"], rows)
    check_decode_ranks(label, ranks, refs, rl_cfg)
    n_batches = -(-EXTRACT_IMAGES // EXTRACT_BATCH)
    per_run = LAUNCHES_PER_STEP * DP_STEPS
    by_rank = []
    for rank, r in enumerate(ranks):
        counts = rank_launches(r)
        by_rank.append(counts)
        print(f"{label} rank {rank}: launches {counts}; steps/s xe "
              f"{DP_STEPS / r['xe']['seconds']:.3f}, scst "
              f"{DP_STEPS / r['scst']['seconds']:.3f} (two ranks sharing "
              f"one card over gloo: a functional check, not a scaling "
              f"figure) [{card}]", flush=True)
        if device != "cpu":
            check_launches(f"{label} rank {rank}", counts, {
                "train": (per_run, per_run), "scst": (per_run, per_run),
                "decode": (2 * 3 * n_batches, 0)})
    return by_rank


def drive_dp_world2(xe_cfg, rl_cfg, scst_weights, card: str,
                    device: str = "cuda"):
    """Two ranks in two subprocesses on one card over gloo (NCCL refuses
    two ranks on one device), global batch 32 (16 a rank), all dropout
    off, against the single-process run in this process: 3 XE steps
    (losses, step-1 gradients, the ranks' weights bitwise equal), 3
    pipelined SCST steps of the RL preset with a frozen df (samples equal
    but at a top-2 margin below MARGIN, losses), and ``decode_split`` of
    the 70-image split greedy and beam 3.  A functional check on one card,
    not a scaling figure.  Returns each rank's launches per path and the
    single-process references, for ``drive_tp_world2``."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dp_inputs(xe_cfg, rl_cfg, scst_weights, tmp)
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        procs = start_world2("dp-worker", tmp)
        try:
            refs = world2_references(inputs, scst_weights, device)
        finally:
            ranks = finish_world2("dp world 2", procs, tmp)
        seconds = time.perf_counter() - t0
    print(f"dp world 2: two ranks on one card over gloo, both phases done "
          f"in {seconds:.1f} s", flush=True)
    b = rl_cfg.train.batch_size // DP_WORLD
    by_rank = check_world2("dp world 2", ranks, refs, rl_cfg,
                           lambda r: slice(r * b, (r + 1) * b), card, device)
    return by_rank, refs


def drive_tp_world2(xe_cfg, rl_cfg, scst_weights, refs, card: str,
                    device: str = "cuda"):
    """Tensor parallelism: two ranks (``chip_smoke.py tp-worker``) on one
    card over gloo, a model group of two at the flagship's full width, so
    kernels #1 and #2 run on 16 of its 32 heads a rank; the world-2
    phase's inputs and its single-process references ``refs``: 3 XE steps
    (losses 2e-4, step-1 gradients in the full layout 1e-4), 3 pipelined
    argmax SCST steps (every rank samples every row), ``decode_split``
    greedy and beam 3 on the gathered replica, and the XE state saved at
    model 2 restored at model 1 bitwise equal to the ranks' gathered
    weights.  Functional only: two ranks share one card.  Returns each
    rank's launches per path."""
    import torch
    from image_caption_tpu_torch.train.checkpoint import CheckpointManager
    from image_caption_tpu_torch.train.loop import Trainer
    with tempfile.TemporaryDirectory() as tmp:
        inputs = dp_inputs(xe_cfg, rl_cfg, scst_weights, tmp)
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        ranks = finish_world2("tp world 2", start_world2("tp-worker", tmp),
                              tmp)
        seconds = time.perf_counter() - t0
        one = Trainer(inputs["xe"]["cfg"], device=device, seed=5)
        one.restore(CheckpointManager(os.path.join(tmp, "ckpt")), 1)
        restored = one.state.model.state_dict()
    gathered = ranks[0]["xe"]["weights"]
    bitwise = all(torch.equal(restored[k].cpu(), gathered[k])
                  for k in gathered) and one.state.step == DP_STEPS
    print(f"tp world 2: a model group of two on one card over gloo, "
          f"{TP_HEADS} heads a rank, done in {seconds:.1f} s; the XE state "
          f"saved at model 2 restored at model 1 bitwise equal to the "
          f"gathered weights: {bitwise}", flush=True)
    if not bitwise:
        raise AssertionError("tp world 2: the checkpoint does not restore "
                             "the gathered weights at model 1")
    return check_world2("tp world 2", ranks, refs, rl_cfg,
                        lambda r: slice(None), card, device)


def sp_inputs(xe_cfg, fallback_cfg, rl_cfg, scst_weights, tmp: str):
    """The sequence-3 phase's inputs: ``xe_cfg`` (the 21-slot preset) at
    attention dropout 0 (its residual dropout on), ``rl_cfg`` (the RL
    flagship) at 36 slots from ``scst_weights`` with all dropout off and
    a frozen df written to ``tmp``, and ``fallback_cfg`` (the XE flagship
    at its own 37 slots) at attention dropout 0, each with its weights
    and global batch."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    no_attn = {"model.attention_dropout": 0.0}
    xe = xe_cfg.with_overrides(**no_attn)
    fallback = fallback_cfg.with_overrides(**no_attn)
    rl = rl_cfg.with_overrides(**{
        "model.num_objects": SP_OBJECTS, "model.dropout": 0.0,
        "model.attention_dropout": 0.0, "data.data_path": tmp,
        "rl.pipeline_depth": 1})
    rl_batch = scst_batch(rl.model, rl.train.batch_size, seed=2)
    write_batch_df(rl.model, rl_batch, tmp)

    def case(cfg):
        weights = Captioner(cfg.model, device="cpu",
                            generator=torch.Generator().manual_seed(3))
        return {"cfg": cfg, "weights": weights.state_dict(),
                "batch": train_batch(cfg.model, cfg.train.batch_size, 4)}
    return {"xe": case(xe), "fallback": case(fallback),
            "scst": {"cfg": rl, "weights": scst_weights, "batch": rl_batch},
            "decode": {"images": EXTRACT_IMAGES,
                       "batch_size": EXTRACT_BATCH}}


def sp_xe(case, steps: int, device: str, mesh=None):
    """``steps`` XE updates of ``case`` by a ``Trainer`` (over ``mesh``,
    else one process, seed 3 either way): the trainer, the losses, the
    step-1 gradients, the seconds and the launches."""
    from image_caption_tpu_torch.train.loop import Trainer
    trainer = (Trainer(case["cfg"], mesh=mesh, seed=3) if mesh is not None
               else Trainer(case["cfg"], device=device, seed=3))
    trainer.load_state_dict(case["weights"])
    zero_launch_counts()
    losses, grads = [], None
    synchronize(device)
    t0 = time.perf_counter()
    for step in range(steps):
        losses.append(trainer.train_step(*case["batch"])["loss"])
        if step == 0:
            grads = {n: p.grad.cpu() for n, p in
                     trainer.state.model.named_parameters()}
    synchronize(device)
    return trainer, {"losses": losses, "grads": grads,
                     "seconds": time.perf_counter() - t0,
                     "launches": launch_counts()}


def sp_worker(rank: int, world: int, workdir: str) -> int:
    """``python chip_smoke.py sp-worker RANK WORLD DIR``: one rank of the
    sequence-3 phase, on ``cuda:0`` over gloo (one sequence group of
    ``world``), with every count and result written to
    ``DIR/rank{RANK}.pt``."""
    import torch
    from image_caption_tpu_torch.parallel import distributed
    from image_caption_tpu_torch.parallel.mesh import make_mesh
    from image_caption_tpu_torch.serve import decode_split
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    inputs = torch.load(os.path.join(workdir, "inputs.pt"),
                        weights_only=False)
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    join_group(workdir, world, rank, "gloo")
    out = {}
    try:
        mesh = make_mesh([device], sequence=world)
        for name, steps in (("xe", DP_STEPS), ("fallback", 1)):
            trainer, out[name] = sp_xe(inputs[name], steps, device, mesh)
            out[name]["grads"] = out[name]["grads"] if rank == 0 else None
            out[name]["digest"] = params_digest(trainer.state.model)
            out[name]["sharded"] = trainer.state.model.sp is not None
            if name == "xe":
                cfg, dec = inputs[name]["cfg"], inputs["decode"]
                m = cfg.model
                split = make_split(m, dec["images"], seed=0)
                out["decode"] = {}
                for label, beam in (("greedy", None), ("beam3", 3)):
                    zero_launch_counts()
                    caps = decode_split(
                        trainer.decode_model(), cfg, split,
                        dec["batch_size"],
                        vocabulary(m.num_vocab), beam_size=beam,
                        device=device, mesh=mesh)
                    out["decode"][label] = {"captions": caps,
                                            "launches": launch_counts()}
            del trainer
        out["scst"] = worker_scst(inputs["scst"], mesh, device)
        out["scst"]["sharded"] = True
        torch.save(out, os.path.join(workdir, f"rank{rank}.pt"))
    finally:
        distributed.shutdown()
    return 0


def sp_references(inputs, device: str):
    """The single-process runs the sequence-3 phase is held against, on
    this process's card: 3 XE steps and ``decode_split`` of the 70-image
    split greedy and beam 3 after them, 3 SCST steps
    (``reference_scst``), one fallback step."""
    from image_caption_tpu_torch.serve import decode_split
    trainer, xe = sp_xe(inputs["xe"], DP_STEPS, device)
    cfg = inputs["xe"]["cfg"]
    split = make_split(cfg.model, EXTRACT_IMAGES, seed=0)
    caps = {label: decode_split(
        trainer.state.model, cfg, split, EXTRACT_BATCH,
        vocabulary(cfg.model.num_vocab), beam_size=beam, device=device)
        for label, beam in (("greedy", None), ("beam3", 3))}
    _, fallback = sp_xe(inputs["fallback"], 1, device)
    scst = inputs["scst"]
    return {"xe": xe, "fallback": fallback, "caps": caps,
            "model": trainer.state.model, "split": split,
            "scst": reference_scst(scst["cfg"], scst["weights"],
                                   scst["batch"], device)}


def drive_sp_world3(xe_cfg, fallback_cfg, rl_cfg, scst_weights, card: str,
                    device: str = "cuda"):
    """Sequence parallelism: three ranks (``chip_smoke.py sp-worker``) on
    one card over gloo as one sequence group, full width, against one
    process here (``sp_inputs``): 3 XE steps of the 21-slot preset at
    residual dropout 0.3
    (7 slots a rank: kernels #1 and #2 at Lq 7 against Lk 21; losses 2e-4,
    step-1 gradients 1e-4, the ranks' weights bitwise equal), then
    ``decode_split`` of 70 images greedy and beam 3 on every slot
    (captions equal but at ties); 3 pipelined argmax SCST steps of the RL
    flagship at 36 slots (12 a rank: the pair block and the causal
    encoder mask cross the blocks; samples equal but at a top-2 margin
    below MARGIN); one XE step of the flagship at its 37 slots, which 3 do
    not divide (every rank runs every slot).  Functional only: three
    ranks share one card.  Returns each rank's launches per path."""
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        inputs = sp_inputs(xe_cfg, fallback_cfg, rl_cfg, scst_weights, tmp)
        torch.save(inputs, os.path.join(tmp, "inputs.pt"))
        t0 = time.perf_counter()
        procs = start_world2("sp-worker", tmp, SP_WORLD)
        try:
            refs = sp_references(inputs, device)
        finally:
            ranks = finish_world2("sp world 3", procs, tmp)
        seconds = time.perf_counter() - t0
    label = "sp world 3"
    print(f"{label}: a sequence group of three on one card over gloo, "
          f"done in {seconds:.1f} s; slot-sharded: xe "
          f"{[r['xe']['sharded'] for r in ranks]}, fallback "
          f"{[r['fallback']['sharded'] for r in ranks]}", flush=True)
    if not (all(r["xe"]["sharded"] for r in ranks)
            and not any(r["fallback"]["sharded"] for r in ranks)):
        raise AssertionError(f"{label}: the slots were not split as the "
                             "axis divides them")
    check_xe_ranks(label, ranks, refs["xe"]["losses"], refs["xe"]["grads"])
    check_xe_ranks(label, ranks, refs["fallback"]["losses"],
                   refs["fallback"]["grads"], key="fallback")
    check_scst_ranks(label, ranks, refs["scst"], lambda r: slice(None))
    check_decode_ranks(label, ranks, refs, inputs["xe"]["cfg"])
    xe_m, rl_m = inputs["xe"]["cfg"].model, inputs["scst"]["cfg"].model
    xe_calls = encoder_launches(xe_m) + 2 * xe_m.decode_num_blocks
    rl_calls = encoder_launches(rl_m) + 2 * rl_m.decode_num_blocks
    n_batches = -(-EXTRACT_IMAGES // EXTRACT_BATCH)
    by_rank = []
    for rank, r in enumerate(ranks):
        counts = rank_launches(r)
        by_rank.append(counts)
        print(f"{label} rank {rank}: launches {counts}, fallback "
              f"{r['fallback']['launches']}; steps/s xe "
              f"{DP_STEPS / r['xe']['seconds']:.3f}, scst "
              f"{DP_STEPS / r['scst']['seconds']:.3f} (three ranks sharing "
              f"one card over gloo: a functional check, not a scaling "
              f"figure) [{card}]", flush=True)
        if device == "cpu":
            continue
        check_launches(f"{label} rank {rank}", counts, {
            "train": (xe_calls * DP_STEPS,) * 2,
            "scst": (rl_calls * DP_STEPS,) * 2,
            "decode": (encoder_launches(xe_m) * 2 * n_batches, 0)})
        check_launches(f"{label} rank {rank} fallback",
                       {"fallback": r["fallback"]["launches"]},
                       {"fallback": (LAUNCHES_PER_STEP,) * 2})
    return by_rank


SCAN_K, SCAN_BATCHES = 4, 12


def drive_scan_steps(cfg, card: str, device: str = "cuda"):
    """``train.scan_steps``: 12 batches at K=4 (three stacked dispatches
    through ``shard_stacked`` and ``train_steps_device``) and at K=1, each
    twice in the order K=1, K=4, K=4, K=1, from the same weights and
    dropout keys: the parameters bitwise equal (else the largest
    norm-relative difference, which fails above 1e-6), 13 + 13 launches a
    step, the steps/s of both, and one K=4 dispatch under the profiler
    for the device's idle share.  Returns the first K=4 run's
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from image_caption_tpu_torch.train.loop import Trainer
    m = cfg.model
    batches = [train_batch(m, cfg.train.batch_size, seed=30 + i)
               for i in range(SCAN_BATCHES)]

    def run(k):
        trainer = Trainer(cfg.with_overrides(**{"train.scan_steps": k}),
                          device=device, seed=0)
        synchronize(device)
        t0 = time.perf_counter()
        for i in range(0, SCAN_BATCHES, k):
            if k == 1:
                trainer.train_step_device(trainer.to_device(batches[i]))
            else:
                trainer.train_steps_device(
                    trainer.shard_stacked(batches[i:i + k]))
        synchronize(device)
        rate = SCAN_BATCHES / (time.perf_counter() - t0)
        return trainer, rate

    one, rate1 = run(1)
    zero_launch_counts()
    scan, rate4 = run(SCAN_K)
    launches = launch_counts()
    _, rate4b = run(SCAN_K)
    _, rate1b = run(1)
    a, b = one.state.model.state_dict(), scan.state.model.state_dict()
    bitwise = all(torch.equal(a[k], b[k]) for k in a)
    worst = max(norm_rel(b[k].float(), a[k].float()) for k in a)
    print(f"scan steps: {SCAN_BATCHES} batches at K={SCAN_K} against K=1 "
          f"from the same weights: parameters bitwise equal {bitwise} "
          f"(norm-relative max {worst:.3e}, tol 1e-6); launches {launches}, "
          f"want {LAUNCHES_PER_STEP} x {SCAN_BATCHES} each", flush=True)
    if not worst <= 1e-6:
        raise AssertionError(f"scan steps: K={SCAN_K} differs from K=1 by "
                             f"{worst:.3e}")
    want = LAUNCHES_PER_STEP * SCAN_BATCHES
    if device != "cpu" and any(n != want for n in launches.values()):
        raise AssertionError(f"scan steps launched {launches}")
    print(f"scan steps: steps/s over {SCAN_BATCHES} steps at batch "
          f"{cfg.train.batch_size}, in the order K=1, K={SCAN_K}, "
          f"K={SCAN_K}, K=1: {rate1:.3f}, {rate4:.3f}, {rate4b:.3f}, "
          f"{rate1b:.3f}; K={SCAN_K} / K=1 "
          f"{(rate4 + rate4b) / (rate1 + rate1b):.4f} [{card}]", flush=True)
    if device == "cpu":
        return launches
    stacked = scan.shard_stacked(batches[:SCAN_K])
    synchronize(device)
    t0 = time.perf_counter()
    scan.train_steps_device(stacked)
    synchronize(device)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        scan.train_steps_device(stacked)
        torch.cuda.synchronize()
    busy_ms = sum(e.self_device_time_total
                  for e in device_kernels(prof)) / 1e3
    print(f"scan steps: one K={SCAN_K} dispatch {wall_ms:.2f} ms on the host "
          f"clock, device busy {busy_ms:.2f} ms, idle share "
          + (f"{1 - busy_ms / wall_ms:.4f}" if busy_ms > 0 else
             "not measured (the profiler saw no device time)")
          + f" [{card}]", flush=True)
    return launches


def stream_features(params, paths, device, mesh=None,
                    batch: int = EXTRACT_BATCH):
    """Features, positions and boxes of ``paths`` as the extraction stream
    loads and pads them into batches of ``batch`` (bf16, the flagship's
    slot contract), on one device or split over ``mesh``; and each
    batch's padded canvases."""
    import torch
    from image_caption_tpu_torch.vision import loader
    from image_caption_tpu_torch.vision.pipeline import (
        extract_features_batch, extract_features_sharded)
    out, batches = [], []
    for start in range(0, len(paths), batch):
        chunk = paths[start:start + batch]
        c, mt, sz = loader.load_letterboxed_batch(chunk, 640, nthreads=8)
        (c, mt, sz), real = padded_batches(c, mt, sz, batch)[0]
        kw = dict(num_objects=36, max_obj=5)
        if mesh is None:
            f, p, bx = extract_features_batch(params, c, mt, sz,
                                              device=device, **kw)
        else:
            f, p, bx = extract_features_sharded(mesh, params, c, mt, sz,
                                                **kw)
        out.append((f[:real].float().cpu(), p[:real].cpu(),
                    bx[:real].cpu()))
        batches.append(c)
    return [torch.cat([o[i] for o in out]) for i in range(3)], batches


def detector_score_gap(params, canvases, row: int, device):
    """The largest difference of YOLOv5x's candidate scores for image
    ``row`` of a padded batch between the whole batch and the half that
    holds it, on one device, in bf16 and in float32: how far the
    detector's rounding moves with the batch size alone."""
    import torch
    from image_caption_tpu_torch.vision import yolov5 as Y
    x = torch.as_tensor(canvases, device=device).float() / 255.0
    half = len(canvases) // 2
    lo = (row // half) * half
    gaps = []
    for dtype in (torch.bfloat16, torch.float32):
        scores = []
        for images, r in ((x, row), (x[lo:lo + half], row - lo)):
            raw = Y.yolov5_raw(params.yolo, images, dtype,
                               focus_stem=Y.stem_is_focus(params.yolo))
            scores.append(Y.decode_boxes_scores(params.yolo, raw)[1][r])
        gaps.append((scores[0] - scores[1]).abs().max().item())
    return gaps


def drive_sharded_extract(params, cfg, card: str, device: str = "cuda"):
    """``extract_features_sharded`` over a single-process mesh of
    ``[cuda:0, cuda:0]`` (two replicas on one card), YOLOv5x + ResNet-101
    in bf16, on 70 JPEGs in batches of 32 (16 a replica): bitwise equal to
    ``extract_features_batch`` on the same halves (batches of 16, the
    stream's padding lands on the same rows), with 4 launches of kernel #4
    a batch a replica; against batches of 32 on one device, features of
    slot 0 (the whole image) and of every image whose detections agree
    within 3e-2 x max|ref|, and for each image whose detections differ the
    detector's own bf16 score gap between the two batch sizes.  Then
    ``caption_images`` over that mesh, greedy: its captions equal one
    device's at batch 16, and at batch 32 on the images whose detections
    agree, but at ties.  Returns the launches of the sharded extraction
    and of the mesh captioning."""
    import torch
    from image_caption_tpu_torch.models.captioner import Captioner
    from image_caption_tpu_torch.ops.attention import fused_attention
    from image_caption_tpu_torch.parallel.mesh import make_mesh
    from image_caption_tpu_torch.serve import caption_images
    from image_caption_tpu_torch.vision import bottleneck as B
    mesh = make_mesh([device, device])
    half = EXTRACT_BATCH // 2
    n_batches = -(-EXTRACT_IMAGES // EXTRACT_BATCH)
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_jpegs(tmp, EXTRACT_IMAGES, 11)
        stream_features(params, paths[:EXTRACT_BATCH], device, mesh)  # set-up
        whole, batches = stream_features(params, paths, device)
        halves, _ = stream_features(params, paths, device, batch=half)
        zero_launch_counts()
        t0 = time.perf_counter()
        got, _ = stream_features(params, paths, device, mesh)
        seconds = time.perf_counter() - t0
        extract_launches = {"fused_stage": B.fused_stage.launches,
                            "fused_bottleneck": B.fused_bottleneck.launches}
        exact = all(torch.equal(a, b) for a, b in zip(got, halves))
        differ = [i for i in range(EXTRACT_IMAGES)
                  if not (torch.equal(got[1][i], whole[1][i])
                          and torch.equal(got[2][i], whole[2][i]))]
        gaps = [detector_score_gap(params, batches[i // EXTRACT_BATCH],
                                   i % EXTRACT_BATCH, device)
                for i in differ]
        keep = [slice(0, 1) if i in differ else slice(None)
                for i in range(EXTRACT_IMAGES)]
        err = max((got[0][i, s] - whole[0][i, s]).abs().max().item()
                  for i, s in enumerate(keep))
        ref = max(whole[0][i, s].abs().max().item()
                  for i, s in enumerate(keep))
        print(f"sharded extract: {EXTRACT_IMAGES} images over 2 replicas "
              f"on one card in {seconds:.3f} s, launches "
              f"{extract_launches} (want fused_stage 4 a batch a replica: "
              f"{8 * n_batches}); bitwise equal to one device at batch "
              f"{half}: {exact}; against batch {EXTRACT_BATCH}: detections "
              f"equal on {EXTRACT_IMAGES - len(differ)} images, features "
              f"max_abs_err {err:.3e} (max|ref| {ref:.3e}, tol 3e-2 x "
              f"max|ref|) [{card}]", flush=True)
        for i, (gap, gap_f32) in zip(differ, gaps):
            print(f"sharded extract: image {i} detects otherwise at batch "
                  f"{EXTRACT_BATCH} than at {half}: the detector's bf16 "
                  f"candidate scores for it differ by up to {gap:.3e} "
                  f"between the two batch sizes (float32: {gap_f32:.3e})",
                  flush=True)
        if not (exact and err <= 3e-2 * ref):
            raise AssertionError(f"sharded extraction: bitwise {exact}, "
                                 f"features differ by {err:.3e}")
        if device != "cpu" and extract_launches != {
                "fused_stage": 8 * n_batches, "fused_bottleneck": 0}:
            raise AssertionError(f"sharded extraction launched "
                                 f"{extract_launches}")

        m = cfg.model
        model = Captioner(m, device=device,
                          generator=torch.Generator().manual_seed(0))
        idx_to_word = vocabulary(m.num_vocab)

        def run(mesh_, batch_size=EXTRACT_BATCH):
            return caption_images(cfg, paths, model, idx_to_word,
                                  extractor_params=params,
                                  batch_size=batch_size,
                                  max_obj=cfg.data.max_obj, device=device,
                                  mesh=mesh_)
        one = run(None)
        one_half = run(None, half)
        zero_launch_counts()
        t0 = time.perf_counter()
        sharded = run(mesh)
        seconds = time.perf_counter() - t0
        caption_launches = {"fused_attention": fused_attention.launches,
                            "fused_stage": B.fused_stage.launches}
    rows = [i for i in range(EXTRACT_IMAGES) if i not in differ]
    split = type("Split", (), {
        "features": whole[0][rows].numpy(),
        "positions": whole[1][rows][..., :m.dim_positions].numpy()})
    ties = caption_ties(model, cfg, split, [one[i] for i in rows],
                        [sharded[i] for i in rows], None, "mesh caption")
    print(f"mesh caption: {EXTRACT_IMAGES} JPEGs over 2 replicas in "
          f"{seconds:.3f} s, launches {caption_launches} (want 3 of #1 and "
          f"4 of #4 a batch a replica); captions equal to one device's at "
          f"batch {half}: {sharded == one_half}; at batch {EXTRACT_BATCH} "
          f"on {len(rows) - ties} of {len(rows)} images with equal "
          f"detections, the rest at ties [{card}]", flush=True)
    if sharded != one_half:
        raise AssertionError("mesh captions differ from one device's at "
                             f"batch {half}")
    if device != "cpu" and caption_launches != {
            "fused_attention": 6 * n_batches, "fused_stage": 8 * n_batches}:
        raise AssertionError(f"mesh caption launched {caption_launches}")
    return extract_launches, caption_launches


def drive_profile(cfg, card: str, device: str = "cuda"):
    """``train --profile --epochs 1`` through ``main.main`` on a synthetic
    dataset: the Chrome trace it writes, its device kernels and the
    attention kernels among them; then ``train --debug-nans`` for one clean
    epoch, and again on a copy of the dataset with a NaN in one image's
    features, which must raise.  Returns the launches of the profiled
    run."""
    import shutil
    from image_caption_tpu_torch.data.synthetic import \
        generate_synthetic_dataset
    from image_caption_tpu_torch.main import main as cli_main
    with tempfile.TemporaryDirectory() as tmp:
        data = os.path.join(tmp, "data")
        vocab = generate_synthetic_dataset(data, feature_format="npy")
        flags = ["--device", device, "--preset", cfg.name,
                 "--set", f"model.num_vocab={len(vocab)}",
                 "--set", "model.attention_dropout=0.0",
                 "--data-path", data]
        zero_launch_counts()
        t0 = time.perf_counter()
        cli_main(flags + ["--output-path", os.path.join(tmp, "p"), "train",
                          "--profile", "--epochs", "1"])
        seconds = time.perf_counter() - t0
        launches = launch_counts()
        path = os.path.join(tmp, "p", "profile", "trace_rank0.json")
        with open(path) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        ours = sum("fused_attention" in e.get("name", "") for e in kernels)
        print(f"profile: train --profile, one epoch in {seconds:.2f} s, "
              f"trace {os.path.getsize(path) / 1e6:.2f} MB with "
              f"{len(events)} events, {len(kernels)} device kernels, "
              f"{ours} of them attention kernels; launches {launches} "
              f"[{card}]", flush=True)
        if device != "cpu" and (not kernels or ours == 0):
            raise AssertionError("the trace holds no device kernel of ours")
        cli_main(flags + ["--output-path", os.path.join(tmp, "n"), "train",
                          "--debug-nans", "--epochs", "1"])
        bad = os.path.join(tmp, "bad")
        shutil.copytree(data, bad)
        feats_path = os.path.join(bad, "train", "train.features.npy")
        feats = np.load(feats_path)
        feats[1, 0, 0] = np.nan
        np.save(feats_path, feats)
        try:
            cli_main([bad if f == data else f for f in flags]
                     + ["--output-path", os.path.join(tmp, "b"), "train",
                        "--debug-nans", "--epochs", "1"])
        except FloatingPointError as e:
            print(f"profile: train --debug-nans: a clean epoch, then on a "
                  f"NaN feature: FloatingPointError({e})", flush=True)
        else:
            raise AssertionError("--debug-nans did not raise on a NaN")
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the "
              "card only", file=sys.stderr)
        return 1
    from image_caption_tpu_torch.config import get_preset
    from image_caption_tpu_torch.ops import _build

    kind = torch.cuda.get_device_name(0)
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {kind}; nvidia-smi: {card}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}; TF32 off for matmul and cuDNN",
          flush=True)

    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS + ("ngram_rewards",))
    print(f"build: {', '.join(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}", flush=True)

    max_err = check_kernel("cuda")
    max_err_bwd = check_kernel_bwd("cuda")
    check_gradients("cuda")
    check_attention_determinism("cuda")
    max_err_bneck = check_bottleneck("cuda")
    check_determinism("cuda")
    check_determinism("cuda", n=FRCNN_CROPS, dtype_name="float32")
    times = time_kernel(card)
    times_bwd = time_kernel_bwd(card)
    times_bneck = time_bottleneck(card)
    err_f32, rows_f32 = check_stage_f32_frcnn(card)
    max_err_bneck["fused_stage"] = max(max_err_bneck["fused_stage"], err_f32)
    times_bneck["fused_stage"].update(rows_f32)
    max_err_mla, times_mla = drive_mla_decode(card)
    kimi_launches = drive_kimi_decode(card)
    gc.collect()
    torch.cuda.empty_cache()

    from image_caption_tpu_torch.ops.attention import (fused_attention,
                                                       fused_attention_bwd)
    from image_caption_tpu_torch.vision import bottleneck as B
    fused_attention.launches = fused_attention_bwd.launches = 0
    B.fused_stage.launches = B.fused_bottleneck.launches = 0
    flagship = get_preset(FLAGSHIP)
    serve_launches = drive_slice(flagship, "cuda", card)
    if fused_attention_bwd.launches != 0 or B.fused_stage.launches != 0:
        raise AssertionError("serving on features launched another kernel")
    xe = get_preset(XE_PRESET).with_overrides(
        **{"model.attention_dropout": 0.0})
    train_launches, _ = drive_train(xe, card)
    drive_train_loop(xe, card)
    train_against_cpu(xe, card)
    scan_launches = drive_scan_steps(xe, card)
    rl = flagship.with_overrides(**{"model.attention_dropout": 0.0})
    B.fused_stage.launches = B.fused_bottleneck.launches = 0
    scst_launches, scst_weights = drive_scst(rl, card)
    scst_launches.update(fused_stage=B.fused_stage.launches,
                         fused_bottleneck=B.fused_bottleneck.launches)
    drive_scst_loop(rl, card)
    scst_against_cpu(rl, scst_weights, card)
    dp1_launches, _, _ = drive_dp_world1(xe, card)
    dp2_launches, world2_refs = drive_dp_world2(
        get_preset(XE_PRESET), flagship, scst_weights, card)
    tp2_launches = drive_tp_world2(get_preset(XE_PRESET), flagship,
                                   scst_weights, world2_refs, card)
    del world2_refs
    sp3_launches = drive_sp_world3(get_preset(SP_PRESET),
                                   get_preset(XE_PRESET), flagship,
                                   scst_weights, card)
    profile_launches = drive_profile(xe, card)

    t0 = time.perf_counter()
    extractor = smoke_extractor(0, "cuda")
    print(f"extractor: YOLOv5x + ResNet-101, random weights from seed 0 "
          f"with BN calibrated on one batch, {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    extract_launches = drive_extract(extractor, flagship, card)
    caption_launches = drive_caption(extractor, flagship, card)
    check_extract_against_cpu(extractor, flagship, card)
    sharded_launches, mesh_caption = drive_sharded_extract(extractor,
                                                           flagship, card)

    with tempfile.TemporaryDirectory() as tmp:
        data_path, features_launches, train_jpegs = drive_features(
            extractor, flagship, card, tmp)
        roi_launches = drive_roi(extractor, flagship, card)
        demo_launches = drive_demo(extractor, flagship, card, data_path,
                                   train_jpegs[0], tmp)

        t0 = time.perf_counter()
        frcnn_cfg = get_preset(FRCNN_PRESET)
        frcnn = smoke_frcnn_extractor(0, "cuda")
        print(f"frcnn extractor: ResNet-50-FPN + ResNet-101, random weights "
              f"from seed 0 with heads calibrated on one batch, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        frcnn_extract = drive_frcnn_extract(frcnn, frcnn_cfg, card)
        check_frcnn_against_cpu(frcnn, frcnn_cfg, card)
        frcnn_caption = drive_frcnn_caption(frcnn, frcnn_cfg, card)
        frcnn_data, frcnn_features = drive_frcnn_features(frcnn, frcnn_cfg,
                                                          card, tmp)
        os.makedirs(os.path.join(tmp, "frcnn_demo"))
        frcnn_demo = drive_demo(frcnn, frcnn_cfg, card, frcnn_data,
                                train_jpegs[0],
                                os.path.join(tmp, "frcnn_demo"),
                                preset=FRCNN_PRESET)

    def entry(name, source, replaces, by_path, err, rows, main_shape):
        row = rows[main_shape]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": sum(by_path.values()),
                "launches_by_path": by_path, "max_abs_err": err,
                "ms": row["ms"], "plain_ms": row["plain_ms"],
                "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
                "library_ms": row["library_ms"], "main_shape": main_shape,
                "shapes": rows}

    def dp(kernel):
        """A kernel's launches on the scanned, data-, tensor- and
        sequence-parallel and profile paths: the multi-rank paths summed
        over their ranks."""
        return {"scan_train": scan_launches.get(kernel, 0),
                "dp_train": dp1_launches.get(kernel, 0),
                **{f"{w}_{p}": sum(r[p].get(kernel, 0) for r in ranks)
                   for w, ranks in (("dp2", dp2_launches),
                                    ("tp2", tp2_launches),
                                    ("sp3", sp3_launches))
                   for p in ("train", "scst", "decode")},
                "profile_train": profile_launches.get(kernel, 0),
                "sharded_extract": sharded_launches.get(kernel, 0),
                "mesh_caption": mesh_caption.get(kernel, 0)}

    fwd_train = train_launches["fused_attention"]
    bneck_src = "image_caption_tpu_torch/csrc/fused_bottleneck.cu"
    kernels = [
        entry("fused_attention",
              "image_caption_tpu_torch/csrc/fused_attention.cu",
              "image_caption_tpu/ops/attention.py:89",
              {"serve": serve_launches, "train": fwd_train,
               "scst": scst_launches["fused_attention"], "extract": 0,
               "caption": caption_launches["fused_attention"],
               "features": 0, "roi": 0,
               "demo": demo_launches["fused_attention"],
               "frcnn_extract": 0,
               "frcnn_caption": frcnn_caption["fused_attention"],
               "frcnn_features": 0,
               "frcnn_demo": frcnn_demo["fused_attention"],
               **dp("fused_attention")},
              max_err, times, "a_encoder"),
        entry("fused_attention_bwd",
              "image_caption_tpu_torch/csrc/fused_attention_bwd.cu",
              "image_caption_tpu/ops/attention.py:125",
              {"serve": 0, "train": train_launches["fused_attention_bwd"],
               "scst": scst_launches["fused_attention_bwd"], "extract": 0,
               "caption": 0, "features": 0, "roi": 0, "demo": 0,
               "frcnn_extract": 0, "frcnn_caption": 0, "frcnn_features": 0,
               "frcnn_demo": 0, **dp("fused_attention_bwd")},
              max_err_bwd, times_bwd, "a_encoder"),
        entry("fused_bottleneck", bneck_src,
              "image_caption_tpu/vision/pallas_bottleneck.py:43",
              {"serve": 0, "train": 0,
               "scst": scst_launches["fused_bottleneck"],
               "extract": extract_launches["fused_bottleneck"],
               "caption": 0,
               "features": features_launches["fused_bottleneck"],
               "roi": 0, "demo": 0,
               "frcnn_extract": frcnn_extract["fused_bottleneck"],
               "frcnn_caption": 0,
               "frcnn_features": frcnn_features["fused_bottleneck"],
               "frcnn_demo": 0, **dp("fused_bottleneck")},
              max_err_bneck["fused_bottleneck"],
              times_bneck["fused_bottleneck"], "stage3_bfloat16"),
        entry("fused_stage", bneck_src,
              "image_caption_tpu/vision/pallas_bottleneck.py:139",
              {"serve": 0, "train": 0, "scst": scst_launches["fused_stage"],
               "extract": extract_launches["fused_stage"],
               "caption": caption_launches["fused_stage"],
               "features": features_launches["fused_stage"],
               "roi": roi_launches, "demo": demo_launches["fused_stage"],
               "frcnn_extract": frcnn_extract["fused_stage"],
               "frcnn_caption": frcnn_caption["fused_stage"],
               "frcnn_features": frcnn_features["fused_stage"],
               "frcnn_demo": frcnn_demo["fused_stage"],
               **dp("fused_stage")},
              max_err_bneck["fused_stage"], times_bneck["fused_stage"],
              "stage3_bfloat16"),
        entry("mla_decode", "image_caption_tpu_torch/csrc/mla_decode.cu",
              "none: the JAX package has no mla_moe captioner",
              {"kimi_decode": kimi_launches}, max_err_mla, times_mla,
              "pos62"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["sp-worker"]:
        sys.exit(sp_worker(int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]))
    if sys.argv[1:2] in (["dp-worker"], ["tp-worker"]):
        world = int(sys.argv[3])
        sys.exit(dp_worker(int(sys.argv[2]), world, sys.argv[4],
                           model=world if sys.argv[1] == "tp-worker" else 1))
    sys.exit(main())
