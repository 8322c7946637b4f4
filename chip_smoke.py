"""Drive the PyTorch port on one CUDA card and check it.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. card: its name and power limit; TF32 is switched off for matmuls and
   cuDNN, so float32 means float32 on the card as on the CPU;
2. build: every CUDA kernel of the port, one ``nvcc`` per source, started
   together, into ``image_caption_tpu_torch/_build/``;
3. kernel check: each kernel against its plain PyTorch version on the card,
   at the shapes the caption slice gives it, in float32 and bfloat16;
4. times: each kernel, its plain version and one PyTorch library call for
   the same function, by CUDA events (10 warm-up runs, median of 50), beside
   the least time the card could take;
5. slice: the flagship captioner at full width, random weights from
   ``torch.Generator`` seed 0, decodes a 70-image split greedily and with
   beam 3 through ``decode_split``; the kernel launch counts are read around
   that run, and the first batch is decoded again on the CPU through the
   plain path and compared.

It prints a JSON line of the kernels, the card's name and power limit, and
as its last line ``{"ok": true, "device": {...}}``.  Without CUDA it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

FLAGSHIP = "RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
# H100 SXM data-sheet peaks: HBM bytes/s and float32 FLOP/s off the tensor
# cores (the kernel computes in float32 on the CUDA cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
TOL = {"float32": 1e-5, "bfloat16": 1e-2}


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


def pair_mask(pad: np.ndarray) -> np.ndarray:
    """The split_image_objects pair block's mask, [B*S, 2, 2]: token 0 is
    the whole image (slot 0), token 1 the object."""
    b, s = pad.shape
    pair = np.stack([np.repeat(pad[:, :1], s, axis=1), pad], axis=2)
    return encoder_mask(pair.reshape(b * s, 2))


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
    return [
        attention_case("a_encoder", batch, heads, slots, slots, head_dim,
                       encoder_mask(pad), 1),
        attention_case("b_pair", batch * slots, heads, 2, 2, head_dim,
                       pair_mask(pad), 2),
        attention_case("c_ragged", 3, 4, 5, 70, 16, ragged, 3),
    ]


def on(case, device, dtype):
    import torch
    t = {n: torch.from_numpy(case[n]).to(device) for n in "qkv"}
    return (t["q"].to(dtype), t["k"].to(dtype), t["v"].to(dtype),
            torch.from_numpy(case["mask"]).to(device),
            float(np.sqrt(case["shape"][-1])))


# ---------------------------------------------------------------------------
# Phase 3: kernel against its plain version
# ---------------------------------------------------------------------------

def check_kernel(device) -> float:
    """Every case in float32 and bfloat16; returns the largest float32
    error.  Tolerance: |kernel - plain| <= tol + tol*|plain|, the plain
    version run on the same inputs in the same dtype."""
    import torch
    from image_caption_tpu_torch.ops.attention import (attention_reference,
                                                       fused_attention)
    worst_f32 = 0.0
    for case in kernel_cases():
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


# ---------------------------------------------------------------------------
# Phase 4: times
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
    cases = kernel_cases()[:2] + [
        dict(kernel_cases(batch=128)[0], name="a_encoder_B128")]
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


# ---------------------------------------------------------------------------
# Phase 5: the slice at full width
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


def profile_batch(model, cfg, split, batch_size, idx_to_word, card):
    """One batch of each decode under torch.profiler: the device's busy
    time (the kernels' own time) against the batch's time on the host
    clock without the profiler, and the kernels that take the most."""
    import torch
    from torch.autograd import DeviceType
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
        # the kernels alone: an operator's row repeats its kernels' time
        stats = [e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA]
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
    got = model.logits(f, p, c, use_kernel=True).cpu()
    want = cpu.logits(f, p, c)
    err = (got - want).abs().max().item()
    print(f"cpu check: teacher-forced logits {tuple(want.shape)} max_abs_err "
          f"{err:.3e} (tol 2e-4)", flush=True)
    if not err <= 2e-4:
        raise AssertionError(f"card and CPU logits differ by {err:.3e}")

    tok_gpu = greedy_decode(model, f, p, use_kernel=True,
                            device=model.device)[0].cpu()
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
    logs = _build.build()
    print(f"build: {', '.join(logs)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build {name}: {line.strip()}", flush=True)

    max_err = check_kernel("cuda")
    times = time_kernel(card)
    launches = drive_slice(get_preset(FLAGSHIP), "cuda", card)

    main_shape = times["a_encoder"]
    kernels = [{
        "name": "fused_attention", "route": "cuda",
        "source": "image_caption_tpu_torch/csrc/fused_attention.cu",
        "replaces": "image_caption_tpu/ops/attention.py:89",
        "launches": launches, "max_abs_err": max_err,
        "ms": main_shape["ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"],
        "bound_by": main_shape["bound_by"],
        "library_ms": main_shape["library_ms"],
        "shapes": times,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
