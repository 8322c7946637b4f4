"""CLI of the port: ``python -m image_caption_tpu_torch.main train``.

The reference dispatches its verbs through google-fire with experiments
selected by editing ``core/config.py`` (``main.py:19-22,250-251``); here
the preset and every config field are flags, as in the JAX package's
``main.py``.  The verbs are ``train``, ``evaluation``, ``demo``,
``caption`` and ``features``; they run on the card unless ``--device``
says otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from .config import Config, get_preset, list_presets


def _parse_overrides(pairs: List[str]) -> dict:
    out = {}
    for pair in pairs:
        key, sep, value = pair.partition("=")
        if not sep:
            raise SystemExit(f"bad override {pair!r}; expected key=value")
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
        else:
            if value in ("true", "True"):
                value = True
            elif value in ("false", "False"):
                value = False
        out[key] = value
    return out


def _load_config(args) -> Config:
    cfg = get_preset(args.preset)
    over = _parse_overrides(args.set or [])
    if args.data_path:
        over["data.data_path"] = args.data_path
    if args.output_path:
        over["data.output_path"] = args.output_path
    return cfg.with_overrides(**over)


def cmd_train(args) -> None:
    from .train.loop import train
    train(_load_config(args), num_epochs=args.epochs,
          resume=not args.no_resume, device=args.device)


def _restore_model(cfg: Config, epoch: Optional[int], device):
    """The captioner of ``{output_path}/model/train_state_{epoch}.pt`` (the
    model part only; the latest epoch when ``epoch`` is None) on
    ``device``, and its epoch."""
    from .models.captioner import Captioner
    from .train.checkpoint import CheckpointManager
    ckpt = CheckpointManager(os.path.join(cfg.data.output_path, "model"))
    epoch = epoch if epoch is not None else ckpt.latest_epoch()
    if epoch not in ckpt.all_epochs():
        raise SystemExit(f"no checkpoint of epoch {epoch} under "
                         f"{ckpt.directory}")
    model = Captioner(cfg.model, device=device)
    model.load_state_dict(ckpt.load_model_state(epoch))
    return model, epoch


def cmd_evaluation(args) -> None:
    """main.py:156-190: restore a checkpoint, decode a split (greedy, or
    beam with ``--beam-size``), write its candidates and score them."""
    from .data.dataset import load_split
    from .data.vocab import invert_vocab
    from .metrics.evaluate import score_captions
    from .serve import decode_split
    from .train.logging import write_scores
    from .utils.device import resolve_device
    from .utils.io import load_pickle, save_pickle

    cfg = _load_config(args)
    d = cfg.data
    device = resolve_device(args.device)
    split = load_split(d.data_path, args.split, load_references=True,
                       streaming=d.stream_features)
    word_to_idx = split.word_to_idx or load_pickle(d.word_to_idx_path)
    idx_to_word = invert_vocab(word_to_idx)

    model, epoch = _restore_model(cfg, args.epoch, device)
    candidates = decode_split(model, cfg, split, cfg.train.batch_size,
                              idx_to_word, beam_size=args.beam_size,
                              device=device)
    save_pickle(candidates, os.path.join(
        d.output_path, "candidates",
        f"{args.split}.candidate.captions.pkl"))
    if split.references is not None:
        hypo = {i: [c] for i, c in enumerate(candidates)}
        scores = score_captions(split.references, hypo)
        write_scores(d.output_path, args.split, epoch, scores)
        for name, value in scores.items():
            print(f"{name}:\t{value}")


def cmd_demo(args) -> None:
    """main.py:193-247: one image -> its caption, with ``--save-img`` the
    detections and, for a greedy decode, one attention overlay per word
    under ``./demo/<stem>/<image_model>``; a detection's class there is the
    argmax of its position row's one-hot (YOLOv5's 80 classes, or Faster
    R-CNN's 91 less the background).  The extraction runs kernel #4 and
    the decode's encoder kernel #1."""
    import numpy as np
    import torch
    from .data.vocab import decode_captions, invert_vocab
    from .models.decoding import beam_score_mode, beam_search, greedy_decode
    from .utils.device import resolve_device
    from .utils.io import load_pickle
    from .vision.pipeline import extract_single_image

    cfg = _load_config(args)
    d = cfg.data
    device = resolve_device(args.device)
    t0 = time.time()
    feats, poss, boxes = extract_single_image(
        args.image_path, image_model=d.image_model,
        num_objects=cfg.model.num_objects, max_obj=args.max_obj,
        weights_dir=args.weights_dir, device=device)
    idx_to_word = invert_vocab(load_pickle(d.word_to_idx_path))
    model, _ = _restore_model(cfg, args.epoch, device)

    feats_b = torch.from_numpy(feats[None]).to(device)
    poss_b = torch.from_numpy(poss[None]).to(device)
    if args.beam_size and args.beam_size > 1:
        tokens = beam_search(model, feats_b, poss_b,
                             beam_size=args.beam_size,
                             score_mode=beam_score_mode(cfg.caption_model),
                             use_kernel=True, device=device)
        attention = None
    else:
        tokens, attention = greedy_decode(model, feats_b, poss_b,
                                          use_kernel=True,
                                          return_attention=True,
                                          device=device)
    caption = decode_captions(tokens.cpu().numpy(), idx_to_word)[0]

    if args.save_img:
        from .vision.overlay import (save_attention_overlays,
                                     save_detection_overlay)
        out_dir = os.path.join(
            "./demo", os.path.splitext(os.path.basename(args.image_path))[0],
            d.image_model)
        # position rows 1.. hold each detection's score one-hot
        cls = np.argmax(poss[1:, 4:], axis=-1)
        scr = np.max(poss[1:, 4:], axis=-1)
        valid = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]) > 0
        save_detection_overlay(args.image_path, boxes[valid], scr[valid],
                               cls[valid], out_dir)
        if attention is not None:
            save_attention_overlays(args.image_path,
                                    attention[:, 0].cpu().numpy(), boxes,
                                    caption, out_dir)

    print(caption)
    print(f"time: {time.time() - t0:.2f}s")


def cmd_caption(args) -> None:
    """Batch captioning: a directory (or a list) of images -> one JSON line
    per image, streamed through load -> extract -> decode
    (``serve.caption_images``).  The captioner comes from the port's
    ``{output_path}/model/train_state_N.pt`` (the model part only, so an
    ``RL_Transformer`` preset serves without an RL trainer) or, with
    ``--checkpoint``, from a reference ``model_N.pt``."""
    from .data.vocab import invert_vocab
    from .serve import caption_images, caption_images_to_jsonl, list_images
    from .utils.device import resolve_device
    from .utils.io import load_pickle
    from .utils.weights import load_reference_checkpoint

    cfg = _load_config(args)
    d = cfg.data
    device = resolve_device(args.device)
    paths = list(args.images or [])
    if args.image_dir:
        paths.extend(list_images(args.image_dir))
    if not paths:
        raise SystemExit("no images: pass --image-dir and/or --images")
    idx_to_word = invert_vocab(load_pickle(d.word_to_idx_path))

    if args.checkpoint:
        model = load_reference_checkpoint(args.checkpoint, cfg.model,
                                          device=device)
    else:
        model, _ = _restore_model(cfg, args.epoch, device)

    # open the sink before the run, and write per batch: a bad --out fails
    # fast and a long run loses nothing already captioned
    out = open(args.out, "w") if args.out else sys.stdout

    def write_batch(start: int, batch_caps) -> None:
        for line in caption_images_to_jsonl(
                paths[start:start + len(batch_caps)], batch_caps):
            print(line, file=out, flush=bool(args.out))

    t0 = time.time()
    try:
        caption_images(
            cfg, paths, model, idx_to_word, weights_dir=args.weights_dir,
            beam_size=args.beam_size, batch_size=args.batch_size,
            max_obj=args.max_obj if args.max_obj is not None else d.max_obj,
            feature_mode=d.feature_mode, skip_errors=args.skip_errors,
            on_batch=write_batch, device=device,
            progress=(lambda done, n: print(f"[caption] {done}/{n}",
                                            file=sys.stderr))
            if args.verbose else None)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"[caption] {len(paths)} images in {time.time() - t0:.2f}s",
          file=sys.stderr)


def cmd_features(args) -> None:
    """features.py: the offline COCO build into ``--data-path``."""
    from .vision.etl import run_etl
    run_etl(_load_config(args), coco_root=args.coco_root,
            splits=args.splits, batch_size=args.batch_size,
            weights_dir=args.weights_dir, feature_format=args.format,
            device=args.device)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="image_caption_tpu_torch")
    p.add_argument("--preset",
                   default="RL_maxlen49_36obj_1wordCount_256_25b_32h_"
                           "split_img_obj",
                   help=f"one of: {', '.join(list_presets())}")
    p.add_argument("--set", action="append", metavar="KEY=VALUE",
                   help="config override, e.g. --set train.batch_size=64")
    p.add_argument("--data-path", default=None)
    p.add_argument("--output-path", default=None)
    p.add_argument("--device", default=None,
                   help="torch device; the card (cuda) when not given")
    sub = p.add_subparsers(dest="cmd", required=True)

    t = sub.add_parser("train")
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--no-resume", action="store_true")
    t.set_defaults(fn=cmd_train)

    e = sub.add_parser("evaluation")
    e.add_argument("--split", default="test")
    e.add_argument("--epoch", type=int, default=None,
                   help="train_state_N.pt to score; the latest by default")
    e.add_argument("--beam-size", type=int, default=None)
    e.set_defaults(fn=cmd_evaluation)

    dm = sub.add_parser("demo")
    dm.add_argument("--image-path", required=True)
    dm.add_argument("--epoch", type=int, default=None,
                    help="train_state_N.pt to use; the latest by default")
    dm.add_argument("--beam-size", type=int, default=None)
    dm.add_argument("--save-img", action="store_true",
                    help="write the detection and attention overlays "
                         "under ./demo/<image stem>/<image_model>")
    dm.add_argument("--max-obj", type=int, default=None)
    dm.add_argument("--weights-dir", default="./weights",
                    help="yolov5x (or fasterrcnn_resnet50_fpn) and "
                         "resnet101 weights; random when absent")
    dm.set_defaults(fn=cmd_demo)

    c = sub.add_parser("caption")
    c.add_argument("--image-dir", default=None,
                   help="caption every image in this directory (sorted)")
    c.add_argument("--images", nargs="+", default=None,
                   help="explicit image paths (before --image-dir's)")
    c.add_argument("--epoch", type=int, default=None,
                   help="train_state_N.pt to serve; the latest by default")
    c.add_argument("--checkpoint", default=None,
                   help="serve a reference model_N.pt instead")
    c.add_argument("--beam-size", type=int, default=None)
    c.add_argument("--batch-size", type=int, default=32)
    c.add_argument("--max-obj", type=int, default=None,
                   help="defaults to data.max_obj, the layout the training "
                        "features were written with")
    c.add_argument("--weights-dir", default="./weights",
                   help="yolov5x (or fasterrcnn_resnet50_fpn) and "
                        "resnet101 weights; random when absent")
    c.add_argument("--out", default=None,
                   help="write JSONL here instead of stdout")
    c.add_argument("--skip-errors", action="store_true",
                   help="unreadable images emit an error record instead "
                        "of failing the run")
    c.add_argument("--verbose", action="store_true")
    c.set_defaults(fn=cmd_caption)

    f = sub.add_parser("features")
    f.add_argument("--coco-root", required=True,
                   help="holds annotations/captions_{train,val}2017.json "
                        "and image/{train,val}2017/")
    f.add_argument("--splits", nargs="+",
                   default=["train", "valid", "test"])
    f.add_argument("--batch-size", type=int, default=64)
    f.add_argument("--weights-dir", default="./weights",
                   help="yolov5x (or fasterrcnn_resnet50_fpn) and "
                        "resnet101 weights; random when absent")
    f.add_argument("--format", choices=("hkl", "npy"), default="hkl",
                   help="feature files as hickle (needs h5py) or .npy")
    f.set_defaults(fn=cmd_features)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
