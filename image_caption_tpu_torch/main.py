"""CLI of the port: ``python -m image_caption_tpu_torch.main train``.

The reference dispatches its verbs through google-fire with experiments
selected by editing ``core/config.py`` (``main.py:19-22,250-251``); here
the preset and every config field are flags, as in the JAX package's
``main.py``.  The port has the ``train`` and ``caption`` verbs so far; they
run on the card unless ``--device`` says otherwise.
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


def cmd_caption(args) -> None:
    """Batch captioning: a directory (or a list) of images -> one JSON line
    per image, streamed through load -> extract -> decode
    (``serve.caption_images``).  The captioner comes from the port's
    ``{output_path}/model/train_state_N.pt`` (the model part only, so an
    ``RL_Transformer`` preset serves without an RL trainer) or, with
    ``--checkpoint``, from a reference ``model_N.pt``."""
    from .data.vocab import invert_vocab
    from .models.captioner import Captioner
    from .serve import caption_images, caption_images_to_jsonl, list_images
    from .train.checkpoint import CheckpointManager
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
        ckpt = CheckpointManager(os.path.join(d.output_path, "model"))
        epoch = args.epoch if args.epoch is not None else ckpt.latest_epoch()
        if epoch not in ckpt.all_epochs():
            raise SystemExit(f"no checkpoint of epoch {epoch} under "
                             f"{ckpt.directory}")
        model = Captioner(cfg.model, device=device)
        model.load_state_dict(ckpt.load_model_state(epoch))

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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="image_caption_tpu_torch")
    p.add_argument("--preset",
                   default="maxlen49_36obj_1wordCount_256_25b_32h_"
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
                   help="yolov5x and resnet101 weights; random when absent")
    c.add_argument("--out", default=None,
                   help="write JSONL here instead of stdout")
    c.add_argument("--skip-errors", action="store_true",
                   help="unreadable images emit an error record instead "
                        "of failing the run")
    c.add_argument("--verbose", action="store_true")
    c.set_defaults(fn=cmd_caption)
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
