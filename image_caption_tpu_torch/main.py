"""CLI of the port: ``python -m image_caption_tpu_torch.main train``.

The reference dispatches its verbs through google-fire with experiments
selected by editing ``core/config.py`` (``main.py:19-22,250-251``); here
the preset and every config field are flags, as in the JAX package's
``main.py``.  The port has the ``train`` verb so far; it runs on the card
unless ``--device`` says otherwise.
"""

from __future__ import annotations

import argparse
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
    return p


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
