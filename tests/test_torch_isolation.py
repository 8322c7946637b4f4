"""The port stands alone: it imports neither JAX nor the JAX package, its
copy of the configuration equals the JAX package's, and its entry points
run on CUDA unless the caller asks for the CPU."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from image_caption_tpu import config as JCFG
from image_caption_tpu_torch import config as TCFG
from image_caption_tpu_torch.data.dataset import CocoSplit
from image_caption_tpu_torch.models import decoding as TD
from image_caption_tpu_torch.models.captioner import Captioner
from image_caption_tpu_torch.parallel import distributed as TDIST
from image_caption_tpu_torch.parallel import mesh as TMESH
from image_caption_tpu_torch.main import main as cli_main
from image_caption_tpu_torch.serve import caption_images, decode_split
from image_caption_tpu_torch.vision import pipeline as TP
from image_caption_tpu_torch.vision.etl import (run_etl,
                                                stream_extracted_batches)
from image_caption_tpu_torch.vision.resnet import init_resnet
from image_caption_tpu_torch.vision.yolov5 import init_yolov5

from conftest import make_fake_batch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted(str(p.relative_to(ROOT)) for p in
                    (ROOT / "image_caption_tpu_torch").rglob("*.py")
                    if "_build" not in p.parts) + ["chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "image_caption_tpu")


def _forbidden(module: str) -> bool:
    """``image_caption_tpu`` or ``image_caption_tpu.x`` is the JAX package;
    ``image_caption_tpu_torch`` only shares its prefix."""
    return module.split(".")[0] in FORBIDDEN


@pytest.mark.parametrize("path", PORT_FILES)
def test_port_file_imports_no_jax(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    found = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            found += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _forbidden(node.module or ""):
                found.append(node.module)
    assert not found, f"{path} imports {found}"


def test_forbidden_names_keep_the_port_apart():
    assert _forbidden("image_caption_tpu")
    assert _forbidden("image_caption_tpu.ops.attention")
    assert _forbidden("jax.numpy")
    assert not _forbidden("image_caption_tpu_torch.ops.attention")


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import image_caption_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('image_caption_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 12, out.stdout


# what the port alone has: the mla_moe captioner's preset, and the fields
# that select and size it (at their defaults in every shared preset)
PORT_ONLY_PRESETS = ["kimi_vl_a3b_regions"]


def _shared_fields(cfg) -> dict:
    """``asdict(cfg)`` without the port-only fields, which must hold their
    defaults."""
    assert cfg.model.architecture == "transformer"
    assert cfg.lm == TCFG.LMConfig()
    out = dataclasses.asdict(cfg)
    del out["lm"], out["model"]["architecture"]
    return out


def test_presets_equal_the_jax_package():
    assert TCFG.list_presets() == sorted(JCFG.list_presets()
                                         + PORT_ONLY_PRESETS)
    for name in JCFG.list_presets():
        assert _shared_fields(TCFG.get_preset(name)) == \
            dataclasses.asdict(JCFG.get_preset(name)), name
    for token in ("NULL", "START", "END", "UNK"):
        assert getattr(TCFG, f"{token}_TOKEN") == \
            getattr(JCFG, f"{token}_TOKEN")
        assert getattr(TCFG, f"{token}_IDX") == getattr(JCFG, f"{token}_IDX")


def test_overrides_equal_the_jax_package():
    overrides = {"model.num_vocab": 50, "model.max_length": 13,
                 "train.batch_size": 4, "caption_model": "Transformer"}
    name = "RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
    assert _shared_fields(
        TCFG.get_preset(name).with_overrides(**overrides)) == \
        dataclasses.asdict(JCFG.get_preset(name).with_overrides(**overrides))


def test_bad_model_config_raises():
    with pytest.raises(ValueError):
        TCFG.ModelConfig(encode_num_heads=7)
    with pytest.raises(ValueError):
        TCFG.ModelConfig(compute_dtype="float16")
    with pytest.raises(ValueError):
        TCFG.ModelConfig(architecture="mamba")
    with pytest.raises(ValueError):
        TCFG.LMConfig(num_experts_per_tok=65)
    with pytest.raises(ValueError):
        TCFG.LMConfig(qk_rope_head_dim=63)
    with pytest.raises(ValueError):
        TCFG.LMConfig(first_k_dense_replace=28)
    with pytest.raises(ValueError):
        TCFG.get_preset("kimi_vl_a3b_regions").with_overrides(
            **{"model.max_length": 1})
    with pytest.raises(KeyError):
        TCFG.get_preset("no_such_preset")


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _tiny_extractor():
    gen = torch.Generator().manual_seed(0)
    return TP.ExtractorParams(
        yolo=init_yolov5(gen, depth_multiple=0.33, width_multiple=0.25),
        resnet=init_resnet(gen, stages=(1, 1, 1, 1)))


@pytest.mark.parametrize("entry", [
    "Captioner", "greedy_decode", "beam_search", "decode_split",
    "caption_images", "stream_extracted_batches", "extract_features_batch",
    "init_extractor", "caption verb", "run_etl", "extract_features_roi",
    "extract_single_image", "features verb", "demo verb", "make_mesh",
    "initialize", "extract_features_sharded"])
def test_entry_points_need_cuda_unless_told_cpu(entry, tiny_cfg, no_cuda,
                                                tmp_path):
    if entry in ("Captioner", "init_extractor"):
        make = Captioner if entry == "Captioner" else \
            lambda m: TP.init_extractor()
        with pytest.raises(RuntimeError, match="CUDA"):
            make(tiny_cfg.model)
        return
    if entry == "initialize":
        # NCCL on the card by default; gloo joins on the CPU when asked
        with pytest.raises(RuntimeError, match="CUDA"):
            TDIST.initialize("localhost:1", 1, 0)
        assert not TDIST.is_initialized()
        return
    if entry == "caption verb":
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(["caption", "--images", "a.jpg"])
        with pytest.raises(SystemExit, match="no images"):
            cli_main(["--device", "cpu", "caption"])
        return
    if entry in ("features verb", "demo verb"):
        # on the CPU each gets past the device to its first file
        argv = (["features", "--coco-root", str(tmp_path / "none")]
                if entry == "features verb" else
                ["demo", "--image-path", str(tmp_path / "none.jpg")])
        with pytest.raises(RuntimeError, match="CUDA"):
            cli_main(["--data-path", str(tmp_path / "d")] + argv)
        with pytest.raises(FileNotFoundError):
            cli_main(["--device", "cpu", "--data-path",
                      str(tmp_path / "d")] + argv)
        return
    model = Captioner(tiny_cfg.model, device="cpu")
    f, p, c = make_fake_batch(tiny_cfg, batch=2)
    extractor = _tiny_extractor()
    canvases = np.full((1, 64, 64, 3), 114, np.uint8)
    metas = np.array([[1.0, 0.0, 0.0]], np.float32)
    sizes = np.array([[64.0, 64.0]], np.float32)
    calls = {
        "greedy_decode": lambda **kw: TD.greedy_decode(model, f, p, **kw),
        "beam_search": lambda **kw: TD.beam_search(model, f, p, beam_size=2,
                                                   **kw),
        "decode_split": lambda **kw: decode_split(
            model, tiny_cfg, CocoSplit(f, p, c, np.arange(2),
                                       np.array(["a", "b"])), 2,
            {i: str(i) for i in range(tiny_cfg.model.num_vocab)}, **kw),
        "caption_images": lambda **kw: caption_images(
            tiny_cfg, [], model, {}, extractor_params=extractor, **kw),
        "stream_extracted_batches": lambda **kw: list(
            stream_extracted_batches([], extractor_params=extractor, **kw)),
        "extract_features_batch": lambda **kw: TP.extract_features_batch(
            extractor, canvases, metas, sizes, num_objects=4, crop_size=32,
            **kw),
        "extract_features_roi": lambda **kw: TP.extract_features_roi(
            extractor, canvases, metas, sizes, num_objects=4, trunk_size=32,
            **kw),
        "extract_single_image": lambda **kw: TP.extract_single_image(
            _jpeg(tmp_path), num_objects=4, **kw),
        "make_mesh": lambda **kw: TMESH.make_mesh(
            [kw["device"]] if kw else None),
        "extract_features_sharded": lambda **kw: TP.extract_features_sharded(
            TMESH.make_mesh([kw["device"]] * 2 if kw else None), extractor,
            np.concatenate([canvases] * 2), np.concatenate([metas] * 2),
            np.concatenate([sizes] * 2), num_objects=4, crop_size=32),
        "run_etl": lambda **kw: run_etl(
            tiny_cfg.with_overrides(**{
                "data.data_path": str(tmp_path / "data")}),
            coco_root=_coco_root(tmp_path), splits=["train"],
            batch_size=1, extractor_params=extractor, **kw),
    }
    if entry == "extract_single_image":
        # the extractor it would load: the tiny one, not random YOLOv5x
        for dev in ("cpu", "cuda"):
            TP._EXTRACTORS[(None, dev)] = extractor
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            calls[entry]()
        calls[entry](device="cpu")
    finally:
        TP._EXTRACTORS.clear()


def _jpeg(directory, name="im.jpg", size=(40, 56)):
    from PIL import Image
    path = os.path.join(str(directory), name)
    Image.fromarray(np.random.RandomState(0).randint(
        0, 256, size + (3,), np.uint8)).save(path)
    return path


def _coco_root(directory) -> str:
    """A COCO tree of one train image with one caption."""
    import json
    root = os.path.join(str(directory), "coco")
    os.makedirs(os.path.join(root, "image", "train2017"), exist_ok=True)
    os.makedirs(os.path.join(root, "annotations"), exist_ok=True)
    _jpeg(os.path.join(root, "image", "train2017"), "a.jpg")
    with open(os.path.join(root, "annotations", "captions_train2017.json"),
              "w") as f:
        json.dump({"images": [{"id": 1, "file_name": "a.jpg"}],
                   "annotations": [{"image_id": 1,
                                    "caption": "A dog."}]}, f)
    return root
