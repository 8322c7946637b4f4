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
from image_caption_tpu_torch.serve import decode_split

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


def test_presets_equal_the_jax_package():
    assert TCFG.list_presets() == JCFG.list_presets()
    for name in JCFG.list_presets():
        assert dataclasses.asdict(TCFG.get_preset(name)) == \
            dataclasses.asdict(JCFG.get_preset(name)), name
    for token in ("NULL", "START", "END", "UNK"):
        assert getattr(TCFG, f"{token}_TOKEN") == \
            getattr(JCFG, f"{token}_TOKEN")
        assert getattr(TCFG, f"{token}_IDX") == getattr(JCFG, f"{token}_IDX")


def test_overrides_equal_the_jax_package():
    overrides = {"model.num_vocab": 50, "model.max_length": 13,
                 "train.batch_size": 4, "caption_model": "Transformer"}
    name = "RL_maxlen49_36obj_1wordCount_256_25b_32h_split_img_obj"
    assert dataclasses.asdict(
        TCFG.get_preset(name).with_overrides(**overrides)) == \
        dataclasses.asdict(JCFG.get_preset(name).with_overrides(**overrides))


def test_bad_model_config_raises():
    with pytest.raises(ValueError):
        TCFG.ModelConfig(encode_num_heads=7)
    with pytest.raises(ValueError):
        TCFG.ModelConfig(compute_dtype="float16")
    with pytest.raises(KeyError):
        TCFG.get_preset("no_such_preset")


@pytest.fixture()
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", ["Captioner", "greedy_decode",
                                   "beam_search", "decode_split"])
def test_entry_points_need_cuda_unless_told_cpu(entry, tiny_cfg, no_cuda):
    if entry == "Captioner":
        with pytest.raises(RuntimeError, match="CUDA"):
            Captioner(tiny_cfg.model)
        return
    model = Captioner(tiny_cfg.model, device="cpu")
    f, p, c = make_fake_batch(tiny_cfg, batch=2)
    calls = {
        "greedy_decode": lambda **kw: TD.greedy_decode(model, f, p, **kw),
        "beam_search": lambda **kw: TD.beam_search(model, f, p, beam_size=2,
                                                   **kw),
        "decode_split": lambda **kw: decode_split(
            model, tiny_cfg, CocoSplit(f, p, c, np.arange(2),
                                       np.array(["a", "b"])), 2,
            {i: str(i) for i in range(tiny_cfg.model.num_vocab)}, **kw),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()
    calls[entry](device="cpu")
