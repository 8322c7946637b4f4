"""Data-parallel extraction and serving over a single-process mesh of
two CPU devices: ``extract_features_sharded`` against
``extract_features_batch`` / ``extract_features_roi`` and the JAX
package's ``extract_features_sharded`` on 2 devices, and
``caption_images`` with a mesh against the JAX package's captions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from image_caption_tpu.parallel import mesh as JM
from image_caption_tpu.vision import pipeline as JP
from image_caption_tpu_torch import serve as TS
from image_caption_tpu_torch.parallel import mesh as TM
from image_caption_tpu_torch.vision import etl as TE
from image_caption_tpu_torch.vision import pipeline as TP

from test_torch_caption import cfg, jax_captions, setup  # noqa: F401
from test_torch_pipeline import _compare, _square


def _four_images():
    parts = [_square(0), _square(1)]
    return tuple(np.concatenate(x) for x in zip(*parts))


def test_extract_features_sharded_matches_batch_and_jax(setup):  # noqa: F811
    _, jp, tp = setup[:3]
    canv, metas, sizes = _four_images()
    kw = dict(num_objects=8, crop_size=64)
    tmesh = TM.make_mesh(["cpu", "cpu"])
    got = TP.extract_features_sharded(tmesh, tp, canv, metas, sizes,
                                      compute_dtype=torch.float32, **kw)
    whole = TP.extract_features_batch(tp, canv, metas, sizes,
                                      compute_dtype=torch.float32,
                                      device="cpu", **kw)
    for a, b in zip(got, whole):
        assert torch.equal(a, b)
    want = JP.extract_features_sharded(
        JM.make_mesh(jax.devices()[:2]), jp, jnp.asarray(canv),
        jnp.asarray(metas), jnp.asarray(sizes), compute_dtype=jnp.float32,
        **kw)
    _compare(got, want)
    with pytest.raises(ValueError, match="not divisible"):
        TP.extract_features_sharded(TM.make_mesh(["cpu"] * 3), tp, canv,
                                    metas, sizes, **kw)
    with pytest.raises(ValueError, match="feature_mode"):
        TP.extract_features_sharded(tmesh, tp, canv, metas, sizes,
                                    feature_mode="ROI", **kw)


def test_extract_features_sharded_roi_matches_unsharded(setup):  # noqa: F811
    tp = setup[2]
    canv, metas, sizes = _four_images()
    kw = dict(num_objects=8, trunk_size=64, detect_size=64,
              compute_dtype=torch.float32)
    got = TP.extract_features_sharded(TM.make_mesh(["cpu", "cpu"]), tp,
                                      canv, metas, sizes,
                                      feature_mode="roi", **kw)
    want = TP.extract_features_roi(tp, canv, metas, sizes, device="cpu",
                                   **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("beam", [None, 2])
def test_caption_images_over_a_mesh_match_jax(beam, cfg, setup,  # noqa: F811
                                              jax_captions):  # noqa: F811
    """Extraction and decode split each batch of 2 over two devices, with
    the extractor and the captioner replicated per device."""
    paths, _, tx, _, tc, idx_to_word = setup
    mesh = TM.make_mesh(["cpu", "cpu"])
    got = TS.caption_images(cfg, paths, tc, idx_to_word, extractor_params=tx,
                            beam_size=beam, batch_size=2, num_workers=2,
                            compute_dtype=torch.float32, device="cpu",
                            mesh=mesh)
    assert got == jax_captions[beam]
    with pytest.raises(ValueError, match="one process"):
        TS.caption_images(cfg, paths, tc, idx_to_word, extractor_params=tx,
                          device="cpu", mesh=TM.Mesh((torch.device("cpu"),),
                                                     2, 1, object()))


@pytest.mark.parametrize("model,device,cards,batch,sharded", [
    ("YOLOv5", "cuda", 2, 64, True), ("YOLOv5", "cuda", 4, 64, True),
    ("YOLOv5", "cuda", 1, 64, False), ("YOLOv5", "cuda", 3, 64, False),
    ("YOLOv5", "cuda:1", 2, 64, False), ("YOLOv5", "cpu", 2, 64, False),
    ("FasterRCNN", "cuda", 2, 64, False)])
def test_run_etl_shards_as_the_jax_etl_does(model, device, cards, batch,
                                            sharded, monkeypatch):
    """YOLOv5 on the card, more than one card, one process and a batch
    they divide (JAX ``vision/etl.py:534-545``)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(TE, "make_mesh", lambda: "every card")
    got = TE.extraction_mesh(model, torch.device(device), batch)
    assert got == ("every card" if sharded else None)


def test_extraction_fingerprint_leaves_the_mesh_out():
    kw = {"num_objects": 36, "feature_mode": "crop", "batch_size": 4}
    paths = ["a.jpg", "b.jpg"]
    assert TE.extraction_fingerprint(paths, dict(kw, mesh=object())) == \
        TE.extraction_fingerprint(paths, kw)
