"""The port's copies of the metrics, the tokenizer and the vocabulary
builders against the JAX package's: equal results on fixed captions."""

import importlib
import json
import os
import pickle

import numpy as np
import pytest

from image_caption_tpu.data import tokenizer as JT
from image_caption_tpu.data import vocab as JV
from image_caption_tpu.metrics import bleu as JB
from image_caption_tpu.metrics import cider as JCI
from image_caption_tpu.metrics import meteor_native as JMN
from image_caption_tpu.metrics import rouge as JR
from image_caption_tpu_torch.data import tokenizer as TT
from image_caption_tpu_torch.data import vocab as TV
from image_caption_tpu_torch.metrics import bleu as TB
from image_caption_tpu_torch.metrics import cider as TCI
from image_caption_tpu_torch.metrics import evaluate as TE
from image_caption_tpu_torch.metrics import meteor_native as TMN
from image_caption_tpu_torch.metrics import rouge as TR

# the JAX package's metrics/__init__ exports a function named evaluate
JE = importlib.import_module("image_caption_tpu.metrics.evaluate")
HERE = os.path.dirname(os.path.abspath(__file__))


def _corpus():
    with open(os.path.join(HERE, "fixtures", "metric_corpus.json")) as f:
        d = json.load(f)
    refs = {int(k): v for k, v in d["references"].items()}
    hypo = {int(k): v for k, v in d["candidates"].items()}
    return refs, hypo


def test_score_captions_equals_jax(monkeypatch):
    monkeypatch.delenv("ICX_METEOR_JAR", raising=False)
    refs, hypo = _corpus()
    want = JE.score_captions(refs, hypo, verbose=False)
    got = TE.score_captions(refs, hypo, verbose=False)
    assert got == want
    assert {"BLEU_4", "METEOR", "ROUGE_L", "CIDEr", "CIDEr-D"} <= set(got)
    assert all(TE.is_scalar_score(got[k]) for k in ("BLEU_4", "CIDEr"))
    assert not TE.is_scalar_score(got["METEOR_backend"])


@pytest.mark.parametrize("pair", [
    (JB.Bleu(4), TB.Bleu(4)), (JR.Rouge(), TR.Rouge()),
    (JCI.Cider(), TCI.Cider()), (JCI.CiderD(), TCI.CiderD())],
    ids=["bleu", "rouge", "cider", "ciderd"])
def test_each_scorer_equals_jax_per_caption(pair):
    refs, hypo = _corpus()
    (jw, js), (tw, ts) = (s.compute_score(gts=refs, res=hypo) for s in pair)
    assert tw == jw
    np.testing.assert_array_equal(np.asarray(ts), np.asarray(js))


def test_doc_frequency_blob_equals_jax(tmp_path):
    refs, hypo = _corpus()
    blob_t = TCI.build_doc_frequency(refs.values())
    assert blob_t == JCI.build_doc_frequency(refs.values())
    path = str(tmp_path / "df.p")
    TCI.save_doc_frequency(blob_t, path)
    frozen_t, frozen_j = TCI.CiderD(df=path), JCI.CiderD(df=path)
    assert not frozen_t.df_fallback
    assert frozen_t.compute_score(refs, hypo)[0] == \
        frozen_j.compute_score(refs, hypo)[0]


def test_meteor_without_nltk_runs_exact_only(monkeypatch):
    import builtins
    real_import = builtins.__import__

    def no_nltk(name, *args, **kw):
        if name.split(".")[0] == "nltk":
            raise ImportError("no nltk")
        return real_import(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_nltk)
    scorer = TMN.MeteorNative()
    assert scorer.stages == ["exact"]
    refs, hypo = _corpus()
    score, per = scorer.compute_score(refs, hypo)
    assert 0.0 < score < 1.0 and len(per) == len(hypo)
    # the JAX package's exact-only stage set gives the same number
    monkeypatch.setattr(builtins, "__import__", real_import)
    want, _ = JMN.MeteorNative(stages=("exact",)).compute_score(refs, hypo)
    assert score == want


def _tokenizer_captions():
    with open(os.path.join(HERE, "fixtures", "tokenizer_cases.json")) as f:
        d = json.load(f)
    return [c["caption"] for key in ("verified", "unverified_pinned")
            for c in d.get(key, [])]


def test_tokenizer_equals_jax():
    caps = _tokenizer_captions()
    assert len(caps) > 10
    for cap in caps:
        cleaned = JT.clean_caption(cap).lower()
        assert TT.ptb_tokenize(cleaned) == JT.ptb_tokenize(cleaned), cap
        assert TT.ptb_tokenize(cap) == JT.ptb_tokenize(cap), cap


def test_vocab_builders_equal_jax():
    refs, hypo = _corpus()
    caps = [c for v in refs.values() for c in v] + _tokenizer_captions()
    for threshold in (1, 2):
        want = JV.build_vocab(caps, threshold=threshold)
        got = TV.build_vocab(caps, threshold=threshold)
        assert got == want and list(got) == list(want)
    vocab = JV.build_vocab(caps[:20])
    np.testing.assert_array_equal(
        TV.build_caption_vector(caps, vocab, max_length=40),
        JV.build_caption_vector(caps, vocab, max_length=40))
    with pytest.raises(ValueError, match="max_length"):
        TV.build_caption_vector(caps, vocab, max_length=2)


def test_scores_file_and_sample_text_equal_jax(tmp_path):
    from image_caption_tpu.train import logging as JLOG
    from image_caption_tpu_torch.train import logging as TLOG
    scores = {"BLEU_1": 0.5, "METEOR": "skipped (no jar)", "CIDEr": 1.25}
    for mod, sub in ((JLOG, "jax"), (TLOG, "port")):
        for epoch in (1, 2):
            mod.write_scores(str(tmp_path / sub), "valid", epoch, scores)
    read = [(tmp_path / s / "valid_scores.txt").read_text()
            for s in ("jax", "port")]
    assert read[0] == read[1] and read[1].count("Epoch ") == 2
    assert TLOG.format_sample("a b .", ["c d .", "e ."]) == \
        JLOG.format_sample("a b .", ["c d .", "e ."])


def test_tensorboard_writer_disabled_is_a_no_op(tmp_path):
    from image_caption_tpu_torch.train.logging import TensorBoardWriter
    w = TensorBoardWriter(str(tmp_path / "log"), enabled=False)
    w.write_batch("loss", 1.0, 2.0, 1)
    w.write_epoch("loss", 1.0, 2.0, 1)
    w.write_scalar("x", 1.0, 1)
    w.write_text("sample", "a", 1)
    w.flush()
    w.close()
    assert not (tmp_path / "log").exists()


def test_evaluate_reads_the_reference_layout(tmp_path, capsys):
    refs, hypo = _corpus()
    os.makedirs(tmp_path / "data" / "valid")
    with open(tmp_path / "data" / "valid" / "valid.references.pkl",
              "wb") as f:
        pickle.dump(refs, f)
    cands = [hypo[i][0] for i in range(len(hypo))]
    with open(tmp_path / "valid.candidate.captions.pkl", "wb") as f:
        pickle.dump(cands, f)
    got = TE.evaluate(str(tmp_path), str(tmp_path / "data"), "valid",
                      get_scores=True)
    want = JE.evaluate(str(tmp_path), str(tmp_path / "data"), "valid",
                       get_scores=True)
    assert got == want
    assert "CIDEr" in capsys.readouterr().out
