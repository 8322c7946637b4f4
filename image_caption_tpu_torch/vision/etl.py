"""The offline dataset build (the ``features`` verb) and the host-to-device
extraction stream that it and serving run on.

The counterpart of the JAX package's ``vision/etl.py`` on one GPU.  It
writes the reference ETL's artifacts (``features.py:16-119``): caption
pickles, the vocabulary, references, the CIDEr document frequencies of the
validation corpus and the feature arrays.  Weights load once; host threads
(or the native loader's C++ threads) decode and letterbox batch k+1 while
the card extracts batch k, and batch k-1 is copied back meanwhile.

Caption processing (``process_caption_data``, core/preprocess.py:224-281):
COCO captions JSON -> (caption, image_id, file_name) records sorted by
image_id, cleaned, tokenized, and dropped if longer than ``max_length``.
val2017 is split 50/50 into valid/test (features.py:40-47).

Extraction is crash-resumable in shards, and every shard and every final
feature file carries a fingerprint of what produced it (the extraction
options, the image list and a digest of the extractor's weights), so a
changed configuration re-extracts instead of mixing features.  The digest
reads the port's tensor layout (OIHW convolutions), not the JAX package's
(HWIO), so a data directory the JAX package wrote does not match and is
re-extracted: safe, and never mixed.
"""

from __future__ import annotations

import hashlib
import json
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data.tokenizer import clean_caption, tokenize_caption
from ..data.vocab import build_caption_vector, build_vocab
from ..utils.device import DeviceLike, resolve_device
from ..utils.io import load_pickle, open_hkl, save_array, save_pickle
from .loader import load_letterboxed_batch
from .pipeline import (FRCNN_CANVAS, ExtractorParams, FrcnnExtractorParams,
                       extract_features_batch, extract_features_frcnn,
                       extract_features_roi, load_extractor,
                       load_frcnn_extractor, validate_feature_mode)

CANVAS = 640
AnyExtractor = Union[ExtractorParams, FrcnnExtractorParams]


# ---------------------------------------------------------------------------
# Caption ETL (host only)
# ---------------------------------------------------------------------------

def process_caption_data(caption_file: str, image_dir: str,
                         max_length: int = 49) -> List[Dict]:
    """COCO captions JSON -> records [{caption, image_id, file_name}],
    sorted by image_id, length-filtered (core/preprocess.py:224-281)."""
    with open(caption_file) as f:
        coco = json.load(f)
    id_to_file = {img["id"]: os.path.join(image_dir, img["file_name"])
                  for img in coco["images"]}
    records = []
    for ann in coco["annotations"]:
        caption = clean_caption(ann["caption"].replace("\n", " ")).lower()
        if len(tokenize_caption(ann["caption"])) > max_length:
            continue
        records.append({"caption": caption,
                        "image_id": ann["image_id"],
                        "file_name": id_to_file[ann["image_id"]]})
    records.sort(key=lambda r: r["image_id"])
    return records


def build_file_names(records: Sequence[Dict]
                     ) -> Tuple[np.ndarray, Dict[int, int]]:
    """Unique file names per image_id in first-seen order + id->dense index
    (core/preprocess.py:348-360)."""
    file_names, id_index = [], {}
    for r in records:
        if r["image_id"] not in id_index:
            id_index[r["image_id"]] = len(file_names)
            file_names.append(r["file_name"])
    return np.asarray(file_names), id_index


def build_image_indices(records: Sequence[Dict],
                        id_index: Dict[int, int]) -> np.ndarray:
    """Per-caption dense image index (core/preprocess.py:363-373)."""
    return np.asarray([id_index[r["image_id"]] for r in records],
                      dtype=np.int64)


def build_references(records: Sequence[Dict]) -> Dict[int, List[str]]:
    """Per-image reference captions ``caption.lower() + ' .'`` keyed by
    dense index (features.py:69-83)."""
    refs: Dict[int, List[str]] = {}
    seen: Dict[int, int] = {}
    for r in records:
        if r["image_id"] not in seen:
            seen[r["image_id"]] = len(refs)
            refs[seen[r["image_id"]]] = []
        refs[seen[r["image_id"]]].append(r["caption"].lower() + " .")
    return refs


# ---------------------------------------------------------------------------
# Image feature extraction (host loading + device batches)
# ---------------------------------------------------------------------------

def stream_extracted_batches(
        image_paths: Sequence[str], *,
        extractor_params: Optional[AnyExtractor] = None,
        weights_dir: Optional[str] = None, num_objects: int = 36,
        max_obj: Optional[int] = None, batch_size: int = 128,
        num_workers: int = 8, image_model: str = "YOLOv5",
        rect_letterbox: bool = False, feature_mode: str = "crop",
        roi_trunk_size: int = 448, roi_detect_size: Optional[int] = 320,
        skip_errors: bool = False, use_kernel: bool = True,
        compute_dtype=torch.bfloat16, device: DeviceLike = None
) -> Iterator[Tuple[int, int, List[int], torch.Tensor, torch.Tensor]]:
    """Yield ``(start, real, failed, feats, poss)`` per ``batch_size``
    chunk of ``image_paths``: ``real`` rows of the padded batch are images,
    ``failed`` lists the batch-relative rows that could not be read (only
    with ``skip_errors``; they hold a gray canvas), and ``feats``
    [B, S, 2048] / ``poss`` [B, S, 84] (95 for Faster R-CNN) stay on
    ``device`` (the card unless told otherwise) without a wait.
    ``feature_mode`` "crop" encodes every box (ResNet through kernel #4
    with ``use_kernel``), "roi" pools a shared trunk at ``roi_trunk_size``
    and detects at ``roi_detect_size``.  ``image_model="FasterRCNN"``
    loads square 800-px canvases (``rect_letterbox`` does not apply) and
    extracts with ``extract_features_frcnn`` in float32 (``max_obj`` and
    ``compute_dtype`` do not apply), as the JAX package does.  Extractor
    weights load from ``weights_dir`` (random when absent) unless
    ``extractor_params`` (``FrcnnExtractorParams`` for Faster R-CNN) are
    given."""
    validate_feature_mode(feature_mode, image_model,
                          roi_trunk_size=roi_trunk_size,
                          roi_detect_size=roi_detect_size)
    device = resolve_device(device)
    frcnn = image_model == "FasterRCNN"
    canvas_size = FRCNN_CANVAS if frcnn else CANVAS
    rect = rect_letterbox and not frcnn
    if extractor_params is None:
        extractor_params = (load_frcnn_extractor if frcnn else
                            load_extractor)(weights_dir, device=device)

    # two pools: decodes fan out on io_pool while batch_pool's one thread
    # runs load_batch itself (one pool would deadlock at num_workers=1)
    io_pool = ThreadPoolExecutor(max(1, num_workers))
    batch_pool = ThreadPoolExecutor(1)

    def load_batch(start):
        paths = image_paths[start:start + batch_size]
        failed: List[int] = []
        if skip_errors:
            canvases, metas, sizes, ok = load_letterboxed_batch(
                paths, canvas_size, rect=rect, nthreads=num_workers,
                io_pool=io_pool, return_ok=True)
            failed = np.nonzero(~ok)[0].tolist()
        else:
            canvases, metas, sizes = load_letterboxed_batch(
                paths, canvas_size, rect=rect, nthreads=num_workers,
                io_pool=io_pool)
        real = len(paths)
        if real < batch_size:                    # pad to the static shape
            reps = batch_size - real
            canvases = np.concatenate([canvases,
                                       np.repeat(canvases[:1], reps, 0)])
            metas = np.concatenate([metas, np.repeat(metas[:1], reps, 0)])
            sizes = np.concatenate([sizes, np.repeat(sizes[:1], reps, 0)])
        return canvases, metas, sizes, real, failed

    def extract(canvases, metas, sizes):
        if frcnn:
            return extract_features_frcnn(
                extractor_params, canvases, metas, sizes,
                num_objects=num_objects, canvas=canvas_size,
                use_kernel=use_kernel, device=device)
        kw = dict(num_objects=num_objects, max_obj=max_obj,
                  compute_dtype=compute_dtype, device=device)
        if feature_mode == "roi":
            return extract_features_roi(
                extractor_params, canvases, metas, sizes,
                trunk_size=roi_trunk_size, detect_size=roi_detect_size,
                **kw)
        return extract_features_batch(extractor_params, canvases, metas,
                                      sizes, use_kernel=use_kernel, **kw)

    starts = list(range(0, len(image_paths), batch_size))
    try:
        pending = batch_pool.submit(load_batch, starts[0]) if starts else None
        for i, start in enumerate(starts):
            canvases, metas, sizes, real, failed = pending.result()
            if i + 1 < len(starts):
                pending = batch_pool.submit(load_batch, starts[i + 1])
            feats, poss, _ = extract(torch.from_numpy(canvases),
                                     torch.from_numpy(metas),
                                     torch.from_numpy(sizes))
            yield start, real, failed, feats, poss
    finally:
        batch_pool.shutdown()
        io_pool.shutdown()


def extract_split_features(image_paths: Sequence[str], *,
                           num_position_dims: int = 84,
                           verbose: bool = True,
                           **kwargs) -> Tuple[np.ndarray, np.ndarray]:
    """All images of a split -> ([N, S, 2048], [N, S, P]) float32 arrays.

    Drains :func:`stream_extracted_batches` (same keyword options) one
    batch behind: batch k-1 is copied to the host while the card runs
    batch k and host threads load batch k+1."""
    n = len(image_paths)
    s = kwargs.get("num_objects", 36) + 1
    all_feats = np.zeros((n, s, 2048), np.float32)
    all_pos = np.zeros((n, s, num_position_dims), np.float32)

    def drain(pending):
        start, real, feats, poss = pending
        all_feats[start:start + real] = feats[:real].cpu().numpy()
        all_pos[start:start + real] = \
            poss[:real, :, :num_position_dims].cpu().numpy()

    pending = None
    for i, (start, real, _, feats, poss) in enumerate(
            stream_extracted_batches(image_paths, **kwargs)):
        if pending is not None:
            drain(pending)             # the previous batch: the card is on
        pending = (start, real, feats, poss)
        if verbose and i % 10 == 0:
            print(f"[etl] {start + real}/{n} images")
    if pending is not None:
        drain(pending)
    return all_feats, all_pos


def _named_leaves(tree, prefix: str = ""):
    """(dotted name, leaf) pairs of nested dicts, named tuples and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif hasattr(tree, "_asdict"):
        items = tree._asdict().items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for key, value in items:
        yield from _named_leaves(value, f"{prefix}.{key}" if prefix
                                 else str(key))


def _params_digest(params) -> Optional[str]:
    """Cheap content fingerprint of the extractor's weights: the tensor
    count, and the shape, dtype and first 64 values of about 16 tensors
    sampled in sorted-name order.  Tells random smoke weights from a
    checkpoint (and one checkpoint from another) without hashing hundreds
    of MB: each sampled tensor is sliced on its device before the copy.
    The bytes follow the port's layouts, so they differ from the JAX
    package's digest of the same checkpoint."""
    if params is None:
        return None
    leaves = [leaf for _, leaf in sorted(_named_leaves(params),
                                         key=lambda kv: kv[0])]
    h = hashlib.sha1()
    h.update(str(len(leaves)).encode())
    stride = max(1, len(leaves) // 16)
    for leaf in leaves[::stride][:16]:
        t = torch.as_tensor(leaf)
        head = t.reshape(-1)[:64].float().cpu().numpy()
        h.update(str((tuple(t.shape), str(t.dtype))).encode())
        h.update(np.ascontiguousarray(head).tobytes())
    return h.hexdigest()


# kwargs that do not change the features: the weights enter as a digest,
# and the batch size, device and ResNet route compute the same function
_FINGERPRINT_EXEMPT = ("extractor_params", "batch_size", "device",
                       "use_kernel")


def extraction_fingerprint(image_paths: Sequence[str], kwargs: Dict) -> Dict:
    """Semantic fingerprint of one extraction run: every other kwarg
    (feature_mode, max_obj, rect_letterbox, roi sizes, image_model,
    compute_dtype by its name, ...), the extractor's weights (a crash with
    random smoke weights resumed after installing real checkpoints must
    re-extract) and the image-path list (the same count of other images
    would misalign rows).  A kwarg that is no plain value raises
    ``TypeError``: dropping it silently could mix shards of two
    configurations."""
    fp = {}
    for k, v in sorted(kwargs.items()):
        if k in _FINGERPRINT_EXEMPT:
            continue
        if isinstance(v, torch.dtype):
            fp[k] = str(v).replace("torch.", "")
        elif isinstance(v, (int, float, str, bool, type(None))):
            fp[k] = v
        elif (isinstance(v, (tuple, list)) and all(
                isinstance(e, (int, float, str, bool, type(None)))
                for e in v)):
            fp[k] = repr(list(v))
        else:
            raise TypeError(
                f"extraction kwarg {k}={v!r} ({type(v).__name__}) cannot "
                "be fingerprinted; pass a plain int/float/str/bool/None "
                "(or a flat tuple of those), or exempt it here if it is "
                "provably result-invariant")
    fp["image_paths_sha1"] = hashlib.sha1(
        "\x00".join(map(str, image_paths)).encode()).hexdigest()
    params_fp = _params_digest(kwargs.get("extractor_params"))
    if params_fp is not None:
        fp["extractor_params_sha1"] = params_fp
    return fp


def extract_split_features_resumable(image_paths: Sequence[str], *,
                                     out_dir: str, split: str,
                                     shard_images: int = 4096,
                                     resume: bool = True,
                                     extract_fn=None,
                                     verbose: bool = True,
                                     **kwargs
                                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Shard-checkpointed extraction (crash-resumable).

    Every ``shard_images`` images are extracted and written atomically to
    ``{out_dir}/shards/{split}.{k:05d}.npz``, and a manifest records the
    completed shards; a re-run with ``resume=True`` skips them.  The
    manifest is invalidated when the image count, the shard size or the
    extraction fingerprint changes: crop- and roi-mode features have one
    shape but are not interchangeable.  Returns the assembled (features,
    positions); the caller removes the shards once the final artifacts
    are written (:func:`run_etl` does)."""
    extract = extract_fn or extract_split_features
    shard_dir = os.path.join(out_dir, "shards")
    os.makedirs(shard_dir, exist_ok=True)
    manifest_path = os.path.join(shard_dir, f"{split}.manifest.json")
    config_fp = extraction_fingerprint(image_paths, kwargs)

    n = len(image_paths)
    done: set = set()
    if resume and os.path.exists(manifest_path):
        with open(manifest_path) as f:
            old = json.load(f)
        if old.get("num_images") == n and \
                old.get("shard_images") == shard_images and \
                old.get("config") == config_fp:
            done = set(old.get("done", []))
        elif verbose:
            print(f"[etl] {split}: shard manifest stale "
                  f"(images {old.get('num_images')}->{n}, shard size, or "
                  f"extraction config {old.get('config')}->{config_fp} "
                  f"changed) — re-extracting")

    def shard_path(k):
        return os.path.join(shard_dir, f"{split}.{k:05d}.npz")

    starts = list(range(0, n, shard_images))
    for k, start in enumerate(starts):
        if k in done and os.path.exists(shard_path(k)):
            continue
        feats, poss = extract(image_paths[start:start + shard_images],
                              verbose=verbose, **kwargs)
        tmp = shard_path(k) + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, features=feats, positions=poss)
        os.replace(tmp, shard_path(k))
        done.add(k)
        mtmp = manifest_path + ".tmp"
        with open(mtmp, "w") as f:
            json.dump({"num_images": n, "shard_images": shard_images,
                       "config": config_fp, "done": sorted(done)}, f)
        os.replace(mtmp, manifest_path)
        if verbose:
            print(f"[etl] {split}: shard {k + 1}/{len(starts)} "
                  f"checkpointed ({min(start + shard_images, n)}/{n})")

    all_feats = all_poss = None
    for k, start in enumerate(starts):
        with np.load(shard_path(k)) as z:
            f, p = z["features"], z["positions"]
        if all_feats is None:
            all_feats = np.zeros((n,) + f.shape[1:], f.dtype)
            all_poss = np.zeros((n,) + p.shape[1:], p.dtype)
        all_feats[start:start + len(f)] = f
        all_poss[start:start + len(p)] = p
    return all_feats, all_poss


def _clean_shards(out_dir: str, split: str) -> None:
    shard_dir = os.path.join(out_dir, "shards")
    if not os.path.isdir(shard_dir):
        return
    for name in os.listdir(shard_dir):
        if name.startswith(f"{split}."):
            os.remove(os.path.join(shard_dir, name))
    if not os.listdir(shard_dir):
        os.rmdir(shard_dir)


def _feature_shape(path: str) -> Tuple[int, ...]:
    """The shape of a feature file, ``.npy`` or hickle, without reading
    its rows."""
    if path.endswith(".npy"):
        return np.load(path, mmap_mode="r").shape
    ds = open_hkl(path)
    try:
        return tuple(ds.shape)
    finally:
        ds.close()


# ---------------------------------------------------------------------------
# The whole build
# ---------------------------------------------------------------------------

def run_etl(cfg: Config, *, coco_root: str,
            splits: Sequence[str] = ("train", "valid", "test"),
            batch_size: int = 128, weights_dir: Optional[str] = None,
            extractor_params: Optional[AnyExtractor] = None,
            feature_format: str = "hkl",
            device: DeviceLike = None) -> None:
    """features.py:16-119 against a standard COCO tree:
    ``{coco_root}/annotations/captions_{train,val}2017.json`` and
    ``{coco_root}/image/{train,val}2017/``, into ``cfg.data.data_path``.

    Extraction runs on ``device`` (the card unless told otherwise) with
    ResNet-101's identity runs through kernel #4: YOLOv5 in bf16 (crop or
    roi mode), Faster R-CNN in float32 (``data.image_model``), with
    ``extractor_params`` or the weights of ``weights_dir`` (random when
    absent).  The feature arrays
    are ``{split}.features.{feature_format}`` and
    ``{split}.positions.{feature_format}``: hickle (``hkl``, needs
    ``h5py``) as the reference writes, or ``npy``; the dataset loader
    reads either.  A split whose feature file exists with the rows and the
    fingerprint of this run is not extracted again."""
    if feature_format not in ("hkl", "npy"):
        raise ValueError(f"feature_format is 'hkl' or 'npy', not "
                         f"{feature_format!r}")
    d = cfg.data
    validate_feature_mode(d.feature_mode, d.image_model,
                          roi_trunk_size=d.roi_trunk_size,
                          roi_detect_size=d.roi_detect_size)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1 or (
            torch.distributed.is_available()
            and torch.distributed.is_initialized()):
        # every process would extract every split and race the same
        # shard and artifact files; refuse on every process instead
        raise RuntimeError(
            "the features ETL is single-host work: run it as a "
            "single-process job (no torch.distributed launcher), then "
            "train against the written artifacts")
    device = resolve_device(device)
    max_len = d.max_caption_words

    ann_cache = os.path.join(d.data_path, "annotations")
    os.makedirs(ann_cache, exist_ok=True)

    def cached(split, make):
        path = os.path.join(ann_cache, f"{split}.annotations.pkl")
        if os.path.exists(path):
            return load_pickle(path)
        records = make()
        save_pickle(records, path)
        return records

    train_records = cached("train", lambda: process_caption_data(
        os.path.join(coco_root, "annotations/captions_train2017.json"),
        os.path.join(coco_root, "image/train2017/"), max_len))

    if "valid" in splits or "test" in splits:
        vpath = os.path.join(ann_cache, "valid.annotations.pkl")
        tpath = os.path.join(ann_cache, "test.annotations.pkl")
        if os.path.exists(vpath) and os.path.exists(tpath):
            valid_records = load_pickle(vpath)
            test_records = load_pickle(tpath)
        else:
            val = process_caption_data(
                os.path.join(coco_root, "annotations/captions_val2017.json"),
                os.path.join(coco_root, "image/val2017/"), max_len)
            cut = int(0.5 * len(val))              # features.py:41-47
            valid_records, test_records = val[:cut], val[cut:]
            save_pickle(valid_records, vpath)
            save_pickle(test_records, tpath)

    records_by_split = {"train": train_records}
    if "valid" in splits:
        records_by_split["valid"] = valid_records
    if "test" in splits:
        records_by_split["test"] = test_records

    word_index = None
    extractor = extractor_params if extractor_params is not None else (
        load_frcnn_extractor if d.image_model == "FasterRCNN" else
        load_extractor)(weights_dir, device=device)

    for split in splits:
        records = records_by_split[split]
        out_dir = os.path.join(d.data_path, split)
        os.makedirs(out_dir, exist_ok=True)

        if split == "train":
            word_index = build_vocab([r["caption"] for r in records],
                                     threshold=d.word_count_threshold)
            save_pickle(word_index, d.word_to_idx_path)
        elif word_index is None:
            # valid/test against an earlier train pass: its vocabulary
            if not os.path.exists(d.word_to_idx_path):
                raise FileNotFoundError(
                    f"no vocabulary at {d.word_to_idx_path}; run the "
                    "train split first")
            word_index = load_pickle(d.word_to_idx_path)

        captions = build_caption_vector([r["caption"] for r in records],
                                        word_index, max_length=max_len)
        save_pickle(captions, os.path.join(out_dir,
                                           f"{split}.captions.pkl"))
        file_names, id_index = build_file_names(records)
        save_pickle(file_names, os.path.join(out_dir,
                                             f"{split}.file.names.pkl"))
        save_pickle(build_image_indices(records, id_index),
                    os.path.join(out_dir, f"{split}.image.indices.pkl"))
        references = build_references(records)
        save_pickle(references,
                    os.path.join(out_dir, f"{split}.references.pkl"))
        if split == "valid":
            # the frozen CIDEr df of the validation corpus, which the RL
            # scorers load from {data_path}/coco-val-df.p (loss.py:112-116)
            from ..metrics.cider import (build_doc_frequency,
                                         save_doc_frequency)
            save_doc_frequency(build_doc_frequency(references.values()),
                               os.path.join(d.data_path, "coco-val-df.p"))
            print("[etl] valid: coco-val-df.p written")
        print(f"[etl] {split}: caption artifacts written")

        ex_kwargs = dict(
            extractor_params=extractor,
            num_objects=cfg.model.num_objects, max_obj=d.max_obj,
            batch_size=batch_size, image_model=d.image_model,
            rect_letterbox=d.rect_letterbox, feature_mode=d.feature_mode,
            roi_trunk_size=d.roi_trunk_size,
            roi_detect_size=d.roi_detect_size,
            num_position_dims=cfg.model.dim_positions,
            compute_dtype=torch.bfloat16, use_kernel=True, device=device)
        fp = extraction_fingerprint(list(file_names), ex_kwargs)

        feats_path = os.path.join(out_dir,
                                  f"{split}.features.{feature_format}")
        pos_path = os.path.join(out_dir,
                                f"{split}.positions.{feature_format}")
        meta_path = os.path.join(out_dir, f"{split}.features.meta.json")
        if os.path.exists(feats_path) and os.path.exists(pos_path):
            # a completed split survives a later crash: skip it when its
            # rows match the caption artifacts and its stored fingerprint
            # matches this run's (delete the files to force)
            shape = _feature_shape(feats_path)
            rows = shape[0]
            stored_fp = None
            if os.path.exists(meta_path):
                with open(meta_path) as f:
                    stored_fp = json.load(f).get("fingerprint")
            if rows == len(file_names) and stored_fp == fp:
                print(f"[etl] {split}: features {shape} already on disk, "
                      "fingerprint matches — skipping extraction (delete "
                      "the feature files to force)")
                continue
            if rows == len(file_names) and stored_fp is None:
                print(f"[etl] {split}: features {shape} already on disk "
                      "(no fingerprint recorded; config and weights "
                      "changes are NOT detected; delete the feature files "
                      "to force) — skipping extraction")
                continue
            print(f"[etl] {split}: stale features on disk "
                  + (f"({rows} rows vs {len(file_names)} images)"
                     if rows != len(file_names)
                     else "(extraction config/weights changed)")
                  + " — re-extracting")

        feats, poss = extract_split_features_resumable(
            list(file_names), out_dir=out_dir, split=split, **ex_kwargs)
        save_array(feats, feats_path)
        save_array(poss, pos_path)
        with open(meta_path + ".tmp", "w") as f:
            json.dump({"fingerprint": fp}, f)
        os.replace(meta_path + ".tmp", meta_path)
        _clean_shards(out_dir, split)
        print(f"[etl] {split}: features {feats.shape} saved")
