"""CUB benchmark: caption <-> image factor coherence (counterpart of
``eval/eval_cub.py``).

The reference shows CUB only as reconstruction grids; the JAX package
scores it over the factors of the captions' grammar (size, colour, beak
length, belly colour: the ``data_proc/surrogates.py`` contract), and so
does the port:

* image -> caption: the generated caption must hold the ground truth's
  factor words (share, and all of them: Strict), and CdSprites+'s letter
  accuracy;
* caption -> image: a 6-class colour judge and a 4-head factor judge read
  the generated bird (Feats, Strict);
* joint: a prior sample counts Strict when its caption parses (3 of 4
  factors or more) and the judged image agrees on every parsed factor.

The judges are trained on the run's train split at first use and cached as
``cub_color_clf_v2.pt`` and ``cub_factor_judge_v1.pt`` under
``eval/classifiers/`` (``CUB_CLASSIFIER_DIR`` overrides it).  Last, ``fid``:
the FID of the caption-generated images against the real ones
(``eval/fid.py``, its feature net's label printed), on the run's device.
The JAX package drops the stat when its FID fails; the port does not: a
failing FID fails the eval.  The stats are fractions and ``fid`` a
distance; ``<run>/cub_stats.txt`` holds the fractions as percentages and
``fid`` as it is.

    MultimodalVAEInfer(<run dir>).eval_statistics()    # or Trainer.test()
"""
from __future__ import annotations

import os
from typing import Dict

import numpy as np

from multimodal_vae_comparison_tpu_torch.data import text as text_utils
from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, CNNClassifier, get_or_train_classifier, judge_calibration,
    mods_by_type, predict)

FACTORS = {
    "size": ["small", "large"],
    "color": ["blue", "red", "yellow", "brown", "grey", "white"],
    "beak": ["short", "long"],
    "belly": ["white", "yellow", "orange"],
}
# the stats of cub_eval, in the order of the stats file
STATS_KEYS = ("judge_accuracy_real", "image_to_text_factors", "image_to_text_strict",
              "image_to_text_letters", "text_to_image_color", "judge4_size_accuracy_real",
              "judge4_color_accuracy_real", "judge4_beak_accuracy_real",
              "judge4_belly_accuracy_real", "text_to_image_feats", "text_to_image_strict",
              "joint_feats", "joint_strict", "fid")


def _word_factor(caption: str, factor: str) -> str:
    """A factor's word, taken by its place in the caption grammar, or "".

    'yellow' and 'white' are colours and belly colours both, so a scan of
    the words would read 'a brown bird with a yellow belly' as yellow.  The
    grammar puts the belly and beak adjective just before its noun, and the
    colour just before 'bird' or just after 'is'."""
    words = caption.lower().split()
    vocab = FACTORS[factor]
    if factor in ("belly", "beak"):
        if factor in words:
            i = words.index(factor)
            if i > 0 and words[i - 1] in vocab:
                return words[i - 1]
        return ""
    if factor == "color":
        if "bird" in words:
            i = words.index("bird")
            if i > 0 and words[i - 1] in vocab:
                return words[i - 1]
        for i, w in enumerate(words[:-1]):
            if w == "is" and words[i + 1] in vocab:
                return words[i + 1]
        return ""
    for w in vocab:  # size: its words are no other factor's
        if w in words:
            return w
    return ""


def _color_labels(captions):
    """(colour class ids, valid): a caption with no colour word is marked
    invalid, and the callers drop it, rather than score it as class 0."""
    table = {w: i for i, w in enumerate(FACTORS["color"])}
    words = [_word_factor(c, "color") for c in captions]
    return (np.array([table.get(w, 0) for w in words]),
            np.array([w != "" for w in words], bool))


def _factor_labels(captions):
    """factor -> (class ids, valid) for every factor of the grammar; one
    template has no belly clause, so a factor may be missing."""
    out = {}
    for f, vocab in FACTORS.items():
        table = {w: i for i, w in enumerate(vocab)}
        words = [_word_factor(c, f) for c in captions]
        out[f] = (np.array([table.get(w, 0) for w in words]),
                  np.array([w != "" for w in words], bool))
    return out


def _train_captions(exp, txt_idx):
    tdata, tmask = exp.datamod.split_arrays(txt_idx, "train")
    return text_utils.onehot2text(np.asarray(tdata), np.asarray(tmask))


def _judges(exp, mapping, cache_dir: str):
    """(colour judge, factor judge), each trained on the TRAIN split only
    (the calibration scores the val split): the colour judge 6 epochs at lr
    1e-3 on the rows whose colour parses; the 4-head factor judge (size,
    colour, beak, belly; 6 classes a head, the others using a prefix) 12
    epochs at lr 3e-4 on the rows where every factor parses, or where size
    and colour do when fewer than 10 rows have all four."""
    img_idx = exp.mod_names.index(mapping["image"])
    txt_idx = exp.mod_names.index(mapping["text"])

    def color_data():
        imgs, _ = exp.datamod.split_arrays(img_idx, "train")
        labels, valid = _color_labels(_train_captions(exp, txt_idx))
        return imgs[valid].astype(np.float32), labels[valid]

    def factor_data():
        imgs, _ = exp.datamod.split_arrays(img_idx, "train")
        fl = _factor_labels(_train_captions(exp, txt_idx))
        valid = np.all([v for _, v in fl.values()], axis=0)
        if valid.sum() < 10:
            valid = fl["size"][1] & fl["color"][1]
        labels = np.stack([fl[f][0] for f in FACTORS], 1)   # (N, 4)
        return imgs[valid].astype(np.float32), labels[valid]

    n = len(FACTORS["color"])
    color = get_or_train_classifier(os.path.join(cache_dir, "cub_color_clf_v2.pt"),
                                    CNNClassifier(num_classes=n).to(exp.device),
                                    color_data, epochs=6)
    factors = get_or_train_classifier(os.path.join(cache_dir, "cub_factor_judge_v1.pt"),
                                      CNNClassifier(num_classes=n, heads=4).to(exp.device),
                                      factor_data, epochs=12, lr=3e-4)
    return color, factors


def _judged(pred, fl):
    """(hit, valid) (N, 4) of a factor judge's predictions against the
    factor labels ``fl``."""
    hit, valid = np.zeros_like(pred, bool), np.zeros_like(pred, bool)
    for fi, f in enumerate(FACTORS):
        labels, v = fl[f]
        valid[:, fi] = v
        hit[:, fi] = pred[:, fi] == labels
    return hit, valid


def _feats(hit, valid):
    return np.where(valid, hit, False).sum(1) / np.maximum(valid.sum(1), 1)


def cub_stats(exp) -> Dict[str, float]:
    """The 14 stats of one run (a MultimodalVAEInfer at K = 1) over at most
    400 val rows: 13 fractions, written to ``<run>/cub_stats.txt`` as
    percentages, and the FID."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import count_same_letters
    from multimodal_vae_comparison_tpu_torch.eval.fid import calculate_fid_given_data
    from multimodal_vae_comparison_tpu_torch.utils import print_save_stats
    mapping = mods_by_type(exp)
    color_judge, judge4 = _judges(exp, mapping,
                                  os.environ.get("CUB_CLASSIFIER_DIR", CLASSIFIER_DIR))
    n = min(400, exp.datamod.n_val)
    batch, _ = exp.get_test_samples(n)
    real = np.asarray(batch[mapping["image"]]["data"])
    txt, masks = batch[mapping["text"]]["data"], batch[mapping["text"]]["masks"]
    gt_caps = text_utils.onehot2text(np.asarray(txt), np.asarray(masks))
    stats = {}
    gt_colors, gt_valid = _color_labels(gt_caps)
    # the colour judge on held-out REAL images, unparsed captions left out
    stats["judge_accuracy_real"] = judge_calibration(
        color_judge, real[gt_valid], gt_colors[gt_valid], name="cub_color")
    # image -> caption: factor-word recall, Strict and letter accuracy
    gen_caps = text_utils.onehot2text(exp.cross_generate(mapping["image"], real)[mapping["text"]])
    factor_hits, strict_hits, letters = [], [], []
    for gt, gen in zip(gt_caps, gen_caps):
        hits = [1 if (_word_factor(gt, f) and _word_factor(gt, f) == _word_factor(gen, f))
                else 0 for f in FACTORS]
        stated = [1 if _word_factor(gt, f) else 0 for f in FACTORS]
        factor_hits.append(np.mean(hits))
        strict_hits.append(int(sum(hits) == sum(stated)))
        letters.append(count_same_letters(gen, gt) / max(len(gt), 1))
    stats["image_to_text_factors"] = float(np.mean(factor_hits))
    stats["image_to_text_strict"] = float(np.mean(strict_hits))
    stats["image_to_text_letters"] = float(np.mean(letters))
    # caption -> image: the colour judge, then the 4 judged factors
    gen_imgs = np.clip(np.asarray(exp.cross_generate(mapping["text"], txt, masks)
                                  [mapping["image"]]), 0, 1)
    pred_color = predict(color_judge, gen_imgs)
    stats["text_to_image_color"] = float((pred_color[gt_valid] == gt_colors[gt_valid]).mean())
    gt_fl = _factor_labels(gt_caps)
    pred4_real = predict(judge4, real)
    for fi, f in enumerate(FACTORS):
        labels, v = gt_fl[f]
        stats[f"judge4_{f}_accuracy_real"] = float((pred4_real[v, fi] == labels[v]).mean())
    hit, valid = _judged(predict(judge4, gen_imgs), gt_fl)
    stats["text_to_image_feats"] = float(_feats(hit, valid).mean())
    stats["text_to_image_strict"] = float(np.where(valid, hit, True).all(1).mean())
    # joint generation from the prior: caption and image of one latent
    gen = exp.joint_generate(len(gt_caps), seed=0)
    j_caps = text_utils.onehot2text(gen[mapping["text"]])
    j_imgs = np.clip(np.asarray(gen[mapping["image"]]), 0, 1)
    j_hit, j_valid = _judged(predict(judge4, j_imgs), _factor_labels(j_caps))
    stats["joint_feats"] = float(_feats(j_hit, j_valid).mean())
    stats["joint_strict"] = float(np.mean((j_valid.sum(1) >= 3)
                                          & np.where(j_valid, j_hit, True).all(1)))
    stats["fid"] = float(calculate_fid_given_data(real, gen_imgs, device=exp.device))
    run_dir = getattr(exp, "run_dir", None) or exp.config.mPath
    if run_dir:
        print_save_stats({k: {"value": v if k == "fid" else 100 * v, "stdev": None}
                          for k, v in stats.items()}, run_dir, "cub")
    return stats


def cub_eval(trainer_or_infer) -> Dict[str, float]:
    """The dataset's benchmark hook (``CUB.eval_statistics_fn``):
    :func:`cub_stats` on a MultimodalVAEInfer or a live Trainer."""
    from multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites import _as_infer
    with _as_infer(trainer_or_infer) as exp:
        return cub_stats(exp)
