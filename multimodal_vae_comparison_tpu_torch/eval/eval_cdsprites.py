"""CdSprites+ automatic benchmark: Strict / Features / Letters coherency
(counterpart of ``eval/eval_cdsprites.py``).

Text->Image coherency judged by per-attribute image classifiers, Image->Text
coherency by positional word matching, and joint coherency of samples from
the learned prior, the aggregate posterior (ex-post) and a GMM fitted to it,
written as Strict / Features / Letters percentages in the reference's stats
format.  The judges are trained on the run's train split at first use and
cached under ``eval/classifiers/`` (``CDSPRITES_CLASSIFIER_DIR`` overrides
it) as ``cdspritesplus_classifier_level{L}_{att}_v2.pt``.

    python -m multimodal_vae_comparison_tpu_torch.eval.eval_cdsprites -p <run dir>

Generation runs batched on the model's device (the card unless ``--device
cpu``); the text analysis is the JAX package's, copied.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import statistics as stat
from typing import Dict, List, Optional

import numpy as np

from multimodal_vae_comparison_tpu_torch.data import text as text_utils
from multimodal_vae_comparison_tpu_torch.eval.classifiers import (
    CLASSIFIER_DIR, CNNClassifier, get_or_train_classifier, predict)
from multimodal_vae_comparison_tpu_torch.utils import (
    last_letter, listdirs, print_save_stats)

# PROVENANCE: the vocabulary tables below and the positional index maps in
# get_attribute_from_recon are the reference's metric contract
# (multimodal_compare/eval/eval_cdsprites.py:19-37,100-151), kept verbatim by
# necessity — re-deriving them differently would change the measured
# benchmark numbers.
COLORS = {"white": [255, 255, 255], "red": [192, 64, 0],
          "yellow": [228, 217, 111], "green": [10, 107, 60],
          "blue": [0, 127, 200], "pink": [255, 0, 255]}
SHAPENAMES = ["heart", "ellipse", "square"]
SIZES = ["small", "big"]
LOCATIONS = ["at top left", "at top right", "at bottom right", "at bottom left"]
BACKGROUNDS = ["on light", "on dark"]
LEVEL_ATTRIBUTES = {1: ["shape"], 2: ["size", "shape"],
                    3: ["size", "color", "shape"],
                    4: ["size", "color", "shape", "position"],
                    5: ["size", "color", "shape", "position", "background"]}
SOURCES = {"shape": SHAPENAMES, "size": SIZES, "color": list(COLORS),
           "background": BACKGROUNDS, "position": LOCATIONS}
CLASS_MAPPINGS = {"shape": ["square", "ellipse", "heart"],
                  "size": ["big", "small"],
                  "color": ["blue", "green", "red", "yellow", "pink"],
                  "position": ["at top left", "at top right",
                               "at bottom left", "at bottom right"],
                  "background": ["on light", "on dark"]}


# the stats of eval_single_model, in the order of the stats file
STATS_KEYS = ("Text-Image Strict", "Text-Image Features", "Image-Text Strict",
              "Image-Text Features", "Image-Text Letters", "Joint Strict",
              "Joint Features", "Joint Strict ExPost", "Joint Features ExPost",
              "Joint Strict FittedPrior", "Joint Features FittedPrior",
              "Judge Accuracy Real")


# -- text analysis (eval_cdsprites.py:68-152) --------------------------------

def find_in_list(targets, source: str) -> Optional[str]:
    for t in targets:
        if t.lower() in source.lower():
            return t.lower()
    return None


def get_attribute(attribute: str, txt: str) -> Optional[str]:
    return find_in_list(SOURCES[attribute], txt)


def search_att(txt: str, source, idx=None, indices=None) -> Optional[str]:
    try:
        for s in source:
            if idx is not None:
                inp = txt.split(" ")[idx]
            elif indices is not None:
                inp = " ".join(txt.split(" ")[i] for i in indices)
            else:
                inp = txt
            if find_in_list([s], inp) is not None:
                return s.lower()
    except Exception:
        return None
    return None


def get_attribute_from_recon(attribute: str, txt: str, level: int) -> Optional[str]:
    """Positional word extraction from reconstructed text
    (eval_cdsprites.py:129-151)."""
    source = SOURCES[attribute]
    if attribute == "size":
        idx, indices = 0, None
    elif attribute == "shape":
        idx, indices = {1: 0, 2: 1, 3: 2, 4: 2, 5: 2}[level], None
    elif attribute == "color":
        idx, indices = {3: 1, 4: 1, 5: 1}[level], None
    elif attribute == "background":
        idx, indices = None, [-2, -1]
    else:  # position
        idx, indices = None, [3, 4, 5, 6]
    return search_att(txt, source, idx=idx, indices=indices)


def try_retrieve_atts(txt: str, level: int) -> str:
    atts = []
    for a in LEVEL_ATTRIBUTES[level]:
        v = get_attribute_from_recon(a, txt, level)
        atts.append(v if v is not None else "Unknown")
    return " ".join(atts)


def count_same_letters(a: str, b: str) -> int:
    n = min(len(a), len(b))
    return sum(a[i] == b[i] for i in range(n))


# -- classifiers ----------------------------------------------------------------

def get_all_classifiers(exp, level: int, log_fn=print) -> Dict[str, CNNClassifier]:
    """One judge per attribute of the level, on ``exp.device``: cached, or
    trained on the DataModule's train split (the judged and calibration
    samples come from the test or val split, which stay held out).  The
    ``_v2`` suffix names this train-split-only recipe, as in the JAX
    package; the ``.pt`` files are the port's own."""
    cache_dir = os.environ.get("CDSPRITES_CLASSIFIER_DIR", CLASSIFIER_DIR)
    shared: Dict[str, np.ndarray] = {}

    def load_once():
        # one h5 read + label decode for ALL attributes, not one per judge
        if not shared:
            images, _ = exp.datamod.split_arrays(0, "train")
            labels_txt = exp.datamod.labels_train
            shared["images"] = images.astype(np.float32)
            shared["texts"] = [
                " ".join(l) if isinstance(l, (list, tuple)) else str(l)
                for l in labels_txt]
        return shared["images"], shared["texts"]

    out = {}
    for att in LEVEL_ATTRIBUTES[level]:
        classes = CLASS_MAPPINGS[att]
        model = CNNClassifier(num_classes=len(classes)).to(exp.device)
        cache = os.path.join(
            cache_dir, f"cdspritesplus_classifier_level{level}_{att}_v2.pt")

        def data_fn(att=att, classes=classes):
            images, texts = load_once()
            y = np.array([classes.index(get_attribute(att, t))
                          for t in texts])
            return images, y

        if log_fn:
            log_fn(f"classifier[{att}]: "
                   f"{'cached' if os.path.exists(cache) else 'training...'}")
        out[att] = get_or_train_classifier(cache, model, data_fn)
    return out


def eval_with_classifier(clf, image_batch: np.ndarray, att: str) -> List[str]:
    preds = predict(clf, image_batch.astype(np.float32) / 255.0)
    return [CLASS_MAPPINGS[att][int(i)] for i in preds]


# -- coherency (eval_cdsprites.py:214-390) -----------------------------------

def get_mean_stats(lists, percentage=True):
    return [100 * sum(l) / len(l) if percentage else sum(l) / len(l)
            for l in lists]


def text_to_image_accuracy(texts: List[str], images: np.ndarray,
                           classifiers, level: int):
    """Txt->Img: classifiers judge each generated image's attributes
    against the input caption."""
    correct_pairs, corr_feats = [], []
    judged = {att: eval_with_classifier(classifiers[att], images, att)
              for att in LEVEL_ATTRIBUTES[level]}
    for i, t in enumerate(texts):
        ok = []
        for att in LEVEL_ATTRIBUTES[level]:
            want = get_attribute(att, t)
            ok.append(int(want is not None and judged[att][i] == want))
        corr_feats.append(sum(ok) / len(ok))
        correct_pairs.append(int(sum(ok) == len(ok)))
    return get_mean_stats([correct_pairs, corr_feats])


def image_to_text_accuracy(gt_texts: List[str], recon_texts: List[str],
                           level: int):
    """Img->Txt: positional word + letter matching."""
    correct_pairs, corr_feats, corr_letters = [], [], []
    for t, r in zip(gt_texts, recon_texts):
        ok = []
        for att in LEVEL_ATTRIBUTES[level]:
            v = get_attribute_from_recon(att, r, level)
            ok.append(int(v is not None and v in t))
        corr_feats.append(sum(ok) / len(ok))
        letters = count_same_letters(r, t) / max(len(t), 1)
        corr_letters.append(letters)
        correct_pairs.append(int(letters == 1.0))
    return get_mean_stats([correct_pairs, corr_feats, corr_letters])


def calculate_cross_coherency(exp, classifiers, level: int, n: int = 250):
    batch, labels = exp.get_test_samples(n)
    texts = [" ".join(x) if isinstance(x, (list, tuple)) else str(x)
             for x in labels]
    mapping = _mod_mapping(batch)
    # Txt -> Img (batched)
    txt_data = batch[mapping["text"]]["data"]
    txt_masks = batch[mapping["text"]]["masks"]
    recons = exp.cross_generate(mapping["text"], txt_data, txt_masks)
    images = (np.clip(recons[mapping["image"]], 0, 1) * 255).astype(np.uint8)
    t2i = text_to_image_accuracy(texts, images, classifiers, level)
    # Img -> Txt (batched)
    recons = exp.cross_generate(mapping["image"], batch[mapping["image"]]["data"])
    recon_txt = text_utils.onehot2text(recons[mapping["text"]])
    gt_txt = text_utils.onehot2text(np.asarray(txt_data),
                                    np.asarray(txt_masks))
    i2t = image_to_text_accuracy(gt_txt, recon_txt, level)
    return {"text_image": t2i, "image_text": i2t}


def judge_calibration_cdsprites(exp, classifiers, level: int, n: int = 250,
                                log_fn=print) -> float:
    """Mean per-attribute judge accuracy on real held-out images, printed
    beside the judged metrics so that a weak judge cannot floor them
    unseen."""
    batch, labels = exp.get_test_samples(n)
    texts = [" ".join(x) if isinstance(x, (list, tuple)) else str(x)
             for x in labels]
    mapping = _mod_mapping(batch)
    images = (np.clip(np.asarray(batch[mapping["image"]]["data"]), 0, 1)
              * 255).astype(np.uint8)
    accs = []
    for att in LEVEL_ATTRIBUTES[level]:
        judged = eval_with_classifier(classifiers[att], images, att)
        want = [get_attribute(att, t) for t in texts]
        ok = [int(w is not None and j == w) for j, w in zip(judged, want)]
        accs.append(100.0 * sum(ok) / max(len(ok), 1))
    mean = float(np.mean(accs)) if accs else float("nan")
    if log_fn:
        per = ", ".join(f"{a}={v:.0f}" for a, v in
                        zip(LEVEL_ATTRIBUTES[level], accs))
        log_fn(f"[judge] cdsprites_judge_accuracy_real: {mean:.1f}% ({per})")
    return mean


def calculate_joint_coherency(exp, classifiers, level: int, n: int = 64,
                              source: str = "prior"):
    recons = exp.joint_generate(n, source=source)
    mapping = _mod_mapping_dims(exp)
    images = (np.clip(recons[mapping["image"]], 0, 1) * 255).astype(np.uint8)
    txts = text_utils.onehot2text(recons[mapping["text"]])
    correct_pairs, corr_feats = [], []
    judged = {att: eval_with_classifier(classifiers[att], images, att)
              for att in LEVEL_ATTRIBUTES[level]}
    for i, txt in enumerate(txts):
        atts = try_retrieve_atts(txt, level)
        ok = []
        for att in LEVEL_ATTRIBUTES[level]:
            want = get_attribute(att, atts)
            ok.append(int(want is not None and judged[att][i] == want))
        corr_feats.append(sum(ok) / len(ok))
        correct_pairs.append(int(sum(ok) == len(ok)))
    return {"joint": get_mean_stats([correct_pairs, corr_feats])}


def _mod_mapping(batch) -> Dict[str, str]:
    """text mod has masks, image mod doesn't (eval_cdsprites.py:322-328)."""
    if batch["mod_1"]["masks"] is None and batch["mod_2"]["masks"] is not None:
        return {"image": "mod_1", "text": "mod_2"}
    if batch["mod_1"]["masks"] is not None and batch["mod_2"]["masks"] is None:
        return {"image": "mod_2", "text": "mod_1"}
    raise ValueError("data does not look like an image+text pair")


def _mod_mapping_dims(exp) -> Dict[str, str]:
    dims = {m.name: m.feature_dims or [] for m in exp.config.mods}
    img = max(dims, key=lambda k: int(np.prod(dims[k])))
    txt = [k for k in dims if k != img][0]
    return {"image": img, "text": txt}


def dataset_level(exp) -> int:
    ds = exp.datamod.datasets[0]
    if hasattr(ds, "level"):
        return ds.level()
    return 1


def eval_single_model(exp, n_samples: int = 250, log_fn=print) -> Dict:
    level = dataset_level(exp)
    classifiers = get_all_classifiers(exp, level, log_fn)
    if log_fn:
        log_fn("Calculating CdSprites+ automatic statistics")
    calibration = judge_calibration_cdsprites(exp, classifiers, level,
                                              n_samples, log_fn)
    cross = calculate_cross_coherency(exp, classifiers, level, n_samples)
    joint = calculate_joint_coherency(exp, classifiers, level)
    # ex-post (aggregate-posterior) sampling, reported alongside the
    # reference's prior-sampling protocol — see infer.joint_generate
    try:
        joint_xp = calculate_joint_coherency(exp, classifiers, level,
                                             source="expost")
    except Exception as e:
        if log_fn:
            log_fn(f"expost joint sampling skipped: {e}")
        joint_xp = {"joint": (float("nan"), float("nan"))}
    # ex-post as prior: a GMM fitted after training to the aggregate
    # posterior (infer._fitted_prior), prior-protocol joint generation
    # without a training-time mixture prior
    try:
        joint_fit = calculate_joint_coherency(exp, classifiers, level,
                                              source="fitted")
    except Exception as e:
        if log_fn:
            log_fn(f"fitted-prior joint sampling skipped: {e}")
        joint_fit = {"joint": (float("nan"), float("nan"))}
    out = {"Text-Image Strict": {"value": cross["text_image"][0], "stdev": None},
           "Text-Image Features": {"value": cross["text_image"][1], "stdev": None},
           "Image-Text Strict": {"value": cross["image_text"][0], "stdev": None},
           "Image-Text Features": {"value": cross["image_text"][1], "stdev": None},
           "Image-Text Letters": {"value": cross["image_text"][2], "stdev": None},
           "Joint Strict": {"value": joint["joint"][0], "stdev": None},
           "Joint Features": {"value": joint["joint"][1], "stdev": None},
           "Joint Strict ExPost": {"value": joint_xp["joint"][0], "stdev": None},
           "Joint Features ExPost": {"value": joint_xp["joint"][1], "stdev": None},
           "Joint Strict FittedPrior": {"value": joint_fit["joint"][0],
                                        "stdev": None},
           "Joint Features FittedPrior": {"value": joint_fit["joint"][1],
                                          "stdev": None},
           "Judge Accuracy Real": {"value": calibration, "stdev": None}}
    run_dir = getattr(exp, "run_dir", None) or exp.config.mPath
    if run_dir:
        print_save_stats(out, run_dir, "cdspritesplus", level)
    return {k: v["value"] for k, v in out.items()}


def cdsprites_eval(trainer_or_infer):
    """The dataset's benchmark hook (``CDSPRITESPLUS.eval_statistics_fn``):
    :func:`eval_single_model` on a MultimodalVAEInfer or a live Trainer, at
    ``CDSPRITES_EVAL_SAMPLES`` test rows (250)."""
    n = int(os.environ.get("CDSPRITES_EVAL_SAMPLES", 250))
    with _as_infer(trainer_or_infer) as exp:
        return eval_single_model(exp, n_samples=n)


@contextlib.contextmanager
def _as_infer(obj):
    """A MultimodalVAEInfer as it is, or a live Trainer wrapped as one.
    Generation is single-sample, so the trainer's model runs with K = 1 in
    eval mode for the eval; its K and mode are restored after, whatever
    happens, so that a later ``fit`` of the same Trainer (the iterseeds
    loop) trains with its config's K."""
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    if isinstance(obj, MultimodalVAEInfer):
        yield obj
        return
    model = obj.model
    K, training = model.K, model.training
    model.K = 1
    model.eval()
    try:
        yield MultimodalVAEInfer.from_trainer(obj)
    finally:
        model.K = K
        model.train(training)


def eval_over_seeds(parent_dir: str, level: int = 0, device=None) -> Dict:
    """Mean (stdev) of every stat over the seed runs under ``parent_dir``,
    each restored and evaluated again (reference eval_cdsprites.py:423-469)."""
    from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
    cats = {k: [] for k in STATS_KEYS}
    for m in sorted(listdirs(parent_dir), key=last_letter):
        try:
            vals = eval_single_model(MultimodalVAEInfer(m, device=device))
        except (OSError, ValueError, RuntimeError) as e:
            print(f"skipping {m}: {type(e).__name__}: {e}")
            continue
        for k in cats:
            cats[k].append(vals[k])
    out = {k: {"value": stat.mean(v),
               "stdev": stat.stdev(v) if len(v) > 1 else 0.0}
           for k, v in cats.items() if v}
    print_save_stats(out, parent_dir, "cdspritesplus", level or 1)
    return out


def aggregate_from_files(parent_dir: str, level: int = 0,
                         stats_name: str = "cdspritesplus") -> Dict:
    """Aggregate mean(std) from the per-seed ``<stats_name>_stats.txt``
    files the test-end hook already wrote — the reference's seed-averaged
    leaderboard format (eval_cdsprites.py:423-469) without re-running
    generation per seed (eval_over_seeds does; at 250 samples/model that
    re-pays the whole eval).  Works for any dataset whose stats files use
    the shared ``Key: value`` format (sprites, vilanro, ...)."""
    cats: Dict[str, List[float]] = {}
    n_runs = 0
    for m in sorted(listdirs(parent_dir), key=last_letter):
        path = os.path.join(m, f"{stats_name}_stats.txt")
        if not os.path.exists(path):
            print(f"skipping {m}: no {stats_name}_stats.txt")
            continue
        n_runs += 1
        with open(path) as f:
            for line in f:
                if ":" not in line:
                    continue
                key, val = line.rsplit(":", 1)
                try:
                    cats.setdefault(key.strip(), []).append(float(val))
                except ValueError:
                    continue
    out = {k: {"value": stat.mean(v),
               "stdev": stat.stdev(v) if len(v) > 1 else 0.0}
           for k, v in cats.items() if v}
    if not out:
        raise FileNotFoundError(f"no per-seed stats files under {parent_dir}")
    print(f"aggregated {n_runs} seed runs under {parent_dir}")
    print_save_stats(out, parent_dir, stats_name, level or 1)
    return out


def main(argv=None):
    from multimodal_vae_comparison_tpu_torch.device import set_numerics
    set_numerics()
    parser = argparse.ArgumentParser()
    parser.add_argument("-p", "--mpath", type=str,
                        help="path to a trained run dir")
    parser.add_argument("-m", "--multieval", type=str,
                        help="parent dir with multiple seed runs (re-runs "
                             "generation per seed)")
    parser.add_argument("-a", "--aggregate", type=str,
                        help="parent dir: aggregate existing per-seed stats "
                             "files without re-running generation")
    parser.add_argument("-l", "--level", type=int, default=0)
    parser.add_argument("-s", "--stats-name", type=str,
                        default="cdspritesplus",
                        help="stats-file prefix for --aggregate (e.g. "
                             "'sprites', 'vilanro_NLReach2-v0_replan0')")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: cuda; cpu for the plain path)")
    args = parser.parse_args(argv)
    if sum(bool(x) for x in (args.mpath, args.multieval, args.aggregate)) != 1:
        parser.error("give exactly one of -p, -m and -a")
    if args.mpath:
        from multimodal_vae_comparison_tpu_torch.eval.infer import MultimodalVAEInfer
        return eval_single_model(MultimodalVAEInfer(args.mpath, device=args.device))
    if args.aggregate:
        return aggregate_from_files(args.aggregate, args.level, stats_name=args.stats_name)
    return eval_over_seeds(args.multieval, args.level, device=args.device)


if __name__ == "__main__":
    main()
