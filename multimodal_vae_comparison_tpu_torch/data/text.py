"""Host-side text processing: character one-hot encoding and decoding.

A copy of the JAX package's ``data/text.py`` (the port imports nothing of
that package): the reference text utilities
(multimodal_compare/utils.py:408-494): the 27-symbol alphabet one-hot
encoding, padding+mask construction, and decoding back to strings.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from multimodal_vae_comparison_tpu_torch.constants import ALPHABET


def char2index(ch: str) -> int:
    # lowercase first: the native kernel (mmvae_io.cpp one_hot_text) applies
    # tolower, and the two paths must produce identical tensors regardless
    # of whether the C toolchain built the .so
    return ALPHABET.find(ch.lower())


def one_hot_encode(seq_len: int, text: str) -> np.ndarray:
    """(seq_len, |alphabet|) one-hot; unknown chars stay all-zero
    (reference utils.py:414-421)."""
    x = np.zeros((seq_len, len(ALPHABET)), dtype=np.float32)
    for i, ch in enumerate(text[:seq_len]):
        idx = char2index(ch)
        if idx != -1:
            x[i, idx] = 1.0
    return x


def one_hot_encode_words(vocab: Sequence[str], words: Sequence[str]) -> np.ndarray:
    """Word-level one-hot over a fixed vocabulary (reference utils.py:423-429)."""
    vocab = list(vocab)
    x = np.zeros((len(words), len(vocab)), dtype=np.float32)
    for i, w in enumerate(words):
        w = w.replace(".", "").lower()
        x[i, vocab.index(w)] = 1.0
    return x


def lengths_to_mask(lengths: Sequence[int], max_len: int = None) -> np.ndarray:
    """(N, max_len) boolean mask, True where data exists
    (reference utils.py:239-250)."""
    lengths = np.asarray(lengths)
    max_len = max_len or int(lengths.max())
    return np.arange(max_len)[None, :] < lengths[:, None]


def encode_text_batch(texts: Sequence[str], seq_len: int) -> Tuple[np.ndarray, np.ndarray]:
    """Batch one-hot encode + masks, padded to ``seq_len``."""
    data = np.stack([one_hot_encode(seq_len, t) for t in texts])
    masks = lengths_to_mask([min(len(t), seq_len) for t in texts], seq_len)
    return data, masks


def seq2text(indices: Sequence[int]) -> str:
    """Index sequence -> string (reference utils.py:432-439)."""
    return "".join(ALPHABET[i] for i in indices)


def onehot2text(onehot: np.ndarray, masks: np.ndarray = None) -> List[str]:
    """Decode (N, L, |alphabet|) one-hot/logits to strings
    (reference output_onehot2text, utils.py:579-592)."""
    idx = np.asarray(onehot).argmax(-1)
    out = []
    for i, row in enumerate(idx):
        s = seq2text(row)
        if masks is not None:
            s = s[: int(np.asarray(masks[i]).sum())]
        out.append(s)
    return out
