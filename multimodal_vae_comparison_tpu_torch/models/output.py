"""Forward-pass output containers (counterpart of ``models/output.py``)."""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch


@dataclasses.dataclass(frozen=True)
class ModalityOutput:
    """Per-modality forward outputs."""

    encoder_dist: Optional[Any] = None        # q(z|x_m) over shared latents
    enc_dist_private: Optional[Any] = None    # q(z_private|x_m)
    joint_dist: Optional[Any] = None          # joint posterior used for m
    decoder_dist: Optional[Any] = None        # p(x_m|z_m) self-reconstruction
    joint_decoder_dist: Optional[Any] = None  # p(x_m|z_joint)
    dec_dist_private: Optional[Any] = None
    cross_decoder_dist: Optional[Dict[str, Any]] = None  # from other mods' z
    latents: Optional[torch.Tensor] = None    # (K, B, D) samples decoded for m


@dataclasses.dataclass(frozen=True)
class VAEOutput:
    """Forward output keyed by modality name."""

    mods: Dict[str, ModalityOutput]

    def unpack(self, field: str):
        """Dict of per-modality values for one field."""
        return {k: getattr(v, field) for k, v in self.mods.items()}
