"""The multimodal VAE zoo (counterpart of ``models/mmvae.py``).

POE (MVAE) and MOE (MMVAE): inference forwards and training objectives.
MoPOE, DMVAE and the unimodal VAE come with a later slice.

Injected noise: ``POE.objective`` takes ``eps`` as a list of one (K, B, D)
draw per subset, in lattice order; MOE's ``forward`` and ``objective`` take
a dict from modality name to its (K, B, D) draw.  Without ``eps`` the draws
come from ``generator`` in the same order (``self.specs`` order for MOE).
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.models.base import MMVAE
from multimodal_vae_comparison_tpu_torch.models.distributions import (
    Normal, log_mean_exp, log_prob_joint)
from multimodal_vae_comparison_tpu_torch.models.output import (
    ModalityOutput, VAEOutput)
from multimodal_vae_comparison_tpu_torch.ops.fusion import (
    product_of_experts, subset_lattice)


def _kmean(lpx: torch.Tensor) -> torch.Tensor:
    """Average a (K, B) likelihood term over K; (B,) terms pass through."""
    return lpx.mean(0) if lpx.dim() == 2 else lpx


def _mask_of(batch, name):
    return batch[name].get("masks")


def _eps_for(eps: Optional[Dict[str, torch.Tensor]], name: str):
    return None if eps is None else eps[name]


class MOE(MMVAE):
    """Mixture-of-experts MMVAE: each present modality's posterior is
    sampled on its own, every sample is decoded by every decoder, and a
    missing modality is decoded from the first present modality's sample."""

    def forward(self, batch, present: Tuple[str, ...],
                eps: Optional[Dict[str, torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        qz_params = self.encode(batch, present)
        filled = [n for n in self.mod_names if n in present]
        zs, qzs = {}, {}
        for spec in self.specs:
            if spec.name in present:
                qzs[spec.name], zs[spec.name] = self.sample_posterior(
                    spec, qz_params[spec.name]["shared"],
                    eps=_eps_for(eps, spec.name), generator=generator)
            else:
                qzs[spec.name] = None
        mods = {}
        for spec in self.specs:
            name = spec.name
            z = zs[name if name in present else filled[0]]
            cond = self._cond_for(name, batch, present)
            dec = self.decode_mod(name, z, _mask_of(batch, name), cond=cond)
            cross = {other: self.decode_mod(name, zs[other], _mask_of(batch, name),
                                            cond=cond)
                     for other in self.mod_names if other != name and other in present}
            mods[name] = ModalityOutput(encoder_dist=qzs[name], decoder_dist=dec,
                                        cross_decoder_dist=cross, latents=z)
        return VAEOutput(mods=mods)

    def objective(self, batch, eps: Optional[Dict[str, torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None):
        if self.obj in ("elbo", "elbo_iw"):
            return self._objective_elbo(batch, eps, generator)
        if self.obj in ("iwae", "dreg"):
            return self._objective_kweighted(batch, eps, generator)
        raise KeyError(f"MOE has no objective '{self.obj}'; available: "
                       "['dreg', 'elbo', 'elbo_iw', 'iwae']")

    def _sample_all(self, batch, eps, generator):
        qz_params = self.encode(batch, self.mod_names)
        qzs, zs = {}, {}
        for spec in self.specs:
            qzs[spec.name], zs[spec.name] = self.sample_posterior(
                spec, qz_params[spec.name]["shared"],
                eps=_eps_for(eps, spec.name), generator=generator)
        return qzs, zs

    def _lpx_by_target(self, batch, zs) -> Dict[str, torch.Tensor]:
        """Lattice-batched decoding: every source's (K, B, D) sample stacks
        along the folded K axis and each decoder runs once on (M*K, B);
        returns target name -> (M, K, B) scaled log-likelihoods."""
        M = len(self.specs)
        z_all = torch.cat([zs[n] for n in self.mod_names], dim=0)
        out = {}
        for spec in self.specs:
            dec = self.decode_mod(spec.name, z_all, _mask_of(batch, spec.name),
                                  cond=self._cond_for(spec.name, batch, self.mod_names))
            lpx = self.recon_lpx(spec, dec, batch)               # (M*K, B)
            out[spec.name] = lpx.reshape((M, self.K) + lpx.shape[1:])
        return out

    def _objective_elbo(self, batch, eps, generator):
        """Mixture ELBO, (1/M) sum_m [sum_n llik_n log p(x_n|z_m) - beta
        KL(q_m || N(0, 1))], with the own-reconstruction term once; under
        ``elbo_iw`` each cross term is weighted by q_r(z_o) / q_o(z_o)."""
        weighted = self.obj == "elbo_iw"
        qzs, zs = self._sample_all(batch, eps, generator)
        lpx_by_tgt = self._lpx_by_target(batch, zs)
        lpx_terms, klds, rec_per_mod = [], [], {}
        for i, spec in enumerate(self.specs):
            qz = qzs[spec.name]
            klds.append(self.kld_std(spec, qz))
            lpx_own = lpx_by_tgt[spec.name][i]
            # metric: K-averaged, llik_scaling divided out, batch-summed
            rec_per_mod[spec.name] = -_kmean(lpx_own).sum() / spec.llik_scaling
            lpx_terms.append(lpx_own)
            for j, other in enumerate(self.mod_names):
                if other == spec.name:
                    continue
                lpx_cross = lpx_by_tgt[spec.name][j]
                if weighted:
                    z_o = zs[other].detach()
                    lq_self = torch.nan_to_num(qz.log_prob(z_o), nan=0.0).sum(-1)
                    lq_other = qzs[other].log_prob(z_o).sum(-1).detach()
                    lpx_cross = torch.exp(lq_self - lq_other) * lpx_cross
                lpx_terms.append(lpx_cross)
        lpx = torch.stack([_kmean(t) for t in lpx_terms])
        kld = torch.stack(klds)
        loss = objectives.elbo(lpx, kld, self.beta) / len(self.specs)
        metrics = {"kld": kld.mean(-1).sum(),
                   **{f"reconstruction_loss_{k}": v for k, v in rec_per_mod.items()}}
        return loss, metrics

    def _objective_kweighted(self, batch, eps, generator):
        """IWAE / DReG K-sample bounds, the looser multimodal variant.

        Every likelihood term (lpz, lqz and each reconstruction) is computed
        from the latents handed to ``log_weights``, so in DReG's second pass
        on :func:`objectives.scale_grad`-wrapped latents every path's
        z-gradient is re-weighted.  DReG's first pass only yields the
        stop-gradient weights, so it runs without a graph."""
        dreg = self.obj == "dreg"
        pz = self.pz()
        qzs, zs = self._sample_all(batch, eps, generator)
        q_lp = ({n: Normal(q.loc.detach(), q.scale.detach()) for n, q in qzs.items()}
                if dreg else qzs)
        rec_per_mod = {}

        def log_weights(zs_dict):
            lpx_by_tgt = self._lpx_by_target(batch, zs_dict)
            lws = []
            for i, spec in enumerate(self.specs):
                z_r = zs_dict[spec.name]                         # (K, B, D)
                lpz = log_prob_joint(pz, z_r)
                lqz = log_mean_exp(torch.stack(
                    [q_lp[o].log_prob(z_r).sum(-1) for o in self.mod_names]), dim=0)
                lpx_all = None
                for tgt in self.mod_names:
                    lpx_t = lpx_by_tgt[tgt][i]
                    if tgt == spec.name:
                        rec_per_mod[spec.name] = (-_kmean(lpx_t).sum()
                                                  / self.spec(tgt).llik_scaling)
                    lpx_all = lpx_t if lpx_all is None else lpx_all + lpx_t
                lws.append(lpz + lpx_all - self.beta * lqz)
            return torch.stack(lws)                              # (M, K, B)

        if not dreg:
            lw = log_weights(zs)
            loss = objectives.iwae(lw.reshape(-1, lw.shape[-1]))
        else:
            with torch.no_grad():
                w = torch.softmax(log_weights(zs), dim=1)        # over K
            zs_scaled = {name: objectives.scale_grad(zs[name], w[i][..., None])
                         for i, name in enumerate(self.mod_names)}
            lw2 = log_weights(zs_scaled)
            loss = -(w * lw2).sum(1).mean(0).sum()
        zero = torch.zeros((), device=loss.device)
        metrics = {"kld": zero, **{f"reconstruction_loss_{k}": v
                                   for k, v in rec_per_mod.items()}}
        return loss, metrics


class POE(MMVAE):
    """Product-of-experts MVAE: joint posterior = PoE(prior expert, present
    experts); the training objective sums one ELBO per modality subset."""

    def _check_priors(self):
        for spec in self.specs:
            if spec.prior not in ("normal", "gaussian"):
                raise ValueError("POE only works with gaussian priors! "
                                 "Adjust the config")

    def mix(self, qz_params, present: Tuple[str, ...]):
        """PoE fusion of the present experts + analytic prior expert."""
        mus = torch.stack([qz_params[n]["shared"][0] for n in present])
        scales = torch.stack([qz_params[n]["shared"][1] for n in present])
        return product_of_experts(mus, scales, include_prior=True)

    def forward(self, batch, present: Tuple[str, ...],
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        """:param eps: optional injected (K, B, D) standard-normal draw for
            the joint sample; drawn from ``generator`` when absent"""
        self._check_priors()
        qz_params = self.encode(batch, present)
        mu, scale = self.mix(qz_params, present)
        joint = Normal(mu, scale)
        z = joint.rsample((self.K,), generator=generator, eps=eps)
        mods = {}
        for spec in self.specs:
            dec = self.decode_mod(spec.name, z, _mask_of(batch, spec.name),
                                  cond=self._cond_for(spec.name, batch, present))
            enc = (Normal(*qz_params[spec.name]["shared"])
                   if spec.name in present else None)
            mods[spec.name] = ModalityOutput(encoder_dist=enc, joint_dist=joint,
                                             decoder_dist=dec, latents=z)
        return VAEOutput(mods=mods)

    def objective(self, batch, eps: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None):
        """Subset-lattice ELBO with lattice-batched decoding: every subset's
        (K, B, D) sample stacks along the folded K axis and each decoder
        runs once on (S*K, B), unless its conditioning input differs by
        subset, in which case it decodes per subset.

        :param eps: optional list of S injected (K, B, D) draws, one per
            subset in lattice order
        """
        self._check_priors()
        lattice = subset_lattice(len(self.specs))
        S = len(lattice)
        if eps is not None and len(eps) != S:
            raise ValueError(f"eps holds {len(eps)} draws; the lattice has {S} subsets")
        presents = [tuple(self.specs[i].name for i in subset) for subset in lattice]
        qz_params = self.encode(batch, self.mod_names)
        joints, z_subs = [], []
        for s, present in enumerate(presents):
            joint = Normal(*self.mix(qz_params, present))
            joints.append(joint)
            z_subs.append(joint.rsample((self.K,), generator=generator,
                                        eps=None if eps is None else eps[s]))
        z_all = torch.cat(z_subs, dim=0)                         # (S*K, B, D)
        lpx_sub = {}                                             # name -> (S, B)
        for spec in self.specs:
            mask = _mask_of(batch, spec.name)
            conds = [self._cond_for(spec.name, batch, p) for p in presents]
            # _cond_for builds a fresh tuple per call: compare its arrays
            shared = all(c is None for c in conds) or all(
                c is not None and c[0] is conds[0][0] and c[1] is conds[0][1]
                for c in conds)
            if shared:
                dec = self.decode_mod(spec.name, z_all, mask, cond=conds[0])
                lpx = self.recon_lpx(spec, dec, batch)           # (S*K, B)
                lpx_sub[spec.name] = lpx.reshape((S, self.K) + lpx.shape[1:]).mean(1)
            else:
                lpx_sub[spec.name] = torch.stack([
                    _kmean(self.recon_lpx(spec, self.decode_mod(
                        spec.name, z_subs[s], mask, cond=conds[s]), batch))
                    for s in range(S)])
        total = torch.zeros((), device=z_all.device)
        total_kld = torch.zeros((), device=z_all.device)
        rec_per_mod = {s.name: torch.zeros((), device=z_all.device) for s in self.specs}
        for s, present in enumerate(presents):
            kld = self.kld_to_prior(joints[s])
            lpx_sum = torch.zeros((), device=z_all.device)
            for spec in self.specs:
                lpx = lpx_sub[spec.name][s]
                lpx_sum = lpx_sum + lpx.sum()
                if present == (spec.name,):
                    rec_per_mod[spec.name] = -lpx.sum() / spec.llik_scaling
            total = total - (lpx_sum - self.beta * kld.sum())
            total_kld = total_kld + kld.mean()
        metrics = {"kld": total_kld / S,
                   **{f"reconstruction_loss_{k}": v for k, v in rec_per_mod.items()}}
        return total, metrics
