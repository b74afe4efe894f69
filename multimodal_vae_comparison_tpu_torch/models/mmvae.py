"""The multimodal VAE zoo (counterpart of ``models/mmvae.py``).

POE (MVAE), MOE (MMVAE), MoPOE, DMVAE and the one-modality VAE
(``UnimodalVAE``, with its gumbel-softmax path): inference forwards and
training objectives.

Injected noise: ``POE.objective`` takes ``eps`` as a list of one (K, B, D)
draw per subset, in lattice order; MOE's ``forward`` and ``objective`` take
a dict from modality name to its (K, B, D) draw; MoPOE takes the one (K, B,
D) draw of its joint sample; DMVAE a list in the order the reference draws
them (see its docstring); UnimodalVAE the one (K, B, D) draw of its
posterior, or on the gumbel path the (K, B, groups, cats) Gumbel noise.
Without ``eps`` the draws come from ``generator``
in the same order (``self.specs`` order for MOE).

Under the mixture prior (``prior_components > 1``) every KL to the prior is
the Monte-Carlo mean over latents drawn from the posterior
(:meth:`MMVAE.kld_to_prior`): MOE's and POE's over the draws they decode;
MoPOE and DMVAE draw more, and their ``eps`` grows by those (see each
``objective``).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from multimodal_vae_comparison_tpu_torch.models import objectives
from multimodal_vae_comparison_tpu_torch.models.base import MMVAE
from multimodal_vae_comparison_tpu_torch.models.distributions import (
    Normal, OneHotCategorical, log_mean_exp, log_prob_joint, stop_gradient)
from multimodal_vae_comparison_tpu_torch.models.output import (
    ModalityOutput, VAEOutput)
from multimodal_vae_comparison_tpu_torch.parallel import rows
from multimodal_vae_comparison_tpu_torch.ops.fusion import (
    mixture_component_selection, poe_lattice, product_of_experts, subset_lattice)


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
        """``elbo`` and ``elbo_iw`` take the mixture ELBO, ``dreg`` the DReG
        bound and any other name the IWAE bound, as the JAX package routes
        them."""
        if self.obj in ("elbo", "elbo_iw"):
            return self._objective_elbo(batch, eps, generator)
        return self._objective_kweighted(batch, eps, generator)

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
        ``elbo_iw`` each cross term is weighted by q_r(z_o) / q_o(z_o).  Under
        the mixture prior the KL is to the prior, over each modality's draw."""
        weighted = self.obj == "elbo_iw"
        qzs, zs = self._sample_all(batch, eps, generator)
        lpx_by_tgt = self._lpx_by_target(batch, zs)
        lpx_terms, rec_per_mod = [], {}
        if self.prior_components > 1:
            kld = torch.stack([self.kld_to_prior(qzs[n], zs[n]) for n in self.mod_names])
        else:
            kld = self.kld_std_all(qzs)                          # (M, B)
        for i, spec in enumerate(self.specs):
            qz = qzs[spec.name]
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
        loss = objectives.elbo(lpx, kld, self.beta) / len(self.specs)
        metrics = {"kld": rows.row_mean(kld).sum(),
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
        # DReG's lqz takes the posteriors without a gradient, each in its own
        # family (Laplace under ``prior: laplace``)
        q_lp = {n: stop_gradient(q) for n, q in qzs.items()} if dreg else qzs
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
                w = objectives.dreg_grad_weights(log_weights(zs), dim=1)   # over K
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

    # whether the N(0, 1) prior expert joins every product (POE2: no)
    prior_expert = True

    def _check_priors(self):
        for spec in self.specs:
            if spec.prior not in ("normal", "gaussian"):
                raise ValueError("POE only works with gaussian priors! "
                                 "Adjust the config")

    def mix(self, qz_params, present: Tuple[str, ...]):
        """PoE fusion of the present experts (+ the analytic prior expert)."""
        mus = torch.stack([qz_params[n]["shared"][0] for n in present])
        scales = torch.stack([qz_params[n]["shared"][1] for n in present])
        return product_of_experts(mus, scales, include_prior=self.prior_expert)

    def lattice_joints(self, qz_params, lattice) -> List[Normal]:
        """The joint posterior of every subset of ``lattice`` (tuples of
        modality indices): PoE of its experts (+ the analytic prior expert),
        all subsets in one launch of the PoE kernel."""
        shared = [qz_params[n]["shared"] for n in self.mod_names]
        mu, scale = poe_lattice([p[0].contiguous() for p in shared],
                                [p[1].contiguous() for p in shared], lattice, 1.0,
                                prior_mask=None if self.prior_expert else 0)
        return [Normal(m, s) for m, s in zip(mu.unbind(0), scale.unbind(0))]

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
        joints = self.lattice_joints(qz_params, lattice)
        z_subs = [joint.rsample((self.K,), generator=generator,
                                eps=None if eps is None else eps[s])
                  for s, joint in enumerate(joints)]
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
        aux_spec = self.endpoint_spec() if hasattr(self, "aux_head") else None
        aux_metrics = {}
        for s, present in enumerate(presents):
            kld = self.kld_to_prior(joints[s], z_subs[s])
            lpx_sum = torch.zeros((), device=z_all.device)
            for spec in self.specs:
                lpx = lpx_sub[spec.name][s]
                lpx_sum = lpx_sum + lpx.sum()
                if present == (spec.name,):
                    rec_per_mod[spec.name] = -lpx.sum() / spec.llik_scaling
            total = total - (lpx_sum - self.beta * kld.sum())
            total_kld = total_kld + rows.row_mean(kld)
            # the endpoint head reads the joint posterior of every modality
            # but the action one (the evaluation's conditioning set): on the
            # full set the action expert would hand it its own endpoint
            if (aux_spec is not None and aux_spec.name not in present
                    and len(present) == len(self.specs) - 1):
                aux_term, aux_mse = self.aux_endpoint_loss(z_subs[s], batch)
                total = total + aux_term
                aux_metrics["aux_endpoint_mse"] = aux_mse
        metrics = {"kld": total_kld / S, **aux_metrics,
                   **{f"reconstruction_loss_{k}": v for k, v in rec_per_mod.items()}}
        return total, metrics


class MoPOE(MMVAE):
    """Mixture of products of experts, the generalized multimodal ELBO: the
    PoE of every fully present subset of the lattice (the N(0, 1) prior
    expert on the full set only), all subsets in one launch of the PoE
    kernel, then a stratified mixture across the subsets: each subset's
    posterior takes its share of the batch rows
    (:func:`mixture_component_selection`).

    Injected noise: ``forward`` and ``objective`` take ``eps`` as the one
    (K, B, D) draw of the joint sample; under the mixture prior
    ``objective`` takes a list: that draw, then one (K, B, D) draw of each
    subset posterior in lattice order, for its Monte-Carlo KL.
    """

    def subsets(self) -> Tuple[Tuple[int, ...], ...]:
        return tuple(subset_lattice(len(self.specs)))

    def mix(self, qz_params, present: Tuple[str, ...]):
        """(mixture-selected joint, {"mod_a_mod_b": subset posterior}) over
        the subsets whose modalities are all present, in lattice order."""
        experts = [i for i, s in enumerate(self.specs) if s.name in present]
        slot = {i: k for k, i in enumerate(experts)}
        subsets = [s for s in self.subsets() if all(i in slot for i in s)]
        prior = sum(1 << k for k, s in enumerate(subsets) if len(s) == len(self.specs))
        shared = [qz_params[self.specs[i].name]["shared"] for i in experts]
        mu, scale = poe_lattice([p[0].contiguous() for p in shared],
                                [p[1].contiguous() for p in shared],
                                [tuple(slot[i] for i in s) for s in subsets], 1.0,
                                prior_mask=prior)
        subset_dists = {"_".join(sorted(self.specs[i].name for i in s)): Normal(m, sc)
                        for s, m, sc in zip(subsets, mu.unbind(0), scale.unbind(0))}
        return Normal(*mixture_component_selection(mu, scale)), subset_dists

    def forward(self, batch, present: Tuple[str, ...],
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        qz_params = self.encode(batch, present)
        joint, _ = self.mix(qz_params, present)
        z = joint.rsample((self.K,), generator=generator, eps=eps)
        mods = {}
        for spec in self.specs:
            enc = (Normal(*qz_params[spec.name]["shared"])
                   if spec.name in present else None)
            dec = self.decode_mod(spec.name, z, _mask_of(batch, spec.name),
                                  cond=self._cond_for(spec.name, batch, present))
            mods[spec.name] = ModalityOutput(encoder_dist=enc, joint_dist=joint,
                                             decoder_dist=dec, latents=z)
        return VAEOutput(mods=mods)

    def objective(self, batch, eps=None, generator: Optional[torch.Generator] = None):
        """Reconstruction of every modality from the mixture's sample (K
        mean, then batch mean), and the group KL: the KL to the learned
        prior of every subset posterior and of the joint, each
        batch-averaged and weighted 1/(S+1); closed form, or under the
        mixture prior over the joint's sample and a draw of each subset's."""
        present = self.mod_names
        mog = self.prior_components > 1
        qz_params = self.encode(batch, present)
        joint, subset_dists = self.mix(qz_params, present)
        subset_eps = None
        if mog and eps is not None:
            if len(eps) != len(subset_dists) + 1:
                raise ValueError(f"eps holds {len(eps)} draws; under the mixture prior "
                                 f"the objective makes {len(subset_dists) + 1}")
            eps, subset_eps = eps[0], iter(eps[1:])
        z = joint.rsample((self.K,), generator=generator, eps=eps)
        dists = list(subset_dists.values()) + [joint]
        w = 1.0 / len(dists)
        group_div = torch.zeros((), device=z.device)
        for d in dists:
            if mog:
                z_d = z if d is joint else d.rsample(
                    (self.K,), generator=generator,
                    eps=None if subset_eps is None else next(subset_eps))
                div = self.kld_to_prior(d, z_d)
            else:
                div = self.kld_to_prior(d)
            group_div = group_div + w * rows.row_mean(div)
        lpx_total = torch.zeros((), device=z.device)
        rec_per_mod = {}
        for spec in self.specs:
            dec = self.decode_mod(spec.name, z, _mask_of(batch, spec.name),
                                  cond=self._cond_for(spec.name, batch, present))
            lpx = _kmean(self.recon_lpx(spec, dec, batch))
            lpx_total = lpx_total + rows.row_mean(lpx)
            rec_per_mod[spec.name] = -lpx.sum() / spec.llik_scaling
        loss = -(lpx_total - self.beta * group_div)
        metrics = {"kld": group_div,
                   **{f"reconstruction_loss_{k}": v for k, v in rec_per_mod.items()}}
        return loss, metrics


class DMVAE(MMVAE):
    """Disentangled multimodal VAE: shared and private latents per modality.

    The joint posterior is the PoE of the present modalities' shared
    experts without the prior expert.  Each present modality draws a shared
    and a private sample; a missing one takes the joint sample and a
    private draw from N(0, 1).  Each modality decodes its own sample, the
    joint one and every other present modality's shared sample, each with
    its private sample beside it.  The objective is a triple ELBO per
    modality: own, joint, and the cross terms with the private KL once per
    cross pair; the private KLs of all modalities take one launch of the KL
    kernel.

    Injected noise: ``eps`` is a list of draws in the order the reference
    draws them: the (K, B, D) joint sample; then per modality in spec
    order its shared (K, B, D) and private (K, B, P) draws (present) or the
    private prior draw alone (missing), followed by one (K, B, D) shared
    draw of each other present modality for its cross decodes.  Under the
    mixture prior ``objective`` takes one more (K, B, D) draw of the joint
    per modality after those, for the joint's Monte-Carlo KL.
    """

    def _check_factorized(self):
        if not any(s.private_latents is not None for s in self.specs):
            raise ValueError("DMVAE requires private_latents in the config")

    def eps_shapes(self, present: Tuple[str, ...], batch_size: int) -> List[Tuple[int, ...]]:
        """The shapes of the draws of a forward over ``present``, in order."""
        shared = (self.K, batch_size, self.n_latents)
        shapes = [shared]
        for spec in self.specs:
            private = (self.K, batch_size, spec.private_latents)
            shapes += [shared, private] if spec.name in present else [private]
            shapes += [shared] * (len(present) - (spec.name in present))
        return shapes

    def forward(self, batch, present: Tuple[str, ...],
                eps: Optional[Sequence[torch.Tensor]] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        self._check_factorized()
        n_draws = len(self.eps_shapes(present, 0))
        if eps is not None and len(eps) != n_draws:
            raise ValueError(f"eps holds {len(eps)} draws; a forward over {present} "
                             f"makes {n_draws}")
        noise = iter(eps or ())

        def draw(dist):
            return dist.rsample((self.K,), generator=generator,
                                eps=None if eps is None else next(noise))

        qz_params = self.encode(batch, present)
        mus = torch.stack([qz_params[n]["shared"][0] for n in present])
        scales = torch.stack([qz_params[n]["shared"][1] for n in present])
        joint = Normal(*product_of_experts(mus, scales, include_prior=False))
        z_joint = draw(joint)
        mods = {}
        for spec in self.specs:
            name = spec.name
            mask = _mask_of(batch, name)
            if name in present:
                qz = Normal(*qz_params[name]["shared"])
                qz_priv = Normal(*qz_params[name]["private"])
                z_shared, z_priv = draw(qz), draw(qz_priv)
            else:
                qz, qz_priv = None, None
                z_shared = z_joint
                ones = z_joint.new_ones((z_joint.shape[1], spec.private_latents))
                z_priv = draw(Normal(torch.zeros_like(ones), ones))
            cond = self._cond_for(name, batch, present)
            dec = self.decode_mod(name, torch.cat([z_shared, z_priv], -1), mask, cond=cond)
            dec_joint = self.decode_mod(name, torch.cat([z_joint, z_priv], -1), mask,
                                        cond=cond)
            cross = {}
            for other in present:
                if other == name:
                    continue
                z_o = draw(Normal(*qz_params[other]["shared"]))
                cross[other] = self.decode_mod(name, torch.cat([z_o, z_priv], -1), mask,
                                               cond=cond)
            mods[name] = ModalityOutput(encoder_dist=qz, enc_dist_private=qz_priv,
                                        joint_dist=joint, decoder_dist=dec,
                                        joint_decoder_dist=dec_joint,
                                        cross_decoder_dist=cross, latents=z_shared)
        return VAEOutput(mods=mods)

    def objective(self, batch, eps: Optional[Sequence[torch.Tensor]] = None,
                  generator: Optional[torch.Generator] = None):
        """Sum over modalities of the own and the joint ELBO (KL to the
        learned prior: closed form, or under the mixture prior the
        Monte-Carlo mean over the modality's shared draw and over a fresh
        draw of the joint) and the cross reconstructions, with the private
        KL to N(0, 1) counted once per cross pair."""
        self._check_factorized()
        mog = self.prior_components > 1
        joint_eps = None
        if mog and eps is not None:
            n = len(self.eps_shapes(self.mod_names, 0))
            if len(eps) != n + len(self.specs):
                raise ValueError(f"eps holds {len(eps)} draws; under the mixture prior "
                                 f"the objective makes {n + len(self.specs)}")
            eps, joint_eps = eps[:n], eps[n:]
        out = self.forward(batch, self.mod_names, eps=eps, generator=generator)
        kld_priv_all = self.kld_std_all({n: out.mods[n].enc_dist_private
                                         for n in self.mod_names})      # (M, B)
        total = torch.zeros((), device=kld_priv_all.device)
        total_kld = torch.zeros((), device=kld_priv_all.device)
        rec_per_mod = {}
        for i, spec in enumerate(self.specs):
            mo = out.mods[spec.name]
            lpx = _kmean(self.recon_lpx(spec, mo.decoder_dist, batch))
            lpx_joint = _kmean(self.recon_lpx(spec, mo.joint_decoder_dist, batch))
            if mog:
                kld = self.kld_to_prior(mo.encoder_dist, mo.latents)
                z_j = mo.joint_dist.rsample((self.K,), generator=generator,
                                            eps=None if joint_eps is None else joint_eps[i])
                kld_joint = self.kld_to_prior(mo.joint_dist, z_j)
            else:
                kld = self.kld_to_prior(mo.encoder_dist)
                kld_joint = self.kld_to_prior(mo.joint_dist)
            lpx_cross = torch.zeros((), device=total.device)
            kld_priv = torch.zeros((), device=total.device)
            for cross in mo.cross_decoder_dist.values():
                lpx_cross = lpx_cross + _kmean(self.recon_lpx(spec, cross, batch)).sum()
                kld_priv = kld_priv + kld_priv_all[i].sum()
            total = total + (objectives.elbo(lpx, kld, self.beta)
                             + objectives.elbo(lpx_joint, kld_joint, self.beta)
                             - (lpx_cross - self.beta * kld_priv))
            total_kld = total_kld + rows.row_mean(kld)
            rec_per_mod[spec.name] = -lpx.sum() / spec.llik_scaling
        metrics = {"kld": total_kld / len(self.specs),
                   **{f"reconstruction_loss_{k}": v for k, v in rec_per_mod.items()}}
        return total, metrics


class UnimodalVAE(MMVAE):
    """The VAE of a config with one modality block: encode, draw K latents
    from the posterior, decode.

    ``objective`` takes ``elbo`` (the KL to N(0, 1) through the KL kernel,
    or under the mixture prior the Monte-Carlo KL over the draws), ``dreg``
    (the stop-gradient posterior of its own family, every z-path gradient
    re-weighted by :func:`objectives.scale_grad` through a second decode),
    the IWAE bound under any other name (``iwae``, ``elbo_iw``: the JAX
    package's routing), and the gumbel-softmax path: under ``obj: elbo_gumbel`` or
    ``prior: gumbel`` the relu'd encoder means are logits of ``n_latents //
    cats`` categoricals of ``cats = feature_dims[1]`` classes, whose relaxed
    one-hot draws are decoded, with the KL to the uniform categorical.  The
    ELBO terms sum over K and the batch; the reconstruction metric is
    -sum(lpx), its llik scaling kept.
    """

    def forward(self, batch, present: Optional[Tuple[str, ...]] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        """:param present: ignored (the one modality is encoded)
        :param eps: optional injected (K, B, D) draw of the posterior"""
        spec = self.specs[0]
        qz_params = self.encode(batch, (spec.name,))
        qz, z = self.sample_posterior(spec, qz_params[spec.name]["shared"], eps=eps,
                                      generator=generator)
        dec = self.decode_mod(spec.name, z, _mask_of(batch, spec.name))
        return VAEOutput(mods={spec.name: ModalityOutput(
            encoder_dist=qz, decoder_dist=dec, latents=z)})

    def _gumbel_forward(self, batch, eps=None, generator=None) -> VAEOutput:
        """The categorical latent path: relu'd encoder means as (B, groups,
        cats) logits, K relaxed one-hot draws (``eps`` the (K, B, groups,
        cats) Gumbel noise), flattened to (K, B, groups * cats) and decoded."""
        spec = self.specs[0]
        mu, _ = self.encode(batch, (spec.name,))[spec.name]["shared"]
        cats = int(spec.feature_dims[1])
        groups = self.n_latents // cats
        qz = OneHotCategorical(F.relu(mu).reshape(mu.shape[0], groups, cats))
        z = qz.rsample((self.K,), generator=generator, eps=eps)
        z = z.reshape(self.K, mu.shape[0], groups * cats)
        dec = self.decode_mod(spec.name, z, _mask_of(batch, spec.name))
        return VAEOutput(mods={spec.name: ModalityOutput(
            encoder_dist=qz, decoder_dist=dec, latents=z)})

    def objective(self, batch, eps: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None):
        spec = self.specs[0]
        rec = f"reconstruction_loss_{spec.name}"
        if self.obj == "elbo_gumbel" or spec.prior == "gumbel":
            mo = self._gumbel_forward(batch, eps, generator).mods[spec.name]
            lpx = self.recon_lpx(spec, mo.decoder_dist, batch)
            uniform = OneHotCategorical(torch.zeros_like(mo.encoder_dist.logits))
            kld = mo.encoder_dist.kl(uniform).sum(-1)
            return objectives.elbo(lpx, kld, self.beta), {"kld": kld.sum(), rec: -lpx.sum()}
        mo = self.forward(batch, eps=eps, generator=generator).mods[spec.name]
        lpx = self.recon_lpx(spec, mo.decoder_dist, batch)
        kld_m = torch.zeros((), device=lpx.device)
        if self.obj == "elbo":
            kld = (self.kld_to_prior(mo.encoder_dist, mo.latents)
                   if self.prior_components > 1 else self.kld_std(spec, mo.encoder_dist))
            loss, kld_m = objectives.elbo(lpx, kld, self.beta), kld.sum()
        elif self.obj == "dreg":
            pz, z = self.pz(), mo.latents
            q_sg = stop_gradient(mo.encoder_dist)
            lw = log_prob_joint(pz, z) + lpx - q_sg.log_prob(z).sum(-1)
            w = objectives.dreg_grad_weights(lw)                     # (K, B)
            z_s = objectives.scale_grad(z, w[..., None])
            lpx_s = self.recon_lpx(spec, self.decode_mod(spec.name, z_s,
                                                         _mask_of(batch, spec.name)), batch)
            loss = objectives.dreg(log_prob_joint(pz, z_s) + lpx_s
                                   - q_sg.log_prob(z_s).sum(-1))
        else:
            lqz = mo.encoder_dist.log_prob(mo.latents).sum(-1)
            loss = objectives.iwae(log_prob_joint(self.pz(), mo.latents) + lpx - lqz)
        return loss, {"kld": kld_m, rec: -lpx.sum()}
