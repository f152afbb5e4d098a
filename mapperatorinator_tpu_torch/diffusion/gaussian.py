"""Gaussian diffusion (ADM/IDDPM lineage) in PyTorch: the JAX
``diffusion/gaussian.py`` (reference:
``osu_diffusion/utils/diffusion/gaussian_diffusion.py:59-874``,
``respace.py:11-130``): squaredcos_cap_v2 / linear beta schedules, epsilon
prediction with LEARNED_RANGE sigma, timestep respacing (per-section counts
like ``[100, 0, ...]`` included), DDPM and DDIM sampling, and the MSE (or
L1) + VB training losses.

The coefficient tables are float64 numpy, as in JAX, gathered as fp32 on the
sampled tensor's device. The loops run one eager step at a time.

Noise. JAX draws from ``jax.random`` keys, which torch cannot reproduce. Each
sampler here, and :meth:`GaussianDiffusion.training_losses`, takes its draws
from a ``source``: a ``torch.Generator`` on the
tensor's device (draws in call order), or a callable ``source(shape) ->
Tensor`` (its draws are moved to the tensor's device and dtype), which lets
a caller feed any draws, the JAX ones included. :func:`scoped` turns a
keyed callable ``noise(shape, where)`` into such a source for one scope of a
larger sampler.
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Union

import numpy as np
import torch

Source = Union[torch.Generator, Callable[[tuple], torch.Tensor]]


def normal(source: Source, shape, like: torch.Tensor) -> torch.Tensor:
    """One standard-normal draw of ``shape`` from ``source``, on ``like``'s
    device and dtype."""
    if isinstance(source, torch.Generator):
        return torch.randn(tuple(shape), generator=source, device=like.device, dtype=like.dtype)
    return torch.as_tensor(source(tuple(shape))).to(device=like.device, dtype=like.dtype)


def scoped(noise, *where) -> Source:
    """The source of one scope of a sampler: ``noise`` itself when it is a
    ``torch.Generator``; for a keyed callable ``noise(shape, where)``, a
    callable that passes ``(*where, k)``, k counting the scope's draws from
    0."""
    if isinstance(noise, torch.Generator):
        return noise
    counter = itertools.count()
    return lambda shape: noise(shape, (*where, next(counter)))


def get_named_beta_schedule(schedule_name: str, num_diffusion_timesteps: int) -> np.ndarray:
    if schedule_name == "linear":
        scale = 1000 / num_diffusion_timesteps
        return np.linspace(
            scale * 0.0001, scale * 0.02, num_diffusion_timesteps, dtype=np.float64
        )
    if schedule_name == "squaredcos_cap_v2":
        alpha_bar = lambda t: math.cos((t + 0.008) / 1.008 * math.pi / 2) ** 2
        betas = []
        for i in range(num_diffusion_timesteps):
            t1 = i / num_diffusion_timesteps
            t2 = (i + 1) / num_diffusion_timesteps
            betas.append(min(1 - alpha_bar(t2) / alpha_bar(t1), 0.999))
        return np.array(betas, dtype=np.float64)
    raise NotImplementedError(f"unknown beta schedule: {schedule_name}")


def space_timesteps(num_timesteps: int, section_counts) -> set:
    """Respacing step selection (reference: respace.py:11-62)."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for i in range(1, num_timesteps):
                if len(range(0, num_timesteps, i)) == desired:
                    return set(range(0, num_timesteps, i))
            raise ValueError(f"cannot create exactly {num_timesteps} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, section_count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < section_count:
            raise ValueError(f"cannot divide section of {size} steps into {section_count}")
        frac_stride = 1 if section_count <= 1 else (size - 1) / (section_count - 1)
        cur_idx = 0.0
        for _ in range(section_count):
            all_steps.append(start_idx + round(cur_idx))
            cur_idx += frac_stride
        start_idx += size
    return set(all_steps)


class GaussianDiffusion:
    """Respaced diffusion process. ``model_fn(x, t)`` receives the ORIGINAL
    timesteps (the respacing map is applied here). x is (N, T, C)."""

    def __init__(
        self,
        betas: np.ndarray,
        use_timesteps: Optional[set] = None,
        learn_sigma: bool = True,
        predict_xstart: bool = False,
        use_l1: bool = False,
    ):
        betas = np.asarray(betas, np.float64)
        if use_timesteps is not None:
            base_alphas_cumprod = np.cumprod(1.0 - betas)
            last = 1.0
            new_betas, self.timestep_map = [], []
            for i, ac in enumerate(base_alphas_cumprod):
                if i in use_timesteps:
                    new_betas.append(1 - ac / last)
                    last = ac
                    self.timestep_map.append(i)
            betas = np.array(new_betas, np.float64)
        else:
            self.timestep_map = list(range(len(betas)))

        self.learn_sigma = learn_sigma
        self.predict_xstart = predict_xstart
        self.use_l1 = use_l1
        self.betas = betas
        self.num_timesteps = len(betas)

        alphas = 1.0 - betas
        self.alphas_cumprod = np.cumprod(alphas)
        self.alphas_cumprod_prev = np.append(1.0, self.alphas_cumprod[:-1])

        self.sqrt_alphas_cumprod = np.sqrt(self.alphas_cumprod)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1.0 - self.alphas_cumprod)
        self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod)
        self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / self.alphas_cumprod - 1)

        self.posterior_variance = betas * (1.0 - self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        self.posterior_log_variance_clipped = (
            np.log(np.append(self.posterior_variance[1], self.posterior_variance[1:]))
            if len(self.posterior_variance) > 1
            else np.array([])
        )
        self.posterior_mean_coef1 = betas * np.sqrt(self.alphas_cumprod_prev) / (1.0 - self.alphas_cumprod)
        self.posterior_mean_coef2 = (1.0 - self.alphas_cumprod_prev) * np.sqrt(alphas) / (1.0 - self.alphas_cumprod)
        # the variance tables p_mean_variance reads: learned sigma interpolates
        # between the clipped posterior log variance and this one, a fixed
        # sigma takes the fixed tables
        self.log_betas = np.log(self.betas)
        if not learn_sigma:
            self.fixed_variance = np.append(self.posterior_variance[1], self.betas[1:])
            self.fixed_log_variance = np.log(self.fixed_variance)
        self._tables: dict = {}  # (table name, device) -> the table on that device

    # -- table gathers -------------------------------------------------------------

    def _table(self, name: str, dtype: torch.dtype, device) -> torch.Tensor:
        key = (name, device)
        if key not in self._tables:
            self._tables[key] = torch.tensor(np.asarray(getattr(self, name)), dtype=dtype, device=device)
        return self._tables[key]

    def _extract(self, name: str, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """The fp32 entries of table ``name`` at the respaced steps ``t``,
        shaped to broadcast over an ``ndim``-dimensional x."""
        out = self._table(name, torch.float32, t.device)[t]
        return out.reshape(out.shape[0], *([1] * (ndim - 1)))

    # -- q distributions -------------------------------------------------------------

    def q_sample(self, x_start: torch.Tensor, t: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        nd = x_start.ndim
        return (
            self._extract("sqrt_alphas_cumprod", t, nd) * x_start
            + self._extract("sqrt_one_minus_alphas_cumprod", t, nd) * noise
        )

    def q_posterior_mean_variance(self, x_start, x_t, t):
        nd = x_t.ndim
        mean = (
            self._extract("posterior_mean_coef1", t, nd) * x_start
            + self._extract("posterior_mean_coef2", t, nd) * x_t
        )
        var = self._extract("posterior_variance", t, nd)
        log_var = self._extract("posterior_log_variance_clipped", t, nd)
        return mean, var, log_var

    def _predict_xstart_from_eps(self, x_t, t, eps):
        nd = x_t.ndim
        return (
            self._extract("sqrt_recip_alphas_cumprod", t, nd) * x_t
            - self._extract("sqrt_recipm1_alphas_cumprod", t, nd) * eps
        )

    def _predict_eps_from_xstart(self, x_t, t, pred_xstart):
        nd = x_t.ndim
        return (
            self._extract("sqrt_recip_alphas_cumprod", t, nd) * x_t - pred_xstart
        ) / self._extract("sqrt_recipm1_alphas_cumprod", t, nd)

    # -- p distribution ---------------------------------------------------------------

    def _map_t(self, t: torch.Tensor) -> torch.Tensor:
        return self._table("timestep_map", torch.int64, t.device)[t]

    def p_mean_variance(
        self,
        model_fn: Callable,
        x: torch.Tensor,
        t: torch.Tensor,
        clip_denoised: bool = True,
        denoised_fn: Optional[Callable] = None,
    ) -> dict:
        """``denoised_fn(pred_xstart)`` (the JAX one also takes a key, which
        no caller reads) runs before the clip to [-2, 2]."""
        nd = x.ndim
        model_output = model_fn(x, self._map_t(t))

        if self.learn_sigma:
            c = x.shape[-1]
            model_output, model_var_values = model_output[..., :c], model_output[..., c:]
            min_log = self._extract("posterior_log_variance_clipped", t, nd)
            max_log = self._extract("log_betas", t, nd)
            frac = (model_var_values + 1) / 2
            model_log_variance = frac * max_log + (1 - frac) * min_log
            model_variance = torch.exp(model_log_variance)
        else:
            model_variance = self._extract("fixed_variance", t, nd)
            model_log_variance = self._extract("fixed_log_variance", t, nd)

        if self.predict_xstart:
            pred_xstart = model_output
        else:
            pred_xstart = self._predict_xstart_from_eps(x, t, model_output)
        if denoised_fn is not None:
            pred_xstart = denoised_fn(pred_xstart)
        if clip_denoised:
            pred_xstart = torch.clamp(pred_xstart, -2, 2)

        mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x, t)
        return {
            "mean": mean,
            "variance": model_variance,
            "log_variance": model_log_variance,
            "pred_xstart": pred_xstart,
        }

    # -- sampling -------------------------------------------------------------------

    @torch.no_grad()
    def p_sample(self, model_fn, x, t, source: Source, clip_denoised=True, denoised_fn=None) -> dict:
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        noise = normal(source, x.shape, x)
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (x.ndim - 1)))
        sample = out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"]) * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    @staticmethod
    def _start(source: Source, shape, noise, device) -> torch.Tensor:
        return noise if noise is not None else normal(source, shape, torch.empty(0, device=device))

    def _steps(self, start_t: Optional[int]) -> range:
        return range((self.num_timesteps if start_t is None else start_t) - 1, -1, -1)

    @torch.no_grad()
    def p_sample_loop(
        self,
        model_fn,
        shape=None,
        source: Source = None,
        noise: Optional[torch.Tensor] = None,
        clip_denoised: bool = True,
        denoised_fn: Optional[Callable] = None,
        start_t: Optional[int] = None,
        device=None,
    ) -> torch.Tensor:
        """DDPM ancestral sampling over the respaced steps, noisiest first
        (reference: gaussian_diffusion.py:469-561), from ``noise``, or from a
        first draw of ``shape`` on ``device``; one draw a step after it.
        ``start_t`` limits the loop to the noisiest ``start_t`` respaced
        steps (for partially-noised inputs)."""
        x = self._start(source, shape, noise, device)
        for i in self._steps(start_t):
            t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
            x = self.p_sample(model_fn, x, t, source, clip_denoised, denoised_fn)["sample"]
        return x

    @torch.no_grad()
    def ddim_sample(
        self, model_fn, x, t, source: Source, clip_denoised=True, denoised_fn=None, eta: float = 0.0
    ) -> dict:
        out = self.p_mean_variance(model_fn, x, t, clip_denoised, denoised_fn)
        eps = self._predict_eps_from_xstart(x, t, out["pred_xstart"])
        nd = x.ndim
        alpha_bar = self._extract("alphas_cumprod", t, nd)
        alpha_bar_prev = self._extract("alphas_cumprod_prev", t, nd)
        sigma = (
            eta
            * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
            * torch.sqrt(1 - alpha_bar / alpha_bar_prev)
        )
        noise = normal(source, x.shape, x)
        mean_pred = out["pred_xstart"] * torch.sqrt(alpha_bar_prev) + torch.sqrt(
            1 - alpha_bar_prev - sigma**2
        ) * eps
        nonzero = (t != 0).to(x.dtype).reshape(-1, *([1] * (nd - 1)))
        sample = mean_pred + nonzero * sigma * noise
        return {"sample": sample, "pred_xstart": out["pred_xstart"]}

    @torch.no_grad()
    def ddim_sample_loop(
        self,
        model_fn,
        shape=None,
        source: Source = None,
        noise: Optional[torch.Tensor] = None,
        clip_denoised: bool = True,
        denoised_fn: Optional[Callable] = None,
        eta: float = 0.0,
        start_t: Optional[int] = None,
        device=None,
    ) -> torch.Tensor:
        """DDIM sampling, drawing as :meth:`p_sample_loop` does."""
        x = self._start(source, shape, noise, device)
        for i in self._steps(start_t):
            t = torch.full((x.shape[0],), i, dtype=torch.int64, device=x.device)
            x = self.ddim_sample(model_fn, x, t, source, clip_denoised, denoised_fn, eta)["sample"]
        return x

    # -- training -------------------------------------------------------------------

    def training_losses(self, model_fn, x_start: torch.Tensor, t: torch.Tensor, source: Source) -> dict:
        """MSE (L1 under ``use_l1``) + VB for learned sigma, per sample (N,)
        (reference: gaussian_diffusion.py:785-874), the noise drawn from
        ``source``. The VB term sees the predicted mean through ``detach``
        (JAX's ``stop_gradient``): it trains the variance only."""
        noise = normal(source, x_start.shape, x_start)
        x_t = self.q_sample(x_start, t, noise)
        model_output = model_fn(x_t, self._map_t(t))

        terms = {}
        if self.learn_sigma:
            c = x_t.shape[-1]
            mean_out, var_values = model_output[..., :c], model_output[..., c:]
            frozen = torch.cat([mean_out.detach(), var_values], dim=-1)
            terms["vb"] = self._vb_terms(frozen, x_start, x_t, t)
            model_output = mean_out

        target = x_start if self.predict_xstart else noise
        dims = tuple(range(1, x_start.ndim))
        name = "l1" if self.use_l1 else "mse"
        diff = target - model_output
        terms[name] = (diff.abs() if self.use_l1 else diff**2).mean(dims)
        terms["loss"] = terms[name] + terms["vb"] if "vb" in terms else terms[name]
        return terms

    def _vb_terms(self, frozen_out, x_start, x_t, t) -> torch.Tensor:
        """The variational bound term in bits: the KL of the posterior at
        t > 0, the decoder's negative log-likelihood at t == 0."""
        nd = x_t.ndim
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)

        c = x_t.shape[-1]
        mean_out, var_values = frozen_out[..., :c], frozen_out[..., c:]
        min_log = self._extract("posterior_log_variance_clipped", t, nd)
        max_log = self._extract("log_betas", t, nd)
        frac = (var_values + 1) / 2
        log_var = frac * max_log + (1 - frac) * min_log
        pred_xstart = self._predict_xstart_from_eps(x_t, t, mean_out)
        mean, _, _ = self.q_posterior_mean_variance(pred_xstart, x_t, t)

        dims = tuple(range(1, nd))
        kl = normal_kl(true_mean, true_log_var, mean, log_var).mean(dims) / math.log(2.0)
        decoder_nll = -discretized_gaussian_log_likelihood(x_start, mean, 0.5 * log_var)
        decoder_nll = decoder_nll.mean(dims) / math.log(2.0)
        return torch.where(t == 0, decoder_nll, kl)


def normal_kl(mean1, logvar1, mean2, logvar2):
    return 0.5 * (
        -1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
        + ((mean1 - mean2) ** 2) * torch.exp(-logvar2)
    )


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, means, log_scales):
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(torch.clamp(cdf_plus, min=1e-12))
    log_one_minus_cdf_min = torch.log(torch.clamp(1.0 - cdf_min, min=1e-12))
    log_cdf_delta = torch.log(torch.clamp(cdf_plus - cdf_min, min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus, torch.where(x > 0.999, log_one_minus_cdf_min, log_cdf_delta))


def create_diffusion(
    timestep_respacing,
    noise_schedule: str = "linear",
    predict_xstart: bool = False,
    learn_sigma: bool = True,
    diffusion_steps: int = 1000,
    use_l1: bool = False,
) -> GaussianDiffusion:
    """Factory matching the reference (osu_diffusion/utils/diffusion/__init__.py:10)."""
    betas = get_named_beta_schedule(noise_schedule, diffusion_steps)
    if timestep_respacing is None or timestep_respacing == "":
        timestep_respacing = [diffusion_steps]
    return GaussianDiffusion(
        betas=betas,
        use_timesteps=space_timesteps(diffusion_steps, timestep_respacing),
        learn_sigma=learn_sigma,
        predict_xstart=predict_xstart,
        use_l1=use_l1,
    )
