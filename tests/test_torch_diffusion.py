"""The port's Gaussian diffusion sampler (``diffusion/gaussian.py``) against
the JAX one.

The schedules and respacing are float64 numpy on both sides and must be
equal. The samplers run one model function written twice, in jnp and in
torch (an eps and a learned-variance half), at atol 1e-5. JAX draws from
``jax.random`` keys, which torch cannot reproduce, so each test replays
the JAX key schedule with ``jax.random`` and hands those draws to the port's
noise source: ``p_sample`` splits its key into (noise, denoise) and draws
from the first; a loop without given noise first splits off the starting
noise, then splits once a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.diffusion import create_diffusion as jax_create_diffusion
from mapperatorinator_tpu.diffusion import gaussian as jax_gaussian
from mapperatorinator_tpu_torch.diffusion import create_diffusion, gaussian

TOL = 1e-5
# p_mean_variance and p_sample also at rtol 1e-6 (the reference's own test
# of p_mean_variance holds rtol 1e-4): at x ~ 2.5 N(0, 1) and the noisiest
# steps without the clip, the mean reaches ~200, where an ulp is 1.5e-5
RTOL = 1e-6
SHAPE = (4, 24, 2)


def jax_model_fn(x, t):
    eps = jnp.sin(1.3 * x + 0.01 * t[:, None, None].astype(jnp.float32))
    var = jnp.tanh(0.7 * x - 0.2)
    return jnp.concatenate([eps, var], axis=-1)


def torch_model_fn(x, t):
    eps = torch.sin(1.3 * x + 0.01 * t[:, None, None].float())
    var = torch.tanh(0.7 * x - 0.2)
    return torch.cat([eps, var], dim=-1)


def replay(draws):
    """A port noise source that hands out ``draws`` in order."""
    it = iter(draws)

    def source(shape):
        draw = next(it)
        assert tuple(draw.shape) == tuple(shape)
        return torch.as_tensor(np.asarray(draw))

    source.left = lambda: sum(1 for _ in it)
    return source


def p_sample_draw(key, shape):
    """The draw ``p_sample`` takes from its key."""
    return jax.random.normal(jax.random.split(key)[0], shape, jnp.float32)


def loop_draws(rng, shape, steps, with_start):
    draws = []
    if with_start:
        rng, sub = jax.random.split(rng)
        draws.append(jax.random.normal(sub, shape, jnp.float32))
    for _ in range(steps):
        rng, sub = jax.random.split(rng)
        draws.append(p_sample_draw(sub, shape))
    return draws


def pair(respacing, **kw):
    return jax_create_diffusion(respacing, **kw), create_diffusion(respacing, **kw)


@pytest.mark.parametrize("name,steps", [("linear", 1000), ("linear", 50), ("squaredcos_cap_v2", 1000),
                                        ("squaredcos_cap_v2", 8)])
def test_named_beta_schedules_are_the_jax_ones(name, steps):
    want = jax_gaussian.get_named_beta_schedule(name, steps)
    got = gaussian.get_named_beta_schedule(name, steps)
    assert got.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    with pytest.raises(NotImplementedError):
        gaussian.get_named_beta_schedule("cosine", steps)


@pytest.mark.parametrize("num,counts", [(1000, [100, 0, 0, 0, 0, 0, 0, 0, 0, 0]), (1000, [250]), (1000, "ddim50"),
                                        (1000, "10,15,20"), (8, [4]), (100, [10]), (7, [3, 2]), (1000, [1000])])
def test_space_timesteps_and_the_respaced_tables_are_the_jax_ones(num, counts):
    assert gaussian.space_timesteps(num, counts) == jax_gaussian.space_timesteps(num, counts)
    want, got = pair(counts, noise_schedule="squaredcos_cap_v2", diffusion_steps=num)
    assert got.timestep_map == want.timestep_map and got.num_timesteps == want.num_timesteps
    for name in ("betas", "alphas_cumprod", "alphas_cumprod_prev", "sqrt_recip_alphas_cumprod",
                 "sqrt_recipm1_alphas_cumprod", "posterior_variance", "posterior_log_variance_clipped",
                 "posterior_mean_coef1", "posterior_mean_coef2"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_space_timesteps_refuses_what_jax_refuses():
    for counts in ("ddim300", [300]):
        with pytest.raises(ValueError):
            jax_gaussian.space_timesteps(200, counts)
        with pytest.raises(ValueError):
            gaussian.space_timesteps(200, counts)


def test_q_sample_matches_jax():
    want_d, got_d = pair([100], noise_schedule="linear", diffusion_steps=1000)
    rng = np.random.default_rng(0)
    x0, noise = (rng.standard_normal(SHAPE).astype(np.float32) for _ in range(2))
    t = np.array([0, 17, 50, 99], np.int32)
    want = want_d.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise))
    got = got_d.q_sample(*(torch.as_tensor(a) for a in (x0, t, noise)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("learn_sigma,predict_xstart", [(True, False), (False, False), (True, True)])
@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("denoised", [False, True])
def test_p_mean_variance_and_p_sample_match_jax(learn_sigma, predict_xstart, clip, denoised):
    want_d, got_d = pair([10], noise_schedule="squaredcos_cap_v2", diffusion_steps=100, learn_sigma=learn_sigma,
                         predict_xstart=predict_xstart)
    rng = np.random.default_rng(1)
    x = (2.5 * rng.standard_normal(SHAPE)).astype(np.float32)
    keep = rng.standard_normal(SHAPE).astype(np.float32)
    inpaint = rng.random(SHAPE) < 0.5
    t = np.array([0, 3, 6, 9], np.int32)

    def jax_fn(x, t):
        out = jax_model_fn(x, t)
        return out if learn_sigma else out[..., :2]

    def torch_fn(x, t):
        out = torch_model_fn(x, t)
        return out if learn_sigma else out[..., :2]

    jax_dn = (lambda p, rng=None: jnp.where(jnp.asarray(inpaint), p, jnp.asarray(keep))) if denoised else None
    port_dn = (lambda p: torch.where(torch.as_tensor(inpaint), p, torch.as_tensor(keep))) if denoised else None
    want = want_d.p_mean_variance(jax_fn, jnp.asarray(x), jnp.asarray(t), clip, jax_dn, jax.random.PRNGKey(3))
    got = got_d.p_mean_variance(torch_fn, torch.as_tensor(x), torch.as_tensor(t), clip, port_dn)
    for name in ("mean", "variance", "log_variance", "pred_xstart"):
        np.testing.assert_allclose(got[name].numpy(), np.broadcast_to(np.asarray(want[name]), got[name].shape),
                                   rtol=RTOL, atol=TOL, err_msg=name)

    key = jax.random.PRNGKey(5)
    want = want_d.p_sample(jax_fn, jnp.asarray(x), jnp.asarray(t), key, clip, jax_dn)
    source = replay([p_sample_draw(key, SHAPE)])
    got = got_d.p_sample(torch_fn, torch.as_tensor(x), torch.as_tensor(t), source, clip, port_dn)
    assert source.left() == 0
    np.testing.assert_allclose(got["sample"].numpy(), np.asarray(want["sample"]), rtol=RTOL, atol=TOL)
    np.testing.assert_allclose(got["pred_xstart"].numpy(), np.asarray(want["pred_xstart"]), rtol=RTOL, atol=TOL)


@pytest.mark.parametrize("given_noise", [True, False])
@pytest.mark.parametrize("start_t", [None, 3])
def test_p_sample_loop_matches_jax(given_noise, start_t):
    want_d, got_d = pair([10], noise_schedule="squaredcos_cap_v2", diffusion_steps=1000)
    rng = jax.random.PRNGKey(7)
    start = np.random.default_rng(2).standard_normal(SHAPE).astype(np.float32) if given_noise else None
    steps = 10 if start_t is None else start_t
    want = want_d.p_sample_loop(jax_model_fn, shape=SHAPE, rng=rng, noise=None if start is None else jnp.asarray(start),
                                start_t=start_t)
    source = replay(loop_draws(rng, SHAPE, steps, with_start=not given_noise))
    got = got_d.p_sample_loop(torch_model_fn, shape=SHAPE, source=source,
                              noise=None if start is None else torch.as_tensor(start), start_t=start_t,
                              device=torch.device("cpu"))
    assert source.left() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("eta", [0.0, 0.6])
def test_ddim_sample_loop_matches_jax(eta):
    want_d, got_d = pair("ddim10", noise_schedule="linear", diffusion_steps=100)
    rng = jax.random.PRNGKey(11)
    inpaint = np.random.default_rng(3).random(SHAPE) < 0.7
    keep = np.zeros(SHAPE, np.float32)
    want = want_d.ddim_sample_loop(jax_model_fn, shape=SHAPE, rng=rng, eta=eta,
                                   denoised_fn=lambda p, r: jnp.where(jnp.asarray(inpaint), p, jnp.asarray(keep)))
    source = replay(loop_draws(rng, SHAPE, 10, with_start=True))
    got = got_d.ddim_sample_loop(torch_model_fn, shape=SHAPE, source=source, eta=eta, device=torch.device("cpu"),
                                 denoised_fn=lambda p: torch.where(torch.as_tensor(inpaint), p, torch.as_tensor(keep)))
    assert source.left() == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


def test_a_generator_source_draws_in_call_order():
    """A ``torch.Generator`` source: two loops from one seed are equal, and
    the loop's draws are the generator's ``randn`` in order."""
    _, got_d = pair([4], noise_schedule="squaredcos_cap_v2", diffusion_steps=8)
    runs = [got_d.p_sample_loop(torch_model_fn, shape=SHAPE, source=torch.Generator().manual_seed(9),
                                device=torch.device("cpu")) for _ in range(2)]
    assert torch.equal(*runs)
    gen = torch.Generator().manual_seed(9)
    draws = [torch.randn(SHAPE, generator=gen) for _ in range(5)]
    again = got_d.p_sample_loop(torch_model_fn, shape=SHAPE, source=replay(draws), device=torch.device("cpu"))
    assert torch.equal(again, runs[0])
    keyed = []
    source = gaussian.scoped(lambda shape, where: keyed.append(where) or torch.zeros(shape), "chunk", 2)
    got_d.p_sample_loop(torch_model_fn, shape=SHAPE, source=source, device=torch.device("cpu"))
    assert keyed == [("chunk", 2, k) for k in range(5)]
