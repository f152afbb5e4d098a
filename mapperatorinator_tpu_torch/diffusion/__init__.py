from .gaussian import GaussianDiffusion, create_diffusion, space_timesteps  # noqa: F401
