from .gaussian import GaussianDiffusion, create_diffusion, space_timesteps  # noqa: F401
from .schedule_sampler import ScheduleSampler, make_schedule_sampler  # noqa: F401
