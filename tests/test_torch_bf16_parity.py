"""The port in bf16 against the JAX package in bf16, on the tiny
v32-architecture checkpoint.

Both models compute in bf16 with fp32 parameters (the ``mixed_precision=bf16``
backbone dtype) and take the same audio and prompt. Their teacher-forced
logits are held to the reference's own bf16-against-fp bars
(test_quantize_checkpoint.py:61-62): relative max error below 0.06 and argmax
agreement above 0.8. The two frameworks round at other places in bf16, so
this is the bar, not the fp32 one. Both attention routes of the port are
checked (on the CPU the flash route is its plain version).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.transformer import Attention
from tests.test_torch_model import audio, prompt, tiny  # noqa: F401  (module fixture)

REL_TOL, ARGMAX_AGREEMENT = 0.06, 0.8  # test_quantize_checkpoint.py:61-62


def bf16_models(tiny, flash: bool):  # noqa: F811
    _, jmodel, jparams, tmodel, _ = tiny
    jb = dataclasses.replace(jmodel.config.backbone, dtype=jnp.bfloat16)
    tb = dataclasses.replace(tmodel.cfg.backbone, dtype=torch.bfloat16)
    jm = JaxMapperatorinator(dataclasses.replace(jmodel.config, backbone=jb))
    tm = Mapperatorinator(dataclasses.replace(tmodel.cfg, backbone=tb))
    tm.load_state_dict(tmodel.state_dict())
    for m in tm.modules():
        if isinstance(m, Attention):
            m.use_flash = flash
    return jm, jparams, tm.eval()


@pytest.mark.parametrize("flash", [True, False])
def test_bf16_teacher_forced_logits_match_jax_bf16(tiny, flash):  # noqa: F811
    jm, jparams, tm = bf16_models(tiny, flash)
    frames = audio(2)
    ids, mask = prompt(2, 40, tm.cfg.vocab_size_in)
    want, _ = jm.apply(jparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                       decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                 decoder_attention_mask=torch.from_numpy(mask))
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    rel = np.abs(got - want).max() / (np.abs(want).max() + 1e-9)
    agree = (got.argmax(-1) == want.argmax(-1)).mean()
    assert rel < REL_TOL, rel
    assert agree > ARGMAX_AGREEMENT, agree
