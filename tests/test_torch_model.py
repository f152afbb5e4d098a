"""The port's model against the JAX Mapperatorinator on the tiny v32-architecture
checkpoint: encoder states, teacher-forced logits and step-by-step cached
logits, at the reference's own model-level bar (2e-4, test_model.py:77).

Both packages load the same ``params.msgpack``; inputs are made with numpy
from a seed. The torch model is checked through both of its attention routes:
the flash route (on the CPU the kernel's plain version) and the plain
masked-softmax route.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu.models.io import load_checkpoint as jax_load_checkpoint
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.io import load_checkpoint
from mapperatorinator_tpu_torch.models.transformer import Attention
from tests.fixtures.tiny_checkpoint import SRC_SEQ_LEN, make_tiny_checkpoint

# tiny shapes: one thread each, since several test workers share the CPU
torch.set_num_threads(1)

TOL = 2e-4  # test_model.py:77

# (global_attn_every_n_layers, local_attention): the checkpoint's all-global
# layout, and alternating local/global with a narrow band
LAYOUTS = {"global": (1, 128), "local": (2, 16)}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    directory = make_tiny_checkpoint(tmp_path_factory.mktemp("ckpt"))
    jmodel, jparams, vocab = jax_load_checkpoint(directory)
    tmodel, _ = load_checkpoint(directory)
    return directory, jmodel, jparams, tmodel.eval(), vocab


def both_models(tiny, layout: str, flash: bool = True):
    """The checkpoint's JAX and torch models with the attention layout
    replaced (the parameters do not depend on it)."""
    _, jmodel, jparams, tmodel, _ = tiny
    every, window = LAYOUTS[layout]
    jb = dataclasses.replace(jmodel.config.backbone, global_attn_every_n_layers=every, local_attention=window)
    tb = dataclasses.replace(tmodel.cfg.backbone, global_attn_every_n_layers=every, local_attention=window)
    jm = JaxMapperatorinator(dataclasses.replace(jmodel.config, backbone=jb))
    tm = Mapperatorinator(dataclasses.replace(tmodel.cfg, backbone=tb))
    tm.load_state_dict(tmodel.state_dict())
    for m in tm.modules():
        if isinstance(m, Attention):
            m.use_flash = flash
    return jm, jparams, tm.eval()


def audio(batch: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = (SRC_SEQ_LEN - 1) * 128
    t = np.arange(n) / 16000
    x = 0.3 * np.sin(2 * np.pi * 440 * t)[None] + 0.05 * rng.standard_normal((batch, n))
    return x.astype(np.float32)


def prompt(batch: int, length: int, vocab_size: int, seed: int = 1):
    """Random ids; row 1 left-padded by 5 (mask False there)."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, vocab_size, (batch, length)).astype(np.int32)
    mask = np.ones((batch, length), bool)
    if batch > 1:
        ids[1, :5] = 0
        mask[1, :5] = False
    return ids, mask


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("flash", [True, False])
def test_encoder_states_match_jax(tiny, layout, flash):
    jm, jparams, tm = both_models(tiny, layout, flash)
    frames = audio(2)
    want = np.asarray(jm.apply(jparams, jnp.asarray(frames), method=JaxMapperatorinator.encode))
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames)).numpy()
    assert got.shape == want.shape == (2, SRC_SEQ_LEN // 2, 64)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("flash", [True, False])
def test_teacher_forced_logits_match_jax(tiny, layout, flash):
    jm, jparams, tm = both_models(tiny, layout, flash)
    frames = audio(2)
    ids, mask = prompt(2, 40, tm.cfg.vocab_size_in)
    want, _ = jm.apply(jparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                       decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                 decoder_attention_mask=torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("layout,max_len", [("global", 256), ("local", 256), ("global", 320)])
def test_cached_decode_logits_match_jax(tiny, layout, max_len):
    """A chunked prefill of a left-padded prompt, then single steps; 320 slots
    exceed the 256 trained positions, so the dynamic-NTK base applies."""
    jm, jparams, tm = both_models(tiny, layout)
    frames = audio(2)
    ids, mask = prompt(2, 12, tm.cfg.vocab_size_in)
    steps = np.random.default_rng(2).integers(3, tm.cfg.vocab_size_in, (2, 8)).astype(np.int32)

    apply = lambda method, *a, **kw: jm.apply(jparams, *a, method=getattr(JaxMapperatorinator, method), **kw)  # noqa: E731
    step = jax.jit(functools.partial(apply, "decode_step"))
    enc = apply("encode", jnp.asarray(frames))
    cache = apply("init_cache", 2, max_len, enc)
    attn = np.zeros((2, max_len), bool)
    attn[:, :12] = mask
    positions = np.clip(np.cumsum(mask, 1) - 1, 0, None)
    want = []
    logits, cache = step(apply("embed_tokens", jnp.asarray(ids)), cache, 0,
                         self_mask=jnp.asarray(attn)[:, None, None, :], positions=jnp.asarray(positions))
    want.append(np.asarray(logits)[:, -1])
    n_valid = mask.sum(1)
    for i in range(steps.shape[1]):
        attn[:, 12 + i] = True
        logits, cache = step(apply("embed_tokens", jnp.asarray(steps[:, i:i + 1])), cache, 12 + i,
                             self_mask=jnp.asarray(attn)[:, None, None, :],
                             positions=jnp.asarray(n_valid + i)[:, None])
        want.append(np.asarray(logits)[:, -1])

    got = []
    with torch.no_grad():
        enc_t = tm.encode(torch.from_numpy(frames))
        cache_t = tm.init_cache(2, max_len, enc_t)
        attn_t = torch.from_numpy(np.zeros((2, max_len), bool))
        attn_t[:, :12] = torch.from_numpy(mask)
        logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(ids).long()), cache_t, 0,
                                   self_mask=attn_t[:, None, None, :], positions=torch.from_numpy(positions))
        got.append(logits[:, -1].numpy())
        for i in range(steps.shape[1]):
            attn_t[:, 12 + i] = True
            logits, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(steps[:, i:i + 1]).long()), cache_t,
                                       12 + i, self_mask=attn_t[:, None, None, :],
                                       positions=torch.from_numpy(n_valid + i)[:, None])
            got.append(logits[:, -1].numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), rtol=TOL, atol=TOL)


def with_backbone(tiny, layout: str, flash: bool, **change):
    """:func:`both_models` with the backbone fields ``change`` set in both."""
    jm, jparams, tm = both_models(tiny, layout, flash)
    jm = JaxMapperatorinator(dataclasses.replace(jm.config, backbone=dataclasses.replace(jm.config.backbone,
                                                                                         **change)))
    tm2 = Mapperatorinator(dataclasses.replace(tm.cfg, backbone=dataclasses.replace(tm.cfg.backbone, **change)))
    tm2.load_state_dict(tm.state_dict())
    for m in tm2.modules():
        if isinstance(m, Attention):
            m.use_flash = flash
    return jm, jparams, tm2.eval()


def check_forward(jm, jparams, tm) -> None:
    """Teacher-forced logits of a left-padded prompt pair, the port's
    against JAX's."""
    frames = audio(2)
    ids, mask = prompt(2, 32, tm.cfg.vocab_size_in)
    want, _ = jm.apply(jparams, frames=jnp.asarray(frames), decoder_input_ids=jnp.asarray(ids),
                       decoder_attention_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long(),
                 decoder_attention_mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("flash", [True, False])
def test_banded_local_attention_matches_jax(tiny, flash):
    """The checkpoint with ``banded_local_attention`` on and the local
    layout's narrow band: the port's encoder states and teacher-forced
    logits against the JAX model built with the same flag."""
    jm, jparams, tm = with_backbone(tiny, "local", flash, banded_local_attention=True)
    frames = audio(2)
    want = jm.apply(jparams, jnp.asarray(frames), method=JaxMapperatorinator.encode)
    with torch.no_grad():
        got = tm.encode(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    check_forward(jm, jparams, tm)


@pytest.mark.parametrize("flash", [True, False])
def test_scale_embedding_matches_jax(tiny, flash):
    """``scale_embedding`` on (the decoder's input rows times sqrt(d_model),
    as in HF configs that set it): the port's teacher-forced logits and a
    cached prefill and step against the JAX model built with the same flag,
    and the flag changes the logits."""
    jm, jparams, tm = with_backbone(tiny, "global", flash, scale_embedding=True)
    check_forward(jm, jparams, tm)
    frames = audio(1)
    ids, _ = prompt(1, 6, tm.cfg.vocab_size_in)
    apply = lambda method, *a, **kw: jm.apply(jparams, *a, method=getattr(JaxMapperatorinator, method), **kw)  # noqa: E731
    enc = apply("encode", jnp.asarray(frames))
    cache = apply("init_cache", 1, 16, enc)
    want, cache = apply("decode_step", apply("embed_tokens", jnp.asarray(ids)), cache, 0)
    want_step, _ = apply("decode_step", apply("embed_tokens", jnp.asarray(ids[:, :1])), cache, 6,
                         positions=jnp.asarray([[6]]))
    _, _, plain = both_models(tiny, "global", flash)
    with torch.no_grad():
        cache_t = tm.init_cache(1, 16, tm.encode(torch.from_numpy(frames)))
        got, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(ids).long()), cache_t, 0)
        got_step, _ = tm.decode_step(tm.embed_tokens(torch.from_numpy(ids[:, :1]).long()), cache_t, 6,
                                     positions=torch.tensor([[6]]))
        unscaled = plain(torch.from_numpy(frames), decoder_input_ids=torch.from_numpy(ids).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got_step.numpy(), np.asarray(want_step), rtol=TOL, atol=TOL)
    assert not np.allclose(got.numpy(), unscaled.numpy(), atol=1e-2)


def test_unported_families_raise(tiny):
    """What the port still cannot build raises: a norm scheme, stem or
    position scheme no JAX branch takes, and an unknown activation. The
    families that raised here before (nGPT, moonshine's stem, its gated
    decoder feed-forward and ``input_raw_wave``) build:
    ``tests/test_torch_ngpt.py`` and ``tests/test_torch_moonshine.py`` hold
    them to the JAX package. So does a head dim past 128, which the JAX
    package builds too: on a card its first kernel call raises."""
    _, _, _, tmodel, _ = tiny
    for change, match in (({"norm_scheme": "postnorm"}, "norm_scheme"), ({"stem_type": "conformer"}, "stem_type"),
                          ({"position_scheme": "alibi"}, "position_scheme"), ({"activation": "swish"}, "activation")):
        cfg = dataclasses.replace(tmodel.cfg, backbone=dataclasses.replace(tmodel.cfg.backbone, **change))
        with pytest.raises(NotImplementedError, match=match):
            Mapperatorinator(cfg)
    for change in ({"decoder_ffn_gated_concat": True, "decoder_activation": "silu"}, {"norm_scheme": "ngpt"},
                   {"stem_type": "moonshine"}, {"head_dim_override": 160}, {"d_model": 1088, "decoder_heads": 4}):
        cfg = dataclasses.replace(tmodel.cfg, backbone=dataclasses.replace(tmodel.cfg.backbone, **change))
        with torch.device("meta"):
            Mapperatorinator(cfg)
    with torch.device("meta"):
        model = Mapperatorinator(dataclasses.replace(tmodel.cfg, input_raw_wave=True, backbone=dataclasses.replace(
            tmodel.cfg.backbone, stem_type="moonshine")))
    assert model.transformer.encoder.conv1.weight.shape[1:] == (1, 127)
