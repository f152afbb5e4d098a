"""The port's decode loop (one device-indexed step over static buffers, the
cached attention reading a bucketed prefix of the cache) against the JAX
engine's compiled loop, on the CPU, where the port runs the step eagerly.

Both packages' models take ``decode_attend_bucket`` 16, so a decode crosses
several buckets: the port reads a bucket's prefix at every batch size, the
JAX engine at batch 2 and up (at batch 1 it reads the whole buffer).

* greedy tokens and the returned end position equal JAX ``generate``'s, at
  B 1 and at B 2 (a CFG 3 pair), with fp32 and with int8 weights and KV;
* the bucketed read equals the full-buffer read at the last slot of a bucket
  and at the first slot of the next;
* with the sampled v32 pipeline, the processed step scores equal JAX
  ``generate_forced``'s along the port's tokens;
* sampling draws what ``torch.multinomial`` draws from the same generator;
* the tokens do not depend on how often the host reads whether every row
  has finished, and a decode that never finishes stops at ``max_length``;
* ``precompile`` and ``inference.run``'s ``precompile=true`` warm the engine
  and leave its results as they were.
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mapperatorinator_tpu.decode import DecodeEngine as JaxDecodeEngine
from mapperatorinator_tpu.decode import logits as jax_logits
from mapperatorinator_tpu.models import Mapperatorinator as JaxMapperatorinator
from mapperatorinator_tpu.models.io import quantize_checkpoint
from mapperatorinator_tpu_torch import inference
from mapperatorinator_tpu_torch.config import load_config
from mapperatorinator_tpu_torch.decode import DecodeEngine
from mapperatorinator_tpu_torch.decode import engine as engine_module
from mapperatorinator_tpu_torch.decode import logits as torch_logits
from mapperatorinator_tpu_torch.models import Mapperatorinator
from mapperatorinator_tpu_torch.models.io import quantize_model
from mapperatorinator_tpu_torch.models.transformer import decode_read_limit
from mapperatorinator_tpu_torch.osu import Vocabulary as PortVocabulary
from tests.fixtures.tiny_checkpoint import SRC_SEQ_LEN, make_wav
from tests.test_torch_decode import LOGITS_TOL, PIPELINES, assert_scores_close, decode_prompt
from tests.test_torch_model import audio, tiny  # noqa: F401  (module fixture)
from tests.test_torch_qmm import lane_tiny  # noqa: F401  (module fixture)

torch.set_num_threads(1)

BUCKET = 16
MAX_LEN = 80  # a 20-token prompt's decode crosses the buckets ending at 32, 48 and 64
# the bucketed read against the full buffer: the masked keys add exactly 0,
# so only the order of the sums differs
READ_TOL = 1e-6


def bucketed(jmodel, tmodel, **backbone):
    """The two models with ``decode_attend_bucket`` BUCKET (and ``backbone``'s
    other fields); the parameters do not depend on them."""
    fields = dict(decode_attend_bucket=BUCKET, **backbone)
    jm = JaxMapperatorinator(dataclasses.replace(
        jmodel.config, backbone=dataclasses.replace(jmodel.config.backbone, **fields)))
    tm = Mapperatorinator(dataclasses.replace(tmodel.cfg, backbone=dataclasses.replace(tmodel.cfg.backbone, **fields)))
    tm.load_state_dict(tmodel.state_dict())
    return jm, tm.eval()


@pytest.fixture(scope="module")
def models(tiny, lane_tiny):  # noqa: F811
    """{"fp32": fp32 weights and KV, "int8": int8 weights and KV (at the lane
    widths, where the JAX QDense runs its qmm kernel)} -> (JAX engine, port
    engine, vocab), both at MAX_LEN with BUCKET."""
    out = {}
    _, jmodel, jparams, tmodel, vocab = tiny
    jm, tm = bucketed(jmodel, tmodel)
    out["fp32"] = (JaxDecodeEngine(jm, jparams, MAX_LEN, vocab.pad_id),
                   DecodeEngine(tm, MAX_LEN, vocab.pad_id, device="cpu"), vocab)
    _, jmodel, jparams, tmodel, vocab = lane_tiny
    jq, jqparams = quantize_checkpoint(jmodel, jparams)
    jm, tm = bucketed(jq, quantize_model(tmodel), quantized_kv=True)
    out["int8"] = (JaxDecodeEngine(jm, jqparams, MAX_LEN, vocab.pad_id),
                   DecodeEngine(tm, MAX_LEN, vocab.pad_id, device="cpu"), vocab)
    return out


def pipelines(vocab, **kw):
    return (jax_logits.build_logits_pipeline(vocab, **kw),
            torch_logits.build_logits_pipeline(PortVocabulary.from_state_dict(vocab.state_dict()), **kw))


def encoded(jeng, teng, cfg: bool):
    """Both engines' encoder states of one window, doubled for a CFG pair."""
    frames = audio(1)
    jenc, tenc = jeng.encode_with_cond(frames), teng.encode_with_cond(frames)
    if cfg:
        return jnp.concatenate([jenc, jenc]), torch.cat([tenc, tenc])
    return jenc, tenc


@pytest.mark.parametrize("rows,cfg_scale", [(1, 1.0), (2, 3.0)])
@pytest.mark.parametrize("weights", ["fp32", "int8"])
def test_greedy_tokens_and_end_match_jax(models, weights, rows, cfg_scale):
    jeng, teng, vocab = models[weights]
    ids = decode_prompt(vocab, rows)
    jp, tp = pipelines(vocab, do_sample=False, cfg_scale=cfg_scale)
    jenc, tenc = encoded(jeng, teng, cfg_scale > 1)
    want, want_end = jeng.generate(jenc, ids, jp, [vocab.eos_id], seed=0, cfg_scale=cfg_scale)
    got, got_end = teng.generate(tenc, ids, tp, [vocab.eos_id], seed=0, cfg_scale=cfg_scale)
    reads = {decode_read_limit(BUCKET, i, MAX_LEN) for i in range(ids.shape[1] - 1, got_end - 1)}
    assert len(reads) >= 4, f"the decode read {sorted(reads)}: it crossed fewer than three buckets"
    np.testing.assert_array_equal(got, want)
    assert got_end == int(want_end)


@pytest.mark.parametrize("kv", ["fp32", "int8"])
@pytest.mark.parametrize("slot", [BUCKET - 1, BUCKET])
def test_bucketed_read_matches_the_full_buffer(tiny, kv, slot):  # noqa: F811
    """One cached step at ``slot`` (the last slot of the first bucket, the
    first of the second) after a prefill of the slots before it, two rows,
    one of them left-padded: reading the bucket's prefix against the
    buffer's MAX_LEN slots."""
    _, jmodel, _, tmodel, vocab = tiny
    _, tm = bucketed(jmodel, tmodel, quantized_kv=kv == "int8")
    rng = np.random.default_rng(4)
    ids = torch.from_numpy(rng.integers(3, tm.cfg.vocab_size_in, (2, slot + 1))).long()
    mask = torch.ones((2, MAX_LEN), dtype=torch.bool)
    mask[1, :3] = False
    positions = (torch.cumsum(mask[:, :slot + 1].long(), 1) - 1).clamp(min=0)
    limit = decode_read_limit(BUCKET, slot, MAX_LEN)
    assert limit == (BUCKET if slot < BUCKET else 2 * BUCKET)
    with torch.no_grad():
        enc = tm.encode(torch.from_numpy(audio(2)))
        logits = {}
        for read in (limit, MAX_LEN):
            cache = tm.init_cache(2, MAX_LEN, enc)
            tm.decode_step(tm.embed_tokens(ids[:, :slot]), cache, 0, self_mask=mask[:, None, None, :],
                           positions=positions[:, :slot])
            logits[read], _ = tm.decode_step(tm.embed_tokens(ids[:, slot:]), cache, torch.tensor(slot),
                                             self_mask=mask[:, None, None, :], positions=positions[:, slot:],
                                             limit=read)
    torch.testing.assert_close(logits[limit], logits[MAX_LEN], rtol=READ_TOL, atol=READ_TOL)


@pytest.mark.parametrize("rows,cfg_scale", [(1, 1.0), (2, 3.0)])
def test_sampled_step_scores_match_jax_generate_forced(models, rows, cfg_scale):
    jeng, teng, vocab = models["fp32"]
    ids = decode_prompt(vocab, rows)
    jp, tp = pipelines(vocab, cfg_scale=cfg_scale, **PIPELINES["sampled-v32"])
    jenc, tenc = encoded(jeng, teng, cfg_scale > 1)
    steps = []
    tokens, end = teng.generate(tenc, ids, tp, [vocab.eos_id], seed=5, cfg_scale=cfg_scale, step_logits=steps)
    half = rows // 2 if cfg_scale > 1 else rows
    forced = tokens[-half:, ids.shape[1]:end]
    assert forced.shape[1] == len(steps) > BUCKET
    want = jeng.generate_forced(jenc, ids, jp, forced, cfg_scale=cfg_scale)
    assert_scores_close(torch.stack(steps, dim=1).numpy(), want, LOGITS_TOL)


def test_sampling_draws_what_multinomial_draws(models):
    """The step's exponential race, noise drawn a block at a time, picks the
    tokens that ``torch.multinomial`` picks from the same generator."""
    _, teng, vocab = models["fp32"]
    _, tp = pipelines(vocab, **PIPELINES["sampled-v32"])
    enc = teng.encode_with_cond(audio(1))
    ids = decode_prompt(vocab, 1)
    steps = []
    tokens, end = teng.generate(enc, ids, tp, [vocab.eos_id], seed=11, step_logits=steps)
    gen = torch.Generator().manual_seed(11)
    want = [int(torch.multinomial(torch.softmax(s, dim=-1), 1, generator=gen)[0, 0]) for s in steps]
    assert len(want) > engine_module.NOISE_BLOCK
    assert tokens[0, ids.shape[1]:end].tolist() == want


@pytest.mark.parametrize("rows,cfg_scale", [(1, 1.0), (2, 3.0)])
def test_tokens_do_not_depend_on_how_often_finished_is_read(models, rows, cfg_scale):
    """Sampled decode with the lookahead's time shifts as EOS, which ends it
    before MAX_LEN: ``finished`` read after every step, and every 8 (the
    steps past the stop write pad)."""
    _, teng, vocab = models["fp32"]
    ids = decode_prompt(vocab, rows)
    _, tp = pipelines(vocab, cfg_scale=cfg_scale, **PIPELINES["sampled-v32"])
    _, tenc = encoded(*models["fp32"][:2], cfg_scale > 1)
    eos = jax_logits.get_eos_token_ids(vocab, lookahead_time=2000.0)
    results = []
    for every in (1, 8):
        teng.sync_every = every
        results.append(teng.generate(tenc, ids, tp, eos, seed=3, cfg_scale=cfg_scale))
    teng.sync_every = engine_module.SYNC_EVERY
    (one, one_end), (eight, eight_end) = results
    assert one_end == eight_end < MAX_LEN and (one_end - ids.shape[1]) % 8
    np.testing.assert_array_equal(one, eight)


def test_a_decode_that_never_finishes_stops_at_max_length(models):
    jeng, teng, vocab = models["fp32"]
    ids = decode_prompt(vocab, 2)
    jp, tp = pipelines(vocab, do_sample=False)
    jenc, tenc = jeng.encode_with_cond(audio(2)), teng.encode_with_cond(audio(2))
    max_length = 61  # 41 steps after the 20-token prompt: not a multiple of the host's read interval
    want, want_end = jeng.generate(jenc, ids, jp, [], seed=0, max_length=max_length)
    got, got_end = teng.generate(tenc, ids, tp, [], seed=0, max_length=max_length)
    assert got_end == int(want_end) == max_length and got.shape == (2, max_length)
    np.testing.assert_array_equal(got, want)


def test_precompile_warms_the_engine_without_changing_results(tiny, monkeypatch, tmp_path):  # noqa: F811
    """``precompile`` allocates the decode buffers for a batch shape and runs
    its prefill ladder; ``run`` with ``precompile=true`` warms the engine it
    loads for B 1 and B 2 (``warm_engine``, as the JAX ``run`` does)."""
    directory, _, _, tmodel, vocab = tiny
    _, tp = pipelines(vocab, do_sample=False)
    ids = decode_prompt(vocab, 1)
    cold = DecodeEngine(tmodel, MAX_LEN, vocab.pad_id, device="cpu")
    warm = DecodeEngine(tmodel, MAX_LEN, vocab.pad_id, device="cpu")
    enc = cold.encode_with_cond(audio(1))
    warm.precompile(enc, max_prompt=100)
    assert len(warm._states) == 1
    np.testing.assert_array_equal(warm.generate(enc, ids, tp, [vocab.eos_id])[0],
                                  cold.generate(enc, ids, tp, [vocab.eos_id])[0])

    inference.warm_engine(warm, SimpleNamespace(data=SimpleNamespace(src_seq_len=SRC_SEQ_LEN, hop_length=128)))
    assert sorted(key[0] for key in warm._states) == [1, 2]

    loaded = {}
    monkeypatch.setattr(inference, "generate", lambda args, engine, **kw: loaded.setdefault("engine", engine))
    args = load_config("v32", [f"model_path={directory}", "device=cpu", "gamemode=0", "precompile=true",
                               f"train.data.src_seq_len={SRC_SEQ_LEN}", f"train.data.tgt_seq_len={MAX_LEN}",
                               f"audio_path={make_wav(tmp_path / 'song.wav', seconds=1.0)}",
                               f"output_path={tmp_path}"])
    inference.run(args)
    assert sorted(key[:2] for key in loaded["engine"]._states) == [(1, MAX_LEN), (2, MAX_LEN)]
