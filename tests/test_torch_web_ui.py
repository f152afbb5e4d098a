"""The port's web UI (``python -m mapperatorinator_tpu_torch.web_ui``) and
MaiMod UI against the repo's JAX ``web_ui.py``, on the CPU:

* ``build_inference_config`` and ``validate_and_autofill`` give the fields
  the JAX ones give for the forms test_web_ui.py posts;
* every route test_web_ui.py exercises, served from the repo's unchanged
  ``template/`` and ``static/`` files;
* a generation job and a MaiMod job on the tiny checkpoint, each in a
  spawned worker on the server's ``--device cpu``, which write an ``.osu``
  and stream suggestions;
* ``mai_mod_ui``'s page.
"""

import json
import random
import threading
import time
import urllib.error
import urllib.parse
import urllib.request
from enum import Enum

import numpy as np
import pytest

import web_ui as jax_web_ui
from mapperatorinator_tpu_torch import mai_mod_ui, web_ui
from tests.fixtures.tiny_checkpoint import SRC_SEQ_LEN, TGT_SEQ_LEN, make_tiny_checkpoint, make_wav
from tests.test_beatmap import SIMPLE_OSU
from tests.test_web_ui import EXPECTED_FIELDS, FormScanner


def start(server):
    threading.Thread(target=server.serve_forever, daemon=True).start()
    return f"http://127.0.0.1:{server.server_address[1]}"


@pytest.fixture(scope="module")
def server():
    httpd = web_ui.make_server(0, device="cpu")
    yield start(httpd)
    httpd.shutdown()


def _get(url):
    try:
        with urllib.request.urlopen(url) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _post(url, fields):
    data = urllib.parse.urlencode(fields, doseq=True).encode()
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _stream(url, deadline_s: float = 300):
    """(the streamed lines, the suggestions) of a job, to its __DONE__."""
    lines, suggestions = [], []
    deadline = time.time() + deadline_s
    with urllib.request.urlopen(url) as resp:
        while time.time() < deadline:
            line = resp.readline().decode()
            if not line:
                break
            lines.append(line)
            if line.startswith("data: __SUGGESTION__"):
                suggestions.append(json.loads(line[len("data: __SUGGESTION__"):]))
            elif line.startswith("data: __DONE__"):
                return lines, suggestions
            elif line.startswith("data: __ERROR__"):
                raise AssertionError(f"the job failed: {''.join(lines[-30:])}")
    raise AssertionError(f"the stream did not finish: {''.join(lines[-30:])}")


def plain(value):
    if isinstance(value, Enum):
        return value.value
    if isinstance(value, (list, tuple)):
        return [plain(v) for v in value]
    return value


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ui")
    ckpt = make_tiny_checkpoint(root / "ckpt")
    wav = make_wav(root / "Artist - Title.wav", seconds=4.0)
    osu = root / "fixture.osu"
    osu.write_text(SIMPLE_OSU)
    return root, ckpt, wav, osu


def generation_form(ckpt, wav, out_dir):
    """The form test_web_ui.py posts to /start_inference."""
    return {"model": "v32", "model_path": str(ckpt), "audio_path": str(wav), "output_path": str(out_dir),
            "gamemode": "0", "difficulty": "4.5", "seed": "3", "title": "WebUI", "artist": "pytest",
            "creator": "ci", "version": "dom", "src_seq_len": str(SRC_SEQ_LEN), "tgt_seq_len": str(TGT_SEQ_LEN)}


def test_build_inference_config_matches_jax(files):
    root, ckpt, wav, osu = files
    forms = [generation_form(ckpt, wav, root),
             {"model": "v31", "beatmap_path": str(osu), "audio_path": str(wav), "in_context_options": ["TIMING"],
              "descriptors": ["jump aim", "clean"], "enable_bf16": "on", "super_timing": "on", "cfg_scale": "2.5",
              "background_image": "bg.png"}]
    for form in forms:
        parsed = {k: v if isinstance(v, list) else [v] for k, v in form.items()}
        want = jax_web_ui.build_inference_config(parsed)
        got = web_ui.build_inference_config(parsed)
        for field in vars(want):
            if field in ("train", "diffusion"):
                continue
            assert plain(getattr(got, field)) == plain(getattr(want, field)), field
        assert got.train.data.src_seq_len == want.train.data.src_seq_len
        assert got.train.data.tgt_seq_len == want.train.data.tgt_seq_len
        assert got.device == "auto"  # the preset's own: the card, where no --device is given
    assert web_ui.build_inference_config({"device": ["cpu"]}).device == "cpu"


def test_validate_and_autofill_matches_jax(files, tmp_path):
    _, _, wav, _ = files
    bad = tmp_path / "song.txt"
    bad.write_text("not a beatmap")
    for form in ({"audio_path": "/nope.wav"}, {"audio_path": ""}, {"beatmap_path": str(bad)},
                 {"audio_path": str(wav)}):
        parsed = {k: [v] for k, v in form.items()}
        random.seed(1)  # compile_seed draws the seed
        want = jax_web_ui.validate_and_autofill(parsed)
        random.seed(1)
        got = web_ui.validate_and_autofill(parsed)
        if got["success"]:
            # the JAX compile_args resolves "auto" to the platform JAX sees; the port's stays the card
            assert got["autofilled_args"].pop("device") == "auto"
            want["autofilled_args"].pop("device")
        assert got == want, form
    assert got["success"] and got["autofilled_args"]["output_path"] == str(wav.parent)


def test_index_serves_every_inference_option(server):
    status, body = _get(server + "/")
    assert status == 200
    scanner = FormScanner()
    scanner.feed(body)
    assert not EXPECTED_FIELDS - scanner.names
    assert {"generate-btn", "cancel-btn", "log"} <= scanner.ids


def test_mai_mod_pages(server):
    status, body = _get(server + "/mai-mod")
    assert status == 200
    scanner = FormScanner()
    scanner.feed(body)
    assert {"beatmap_path", "audio_path", "model"} <= scanner.names and "results" in scanner.ids
    httpd = web_ui.make_server(0, handler=mai_mod_ui.MaiModHandler)
    try:
        url = start(httpd)
        assert _get(url + "/") == (200, body)
        assert _get(url + "/static/app_mai_mod.js")[0] == 200
    finally:
        httpd.shutdown()


@pytest.mark.parametrize("path,marker", [
    ("/static/app.js", "start_inference"), ("/static/app_mai_mod.js", "start_mai_mod"),
    ("/static/style.css", "--accent"), ("/static/i18n.js", "localStorage"),
    ("/static/i18n/en.json", "field.difficulty"), ("/static/i18n/ru.json", "field.difficulty"),
    ("/static/i18n/zh-CN.json", "field.difficulty")])
def test_static_assets_and_i18n(server, path, marker):
    status, body = _get(server + path)
    assert status == 200 and marker in body


def test_json_routes(server, tmp_path, monkeypatch):
    status, body = _get(server + "/models")
    assert status == 200 and json.loads(body) == jax_web_ui.list_model_presets() == \
        ["v28", "v29", "v30", "v31", "v32", "v32-mini"]
    status, body = _get(server + "/descriptors")
    assert status == 200 and json.loads(body) == jax_web_ui.load_descriptors()
    assert _get(server + "/check_bf16_support") == (200, json.dumps({"supported": True}))
    assert _post(server + "/validate_paths", {"audio_path": "/nope.wav"})[1]["errors"] == \
        ["Audio file not found: /nope.wav"]
    assert _post(server + "/cancel_inference", {"job_id": "nope"}) == (200, {"status": "not running"})
    status, out = _post(server + "/start_inference", {"model": "no_such_preset"})
    assert status == 400 and out["status"] == "error"
    assert _post(server + "/start_mai_mod", {"audio_path": "x.wav"})[0] == 400
    assert _post(server + "/nope", {})[0] == 404
    monkeypatch.setattr(web_ui, "CONFIG_SAVE_PATH", tmp_path / "ui.json")
    status, out = _post(server + "/save_config", {"model": "v32", "descriptors": ["a", "b"]})
    assert status == 200 and json.loads((tmp_path / "ui.json").read_text()) == {"model": "v32",
                                                                                  "descriptors": ["a", "b"]}
    assert _post(server + "/open_log_file", {"path": str(tmp_path / "ui.json")})[0] == 403


def test_static_path_traversal_forbidden(server):
    for path in ("/static/../web_ui.py", "/static/%2e%2e/web_ui.py"):
        status, body = _get(server + path)
        assert status in (403, 404) and "REPO_ROOT" not in body


def _quick_worker(form, q, log_path=None):
    # module-level: spawned processes must pickle the target
    q.put(f"device {form.get('device')}")
    q.put("__DONE__")


def test_finished_jobs_are_reaped(server):
    job_id = web_ui._spawn(_quick_worker, {"device": ["cpu"]})
    with web_ui.JOBS_LOCK:
        assert job_id in web_ui.JOBS
    lines, _ = _stream(server + f"/stream_output?job_id={job_id}", 60)
    assert any("device ['cpu']" in line for line in lines)
    deadline = time.time() + 10
    while time.time() < deadline:
        with web_ui.JOBS_LOCK:
            if job_id not in web_ui.JOBS:
                break
        time.sleep(0.2)
    with web_ui.JOBS_LOCK:
        assert job_id not in web_ui.JOBS


def test_generation_and_mai_mod_jobs_on_the_cpu(server, files, tmp_path):
    _, ckpt, wav, osu = files
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    # a form's device is ignored: the server's --device (cpu) decides, so this job runs
    status, out = _post(server + "/start_inference", {**generation_form(ckpt, wav, out_dir), "device": "cuda"})
    assert status == 202, out
    lines, _ = _stream(server + f"/stream_output?job_id={out['job_id']}")
    [written] = out_dir.glob("*.osu")
    assert "[HitObjects]" in written.read_text()
    log = (web_ui.LOG_DIR / f"{out['job_id']}.log").read_text()
    assert "Generated beatmap saved to" in log or str(written) in log

    fields = {"model": "v32", "model_path": str(ckpt), "beatmap_path": str(osu), "audio_path": str(wav),
              "surprisal_threshold": "0", "src_seq_len": str(SRC_SEQ_LEN), "tgt_seq_len": str(TGT_SEQ_LEN)}
    status, out = _post(server + "/start_mai_mod", fields)
    assert status == 202, out
    _, suggestions = _stream(server + f"/stream_output?job_id={out['job_id']}")
    assert suggestions
    for s in suggestions:
        assert s["category"] and s["edit_link"].startswith("osu://edit/") and np.isfinite(s["surprisal"])
