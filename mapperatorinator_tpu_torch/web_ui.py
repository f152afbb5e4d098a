"""Web UI for beatmap generation on the port (the repo's ``web_ui.py``).

A dependency-free HTTP app (stdlib ``http.server``) with the routes of the
repo's UI, whose ``template/`` pages and ``static/`` scripts it serves
unchanged:

* ``/`` — the generation form, ``/mai-mod`` — the MaiMod analysis page,
* ``/start_inference`` / ``/start_mai_mod`` — start a worker process running
  :func:`.inference.run` / :func:`.mai_mod.run_analysis`,
* ``/stream_output?job_id=`` — server-sent events from the worker,
* ``/cancel_inference``, ``/validate_paths``, ``/save_config``,
  ``/open_log_file``, ``/open_folder``, ``/models``, ``/descriptors``,
  ``/check_bf16_support``.

Run::

    python -m mapperatorinator_tpu_torch.web_ui [--port 8765] [--device cpu] [--window]

The form composes the repo's inference presets (``configs/inference/<model>.yaml``).
Jobs start in a ``spawn`` context, so the server process never touches
CUDA: each worker selects its device itself (:func:`.config.select_device`),
the one ``--device`` names, by default the presets' own, which is the card.
``--window`` opens a desktop shell via pywebview where it is installed, and
falls back to printing the URL.
"""

from __future__ import annotations

import json
import multiprocessing
import os
import queue
import subprocess
import sys
import threading
import urllib.parse
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

from .config import CONFIGS, load_config
from .osu.events import ContextType

REPO_ROOT = Path(__file__).resolve().parents[1]

CONFIG_SAVE_PATH = Path.home() / ".mapperatorinator_tpu_torch_ui.json"
LOG_DIR = REPO_ROOT / "logs" / "web_ui"

# job_id -> {"process": Process, "queue": Queue}
JOBS: dict = {}
JOBS_LOCK = threading.Lock()

_OPTIONAL_INT = (
    "gamemode year mapper_id beatmap_id keycount seed start_time end_time preview_time"
).split()
_OPTIONAL_FLOAT = (
    "difficulty hp_drain_rate circle_size overall_difficulty approach_rate "
    "slider_multiplier slider_tick_rate hold_note_ratio scroll_speed_ratio "
    "cfg_scale temperature top_p"
).split()
_STRINGS = (
    "audio_path output_path beatmap_path lora_path model_path title title_unicode "
    "artist artist_unicode creator version source tags background_image"
).split()
_CHECKBOXES = (
    "export_osz add_to_beatmap overwrite_reference_beatmap hitsounded super_timing"
).split()


def _first(form: dict, key: str):
    v = form.get(key)
    return v[0] if v else None


def _apply_device(args, form: dict) -> None:
    """The device the server was started with (``--device``), which it puts
    in each job's form; without one the preset's own stays."""
    device = _first(form, "device")
    if device:
        args.device = device


def build_inference_config(form: dict):
    """Form fields -> the composed inference config (mirrors the reference's
    start_inference coercion, web-ui.py:535-640)."""
    config_name = _first(form, "model") or "v32"
    args = load_config(config_name)

    for key in _STRINGS:
        v = _first(form, key)
        if v:
            if key == "background_image":
                args.background = v
            else:
                setattr(args, key, v)
    for key in _OPTIONAL_INT:
        v = _first(form, key)
        if v not in (None, ""):
            setattr(args, key, int(float(v)))
    for key in _OPTIONAL_FLOAT:
        v = _first(form, key)
        if v not in (None, ""):
            setattr(args, key, float(v))
    for key in _CHECKBOXES:
        if _first(form, key) in ("on", "true", "1"):
            setattr(args, key, True)
    if _first(form, "enable_bf16") in ("on", "true", "1"):
        args.precision = "bf16"

    # window-length overrides (tiny checkpoints / tests)
    for key in ("src_seq_len", "tgt_seq_len"):
        v = _first(form, key)
        if v not in (None, ""):
            setattr(args.train.data, key, int(v))

    descriptors = form.get("descriptors") or []
    args.descriptors = descriptors or None
    negative = form.get("negative_descriptors") or []
    args.negative_descriptors = negative or None

    in_context = form.get("in_context_options") or []
    if in_context and args.beatmap_path:
        args.in_context = [ContextType[o] for o in in_context]
    _apply_device(args, form)
    return args


def _queue_writer(q, log_path=None):
    """Worker stdout shim: lines go to the SSE queue and (when a path is
    given) to the job's log file, which /open_log_file serves later
    (reference: web-ui.py:818-855 opens per-run log files)."""
    log_file = open(log_path, "a", encoding="utf-8") if log_path else None

    class Writer:
        def write(self, s):
            s = s.strip()
            if s:
                for line in s.splitlines():
                    q.put(line)
                    if log_file is not None:
                        log_file.write(line + "\n")
                        log_file.flush()

        def flush(self):
            pass

        def isatty(self):
            return False

    return Writer()


def _inference_worker(form: dict, q, log_path=None) -> None:
    import traceback

    sys.stdout = sys.stderr = _queue_writer(q, log_path)
    try:
        args = build_inference_config(form)
        from . import inference

        inference.run(args)
        q.put("__DONE__")
    except Exception as e:  # surfaced in the UI log
        traceback.print_exc()
        q.put(f"__ERROR__{e}")


def _mai_mod_worker(form: dict, q, log_path=None) -> None:
    import dataclasses
    import traceback

    sys.stdout = sys.stderr = _queue_writer(q, log_path)
    try:
        config_name = _first(form, "model") or "v31"
        args = load_config(config_name)
        if _first(form, "model_path"):
            args.model_path = _first(form, "model_path")
        args.beatmap_path = _first(form, "beatmap_path")
        if _first(form, "audio_path"):
            args.audio_path = _first(form, "audio_path")
        gm = _first(form, "gamemode")
        if gm not in (None, ""):
            args.gamemode = int(gm)
        # window-length overrides (tiny checkpoints / tests)
        for key in ("src_seq_len", "tgt_seq_len"):
            v = _first(form, key)
            if v not in (None, ""):
                setattr(args.train.data, key, int(v))
        _apply_device(args, form)

        from . import mai_mod

        threshold = float(_first(form, "surprisal_threshold") or 20.0)
        suggestions = mai_mod.run_analysis(args, surprisal_threshold=threshold)
        for s in suggestions:
            q.put("__SUGGESTION__" + json.dumps(dataclasses.asdict(s) if dataclasses.is_dataclass(s) else s))
        q.put("__DONE__")
    except Exception as e:
        traceback.print_exc()
        q.put(f"__ERROR__{e}")


def validate_and_autofill(form: dict) -> dict:
    """The reference's /validate_paths contract (web-ui.py:881-925): run the
    CLI's own ``compile_args`` on the submitted paths and return either the
    autofilled argument values (shown as input placeholders client-side) or
    the ValueError text as a user-facing validation error."""
    try:
        from . import inference as inf

        config_name = _first(form, "model") or "v32"
        args = load_config(config_name)
        args.audio_path = (_first(form, "audio_path") or "").strip()
        args.beatmap_path = (_first(form, "beatmap_path") or "").strip()
        args.output_path = (_first(form, "output_path") or "").strip()

        try:
            inf.compile_args(args, verbose=False)
        except ValueError as v:
            return {"success": False, "autofilled_args": None, "errors": [str(v)]}

        autofilled = dict(vars(args))
        for key in ("in_context", "output_type", "train", "diffusion"):
            autofilled.pop(key, None)
        # every remaining value must be JSON-clean for the stdlib handler
        autofilled = {k: (v if isinstance(v, (str, int, float, bool, list)) or v is None else str(v))
                      for k, v in autofilled.items()}
        return {"success": True, "autofilled_args": autofilled, "errors": []}
    except Exception as e:  # unexpected failure, reference returns the text
        return {"success": False, "autofilled_args": None,
                "errors": [f"Error during path validation: {e}"]}


def list_model_presets() -> list[str]:
    """The inference presets, ``configs/inference/*.yaml`` but the default,
    as the JAX UI lists them."""
    names = sorted(
        p.stem for p in (CONFIGS / "inference").glob("*.yaml")
        if p.stem != "default"
    )
    return names


def _datasets_dirs() -> list[Path]:
    dirs = []
    env = os.environ.get("MAPPERATORINATOR_DATASETS")
    if env:
        dirs.append(Path(env))
    dirs.append(REPO_ROOT / "datasets")
    return dirs


def load_descriptors() -> dict:
    """Grouped descriptor sets for the multiselect, from the datasets JSON
    files (reference: web-ui.py:44-100 loads omdb_descriptors.json and
    tags_2026.json into {groups: [{key, title, items}]})."""
    sets = {}
    for set_name, filename in (("omdb", "omdb_descriptors.json"),
                               ("user_tags", "tags_2026.json")):
        groups: list = []
        by_key: dict = {}
        for d in _datasets_dirs():
            path = d / filename
            if not path.exists():
                continue
            with open(path, encoding="utf-8") as f:
                tag_data = json.load(f)
            for tag in tag_data.get("tags", []):
                full_name = (tag.get("name") or "").strip()
                if not full_name:
                    continue
                group_key, label = full_name.split("/", 1) if "/" in full_name else ("other", full_name)
                group = by_key.get(group_key)
                if group is None:
                    title = " ".join(w.capitalize() for w in group_key.replace("_", " ").split())
                    group = {"key": group_key, "title": title, "items": []}
                    by_key[group_key] = group
                    groups.append(group)
                value = (tag.get("value") or full_name).strip()
                if value:
                    group["items"].append({
                        "value": value,
                        "label": label,
                        "title": tag.get("description") or "",
                        "rulesetId": tag.get("ruleset_id"),
                    })
            break
        sets[set_name] = {"groups": groups}
    return sets


def _reap_job(job_id) -> None:
    """Release the finished job's process handle and queue fds — entries
    otherwise accumulate for the lifetime of the server."""
    with JOBS_LOCK:
        job = JOBS.pop(job_id, None)
    if job is None:
        return
    job["process"].join(timeout=5)
    job["queue"].close()


def _spawn(worker, form: dict) -> str:
    job_id = uuid.uuid4().hex
    LOG_DIR.mkdir(parents=True, exist_ok=True)
    log_path = LOG_DIR / f"{job_id}.log"
    ctx = multiprocessing.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=worker, args=(form, q, str(log_path)), daemon=True)
    p.start()
    with JOBS_LOCK:
        JOBS[job_id] = {"process": p, "queue": q, "log_path": str(log_path)}
    return job_id


def _job_log_path(job_id) -> str:
    with JOBS_LOCK:
        job = JOBS.get(job_id)
    return job["log_path"] if job else str(LOG_DIR / f"{job_id}.log")


class Handler(BaseHTTPRequestHandler):
    """The routes. The server's ``device`` attribute (set by :func:`serve`
    and :func:`main` from ``--device``; None keeps the presets' own) goes
    into every job's form."""

    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # quiet
        pass

    # -- helpers ------------------------------------------------------------

    def _json(self, payload, status: int = 200) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _file(self, path: Path, content_type: str) -> None:
        if not path.exists():
            self._json({"error": "not found"}, 404)
            return
        body = path.read_bytes()
        self.send_response(200)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _form(self) -> dict:
        length = int(self.headers.get("Content-Length", 0))
        raw = self.rfile.read(length).decode()
        form = urllib.parse.parse_qs(raw, keep_blank_values=True)
        # the device is the server's to choose, not the form's
        form.pop("device", None)
        device = getattr(self.server, "device", None)
        if device:
            form["device"] = [device]
        return form

    # -- GET ------------------------------------------------------------------

    def do_GET(self):
        parsed = urllib.parse.urlparse(self.path)
        path = parsed.path
        if path == "/":
            self._file(REPO_ROOT / "template" / "index.html", "text/html; charset=utf-8")
        elif path in ("/mai-mod", "/mai_mod"):
            self._file(REPO_ROOT / "template" / "index_mai_mod.html", "text/html; charset=utf-8")
        elif path.startswith("/static/"):
            rel = path[len("/static/"):]
            static_root = (REPO_ROOT / "static").resolve()
            target = (static_root / rel).resolve()
            if not target.is_relative_to(static_root):
                self._json({"error": "forbidden"}, 403)
                return
            ctype = {
                ".js": "text/javascript", ".css": "text/css", ".json": "application/json",
                ".png": "image/png", ".svg": "image/svg+xml",
            }.get(target.suffix, "application/octet-stream")
            self._file(target, ctype)
        elif path == "/models":
            self._json(list_model_presets())
        elif path == "/descriptors":
            self._json(load_descriptors())
        elif path == "/check_bf16_support":
            # the kernels are built for sm_90a, where bf16 is native, and the
            # CPU computes bf16 too; answered without touching CUDA here
            self._json({"supported": True})
        elif path == "/stream_output":
            q = urllib.parse.parse_qs(parsed.query)
            job_id = (q.get("job_id") or [None])[0]
            self._stream(job_id)
        else:
            self._json({"error": "not found"}, 404)

    def _stream(self, job_id) -> None:
        with JOBS_LOCK:
            job = JOBS.get(job_id)
        if job is None:
            self._json({"error": "unknown job"}, 404)
            return
        self.send_response(200)
        self.send_header("Content-Type", "text/event-stream")
        self.send_header("Cache-Control", "no-cache")
        self.send_header("Connection", "close")
        self.end_headers()
        log_queue = job["queue"]
        proc = job["process"]
        finished = False
        try:
            while True:
                try:
                    line = log_queue.get(timeout=0.5)
                except queue.Empty:
                    if not proc.is_alive():
                        self.wfile.write(b"data: __DONE__\n\n")
                        self.wfile.flush()
                        finished = True
                        return
                    continue
                for chunk in str(line).splitlines() or [""]:
                    self.wfile.write(f"data: {chunk}\n\n".encode())
                self.wfile.flush()
                if line in ("__DONE__",) or str(line).startswith("__ERROR__"):
                    finished = True
                    return
        except (BrokenPipeError, ConnectionResetError):
            return
        finally:
            if finished:
                _reap_job(job_id)

    # -- POST -----------------------------------------------------------------

    def do_POST(self):
        path = urllib.parse.urlparse(self.path).path
        form = self._form()
        if path == "/start_inference":
            try:
                build_inference_config(form)  # validate before spawning
            except Exception as e:
                self._json({"status": "error", "message": str(e)}, 400)
                return
            job_id = _spawn(_inference_worker, form)
            self._json({"status": "success", "message": "Inference started",
                        "job_id": job_id, "log_path": _job_log_path(job_id)}, 202)
        elif path == "/start_mai_mod":
            if not _first(form, "beatmap_path"):
                self._json({"status": "error", "message": "beatmap_path is required"}, 400)
                return
            job_id = _spawn(_mai_mod_worker, form)
            self._json({"status": "success", "message": "Analysis started",
                        "job_id": job_id, "log_path": _job_log_path(job_id)}, 202)
        elif path == "/cancel_inference":
            job_id = _first(form, "job_id")
            with JOBS_LOCK:
                job = JOBS.pop(job_id, None)
            if job and job["process"].is_alive():
                proc = job["process"]
                proc.terminate()
                # kill-escalation (the reference force-kills the whole tree,
                # web-ui.py:753-780): SIGKILL if SIGTERM is ignored
                def _escalate(p=proc):
                    p.join(timeout=5)
                    if p.is_alive():
                        p.kill()

                threading.Thread(target=_escalate, daemon=True).start()
                self._json({"status": "success", "message": "cancelled"})
            else:
                self._json({"status": "not running"})
        elif path == "/validate_paths":
            self._json(validate_and_autofill(form))
        elif path == "/save_config":
            data = {k: v if len(v) > 1 else v[0] for k, v in form.items() if k != "device"}
            CONFIG_SAVE_PATH.write_text(json.dumps(data, indent=2))
            self._json({"status": "success", "path": str(CONFIG_SAVE_PATH)})
        elif path == "/open_log_file":
            # containment: only files under logs/ may be opened
            # (reference security check, web-ui.py:826-835)
            target = _first(form, "path") or ""
            logs_root = (REPO_ROOT / "logs").resolve()
            resolved = Path(target).resolve() if target else None
            if resolved is None:
                self._json({"status": "error", "message": "No log file path specified"}, 400)
            elif not resolved.is_relative_to(logs_root):
                self._json({"status": "error",
                            "message": "Access denied: file is outside the logs directory"}, 403)
            elif not resolved.is_file():
                self._json({"status": "error", "message": "Log file not found"}, 404)
            else:
                opener = {"win32": "explorer", "darwin": "open"}.get(sys.platform, "xdg-open")
                try:
                    subprocess.Popen([opener, str(resolved)],
                                     stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                    self._json({"status": "success"})
                except OSError as e:
                    self._json({"status": "error", "message": str(e)}, 500)
        elif path == "/open_folder":
            target = _first(form, "path") or "."
            opener = {"win32": "explorer", "darwin": "open"}.get(sys.platform, "xdg-open")
            try:
                subprocess.Popen([opener, target], stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
                self._json({"status": "success"})
            except OSError as e:
                self._json({"status": "error", "message": str(e)}, 500)
        else:
            self._json({"error": "not found"}, 404)


def make_server(port: int = 8765, host: str = "127.0.0.1", device: str | None = None,
                handler=Handler) -> ThreadingHTTPServer:
    """The HTTP server (not started), its jobs on ``device``."""
    server = ThreadingHTTPServer((host, port), handler)
    server.device = device
    return server


def serve(port: int = 8765, host: str = "127.0.0.1", device: str | None = None,
          handler=Handler) -> ThreadingHTTPServer:
    """The server, serving from a daemon thread; ``shutdown()`` stops it."""
    server = make_server(port, host, device, handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    return server


def parse_cli(argv, default_port: int) -> tuple[int, str | None, bool]:
    """(port, device, window) of ``[--port N] [--device D] [--window]``."""
    port = int(argv[argv.index("--port") + 1]) if "--port" in argv else default_port
    device = argv[argv.index("--device") + 1] if "--device" in argv else None
    return port, device, "--window" in argv


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    port, device, window = parse_cli(argv, 8765)
    url = f"http://127.0.0.1:{port}"
    if window:
        try:
            import webview  # pywebview desktop shell (reference web-ui.py:1000-1034)

            serve(port, device=device)
            webview.create_window("Mapperatorinator", url)
            webview.start()
            return
        except ImportError:
            print("pywebview not available; serving in browser mode")
    server = make_server(port, device=device)
    print(f"Mapperatorinator web UI at {url}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
