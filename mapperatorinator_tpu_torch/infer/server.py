"""Cross-process inference batching server on the PyTorch port: the JAX
``infer/server.py`` with the engine glue on the torch engine.

Host-side IPC daemon batching generation requests from multiple OS processes
onto one card (reference: ``osuT5/osuT5/inference/server.py:215-628``): a
listener thread per client over a Unix socket, a batcher thread grouping
requests by identical generate settings and splitting/padding/concatenating
work units up to max_batch_size, per-batch error -> RETRY signaling, and an
idle self-shutdown watchdog. ``InferenceServer`` and ``InferenceClient`` are
the JAX classes (``tests/test_torch_nojax.py`` holds them to their source).
The batch thread runs :func:`make_engine_generate_fn`'s decode, on the card
with the engine's CUDA graphs captured and replayed from that thread.

The socket names (:data:`SOCKET_PATH`, :func:`get_server_address`) lie in
the temporary directory and carry a ``mapperatorinator_tpu_torch`` prefix,
so a port client never connects to a JAX server of the same model, whose
requests another package would answer on another device.
"""

from __future__ import annotations

import os
import tempfile
import threading
import time
import traceback
from multiprocessing.connection import Client, Listener
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

SOCKET_PATH = os.path.join(tempfile.gettempdir(), "mapperatorinator_tpu_torch.sock")
RETRY_SIGNAL = "RETRY_SIGNAL"


def get_server_address(ckpt_path, lora_path=None, gamemode=None) -> str:
    """Socket path derived from the model identity (reference:
    inference.py:584-617), in the temporary directory (``TMPDIR``)."""
    import hashlib

    key = f"{ckpt_path}|{lora_path}|{gamemode}"
    digest = hashlib.sha1(key.encode()).hexdigest()[:12]
    return os.path.join(tempfile.gettempdir(), f"mapperatorinator_tpu_torch_{digest}.sock")


class InferenceServer:
    def __init__(
        self,
        generate_fn: Callable[[dict, dict], tuple[np.ndarray, dict]],
        max_batch_size: int = 8,
        batch_timeout: float = 0.2,
        idle_timeout: float = 20,
        socket_path: str = SOCKET_PATH,
    ):
        """generate_fn(model_kwargs, generate_kwargs) -> (outputs, stats);
        model_kwargs carry numpy arrays keyed like the Processor's
        model_generate inputs (frames, decoder_input_ids, ...)."""
        self.generate_fn = generate_fn
        self.max_batch_size = max_batch_size
        self.batch_timeout = batch_timeout
        self.idle_timeout = idle_timeout
        self.socket_path = socket_path
        self.grouped_requests: dict = {}
        self.lock = threading.Lock()
        self.shutdown_flag = threading.Event()
        self.listener = None
        self.connections = 0

    def start(self) -> None:
        try:
            os.unlink(self.socket_path)
        except (FileNotFoundError, OSError):
            pass
        self.listener = Listener(self.socket_path)
        threading.Thread(target=self._listener_thread, daemon=True).start()
        threading.Thread(target=self._batch_thread, daemon=True).start()
        threading.Thread(target=self._idle_monitor, daemon=True).start()

    def stop(self) -> None:
        self.shutdown_flag.set()
        try:
            if self.listener is not None:
                self.listener.close()
        except Exception:
            pass
        try:
            os.unlink(self.socket_path)
        except Exception:
            pass

    def _listener_thread(self) -> None:
        while not self.shutdown_flag.is_set():
            try:
                conn = self.listener.accept()
                threading.Thread(target=self._client_handler, args=(conn,), daemon=True).start()
            except (OSError, EOFError):
                if self.shutdown_flag.is_set():
                    return
                time.sleep(1)

    def _client_handler(self, conn) -> None:
        with self.lock:
            self.connections += 1
        try:
            with conn:
                while True:
                    try:
                        model_kwargs, generate_kwargs = conn.recv()
                    except (EOFError, OSError):
                        break
                    except Exception:
                        conn.send(RETRY_SIGNAL)
                        continue

                    key = frozenset(
                        (k, tuple(v) if isinstance(v, list) else v) for k, v in generate_kwargs.items()
                    )
                    event = threading.Event()
                    record = {
                        "model_kwargs": model_kwargs,
                        "generate_kwargs": generate_kwargs,
                        "total_work": model_kwargs["frames"].shape[0],
                        "work_done": 0,
                        "event": event,
                        "result": None,
                        "generated_tokens": 0,
                        "elapsed_seconds": 0.0,
                    }
                    with self.lock:
                        self.grouped_requests.setdefault(key, []).append(record)

                    event.wait()
                    try:
                        conn.send(record["result"])
                    except BrokenPipeError:
                        break
        finally:
            with self.lock:
                self.connections -= 1

    def _batch_thread(self) -> None:
        while not self.shutdown_flag.is_set():
            time.sleep(self.batch_timeout)
            with self.lock:
                if not self.grouped_requests:
                    continue
                key = next(iter(self.grouped_requests))
                requests = self.grouped_requests[key]
                generate_kwargs = requests[0]["generate_kwargs"]
                cfg_scale = generate_kwargs.get("cfg_scale", 1.0)
                num_beams = generate_kwargs.get("num_beams", 1)
                batch_multiplier = 2 * num_beams if cfg_scale > 1 else num_beams

                batch_requests = []
                remaining = max(1, self.max_batch_size // batch_multiplier)
                while remaining > 0 and requests:
                    request = requests.pop(0)
                    todo = request["total_work"] - request["work_done"]
                    work = min(todo, remaining)
                    cut = {
                        k: v[request["work_done"] : request["work_done"] + work]
                        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == request["total_work"]
                        else v
                        for k, v in request["model_kwargs"].items()
                    }
                    batch_requests.append((cut, request, work))
                    remaining -= work
                    if todo > work:
                        requests.insert(0, request)
                if not self.grouped_requests[key]:
                    del self.grouped_requests[key]

            try:
                keys = [k for k in batch_requests[0][0] if batch_requests[0][0][k] is not None]
                model_kwargs = {}
                paddings = [0] * len(batch_requests)
                for k in keys:
                    arrays = [b[0][k] for b in batch_requests]
                    if isinstance(arrays[0], np.ndarray) and arrays[0].ndim > 1:
                        max_len = max(a.shape[-1] for a in arrays)
                        if k == "decoder_input_ids":
                            paddings = [max_len - a.shape[-1] for a in arrays]
                        arrays = [
                            np.pad(a, [(0, 0)] * (a.ndim - 1) + [(max_len - a.shape[-1], 0)]) for a in arrays
                        ]
                    model_kwargs[k] = np.concatenate(arrays, axis=0) if isinstance(arrays[0], np.ndarray) else arrays[0]

                outputs, stats = self.generate_fn(model_kwargs, dict(batch_requests[0][1]["generate_kwargs"]))
                per_sample = stats.get("generated_tokens_per_sample", [0] * outputs.shape[0])

                batch_i = 0
                for i, (_, request, work_done) in enumerate(batch_requests):
                    padding = paddings[i]
                    out = outputs[batch_i : batch_i + work_done, padding:]
                    request_tokens = int(sum(per_sample[batch_i : batch_i + work_done]))
                    batch_i += work_done
                    if request["result"] is None:
                        request["result"] = out
                    else:
                        a, b = request["result"], out
                        width = max(a.shape[1], b.shape[1])
                        a = np.pad(a, [(0, 0), (0, width - a.shape[1])])
                        b = np.pad(b, [(0, 0), (0, width - b.shape[1])])
                        request["result"] = np.concatenate([a, b], axis=0)
                    request["work_done"] += work_done
                    request["generated_tokens"] += request_tokens
                    request["elapsed_seconds"] += stats.get("elapsed_seconds", 0.0)
                    if request["work_done"] >= request["total_work"]:
                        elapsed = request["elapsed_seconds"]
                        tokens = request["generated_tokens"]
                        request["result"] = {
                            "output": request["result"],
                            "stats": {
                                "generated_tokens": tokens,
                                "elapsed_seconds": elapsed,
                                "tokens_per_second": tokens / elapsed if elapsed > 0 else 0.0,
                            },
                        }
                        request["event"].set()
            except Exception:
                traceback.print_exc()
                for _, request, _ in batch_requests:
                    request["result"] = RETRY_SIGNAL
                    request["event"].set()

    def _idle_monitor(self) -> None:
        last_activity = time.time()
        while not self.shutdown_flag.is_set():
            time.sleep(self.idle_timeout / 2)
            with self.lock:
                if self.connections > 0:
                    last_activity = time.time()
            if time.time() - last_activity > self.idle_timeout:
                self.stop()


def make_engine_generate_fn(engine, vocab) -> Callable:
    """Server-side executor: rebuild the logits pipeline from the request's
    generate_kwargs and run the engine's decode (reference: server.py:84-156),
    the CFG pair's encoder states concatenated on the engine's device. The
    batcher groups requests by identical generate_kwargs; on a card each batch
    shape replays the engine's decode-step graphs for it, captured by its
    first call."""
    from ..decode.logits import build_logits_pipeline, get_eos_token_ids
    from ..osu.events import ContextType

    seed_counter = [0]

    def generate_fn(model_kwargs: dict, generate_kwargs: dict):
        mk = dict(model_kwargs)
        frames = mk.pop("frames")
        cond_prompt = mk.pop("decoder_input_ids")
        uncond_prompt = mk.pop("uncond_prompt", None)

        gk = dict(generate_kwargs)
        cfg_scale = gk.pop("cfg_scale", 1.0)
        num_beams = gk.pop("num_beams", 1)
        do_sample = gk.pop("do_sample", True)
        lookback_time = gk.pop("lookback_time", 0.0)
        lookahead_time = gk.pop("lookahead_time", 0.0)
        ct = gk.pop("context_type", None)
        seed_counter[0] += 1
        seed = gk.pop("seed", seed_counter[0])
        max_length = gk.pop("max_length")

        pipeline = build_logits_pipeline(
            vocab, cfg_scale=cfg_scale, do_sample=do_sample,
            lookback_max_time=lookback_time, **gk,
        )
        eos_ids = get_eos_token_ids(
            vocab, lookback_time=lookback_time, lookahead_time=lookahead_time,
            context_type=ContextType(ct) if ct else None,
        )

        encoder_states = engine.encode_with_cond(frames, mk or None)
        t0 = time.perf_counter()
        if cfg_scale > 1 and uncond_prompt is not None:
            prompts = np.concatenate([uncond_prompt, cond_prompt], axis=0)
            encoder_states = torch.cat([encoder_states, encoder_states], dim=0)
        else:
            prompts = cond_prompt

        use_cfg = cfg_scale > 1 and uncond_prompt is not None
        if num_beams > 1:
            tokens, _ = engine.generate_beams(
                encoder_states, prompts, pipeline, eos_ids, num_beams,
                max_length=max_length, seed=seed,
                cfg_scale=cfg_scale if use_cfg else 1.0,
            )
            # beams already return only the positive-half best hypotheses
            use_cfg = False
        else:
            tokens, _ = engine.generate(
                encoder_states, prompts, pipeline, eos_ids,
                seed=seed, cfg_scale=cfg_scale, max_length=max_length,
            )
        elapsed = time.perf_counter() - t0
        if use_cfg:
            tokens = tokens[tokens.shape[0] // 2 :]
        per_sample = (
            (tokens != vocab.pad_id).sum(axis=1) - (cond_prompt != vocab.pad_id).sum(axis=1)
        ).tolist()
        return np.asarray(tokens), {
            "generated_tokens_per_sample": per_sample,
            "elapsed_seconds": elapsed,
        }

    return generate_fn


class InferenceClient:
    """Connects to (or spawns) a server and proxies generate calls
    (reference: server.py:442-580)."""

    def __init__(
        self,
        server_factory: Optional[Callable[[], InferenceServer]] = None,
        socket_path: str = SOCKET_PATH,
        max_retries: int = 3,
        spawn_wait: float = 0.5,
    ):
        self.server_factory = server_factory
        self.socket_path = socket_path
        self.max_retries = max_retries
        self.spawn_wait = spawn_wait
        self.conn = None
        self._owned_server: Optional[InferenceServer] = None
        self.last_generation_stats: Optional[dict] = None

    def __enter__(self):
        self.connect()
        return self

    def __exit__(self, *exc):
        self.close()

    def connect(self) -> None:
        if self.conn is not None:
            return
        lock_path = Path(self.socket_path + ".lock")
        for attempt in range(self.max_retries + 1):
            try:
                self.conn = Client(self.socket_path)
                return
            except (FileNotFoundError, ConnectionRefusedError, OSError):
                if self.server_factory is None:
                    raise
                # spawn under a file lock so concurrent clients spawn once
                import fcntl

                with open(lock_path, "w") as fp:
                    fcntl.flock(fp.fileno(), fcntl.LOCK_EX)
                    try:
                        try:
                            self.conn = Client(self.socket_path)
                            return
                        except (FileNotFoundError, ConnectionRefusedError, OSError):
                            self._owned_server = self.server_factory()
                            self._owned_server.socket_path = self.socket_path
                            self._owned_server.start()
                    finally:
                        fcntl.flock(fp.fileno(), fcntl.LOCK_UN)
                time.sleep(self.spawn_wait)
        raise ConnectionError(f"could not connect to inference server at {self.socket_path}")

    def close(self) -> None:
        if self.conn is not None:
            self.conn.close()
            self.conn = None

    def generate(self, model_kwargs: dict, generate_kwargs: dict) -> np.ndarray:
        self.connect()
        for attempt in range(self.max_retries):
            try:
                self.conn.send((model_kwargs, generate_kwargs))
                result = self.conn.recv()
            except (EOFError, OSError):
                self.close()
                self.connect()
                continue
            if isinstance(result, str) and result == RETRY_SIGNAL:
                continue
            self.last_generation_stats = result.get("stats")
            return result["output"]
        raise RuntimeError("inference server kept returning retry signals")
