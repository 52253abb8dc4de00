#!/usr/bin/env python3
"""Smoke run of the serving path on NVIDIA GPUs, at full large-v3 width.

    python chip_smoke.py             one card: encoder attention and full
                                     model numerics, then main.serve with
                                     gRPC streams, a REST batch task and a
                                     beam-5 slot-pool phase
    python chip_smoke.py --chips 4   four cards: the server's mesh path at
                                     dp=4 and tp=2 x dp=2 against one card

Weights are random, drawn from --seed. Every phase prints a line; the run
stops with a non-zero exit at the first failure, and without a GPU before
any device work. The last line of standard output is one JSON object,
{"ok": true, "device": {"platform", "kind", "count"}}. Times printed here
are set-up figures (compile and wall seconds per phase), not performance
claims. One process drives the card(s).
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import collections
import contextlib
import importlib
import json
import logging
import re
import subprocess
import sys
import threading
import time
import wave
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WORK = REPO / "asr_data" / "smoke"          # git-ignored scratch space
MODEL = "large-v3"

# (B, H, T, Dh): the 30 s window encode at the server's window batch, and
# the 5.12 s streaming admission bucket (t_mel=512 -> 256 encoder frames)
ATTN_SHAPES = ((64, 20, 1500, 64), (8, 20, 256, 64))
# Kept attention (bf16 operands, bf16 output) against `_attention` in f32
# from the same bf16 inputs, as the relative L2 error ||got - ref|| / ||ref||.
# bf16 keeps 8 significant bits: rounding the output costs ~1.6e-3 of its
# norm, and cuDNN's bf16 softmax weights in P @ V about as much again. The
# limit is ~3x the larger reading on the card; two planted faults of the
# kept implementation (the last 36 keys masked, the logits scaled by 1.05)
# must exceed it.
ATTN_REL_L2 = 7e-3
PLANTED_MASKED_KEYS = 36
PLANTED_SCALE = 1.05
# Served bf16 large-v3 (kept attention) against the same weights in f32 at
# "highest" matmul precision with plain `_attention`: relative L2 error of
# all teacher-forced logits. This measures the bf16 residual stream and
# bf16 weights through 32 + 32 random-weight blocks; the bound is ~3x the
# reading on the card. The same served program with its weights rounded
# through float8 (e4m3) is a control that must exceed it.
MODEL_REL_L2 = 5e-2
# The same bf16 model on a mesh against one card. dp=4 runs each row's
# program unchanged. tp=2 splits each row-parallel contraction over two
# cards and all-reduces the partial sums; where the new order of the sums
# moves a value across a bf16 rounding boundary, the cast flips it by one
# unit, and the random-weight blocks carry such flips forward as they do any
# bf16 rounding. Each mesh is also held to MODEL_REL_L2 against the f32
# reference, as one card is. The tolerance is ~3x the tp reading on the card.
MESH_REL_L2 = 4e-2
FRONT_DOOR = ("grpc", "google.protobuf", "aiohttp", "requests")
# Random weights on synthetic audio fail whisper's quality gates on every
# decode, which would turn each request into a full temperature-fallback
# ladder. The gates are neutralised (as bench.py does) and windows decode
# at most 64 tokens, so the run stays short; every code path still runs.
NEUTRAL_GATES = dict(compression_ratio_thold=1e9, logprob_thold=-1e9,
                     entropy_thold=-1.0, max_decode_len=128)


class SmokeFailure(Exception):
    pass


def say(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


class Phases:
    """Wall and compile seconds per phase (compile from JAX's own
    backend-compile events), printed at the end as set-up figures."""

    def __init__(self):
        import jax

        self.compile_s = 0.0
        self.rows: list[tuple[str, float, float]] = []
        jax.monitoring.register_event_duration_secs_listener(self._on_event)

    def _on_event(self, event, duration, **_):
        if event == "/jax/core/compile/backend_compile_duration":
            self.compile_s += duration

    @contextlib.contextmanager
    def __call__(self, name: str):
        say(f"phase {name}: start")
        t0, c0 = time.perf_counter(), self.compile_s
        yield
        wall, comp = time.perf_counter() - t0, self.compile_s - c0
        self.rows.append((name, wall, comp))
        say(f"phase {name}: ok ({wall:.1f} s wall, {comp:.1f} s compile)")


# ------------------------------------------------------------------ device

def check_device(devices) -> None:
    """Refuse anything but a GPU: this script never runs on the CPU."""
    platform = devices[0].platform if devices else "none"
    require(platform == "gpu", f"JAX found no GPU (platform {platform!r})")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip()


def front_door_packages() -> dict[str, bool]:
    found = {}
    for name in FRONT_DOOR:
        try:
            importlib.import_module(name)
            found[name] = True
        except ImportError:
            found[name] = False
    return found


# ------------------------------------------------------------------ inputs

def speechlike_pcm(rng, seconds: float) -> np.ndarray:
    """Seeded s16 PCM: an amplitude-modulated tone in noise."""
    t = np.arange(int(seconds * 16000)) / 16000.0
    f0 = rng.uniform(120.0, 300.0)
    tone = 0.3 * np.sin(2 * np.pi * f0 * t) * (0.5 + 0.5 * np.sin(2 * np.pi * 3 * t))
    x = tone + 0.05 * rng.standard_normal(t.size)
    return (np.clip(x, -1.0, 1.0) * 16000).astype(np.int16)


def write_wav(path: Path, pcm: np.ndarray) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def teacher_tokens(tok, rng, batch: int, n_tok: int) -> np.ndarray:
    sot = tok.sot_sequence("en")
    text = rng.integers(0, tok.eot, (batch, n_tok - len(sot)))
    return np.concatenate([np.tile(sot, (batch, 1)), text], 1).astype(np.int32)


def rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---------------------------------------------------------------- numerics

@contextlib.contextmanager
def plain_encoder_attention():
    """Trace the encoder with the plain `_attention` reference in place of
    the kept implementation."""
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    kept = W.encoder_attention

    def plain(q, k, v):  # (B, T, H, Dh) <-> _attention's (B, H, T, Dh)
        def t(x):
            return jnp.swapaxes(x, 1, 2)

        return t(W._attention(t(q), t(k), t(v), None))

    W.encoder_attention = plain
    try:
        yield
    finally:
        W.encoder_attention = kept


def planted_faults(impl: str) -> dict:
    """Faulty variants of the kept attention that ATTN_REL_L2 must catch."""
    import jax
    import jax.numpy as jnp

    def masked(q, k, v):
        n = jnp.full((q.shape[0],), q.shape[1] - PLANTED_MASKED_KEYS, jnp.int32)
        return jax.nn.dot_product_attention(q, k, v, key_value_seq_lengths=n,
                                            implementation=impl)

    def scaled(q, k, v):
        return jax.nn.dot_product_attention(
            q, k, v, scale=PLANTED_SCALE / q.shape[-1] ** 0.5,
            implementation=impl)

    return {f"last {PLANTED_MASKED_KEYS} keys masked": masked,
            f"logits scaled by {PLANTED_SCALE}": scaled}


def attention_check(shapes, seed: int) -> dict:
    """The kept encoder attention at bf16 against `_attention` in f32, and
    the planted faults against the same reference. Returns the relative L2
    errors per shape."""
    import jax
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    impl = W.attention_impl(jax.default_backend(), jnp.bfloat16)
    say(f"encoder attention implementation: {impl}")
    rng = np.random.default_rng(seed)

    def ref(q, k, v):
        def t(x):
            return jnp.swapaxes(x.astype(jnp.float32), 1, 2)

        return jnp.swapaxes(W._attention(t(q), t(k), t(v), None), 1, 2)

    def sq_sums(got, want):
        d = got.astype(jnp.float32) - want
        return jnp.sum(d * d), jnp.sum(want * want)

    with jax.default_matmul_precision("highest"):
        ref_fn = jax.jit(ref)
    sq_fn = jax.jit(sq_sums)
    faults = planted_faults(impl)
    readings = {}
    for B, H, T, Dh in shapes:
        q, k, v = (jnp.asarray(rng.standard_normal((B, T, H, Dh), np.float32),
                               jnp.bfloat16) for _ in range(3))
        compiled = jax.jit(W.encoder_attention).lower(q, k, v).compile()
        if impl == "cudnn":
            require("cudnn" in compiled.as_text().lower(),
                    "cuDNN attention was selected but is not in the program")
        outs = {"kept": compiled(q, k, v)}
        outs.update((name, jax.jit(fn)(q, k, v)) for name, fn in faults.items())
        diff_sq, ref_sq = dict.fromkeys(outs, 0.0), 0.0
        step = 8  # the f32 reference materialises (b, H, T, T) logits
        with jax.default_matmul_precision("highest"):
            for b in range(0, B, step):
                want = ref_fn(q[b:b + step], k[b:b + step], v[b:b + step])
                for name, out in outs.items():
                    d2, r2 = sq_fn(out[b:b + step], want)
                    diff_sq[name] += float(d2)
                ref_sq += float(r2)
        errs = {name: (d2 / ref_sq) ** 0.5 for name, d2 in diff_sq.items()}
        readings[(B, H, T, Dh)] = errs
        say(f"attention (B={B}, H={H}, T={T}, Dh={Dh}) {impl}: relative L2 "
            f"error {errs['kept']:.3e} (limit {ATTN_REL_L2:.0e})")
        require(errs["kept"] <= ATTN_REL_L2,
                f"attention error {errs['kept']:.3e} > {ATTN_REL_L2:.0e}")
        for name in faults:
            say(f"  planted fault, {name}: relative L2 error {errs[name]:.3e} "
                f"(must exceed {ATTN_REL_L2:.0e})")
            require(errs[name] > ATTN_REL_L2,
                    f"the attention limit misses a planted fault: {name}")
    return readings


def model_check(dims, params_np, seed: int, batch: int = 2, n_tok: int = 32):
    """encode + decode_logits on the served bf16 path against the same
    weights in f32 at 'highest' precision with plain `_attention`, and the
    float8-weight control. Returns both relative L2 errors."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from speaksense_tpu.asr.engine import WhisperEngine
    from speaksense_tpu.config import EngineConfig
    from speaksense_tpu.models import whisper as W
    from speaksense_tpu.models.tokenizer import Tokenizer

    rng = np.random.default_rng(seed + 1)
    tok = Tokenizer.synthetic(dims.n_vocab)
    served = WhisperEngine(params_np, dims, tok, config=EngineConfig())
    audio = np.stack([speechlike_pcm(rng, 30.0) for _ in range(batch)])
    mel = served.compute_mel(audio.astype(np.float32) / 32767.0)
    tokens = jnp.asarray(teacher_tokens(tok, rng, batch, n_tok))

    def fwd(params, mel, tokens):
        return W.decode_logits(params, dims, tokens, W.encode(params, dims, mel))

    fwd_jit = jax.jit(fwd)
    got = np.asarray(fwd_jit(served.params, mel, tokens))
    # the control: the same program with every weight matrix rounded
    # through float8 e4m3 (3 mantissa bits against bf16's 7). The rounding
    # is done on the host: on the device XLA may drop a convert round trip
    # as excess precision, and the control would then be no control.
    def fp8(x):
        if x.ndim < 2 or not jnp.issubdtype(x.dtype, jnp.floating):
            return x
        h = np.asarray(jax.device_get(x))
        return jax.device_put(h.astype(ml_dtypes.float8_e4m3fn).astype(h.dtype),
                              x.sharding)

    ctrl = np.asarray(fwd_jit(jax.tree.map(fp8, served.params), mel, tokens))
    del served
    ref_params = jax.tree.map(jnp.asarray, params_np)
    with jax.default_matmul_precision("highest"), plain_encoder_attention():
        want = np.asarray(jax.jit(fwd)(ref_params, mel, tokens))
    del ref_params
    require(got.shape == want.shape == (batch, n_tok, dims.n_vocab),
            f"logits shape {got.shape} vs {want.shape}")
    require(np.isfinite(got).all(), "served logits are not finite")
    err, ctrl_err = rel_l2(got, want), rel_l2(ctrl, want)
    agree = float((got.argmax(-1) == want.argmax(-1)).mean())
    say(f"{dims.n_audio_state}-wide model logits (B={batch}, {n_tok} tokens): "
        f"relative L2 error {err:.3e} (bound {MODEL_REL_L2:.0e}), "
        f"argmax agreement {agree:.3f}")
    say(f"  control, float8 weights: relative L2 error {ctrl_err:.3e} "
        f"(must exceed {MODEL_REL_L2:.0e})")
    require(err <= MODEL_REL_L2, f"model error {err:.3e} > {MODEL_REL_L2:.0e}")
    require(ctrl_err > MODEL_REL_L2, "the model bound misses float8 weights")
    return err, ctrl_err


# ------------------------------------------------------------------ server

def write_checkpoint(path: Path, dims, params_np) -> None:
    """Random weights as an f16 ggml file that the normal loader reads."""
    from speaksense_tpu.audio import mel as MEL
    from speaksense_tpu.ckpt.ggml import (
        F16, GgmlModel, ggml_tensors_from_params, write_ggml,
    )
    from speaksense_tpu.models.tokenizer import Tokenizer

    model = GgmlModel(dims=dims, ftype=F16,
                      filters=MEL.mel_filter_bank(dims.n_mels),
                      vocab=Tokenizer.synthetic(dims.n_vocab).vocab,
                      tensors=ggml_tensors_from_params(params_np, dims))
    write_ggml(model, str(path), ftype=F16)
    say(f"wrote {path.name}: {path.stat().st_size / 2**30:.2f} GiB")


def server_config(model_path: Path, work: Path, grpc_port: int, http_port: int,
                  compute_dtype: str = "bfloat16"):
    from speaksense_tpu.config import Config

    config = Config(model_path=str(model_path),
                    sqlite_path=f"sqlite://{work / 'tasks.db'}?mode=rwc",
                    audio_path=str(work / "audio") + "/",
                    log_dir=str(work / "logs"),
                    grpc_port=grpc_port, http_port=http_port, task_workers=1)
    config.engine.weight_cache_dir = str(work / "weights_cache")
    config.engine.compute_dtype = compute_dtype
    for k, v in NEUTRAL_GATES.items():
        setattr(config.engine, k, v)
    return config


class ErrorCount(logging.Handler):
    """Counts ERROR records: the serving layers log a failed decode and
    carry on, so a phase that logged one has failed."""

    def __init__(self):
        super().__init__(logging.ERROR)
        self.records: list[str] = []

    def emit(self, record):
        self.records.append(f"{record.name}: {record.getMessage()}")


def chunk_messages(pcm: np.ndarray, seconds: float = 5.0) -> list[bytes]:
    n = int(seconds * 16000)
    return [base64.standard_b64encode(pcm[i:i + n].tobytes())
            for i in range(0, pcm.size, n)]


async def grpc_streams(port: int, streams: list[list[bytes]]) -> list[dict]:
    """Concurrent bidirectional streams over the wire; one dict per stream."""
    import grpc

    from speaksense_tpu.serving.grpc_server import SERVICE_PATH
    from speaksense_tpu.serving.pb import asr_pb2

    async def one(ch, msgs):
        async def gen():
            for m in msgs:
                yield asr_pb2.TranscribeRequest(type=asr_pb2.PCM, end=0, audio=m)
            yield asr_pb2.TranscribeRequest(type=asr_pb2.PCM, end=1, audio=b"")

        call = ch.stream_stream(
            SERVICE_PATH,
            request_serializer=asr_pb2.TranscribeRequest.SerializeToString,
            response_deserializer=asr_pb2.TranscribeResponse.FromString)
        ends = [r.end async for r in call(gen())]
        return {"responses": ends.count(0), "ends": ends.count(1),
                "last": ends[-1] if ends else None}

    async with grpc.aio.insecure_channel(f"127.0.0.1:{port}") as ch:
        return list(await asyncio.gather(*[one(ch, m) for m in streams]))


def direct_streams(engine, streams: list[list[bytes]]) -> list[dict]:
    """The same streams through StreamSession, the layer under the wire."""
    from speaksense_tpu.serving.stream import StreamSession

    out: list[dict | None] = [None] * len(streams)

    def one(i, msgs):
        s = StreamSession(engine, language="zh", denoise=True)
        evs = [ev for m in msgs for ev in s.feed(m)] + s.finish()
        ends = [ev.end for ev in evs]
        out[i] = {"responses": ends.count(0), "ends": ends.count(1),
                  "last": ends[-1] if ends else None}

    threads = [threading.Thread(target=one, args=(i, m))
               for i, m in enumerate(streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
        require(not t.is_alive(), "a stream session did not finish")
    return out


def check_streams(results: list[dict], how: str) -> None:
    for i, r in enumerate(results):
        say(f"stream {i} ({how}): {r['responses']} responses, "
            f"end markers {r['ends']}")
        require(r["responses"] >= 1, f"stream {i} got no transcript response")
        require(r["ends"] == 1 and r["last"] == 1,
                f"stream {i} did not end cleanly: {r}")


def task_config(wav: Path, callback_url: str | None):
    from speaksense_tpu.schedule.types import (
        CallbackType, PathType, TaskConfig, TaskParams, TaskType,
        TranscribeParams,
    )

    return TaskConfig(
        task_type=TaskType.TRANSCRIBE, input_path=str(wav),
        path_type=PathType.LOCAL,
        callback_type=(CallbackType.http(callback_url) if callback_url
                       else CallbackType.none()),
        params=TaskParams.transcribe(TranscribeParams(language="en")))


async def rest_task(port: int, wav: Path, callback: bool,
                    timeout_s: float = 900.0) -> dict:
    """Create one batch task over REST and poll it to an end."""
    import aiohttp

    base = f"http://127.0.0.1:{port}"
    cfg = task_config(wav, f"{base}/callback/http" if callback else None)
    async with aiohttp.ClientSession() as s:
        async with s.post(f"{base}/schedule/tasks", json=cfg.to_json()) as r:
            body = await r.json()
            require(r.status == 201 and body["success"], f"create task: {body}")
        tid = body["data"]["id"]
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            async with s.get(f"{base}/schedule/tasks/{tid}") as r:
                task = (await r.json())["data"]
            if task["status"] == "Completed" or isinstance(task["status"], dict):
                return task
            await asyncio.sleep(0.5)
    raise SmokeFailure(f"task {tid} did not finish in {timeout_s:.0f} s")


def direct_task(engine, wav: Path, work: Path, timeout_s: float = 900.0) -> dict:
    """The same task through TaskManager + TranscribeProcessor."""
    from speaksense_tpu.schedule.manager import TaskManager
    from speaksense_tpu.schedule.processors import TranscribeProcessor
    from speaksense_tpu.schedule.scheduler import create_scheduler
    from speaksense_tpu.schedule.types import TaskType
    from speaksense_tpu.storage.sqlite import SqliteTaskStorage

    storage = SqliteTaskStorage(str(work / "direct_tasks.db"))
    manager = TaskManager(storage)
    manager.register_processor(TranscribeProcessor(engine, audio_dir=str(work)))
    scheduler = create_scheduler(manager, [TaskType.TRANSCRIBE],
                                 workers={TaskType.TRANSCRIBE: 1})
    try:
        tid = manager.create_task(task_config(wav, None)).id
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            task = manager.get_task(tid).to_public_json()
            if task["status"] == "Completed" or isinstance(task["status"], dict):
                return task
            time.sleep(0.5)
    finally:
        scheduler.stop()
        storage.close()
    raise SmokeFailure(f"task {tid} did not finish in {timeout_s:.0f} s")


def check_task(task: dict, how: str) -> None:
    require(task["status"] == "Completed", f"task ended {task['status']}")
    segs = task["result"]["result"]["segments"]
    say(f"batch task ({how}): Completed, {len(segs)} segments")
    require(len(segs) >= 1, "completed task has no segments")


def pool_memory(pool, params, suppress) -> list[str]:
    """compiled.memory_analysis() of every admission and step program the
    pool has compiled."""
    import jax
    import jax.numpy as jnp

    from speaksense_tpu.audio import mel as MEL

    def sds(shape, dtype):
        return jax.ShapeDtypeStruct(shape, dtype)

    def fmt(name, ma):
        gib = 2.0 ** 30
        return (f"{name}: arguments {ma.argument_size_in_bytes / gib:.2f} GiB, "
                f"outputs {ma.output_size_in_bytes / gib:.2f} GiB, aliased "
                f"{ma.alias_size_in_bytes / gib:.2f} GiB, temporaries "
                f"{ma.temp_size_in_bytes / gib:.2f} GiB")

    lines = []
    for (n, P, is_audio, _denoise, dt), fn in pool._admit_fns.items():
        one = ((pool.t_mel * MEL.HOP_LENGTH,) if is_audio
               else (pool.t_mel, pool.dims.n_mels))
        i32 = jnp.int32
        args = (params, pool.state, sds((n,) + one, np.dtype(dt)),
                sds((n,), i32), sds((n, P), i32), sds((n,), i32),
                sds((n,), i32), sds((n,), jnp.float32), sds((n,), jnp.bool_),
                sds((), i32))
        ma = fn.lower(*args).compile().memory_analysis()
        lines.append(fmt(f"admit (rows {n}, prompt {P})", ma))
    for (k, flush), fn in pool._step_fns.items():
        ma = fn.lower(params, suppress, pool.state).compile().memory_analysis()
        lines.append(fmt(f"step (k={k}, flush={flush})", ma))
    return lines


async def serve_phases(dims, model_path: Path, work: Path, seed: int,
                       phase: Phases, wire: bool, callback: bool,
                       ports=(7300, 7200), compute_dtype="bfloat16") -> list[str]:
    """main.start with --slot-serving, then streams, a batch task and a
    beam-5 pool phase; returns the memory-analysis lines."""
    from speaksense_tpu import main as M

    from speaksense_tpu.serving import grpc_server as G

    rng = np.random.default_rng(seed + 2)
    config = server_config(model_path, work, *ports, compute_dtype=compute_dtype)
    errors = ErrorCount()
    logging.getLogger().addHandler(errors)
    # the smoke serves on loopback only: the etcd registration advertises
    # 127.0.0.1 and skips the interface lookup, a UDP connect toward a
    # public address
    kept_local_ip, G.local_ip = G.local_ip, lambda: "127.0.0.1"
    try:
        with phase("start server (main.start, --slot-serving)"):
            if wire:
                server = await M.start(config, slot_serving=True)
                engine, inner = server.engine, server.inner
                grpc_port = server.grpc_server.port
                http_port = server.runner.addresses[0][1]
                say(f"serving gRPC :{grpc_port}, REST :{http_port}")
            else:
                from speaksense_tpu.utils.jaxsetup import init_compilation_cache

                init_compilation_cache()
                config.init_dirs()
                engine = M.build_engine(config)
                inner = engine.engine
                inner.enable_slot_serving()
                say("front-door packages missing: engine built without the "
                    "wire servers (main.build_engine)")
        try:
            streams = [chunk_messages(speechlike_pcm(rng, 30.0)) for _ in range(4)]
            with phase("4 streams x 6 chunks (greedy slot pool)"):
                pool = inner._slot_server.pool
                rows0 = pool.admit_rows
                if wire:
                    check_streams(await grpc_streams(grpc_port, streams), "gRPC")
                else:
                    check_streams(direct_streams(engine, streams), "StreamSession")
                say(f"pool admitted {pool.admit_rows - rows0} chunks in "
                    f"{pool.step_calls} step dispatches")
                require(pool.admit_rows - rows0 >= 4 * 6,
                        "pool admitted fewer chunks than the streams sent")
            wav = work / "task.wav"
            write_wav(wav, speechlike_pcm(rng, 60.0))
            with phase("60 s batch task (window batcher, long-form seek)"):
                if wire:
                    check_task(await rest_task(http_port, wav, callback), "REST")
                else:
                    check_task(await asyncio.to_thread(
                        direct_task, engine, wav, work), "TaskManager")
            with phase("memory analysis of the greedy pool programs"):
                mem = pool_memory(pool, inner.params, pool.suppress)
            with phase("beam-5 slot pool, 2 streams x 2 chunks"):
                inner.disable_slot_serving()
                inner.enable_slot_serving(n_slots=3, beam_size=5)
                beam = inner._slot_server.pool
                require(beam.K == 5, f"beam pool has K={beam.K}")
                beam_streams = [chunk_messages(speechlike_pcm(rng, 10.0))
                                for _ in range(2)]
                if wire:
                    check_streams(await grpc_streams(grpc_port, beam_streams),
                                  "gRPC, beam 5")
                else:
                    check_streams(direct_streams(engine, beam_streams),
                                  "StreamSession, beam 5")
                require(beam.admit_rows >= 4, "beam pool admitted too few chunks")
                mem += [f"beam {line}" for line in
                        pool_memory(beam, inner.params, beam.suppress)]
        finally:
            with phase("stop server"):
                if wire:
                    await M.stop(server)
                else:
                    engine.stop()
                    inner.disable_slot_serving()
    finally:
        G.local_ip = kept_local_ip
        logging.getLogger().removeHandler(errors)
    require(not errors.records, "errors logged while serving: "
            + "; ".join(errors.records[:5]))
    return mem


def run_single(dims, seed: int, work: Path, attn_shapes=ATTN_SHAPES,
               ports=(7300, 7200), compute_dtype="bfloat16") -> list[str]:
    """The one-card run after the device check: numerics, then the served
    path. Returns the summary lines. compute_dtype is the served engine's
    (the CPU rehearsal serves float32: XLA's CPU backend has no bf16 x bf16
    -> f32 kernel for some of the beam pool's dots)."""
    import jax

    from speaksense_tpu.models import whisper as W

    phase = Phases()
    pkgs = front_door_packages()
    wire = pkgs["grpc"] and pkgs["google.protobuf"] and pkgs["aiohttp"]
    with phase("encoder attention check"):
        attention_check(attn_shapes, seed)
    params_np = W.init_params_np(dims, seed=seed)
    with phase(f"{MODEL}-width model check"):
        model_check(dims, params_np, seed)
    work.mkdir(parents=True, exist_ok=True)
    ckpt = work / "ggml-random.bin"
    with phase("write f16 ggml checkpoint"):
        write_checkpoint(ckpt, dims, params_np)
    del params_np
    mem = asyncio.run(serve_phases(dims, ckpt, work, seed, phase, wire,
                                   callback=pkgs["requests"], ports=ports,
                                   compute_dtype=compute_dtype))
    lines = [f"memory_analysis {line}" for line in mem]
    stats = jax.devices()[0].memory_stats() or {}
    lines.append(f"peak_bytes_in_use: {stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")
    lines += [f"set-up time, {name}: {wall:.1f} s wall, {comp:.1f} s compile"
              for name, wall, comp in phase.rows]
    return lines


# --------------------------------------------------------------- mesh path

def all_reduce_types(hlo: str) -> collections.Counter:
    """Element types of the all-reduce results in compiled HLO text (the
    asynchronous all-reduce-start included; a combined all-reduce counts
    each of its results)."""
    types = collections.Counter()
    for line in hlo.splitlines():
        m = re.search(r"= (.*?) all-reduce(?:-start)?\(", line)
        if m:
            types.update(re.findall(r"\b([a-z]+\d*)\[", m.group(1)))
    return types


def run_multichip(dims, seed: int, n_devices: int = 4) -> list[str]:
    """The server's mesh path (main.place_on_mesh) at dp=4 and tp=2 x dp=2
    against a one-card engine, on the same requests."""
    import jax
    import jax.numpy as jnp

    from speaksense_tpu import main as M
    from speaksense_tpu.asr.engine import WhisperEngine
    from speaksense_tpu.config import Config, EngineConfig
    from speaksense_tpu.models import whisper as W
    from speaksense_tpu.models.tokenizer import Tokenizer

    require(len(jax.local_devices()) >= n_devices,
            f"needs {n_devices} devices, found {len(jax.local_devices())}")
    phase = Phases()
    rng = np.random.default_rng(seed + 3)
    tok = Tokenizer.synthetic(dims.n_vocab)
    params_np = W.init_params_np(dims, seed=seed)
    n_req = 8
    audio = np.stack([speechlike_pcm(rng, 30.0) for _ in range(n_req)])
    tokens = teacher_tokens(tok, rng, n_req, 32)
    chunks = [speechlike_pcm(rng, 5.0) for _ in range(n_req)]

    def fwd(params, mel, tokens):
        return W.decode_logits(params, dims, tokens, W.encode(params, dims, mel))

    def run(tp: int, dp: int) -> dict:
        cfg = EngineConfig(**NEUTRAL_GATES)
        engine = WhisperEngine(params_np, dims, tok, config=cfg)
        if tp * dp > 1:
            M.place_on_mesh(engine, Config(tp=tp, dp=dp))
            require(engine.mesh.devices.size == tp * dp, "mesh size")
        mel = engine.compute_mel(audio.astype(np.float32) / 32767.0)
        compiled = jax.jit(fwd).lower(engine.params, mel, jnp.asarray(tokens)).compile()
        logits = np.asarray(compiled(engine.params, mel, jnp.asarray(tokens)))
        reduces = all_reduce_types(compiled.as_text())
        window = [r["tokens"][:r["n_sampled"]].tolist()
                  for r in engine.decode_windows(mel, "en", max_new_tokens=32)]
        engine.enable_slot_serving(n_slots=2 * n_req - 1, max_new=32)
        futs = [engine._slot_server.submit_audio(c, language="en") for c in chunks]
        pooled = [f.result(timeout=1200) for f in futs]
        engine.disable_slot_serving()
        pool = [r["tokens"][:r["n_sampled"]].tolist() for r in pooled]
        return {"logits": logits, "window": window, "pool": pool, "mel": mel,
                "reduces": reduces, "params": engine.params}

    results = {}
    devices = jax.local_devices()[:n_devices]
    for label, tp, dp in (("dp=4", 1, n_devices), ("tp=2 x dp=2", 2, n_devices // 2)):
        with phase(f"mesh {label}"):
            results[label] = run(tp, dp)
        holding = set().union(*(leaf.sharding.device_set for leaf in
                                jax.tree.leaves(results[label].pop("params"))))
        require(holding == set(devices), f"{label}: the weights sit on "
                f"{len(holding)} of {n_devices} devices")
        say(f"{label}: all-reduces in the forward program by element type: "
            + (", ".join(f"{t} x{n}" for t, n in sorted(results[label]["reduces"].items()))
               or "none"))
        # memory_stats() is None on the CPU backend (the rehearsal)
        stats = [d.memory_stats() for d in devices]
        if all(stats):
            peaks = [s["peak_bytes_in_use"] / 2**30 for s in stats]
            say(f"after {label}: peak_bytes_in_use per card (GiB): "
                + ", ".join(f"{p:.2f}" for p in peaks))
            require(all(p > 0 for p in peaks), "a card of the mesh holds no work")
    with phase("one card"):
        ref = run(1, 1)
        ref.pop("params")
    with phase("f32 reference, one card"):
        ref_params = jax.tree.map(jnp.asarray, params_np)
        with jax.default_matmul_precision("highest"), plain_encoder_attention():
            ref32 = np.asarray(jax.jit(fwd)(ref_params, ref["mel"], jnp.asarray(tokens)))
        del ref_params
    lines = []
    for label, got in {**results, "one card": ref}.items():
        require(np.isfinite(got["logits"]).all(), f"{label} logits not finite")
        err32 = rel_l2(got["logits"], ref32)
        say(f"{label} vs f32 reference: logits relative L2 {err32:.3e} "
            f"(bound {MODEL_REL_L2:.0e})")
        require(err32 <= MODEL_REL_L2, f"{label} error against f32 {err32:.3e}")
        lines.append(f"{label}: relative L2 against f32 {err32:.3e}")
    for label, got in results.items():
        err = rel_l2(got["logits"], ref["logits"])
        win = np.mean([a == b for a, b in zip(got["window"], ref["window"])])
        pool = np.mean([a == b for a, b in zip(got["pool"], ref["pool"])])
        say(f"{label} vs one card: logits relative L2 {err:.3e} (tolerance "
            f"{MESH_REL_L2:.0e}); greedy tokens identical in {win:.2f} of "
            f"windows and {pool:.2f} of pooled chunks")
        require(err <= MESH_REL_L2, f"{label} logits error {err:.3e}")
        lines.append(f"{label}: relative L2 against one card {err:.3e}, window "
                     f"tokens {win:.2f}, pooled tokens {pool:.2f}")
    lines += [f"set-up time, {name}: {wall:.1f} s wall, {comp:.1f} s compile"
              for name, wall, comp in phase.rows]
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the multi-card mesh path")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from speaksense_tpu.utils.jaxsetup import init_compilation_cache

    init_compilation_cache()
    import jax

    devices = jax.devices()
    check_device(devices)
    say(f"card: {card_line()}")
    say(f"devices: {len(devices)} x {devices[0].device_kind}, "
        f"jax {jax.__version__}")
    pkgs = front_door_packages()
    say("front-door packages: " + ", ".join(
        f"{k} {'yes' if v else 'no'}" for k, v in pkgs.items()))

    from speaksense_tpu.models import whisper as W

    dims = W.MODEL_DIMS[MODEL]
    require(len(devices) >= args.chips,
            f"--chips {args.chips} but JAX found {len(devices)} device(s)")
    if args.chips == 4:
        lines = run_multichip(dims, args.seed, n_devices=4)
    else:
        lines = run_single(dims, args.seed, WORK)
    for line in lines:
        say(line)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"[smoke] FAILED: {e}", flush=True)
        sys.exit(1)
