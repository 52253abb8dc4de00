"""Typed, env-overridable configuration.

Mirrors the reference's config surface (/root/reference/src/lib.rs:21-60):
the four env vars ASR_MODEL_PATH / ASR_SQLITE_PATH / ETCD_ENDPOINT /
ASR_AUDIO_PATH with the same defaults, resolved env -> .env file -> default.
Ports and engine knobs (hardcoded in the reference) are exposed as typed
fields here so one config object drives the whole stack.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path

# Defaults identical to /root/reference/src/lib.rs:21-24
DEFAULT_SQLITE_PATH = "sqlite://./asr_data/database/storage.db?mode=rwc"
DEFAULT_AUDIO_PATH = "./asr_data/audio/"
DEFAULT_ETCD_ENDPOINT = "http://localhost:2379"
DEFAULT_MODEL_PATH = "./models/ggml-large-v3.bin"


def _load_dotenv(path: str = ".env") -> dict[str, str]:
    """Minimal .env parser (reference uses the dotenv crate, src/lib.rs:62)."""
    out: dict[str, str] = {}
    p = Path(path)
    if not p.is_file():
        return out
    try:
        for line in p.read_text().splitlines():
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            k, _, v = line.partition("=")
            out[k.strip()] = v.strip().strip('"').strip("'")
    except OSError:
        pass
    return out


def _env(name: str, dotenv: dict[str, str], default: str) -> str:
    return os.environ.get(name) or dotenv.get(name) or default


def _parse_grpc_auth(value: str) -> str:
    """Fail CLOSED on typos: an operator setting SPEAKSENSE_GRPC_AUTH=on /
    require / true means to enforce auth — silently treating an
    unrecognized value as "off" would run the stream endpoint
    unauthenticated against their intent."""
    v = value.strip().lower()
    if v in ("off", "optional", "required"):
        return v
    raise ValueError(
        f"SPEAKSENSE_GRPC_AUTH={value!r}: must be off | optional | required")


@dataclass
class EngineConfig:
    """Inference-engine knobs (reference hardcodes these in
    src/asr/whisper.rs:131-173 and src/grpc/handlers/asr.rs:14-18)."""

    # decode parameters mirroring FullParams (src/asr/whisper.rs:131-173)
    best_of: int = 5
    beam_size: int = 0              # 0/1 = greedy (reference default strategy,
                                    # whisper.rs:132-141); --beam-size 5 enables
                                    # beam search on EVERY serving path
    temperature: float = 0.0
    temperature_increment: float = 0.2
    entropy_thold: float = 2.4      # 32-token histogram-entropy retry gate
    #                                 (whisper.cpp entropy_thold, whisper.rs:164)
    compression_ratio_thold: float = 2.4
    logprob_thold: float = -1.0
    no_speech_thold: float = 0.6
    max_initial_ts: float = 1.0
    audio_ctx: int = 1500           # encoder frames (1500 = full 30 s)
    # batching / serving
    max_batch_size: int = 8         # windows batched per engine step
    max_decode_len: int = 448       # n_text_ctx
    stream_slots: int = 64          # continuous-batching decode slots
    # numerics
    compute_dtype: str = "bfloat16"
    cross_kv_int8: bool = False     # int8 cross-attention KV (2x less decode KV traffic)
    # int8 SELF-attention KV pages for full-window decodes, quantized at
    # ring-flush time (drift bounds: tests/test_accuracy.py). Applied only
    # when the window's token budget spans more than one 128-column page —
    # at t_text=128 the flush-quantize cost offsets the page-read saving.
    # Beam slot pools default int8 pages independently (enable_slot_serving).
    self_kv_int8: bool = False
    weights_int8: bool = False      # int8 decoder block weights (per-out-channel
    # scales). Opt-in until the executable promotion gate
    # passes on real speech: tools/wer_check.py --compare-int8-weights, which
    # promotes iff corpus WER regresses <= 0.1 pts and no file by > 1.0 pts
    # (hermetic drift proxies: tests/test_accuracy.py)
    fuse_qkv: bool = True           # one (d,3d) q/k/v projection per block (pure re-layout)
    # convert-once weight cache directory
    weight_cache_dir: str = "./asr_data/weights_cache"


@dataclass
class Config:
    model_path: str = DEFAULT_MODEL_PATH
    sqlite_path: str = DEFAULT_SQLITE_PATH
    etcd_endpoint: str = DEFAULT_ETCD_ENDPOINT
    audio_path: str = DEFAULT_AUDIO_PATH
    http_port: int = 7200           # reference src/main.rs:91
    grpc_port: int = 7300           # reference src/main.rs:83-88
    log_dir: str = "./logs"
    etcd_required: bool = False     # reference hard-fails without etcd (src/main.rs:79); we tolerate absence
    # concurrent Transcribe task workers: the reference runs one worker per
    # task type (scheduler/mod.rs:26-32) because each whisper.cpp call owns
    # the backend; here N workers' windows coalesce in the shared batcher,
    # so parallel claims RAISE batch occupancy instead of contending
    task_workers: int = 4
    # gRPC stream auth mode: "off" (reference wire parity: unauthenticated),
    # "optional" (verify+meter `authorization` metadata when present),
    # "required" (reject keyless streams)
    grpc_auth: str = "off"
    # multi-device serving: tp shards the model over local devices
    # (Megatron layout), dp spans the remaining ones (0 = auto:
    # local_devices // tp). tp=1 on one device builds no mesh.
    tp: int = 1
    dp: int = 0
    engine: EngineConfig = field(default_factory=EngineConfig)

    @property
    def sqlite_file(self) -> str:
        """Strip the sqlite:// URL scheme and query (reference src/lib.rs:66)."""
        path = self.sqlite_path
        if path.startswith("sqlite://"):
            path = path[len("sqlite://"):]
        return path.split("?", 1)[0]

    @classmethod
    def from_env(cls) -> "Config":
        dotenv = _load_dotenv()
        return cls(
            model_path=_env("ASR_MODEL_PATH", dotenv, DEFAULT_MODEL_PATH),
            sqlite_path=_env("ASR_SQLITE_PATH", dotenv, DEFAULT_SQLITE_PATH),
            etcd_endpoint=_env("ETCD_ENDPOINT", dotenv, DEFAULT_ETCD_ENDPOINT),
            audio_path=_env("ASR_AUDIO_PATH", dotenv, DEFAULT_AUDIO_PATH),
            http_port=int(_env("ASR_HTTP_PORT", dotenv, "7200")),
            grpc_port=int(_env("ASR_GRPC_PORT", dotenv, "7300")),
            task_workers=int(_env("SPEAKSENSE_TASK_WORKERS", dotenv, "4")),
            grpc_auth=_parse_grpc_auth(_env("SPEAKSENSE_GRPC_AUTH", dotenv, "off")),
            tp=int(_env("SPEAKSENSE_TP", dotenv, "1")),
            dp=int(_env("SPEAKSENSE_DP", dotenv, "0")),
        )

    def init_dirs(self) -> None:
        """Pre-create runtime directories (reference init_env, src/lib.rs:62-73
        and src/main.rs:31-33)."""
        Path(self.sqlite_file).parent.mkdir(parents=True, exist_ok=True)
        Path(self.audio_path).mkdir(parents=True, exist_ok=True)
        Path(self.engine.weight_cache_dir).mkdir(parents=True, exist_ok=True)
