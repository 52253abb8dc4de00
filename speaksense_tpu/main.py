"""Composition root: wire everything and serve.

Startup order mirrors the reference (/root/reference/src/main.rs:24-103):
env/config -> logging -> dirs -> ASR engine -> SQLite stores -> Auth + admin
key -> TaskManager + TranscribeProcessor -> scheduler/workers -> gRPC server
(with etcd registration) -> REST server. Unlike the reference, a missing
etcd does not abort gRPC startup unless config.etcd_required.

Run: python -m speaksense_tpu.main [--model PATH | --fake-engine]
"""

from __future__ import annotations

import argparse
import asyncio
import logging
import signal
from dataclasses import dataclass

from speaksense_tpu.config import Config
from speaksense_tpu.utils import logging as logsetup

log = logging.getLogger("speaksense")


def build_engine(config: Config, fake: bool = False):
    if fake:
        from speaksense_tpu.asr.fake import FakeAsrEngine

        log.warning("using FakeAsrEngine (no model loaded)")
        return FakeAsrEngine()
    from speaksense_tpu.asr.engine import WhisperEngine
    from speaksense_tpu.runtime.batcher import BatchedEngine

    engine = WhisperEngine.from_pretrained(config.model_path, config=config.engine)
    # all gRPC streams + task workers share one continuously-batched engine
    return BatchedEngine(engine)


def build_context(config: Config, engine):
    from speaksense_tpu.auth import Auth
    from speaksense_tpu.schedule.manager import TaskManager
    from speaksense_tpu.schedule.processors import (
        NoiseReductionProcessor, TranscribeProcessor, VoiceprintProcessor,
    )
    from speaksense_tpu.schedule.scheduler import create_scheduler
    from speaksense_tpu.schedule.types import TaskType
    from speaksense_tpu.serving.rest import AppContext
    from speaksense_tpu.storage.sqlite import SqliteKeyStorage, SqliteTaskStorage

    task_storage = SqliteTaskStorage(config.sqlite_file)
    key_storage = SqliteKeyStorage(config.sqlite_file)
    auth = Auth(key_storage, key_storage)
    auth.initialize_admin_key()

    manager = TaskManager(task_storage)
    # completed tasks advance the creating key's total_tokens /
    # total_audio_seconds (the reference reserves these columns and never
    # fills them, key_stats_entity.rs:14-15)
    manager.usage_hook = auth.record_usage
    manager.register_processor(TranscribeProcessor(engine, audio_dir=config.audio_path))
    manager.register_processor(NoiseReductionProcessor(audio_dir=config.audio_path))
    manager.register_processor(VoiceprintProcessor(audio_dir=config.audio_path))
    # requeue rows stuck in Processing from a crashed/restarted previous
    # process BEFORE workers start (they are otherwise stranded forever)
    manager.recover_orphaned_tasks()
    scheduler = create_scheduler(
        manager,
        [TaskType.TRANSCRIBE, TaskType.NOISE_REDUCTION,
         TaskType.VOICEPRINT_RECOGNITION],
        workers={TaskType.TRANSCRIBE: config.task_workers})
    return AppContext(auth=auth, task_manager=manager), scheduler


def place_on_mesh(engine, config: Config) -> None:
    """PRODUCTION multi-device serving: --tp shards the model over the
    host's devices (Megatron layout, parallel/mesh.py), dp spans the
    remaining local devices (slot rows / window batch). tp=1 on a single
    device builds no mesh at all — the exact one-device programs."""
    import jax

    from speaksense_tpu.parallel import make_mesh

    n_local = len(jax.local_devices())
    tp = max(1, config.tp)
    dp = config.dp or max(1, n_local // tp)
    if tp * dp > n_local:
        raise ValueError(f"tp={tp} x dp={dp} exceeds {n_local} local devices")
    if tp > 1 or dp > 1:
        mesh = make_mesh(n_devices=tp * dp, tp=tp, devices=jax.local_devices())
        engine.shard(mesh)


@dataclass
class RunningServer:
    """What start() brought up; stop() takes it down in reverse order."""

    engine: object
    inner: object
    scheduler: object
    grpc_server: object
    runner: object


async def start(config: Config, fake_engine: bool = False,
                slot_serving: bool = False, slot_prompt: int = 16,
                condition: bool = True, slot_tokens: int = 96,
                slots: int | None = None) -> RunningServer:
    from speaksense_tpu.registry.etcd import EtcdRegistry
    from speaksense_tpu.serving.grpc_server import GrpcServer
    from speaksense_tpu.serving.rest import start_server

    from speaksense_tpu.utils.jaxsetup import init_compilation_cache

    init_compilation_cache()
    config.init_dirs()
    if not fake_engine:
        # multi-host DP: no-op unless SPEAKSENSE_COORDINATOR /
        # _NUM_PROCESSES / _PROCESS_ID are set; each host registers its own
        # etcd node below (clients load-balance go-micro style)
        from speaksense_tpu.parallel import init_distributed

        init_distributed()
    engine = build_engine(config, fake=fake_engine)
    inner = getattr(engine, "engine", engine)
    if not fake_engine and hasattr(inner, "shard"):
        place_on_mesh(inner, config)
    if slot_serving and hasattr(inner, "enable_slot_serving"):
        inner.enable_slot_serving(n_slots=slots, max_new=slot_tokens,
                                  max_prompt=slot_prompt)
    ctx, scheduler = build_context(config, engine)

    registry = EtcdRegistry(config.etcd_endpoint)
    grpc_server = GrpcServer(
        engine, port=config.grpc_port, registry=registry,
        # optional stream auth (SPEAKSENSE_GRPC_AUTH=optional|required): the
        # same key store as REST; off by default for reference wire parity
        auth=ctx.auth if config.grpc_auth in ("optional", "required") else None,
        require_auth=config.grpc_auth == "required",
        condition=condition)
    try:
        await grpc_server.start()
    except Exception:
        if config.etcd_required:
            raise
        log.exception("gRPC startup issue")

    runner = await start_server(ctx, port=config.http_port)
    log.info("SpeakSense up: gRPC :%d, REST :%d", config.grpc_port, config.http_port)
    return RunningServer(engine, inner, scheduler, grpc_server, runner)


async def stop(server: RunningServer) -> None:
    """Stop claiming new tasks and drain the batcher/slot pool (the
    reference has no drain path; streams just die — SURVEY §5)."""
    server.scheduler.stop()
    if hasattr(server.engine, "stop"):
        server.engine.stop()          # window batcher: finish in-flight batch
    if hasattr(server.inner, "disable_slot_serving"):
        server.inner.disable_slot_serving()
    await server.grpc_server.stop()
    await server.runner.cleanup()


async def serve(config: Config, fake_engine: bool = False,
                slot_serving: bool = False, slot_prompt: int = 16,
                condition: bool = True, slot_tokens: int = 96,
                slots: int | None = None) -> None:
    server = await start(config, fake_engine=fake_engine,
                         slot_serving=slot_serving, slot_prompt=slot_prompt,
                         condition=condition, slot_tokens=slot_tokens,
                         slots=slots)

    # graceful shutdown: SIGTERM/SIGINT deregisters from etcd, stops claiming
    # new tasks, and drains the batcher/slot pool before exiting
    stop_event = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        try:
            loop.add_signal_handler(sig, stop_event.set)
        except (NotImplementedError, RuntimeError):  # pragma: no cover
            pass
    wait_task = asyncio.create_task(server.grpc_server.wait())
    stop_task = asyncio.create_task(stop_event.wait())
    try:
        await asyncio.wait({wait_task, stop_task},
                           return_when=asyncio.FIRST_COMPLETED)
        if stop_event.is_set():
            log.info("shutdown signal received; draining")
    finally:
        await stop(server)
        for t in (wait_task, stop_task):
            t.cancel()


def main() -> None:
    parser = argparse.ArgumentParser(description="SpeakSense ASR server")
    parser.add_argument("--model", help="ggml model path (default: $ASR_MODEL_PATH)")
    parser.add_argument("--fake-engine", action="store_true",
                        help="serve with the deterministic fake engine (no "
                             "model, no accelerator)")
    parser.add_argument("--http-port", type=int)
    parser.add_argument("--grpc-port", type=int)
    parser.add_argument("--batch", type=int, default=None,
                        help="windows batched per engine step (default 8)")
    parser.add_argument("--int8-kv", action="store_true",
                        help="int8 cross-attention KV (2x less decode KV traffic)")
    parser.add_argument("--int8-self-kv", action="store_true",
                        help="int8 self-attention KV pages for full-window "
                             "decodes, quantized at ring flush (skipped for "
                             "windows whose token budget fits one 128-column "
                             "page)")
    parser.add_argument("--int8-weights", action="store_true",
                        help="int8 decoder block weights (per-out-channel scales)")
    parser.add_argument("--beam-size", type=int, default=None,
                        help="beam search width at t=0 (default greedy)")
    parser.add_argument("--tp", type=int, default=None,
                        help="tensor-parallel width: shard the model over "
                             "tp local devices (Megatron layout); default 1 "
                             "(no sharding on a single device)")
    parser.add_argument("--dp", type=int, default=None,
                        help="data-parallel width (default: local devices / tp)")
    parser.add_argument("--slot-serving", action="store_true",
                        help="route streaming chunks through the token-level "
                             "slot pool (runtime/slots.py) instead of the "
                             "window batcher")
    parser.add_argument("--slot-prompt", type=int, default=16,
                        help="slot-pool prompt budget in tokens (default 16 "
                             "= plain SOT; 64 lets pooled streams carry "
                             "previous-text conditioning at the cost of a "
                             "larger per-slot KV page)")
    parser.add_argument("--no-condition", action="store_true",
                        help="disable previous-text conditioning on streams "
                             "(whisper.cpp no_context=true; the reference "
                             "serves no_context=false)")
    parser.add_argument("--slot-tokens", type=int, default=96,
                        help="slot-pool decode-token budget per 5 s chunk "
                             "(default 96; 64 is the beam latency mode)")
    parser.add_argument("--slots", type=int, default=None,
                        help="slot-pool size (default EngineConfig."
                             "stream_slots; beam pools need fewer, each "
                             "slot holds beam-size KV pages)")
    args = parser.parse_args()

    config = Config.from_env()
    if args.model:
        config.model_path = args.model
    if args.http_port:
        config.http_port = args.http_port
    if args.grpc_port:
        config.grpc_port = args.grpc_port
    if args.batch:
        config.engine.max_batch_size = args.batch
    if args.int8_kv:
        config.engine.cross_kv_int8 = True
    if args.int8_self_kv:
        config.engine.self_kv_int8 = True
    if args.int8_weights:
        config.engine.weights_int8 = True
    if args.beam_size:
        config.engine.beam_size = args.beam_size
    if args.tp:
        config.tp = args.tp
    if args.dp:
        config.dp = args.dp

    logsetup.init(config.log_dir)
    asyncio.run(serve(config, fake_engine=args.fake_engine,
                      slot_serving=args.slot_serving,
                      slot_prompt=args.slot_prompt,
                      condition=not args.no_condition,
                      slot_tokens=args.slot_tokens,
                      slots=args.slots))


if __name__ == "__main__":
    main()
