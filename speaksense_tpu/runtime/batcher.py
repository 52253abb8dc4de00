"""BatchedEngine: cross-request window batching.

Replaces the reference's per-stream serialization (one whisper.cpp state +
mutex per gRPC stream, /root/reference/src/asr/whisper.rs:30-39 and
src/grpc/handlers/asr.rs:164-169) with a shared batch loop:

  callers (gRPC streams, REST task workers, CLI) submit mel windows ->
  a collector thread drains the queue, groups compatible windows
  (same mel bucket / task / timestamp mode), pads to the batch bucket,
  and runs ONE compiled decode for all of them. Per-slot language prompts
  and per-slot fallback temperatures mean heterogeneous requests still
  share the program.

Window-level batching is the right granularity for whisper serving: decode
lengths are short (tens of tokens per 5-30 s window) and every window
recomputes cross-KV anyway; token-level admission would add host-device
sync per step for marginal gain. Throughput scales with batch occupancy.

BatchedEngine implements the AsrEngine interface, so it drops into the gRPC
handler, the task processors, and the REST stack unchanged.
"""

from __future__ import annotations

import logging
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

from speaksense_tpu.asr import AsrEngine, AsrParams, TranscribeResult
from speaksense_tpu.asr.engine import WhisperEngine

log = logging.getLogger(__name__)


@dataclass
class _WindowJob:
    mel: np.ndarray              # (T_mel, n_mels)
    language: str | None
    task: str
    suppress_non_speech: bool
    context: list | None = None  # previous-text conditioning tokens
    speaker_diarization: bool = False
    temperature: float = 0.0     # user-requested initial sampling temp
    future: Future = field(default_factory=Future)

    @property
    def group_key(self):
        # speaker_diarization changes the suppress mask (the tdrz turn
        # token), i.e. the compiled program — batches must not mix it
        return (self.mel.shape[0], self.task, self.suppress_non_speech,
                self.speaker_diarization)


class BatchedEngine(AsrEngine):
    def __init__(self, engine: WhisperEngine, max_batch: int | None = None,
                 max_wait_ms: float = 5.0):
        self.engine = engine
        self.max_batch = max_batch or engine.config.max_batch_size
        self.max_wait_s = max_wait_ms / 1000.0
        self._queue: "queue.Queue[_WindowJob]" = queue.Queue()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="batch-engine", daemon=True)
        self._thread.start()
        # telemetry
        self.batches_run = 0
        self.windows_run = 0

    # ------------------------------------------------------------- batching

    def submit_window(self, mel, language: str | None, task: str,
                      suppress_non_speech: bool, context: list | None = None,
                      speaker_diarization: bool = False,
                      temperature: float = 0.0) -> Future:
        """mel: (T_mel, n_mels), numpy OR device array — device arrays are
        kept on device (compute_mel output would otherwise round-trip
        through the host, ~1.5 MB each way per 30 s window)."""
        job = _WindowJob(mel, language, task, suppress_non_speech, context,
                         speaker_diarization, temperature)
        self._queue.put(job)
        return job.future

    def _decode_window(self, mel, language, task, suppress_non_speech,
                       context=None, speaker_diarization=False,
                       temperature=0.0) -> dict:
        """decode_window hook for WhisperEngine.transcribe_audio: one window
        through the shared batch. Forwards speaker_diarization (the tdrz
        suppress-mask toggle — dropping it silently disabled diarization in
        production, round-2 review) and the user temperature."""
        if mel.ndim == 3:
            mel = mel[0]
        return self.submit_window(mel, language, task, suppress_non_speech,
                                  context, speaker_diarization,
                                  temperature).result()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            # drain compatible jobs up to the bucket, waiting briefly for
            # stragglers so concurrent streams coalesce. max_wait is a
            # TOTAL deadline for the collection phase (a per-dequeue wait
            # would let steady incompatible traffic extend it unboundedly)
            import time as _time

            deadline = _time.monotonic() + self.max_wait_s
            leftovers: list[_WindowJob] = []
            while len(batch) < self.max_batch:
                remaining = deadline - _time.monotonic()
                try:
                    job = (self._queue.get(timeout=remaining)
                           if remaining > 0 else self._queue.get_nowait())
                except queue.Empty:
                    break
                if job.group_key == first.group_key:
                    batch.append(job)
                else:
                    leftovers.append(job)
            for job in leftovers:  # different bucket: requeue for next round
                self._queue.put(job)
            self._run_batch(batch)

    def _run_batch(self, batch: list[_WindowJob]) -> None:
        try:
            import jax.numpy as jnp

            # device-side stack: numpy mels upload once, device mels stay put
            mels = jnp.stack([jnp.asarray(j.mel) for j in batch])
            # pad to the full bucket so every occupancy shares one program.
            # Pad rows REPLICATE row 0 (same mel + language): zero-mel pads
            # decode garbage that reliably trips the quality thresholds and
            # dragged every underfilled batch through the full temperature-
            # fallback ladder (up to 5 extra full-width dispatches whose
            # results are discarded — round-2 review); a replica follows
            # row 0's own accept/retry behavior instead
            pad = self.max_batch - len(batch)
            if pad > 0:
                mels = jnp.concatenate(
                    [mels, jnp.broadcast_to(mels[:1], (pad,) + mels.shape[1:])])
            langs = [j.language for j in batch] + [batch[0].language] * pad
            contexts = [j.context or [] for j in batch] + [[]] * pad
            temps = [j.temperature for j in batch] + [batch[0].temperature] * pad
            results = self.engine.decode_windows(
                mels, langs, task=batch[0].task,
                suppress_non_speech=batch[0].suppress_non_speech,
                speaker_diarization=batch[0].speaker_diarization,
                temperatures=temps if any(temps) else None,
                context_tokens=contexts if any(contexts) else None)
            self.batches_run += 1
            self.windows_run += len(batch)
            from speaksense_tpu.utils.metrics import REGISTRY as METRICS

            METRICS.inc("asr_batches_total")
            METRICS.set_gauge("asr_batch_occupancy", len(batch) / self.max_batch)
            for job, res in zip(batch, results):
                job.future.set_result(res)
        except Exception as e:
            log.error("batched decode failed: %s", e, exc_info=True)
            for job in batch:
                if not job.future.done():
                    job.future.set_exception(e)

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # resolve abandoned jobs: submit_window callers block on
        # Future.result() with no timeout, so queued-but-never-run jobs
        # would hang their worker threads forever (round-2 review)
        err = RuntimeError("batch engine stopped")
        while True:
            try:
                job = self._queue.get_nowait()
            except queue.Empty:
                break
            if not job.future.done():
                job.future.set_exception(err)

    # ------------------------------------------------------- AsrEngine API

    def create_state(self):
        return self.engine.create_state()

    def transcribe_with_state(self, state, audio, params: AsrParams) -> TranscribeResult:
        return self.engine.transcribe_with_state(state, audio, params,
                                                 decode_window=self._decode_window)

    def transcribe_audio(self, audio, params: AsrParams) -> TranscribeResult:
        return self.engine.transcribe_audio(np.asarray(audio, np.float32), params,
                                            decode_window=self._decode_window)

    def detect_language(self, audio) -> str:
        return self.engine.detect_language(audio)

    def transcribe_audio_vad(self, audio, params: AsrParams) -> TranscribeResult:
        """VAD-segmented long-form path THROUGH the shared batch (the
        TranscribeProcessor probes hasattr(engine, 'transcribe_audio_vad');
        without this forward the production wrapper silently lost the VAD
        fast path — round-2 review)."""
        return self.engine.transcribe_audio_vad(
            np.asarray(audio, np.float32), params,
            decode_window=self._decode_window)

    # ---------------------------------------------- slot-pool fast paths
    # StreamSession probes its engine for these (serving/stream.py); the
    # production composition root hands GrpcServer THIS wrapper (main.py
    # build_engine), so without forwarding the device-denoise, session-
    # pipelining, and s16 wire-dtype paths would be bench-only: the bench
    # drives a raw WhisperEngine, production would silently fall back to
    # host denoise + sequential chunks (caught by review; pinned by
    # tests/test_batcher.py::test_batched_engine_forwards_slot_paths).

    @property
    def device_denoise(self) -> bool:
        return bool(getattr(self.engine, "device_denoise", False))

    def submit_stream_chunk(self, state, audio, params: AsrParams,
                            pad_to_bucket: bool = False):
        submit = getattr(self.engine, "submit_stream_chunk", None)
        if submit is None:
            return None
        # None (off-bucket / conditioning / no pool) -> the caller takes the
        # sequential path through transcribe_with_state, i.e. the batcher
        return submit(state, audio, params, pad_to_bucket=pad_to_bucket)
