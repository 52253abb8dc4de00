"""WhisperEngine: the JAX inference engine behind the AsrEngine interface.

This replaces the whisper.cpp black box the reference wraps
(/root/reference/src/asr/whisper.rs): model loading (ggml -> device pytree),
log-mel, encoder/decoder, sampling with whisper's quality-threshold
temperature fallback (FullParams entropy_thold 2.4 / logprob_thold -1.0 /
no_speech_thold 0.6 — whisper.rs:164-167), long-form seek stitching, and the
reference's post-filters (promo text, CJK punctuation).

Accelerator-oriented specifics:
- every (batch, mel-frames, prompt-len) shape bucket compiles once and is
  cached; all windows of all concurrent requests can share one program;
- temperature fallback retries are *per-slot* via a (B,) temperature vector
  instead of whole-window serial retries;
- short streaming chunks use a truncated encoder context bucket
  (whisper.cpp's audio_ctx trick, whisper.rs:144) so a 5 s chunk costs
  ~1/6 of a full 30 s encode.
"""

from __future__ import annotations

import functools
import logging
import threading
import time
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from speaksense_tpu.asr import AsrEngine, AsrParams, TranscribeResult, TranscribeSegment
from speaksense_tpu.asr import postprocess as PP
from speaksense_tpu.audio import mel as MEL
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models import whisper as W
from speaksense_tpu.models import decode as D
from speaksense_tpu.models.tokenizer import Tokenizer
from speaksense_tpu.utils.metrics import REGISTRY as METRICS

log = logging.getLogger(__name__)

SAMPLE_RATE = MEL.SAMPLE_RATE
# whisper temperature fallback schedule (openai + whisper.cpp)
FALLBACK_TEMPS = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


@dataclass
class EngineState:
    """Per-stream host-side decode context (the reference's WhisperState is a
    per-stream C++ KV allocation, whisper.rs:30-39; our device KV is pooled,
    so the state carries only conditioning/bookkeeping)."""

    language: str | None = None
    prev_text: str = ""
    context_tokens: list = field(default_factory=list)  # stream conditioning
    lock: threading.Lock = field(default_factory=threading.Lock)
    # conditioned-pipelining bound: chunks of THIS stream submitted but not
    # yet settled with conditioning active (see submit_stream_chunk)
    inflight_conditioned: int = 0


def needs_fallback_retry(cand: dict, config: EngineConfig) -> bool:
    """Temperature-fallback quality gates on one decode candidate, matching
    the wrapped engine's semantics: zlib compression ratio + avg logprob
    (openai whisper) and the 32-token histogram-entropy gate (whisper.cpp
    entropy_thold 2.4, whisper.rs:164 — fires only past 32 sampled tokens,
    as whisper_sequence_score's `result_len > n` guard does).

    Silence short-circuit (openai transcribe.py decode_with_fallback):
    a window whose no-speech probability clears no_speech_thold never
    retries — the low logprob IS the silence signal, and the seek loop /
    stream postprocess suppresses its text instead."""
    if cand.get("no_speech_prob", 0.0) > config.no_speech_thold:
        return False
    return ((cand["compression_ratio"] > config.compression_ratio_thold)
            or (cand["avg_logprob"] < config.logprob_thold)
            or (cand["n_sampled"] > 32
                and cand.get("token_entropy", 99.0) < config.entropy_thold))


class _PendingChunk:
    """Handle for one in-flight stream chunk (WhisperEngine.
    submit_stream_chunk): settle() blocks until the slot pool finishes the
    chunk's decode, then runs the host postprocess. Settle calls for one
    stream must happen in submission order from a single thread — the
    conditioning-context update is ordered by that discipline, not a lock
    (the sequential path holds state.lock for the whole chunk instead)."""

    __slots__ = ("engine", "state", "future", "n_samples", "params", "language",
                 "conditioned", "retry")

    def __init__(self, engine, state, future, n_samples, params, language,
                 conditioned: bool = False, retry=None):
        self.engine = engine
        self.state = state
        self.future = future
        self.n_samples = n_samples
        self.params = params
        self.language = language
        self.conditioned = conditioned
        # retry(temperature) -> list[raw candidate dicts]: resubmits the
        # chunk's audio for the temperature-fallback ladder (None = gates
        # off, e.g. engines without a pool retry path)
        self.retry = retry

    def settle(self) -> TranscribeResult:
        try:
            raw = self.future.result()
            raw = self.engine._pool_quality_gate(raw, self.retry)
            result = self.engine._finish_slot_chunk(raw, self.n_samples,
                                                    self.params, self.language,
                                                    self.state)
        finally:
            if self.conditioned and self.state is not None:
                with self.state.lock:
                    self.state.inflight_conditioned -= 1
        if self.state is not None:
            self.state.language = result.language or self.state.language
        return result


class _PendingMultiChunk:
    """Handle for one OVERSIZED in-flight stream chunk (WhisperEngine.
    submit_stream_chunk): a chunk whose mel bucket exceeds the slot pool's
    t_mel rides the pool as ceil-split pool-bucket sub-windows admitted
    CONCURRENTLY (each gets the pool's per-window token budget, so the
    budget scales with chunk length), instead of falling back to the window
    batcher. settle() joins the pieces in submission order and merges their
    segments onto the chunk's absolute timeline. Split points are hard cuts
    with no overlap — healing boundary words is the transport layer's job
    (the 1 s chunk overlap in serving/stream.py), exactly as it is for the
    reference's own 5 s hard chunk cuts
    (/root/reference/src/grpc/handlers/asr.rs:14-18)."""

    __slots__ = ("engine", "state", "futures", "piece_samples", "n_samples",
                 "params", "language", "conditioned", "retries")

    def __init__(self, engine, state, futures, piece_samples, n_samples,
                 params, language, conditioned: bool = False, retries=None):
        self.engine = engine
        self.state = state
        self.futures = futures
        self.piece_samples = piece_samples
        self.n_samples = n_samples
        self.params = params
        self.language = language
        self.conditioned = conditioned
        # per-piece retry(temperature) closures (parallel to futures)
        self.retries = retries

    def settle(self) -> TranscribeResult:
        try:
            raws = [f.result() for f in self.futures]
            retries = self.retries or [None] * len(raws)
            raws = [self.engine._pool_quality_gate(r, rt)
                    for r, rt in zip(raws, retries)]
            result = self.engine._finish_slot_chunk_multi(
                raws, self.piece_samples, self.n_samples, self.params,
                self.language, self.state)
        finally:
            if self.conditioned and self.state is not None:
                with self.state.lock:
                    self.state.inflight_conditioned -= 1
        if self.state is not None:
            self.state.language = result.language or self.state.language
        return result


class WhisperEngine(AsrEngine):
    def __init__(self, params, dims: W.WhisperDims, tokenizer: Tokenizer,
                 mel_filters: np.ndarray | None = None,
                 config: EngineConfig | None = None, name: str = "whisper"):
        self.config = config or EngineConfig()
        self.dims = dims
        self.tokenizer = tokenizer
        self.name = name
        dtype = jnp.bfloat16 if self.config.compute_dtype == "bfloat16" else jnp.float32
        self.dtype = dtype

        # weight re-layouts run HOST-SIDE, BEFORE device placement: both are
        # numpy transforms, and applying them to device-resident arrays
        # would fetch the block weights back to the host — ~600 MB per
        # engine construction for large-v3 with fuse_qkv on
        if self.config.fuse_qkv:
            # pure weight re-layout: one (d, 3d) qkv matmul per block instead
            # of three (d, d) — fewer ops in the scanned decode step
            params = W.fuse_qkv_weights(params)
        if self.config.weights_int8:
            # int8 decoder block weights (whisper.cpp ships q5/q8 ggml models
            # the same way; per-out-channel scales here)
            params = W.quantize_block_weights(params)

        def to_dev(path, x):
            x = jnp.asarray(x)
            leaf = getattr(path[-1], "key", None) if path else None
            if x.dtype == jnp.int8 or leaf == "ws":
                # quantized weights stay int8; their per-channel scales stay
                # f32 (bf16 scales would compound the quantization error)
                return x
            # keep norm/bias/pos f32; big matmul weights in compute dtype
            return x.astype(dtype) if x.ndim >= 2 else x.astype(jnp.float32)

        self.params = jax.tree_util.tree_map_with_path(to_dev, params)
        self.mel_filters = (np.asarray(mel_filters, np.float32)
                            if mel_filters is not None else MEL.mel_filter_bank(dims.n_mels))
        # suppression mask variants (device-resident)
        self._suppress = {
            (sns, turn): jnp.asarray(tokenizer.suppress_mask(
                suppress_non_speech=sns, allow_speaker_turn=turn))
            for sns in (True, False) for turn in (True, False)
        }
        self._jit_cache: dict = {}
        self._rng = np.random.default_rng(0)
        self.mesh = None  # set by shard(): (dp, tp) serving mesh

    # ------------------------------------------------------------------ shard

    def shard(self, mesh) -> None:
        """Place the engine's parameters on a (dp, tp) serving mesh
        (parallel/mesh.py Megatron layout: attention/MLP projections split
        over tp, everything else replicated). Every program compiled after
        this — window decode, beam, slot-pool admit/step — runs SPMD with
        XLA-inserted collectives over the devices' interconnect. This is the
        production mapping of the reference's n_threads=16 intra-op knob
        (whisper.rs:143 — SURVEY §2 parallelism table).

        Call BEFORE enable_slot_serving so the pool's KV pages shard too
        (slots on dp, heads on tp)."""
        from speaksense_tpu.parallel import shard_params

        if getattr(self, "_slot_server", None) is not None:
            raise RuntimeError("shard() must run before enable_slot_serving "
                               "(the pool's pages must shard with the params)")
        self.params = shard_params(self.params, mesh)
        # suppress masks are tiny but participate in every decode program;
        # replicate them explicitly so SPMD sharding propagation never
        # guesses a partition for them
        import jax
        from jax.sharding import NamedSharding, PartitionSpec as P

        self._suppress = {k: jax.device_put(v, NamedSharding(mesh, P(None)))
                          for k, v in self._suppress.items()}
        self.mesh = mesh
        log.info("engine sharded over mesh %s (dp=%d, tp=%d)", mesh.devices.shape,
                 mesh.shape["dp"], mesh.shape["tp"])

    # ------------------------------------------------------------------ load

    @classmethod
    def from_ggml(cls, path: str, config: EngineConfig | None = None,
                  use_cache: bool = True) -> "WhisperEngine":
        import dataclasses

        from speaksense_tpu.ckpt import cache as CK
        from speaksense_tpu.ckpt.ggml import load_ggml, params_from_ggml

        config = config or EngineConfig()
        t0 = time.time()
        cached = CK.load_cached(path, config.weight_cache_dir) if use_cache else None
        if cached is not None:
            params, meta = cached
            dims = W.WhisperDims(**meta["dims"])
            tok = Tokenizer.from_vocab(meta["vocab"])
            filters = meta["filters"]
            log.info("loaded cached weights for %s in %.1fs", path, time.time() - t0)
        else:
            model = load_ggml(path)
            params = params_from_ggml(model)
            dims, tok = model.dims, Tokenizer.from_vocab(model.vocab)
            filters = model.filters if model.filters.size else None
            log.info("loaded ggml model %s in %.1fs (dims=%s)", path, time.time() - t0, dims)
            if use_cache:
                try:
                    CK.save_cached(path, config.weight_cache_dir, params,
                                   dataclasses.asdict(dims), model.vocab, filters,
                                   ftype=model.ftype)
                except OSError as e:
                    log.warning("weight cache write failed: %s", e)
        return cls(params, dims, tok, mel_filters=filters, config=config, name=str(path))

    @classmethod
    def from_random(cls, model: str = "tiny", config: EngineConfig | None = None,
                    seed: int = 0) -> "WhisperEngine":
        """Random-weight engine for tests/benchmarks (no checkpoint needed)."""
        dims = W.MODEL_DIMS[model]
        params = W.init_params(dims, jax.random.PRNGKey(seed))
        tok = Tokenizer.synthetic(dims.n_vocab)
        return cls(params, dims, tok, config=config, name=f"random-{model}")

    @classmethod
    def from_pretrained(cls, path: str, config: EngineConfig | None = None) -> "WhisperEngine":
        """Dispatch on checkpoint type: ggml .bin files or HF directories
        (config.json + safetensors, e.g. distil-whisper releases)."""
        import os

        if os.path.isdir(path):
            return cls.from_hf_dir(path, config=config)
        return cls.from_ggml(path, config=config)

    @classmethod
    def from_hf_dir(cls, path: str, config: EngineConfig | None = None) -> "WhisperEngine":
        import json
        from pathlib import Path

        from speaksense_tpu.ckpt.hf_dir import load_hf_dir

        params, dims = load_hf_dir(path)
        # HF dirs don't embed the ggml vocab; a tokenizer-layout vocab can be
        # supplied as vocab.json (id->piece) or falls back to the synthetic
        # layout (specials correct, text decode degraded).
        vocab_file = Path(path) / "speaksense_vocab.json"
        if vocab_file.is_file():
            vocab = [bytes.fromhex(h) for h in json.loads(vocab_file.read_text())]
            tok = Tokenizer.from_vocab(vocab)
        else:
            log.warning("%s has no speaksense_vocab.json; using synthetic vocab "
                        "(special tokens fine, text decode needs the real vocab)", path)
            tok = Tokenizer.synthetic(dims.n_vocab)
        return cls(params, dims, tok, config=config, name=str(path))

    # ------------------------------------------------------------- jit plumbing

    def _mel_bucket(self, t_mel: int) -> int:
        for b in (512, 1024, 3000):
            if t_mel <= b:
                return b
        return 3000

    def _window_fn(self, batch: int, prompt_len: int, t_mel: int, with_ts: bool,
                   max_new: int):
        key = ("win", batch, prompt_len, t_mel, with_ts, max_new)
        fn = self._jit_cache.get(key)
        if fn is None:
            cfg = D.RuleConfig.from_tokenizer(
                self.tokenizer, with_timestamps=with_ts,
                max_initial_ts=self.config.max_initial_ts, max_new_tokens=max_new)
            n_audio_ctx = min(t_mel // 2, self.dims.n_audio_ctx)

            cross_int8 = self.config.cross_kv_int8
            # int8 self-KV pages only when the token budget spans >1
            # 128-column page (t_cap >= 256): at t_text=128 the flush
            # quantize offsets the page-read saving
            self_int8 = (self.config.self_kv_int8
                         and prompt_len + max_new > 128)

            def run(params, suppress, mel_f32, prompt, prompt_len, sot_index, temps, key):
                return D.transcribe_window(params, self.dims, cfg, suppress, mel_f32,
                                           prompt, temps, key, sot_index=sot_index,
                                           n_audio_ctx=n_audio_ctx, prompt_len=prompt_len,
                                           cross_kv_int8=cross_int8,
                                           self_kv_int8=self_int8)

            fn = jax.jit(run)
            self._jit_cache[key] = fn
        return fn

    def _detect_fn(self, batch: int, t_mel: int):
        key = ("lang", batch, t_mel)
        fn = self._jit_cache.get(key)
        if fn is None:
            n_audio_ctx = min(t_mel // 2, self.dims.n_audio_ctx)

            def run(params, mel):
                enc = W.encode(params, self.dims, mel, n_ctx_out=n_audio_ctx)
                return D.detect_language(params, self.dims, enc, self.tokenizer)

            fn = jax.jit(run)
            self._jit_cache[key] = fn
        return fn

    def compute_mel(self, audio: np.ndarray, pad_to: int | None = None) -> jax.Array:
        """audio (n,) or (B, n) f32 @16k -> (B, T_mel, n_mels). pad_to selects
        a frame bucket (512 for streaming chunks, 3000 for full windows)."""
        a = np.atleast_2d(np.asarray(audio, np.float32))
        if pad_to is None:
            m = MEL.log_mel_spectrogram(a, n_mels=self.dims.n_mels, filters=self.mel_filters)
        else:
            target = pad_to * MEL.HOP_LENGTH
            if a.shape[-1] < target:
                a = np.pad(a, ((0, 0), (0, target - a.shape[-1])))
            a = a[:, :target]
            m = MEL.log_mel_spectrogram(a, n_mels=self.dims.n_mels,
                                        filters=self.mel_filters, pad_to_chunk=False)
        return m

    # --------------------------------------------------------------- decoding

    def _beam_fn(self, batch: int, prompt_len: int, t_mel: int, with_ts: bool,
                 max_new: int, beam_size: int):
        key = ("beam", batch, prompt_len, t_mel, with_ts, max_new, beam_size)
        fn = self._jit_cache.get(key)
        if fn is None:
            from speaksense_tpu.models.beam import transcribe_window_beam

            cfg = D.RuleConfig.from_tokenizer(
                self.tokenizer, with_timestamps=with_ts,
                max_initial_ts=self.config.max_initial_ts, max_new_tokens=max_new)
            n_audio_ctx = min(t_mel // 2, self.dims.n_audio_ctx)

            def run(params, suppress, mel_f32, prompt, prompt_len, sot_index):
                return transcribe_window_beam(params, self.dims, cfg, suppress, mel_f32,
                                              prompt, beam_size=beam_size,
                                              n_audio_ctx=n_audio_ctx,
                                              prompt_len=prompt_len,
                                              sot_index=sot_index,
                                              cross_kv_int8=self.config.cross_kv_int8)

            fn = jax.jit(run)
            self._jit_cache[key] = fn
        return fn

    def decode_windows(self, mels, language, task: str = "transcribe",
                       with_timestamps: bool = True, suppress_non_speech: bool = False,
                       max_new_tokens: int | None = None, temperatures=None,
                       beam_size: int | None = None,
                       speaker_diarization: bool = False,
                       context_tokens: list | None = None) -> list[dict]:
        """Decode a batch of mel windows with per-slot temperature fallback.
        mels: (B, T_mel, n_mels); language: one code or a per-slot list (the
        continuous batcher packs windows of different streams/languages into
        one step). Returns per-slot dicts with tokens/text/avg_logprob/
        no_speech_prob/compression_ratio/temperature.

        beam_size=None defers to config.beam_size, so the server flag
        --beam-size reaches every serving caller (window batcher, stream
        chunks, task processors) without each one plumbing the knob."""
        if beam_size is None:
            beam_size = self.config.beam_size
        mels = jnp.asarray(mels)
        B, T_mel = mels.shape[0], mels.shape[1]
        langs = [language] * B if (language is None or isinstance(language, str)) else list(language)
        sot_rows = [
            self.tokenizer.sot_sequence(l or "en", task=task, timestamps=with_timestamps)
            for l in langs
        ]
        prompt_ids = sot_rows[0]
        # conditioning: [<|startofprev|>] + context + sot_seq, right-padded to
        # a bucket so one compiled program serves every context length
        # (whisper.cpp's no_context=false mode; openai condition_on_previous_text)
        ctx = context_tokens if context_tokens is not None else [[] for _ in range(B)]
        max_ctx = self.dims.n_text_ctx // 2 - 1 - max(len(r) for r in sot_rows)
        rows, lens, sots = [], [], []
        for i in range(B):
            c = list(ctx[i] or [])[-max_ctx:]
            row = ([self.tokenizer.sot_prev] + c if c else []) + sot_rows[i]
            rows.append(row)
            lens.append(len(row))
            sots.append(len(row) - len(sot_rows[i]))
        P = max(lens)
        if P > len(prompt_ids):  # bucket to multiples of 32 past the base size
            P = ((P + 31) // 32) * 32
        prompt_np = np.full((B, P), self.tokenizer.eot, np.int32)
        for i, row in enumerate(rows):
            prompt_np[i, : len(row)] = row
        prompt = jnp.asarray(prompt_np)
        prompt_len = jnp.asarray(np.asarray(lens, np.int32))
        sot_index = jnp.asarray(np.asarray(sots, np.int32))
        max_new = max_new_tokens or self.config.max_decode_len // 2
        fn = self._window_fn(B, P, T_mel, with_timestamps, max_new)
        suppress = self._suppress[(suppress_non_speech, speaker_diarization)]

        temps = np.zeros((B,), np.float32) if temperatures is None else np.asarray(temperatures, np.float32)
        schedule = [t for t in FALLBACK_TEMPS]
        results: list[dict | None] = [None] * B
        last_attempt: list[dict | None] = [None] * B
        pending = np.ones((B,), bool)
        METRICS.inc("asr_windows_total", B)
        t_start = time.perf_counter()

        def _candidate(tokens, n_sampled, avg_lp, ns_prob, row, temp) -> dict:
            n = int(n_sampled[row])
            text = self.tokenizer.decode(tokens[row, :n])
            return dict(
                tokens=tokens[row], n_sampled=n, text=text,
                avg_logprob=float(avg_lp[row]), no_speech_prob=float(ns_prob[row]),
                compression_ratio=PP.compression_ratio(text), temperature=float(temp),
                token_entropy=PP.token_entropy(tokens[row, :n]),
            )

        def _settle(b: int, cand: dict, attempt: int) -> None:
            """Accept the slot's candidate or schedule a hotter retry.
            Escalation picks the first ladder rung STRICTLY above the row's
            current temperature (not schedule[attempt+1]): a caller that
            starts a row mid-ladder (temperatures=[0.4], e.g. the beam
            pool's window-path retry) must not re-decode at the same temp."""
            last_attempt[b] = cand
            needs_retry = needs_fallback_retry(cand, self.config)
            if needs_retry and temps[b] < schedule[-1]:
                temps[b] = next(t for t in schedule if t > temps[b])
                METRICS.inc("asr_fallback_retries_total")
                return
            results[b] = cand
            pending[b] = False

        # attempt 0: t=0 for every slot — beam search if configured, else
        # greedy (the reference's SamplingStrategy, whisper.rs:132-141)
        key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
        if beam_size and beam_size > 1 and not temps.any():
            # variable-length conditioning prompts ride the same
            # prompt_len/sot_index contract as the greedy path
            bfn = self._beam_fn(B, P, T_mel, with_timestamps, max_new, beam_size)
            out = bfn(self.params, suppress, mels, prompt, prompt_len, sot_index)
        else:
            out = fn(self.params, suppress, mels, prompt, prompt_len, sot_index,
                     jnp.asarray(temps), key)
        tokens = np.asarray(out["tokens"])
        n_sampled = np.asarray(out["n_sampled"])
        avg_lp = np.asarray(out["avg_logprob"])
        ns_prob = np.asarray(out["no_speech_prob"])
        for b in range(B):
            _settle(b, _candidate(tokens, n_sampled, avg_lp, ns_prob, b, temps[b]), 0)

        # retries: t>0 sampling with best_of candidates per slot (the
        # reference configures greedy best_of=5, whisper.rs:132-141; openai
        # whisper applies best_of at t>0 and picks the best avg_logprob).
        # Candidates are extra ROWS of the same compiled B-bucket program:
        # a pending slot's mel/prompt is tiled best_of times and each row
        # draws independent Gumbel noise (decode.py:_sample is per-row).
        best_of = max(1, int(self.config.best_of))
        for attempt in range(1, len(schedule)):
            pend_idx = [b for b in range(B) if pending[b]]
            if not pend_idx:
                break
            bo = best_of
            Bc = max(B, bo)  # candidate bucket; == B when B >= best_of
            retry_fn = fn if Bc == B else self._window_fn(Bc, P, T_mel,
                                                          with_timestamps, max_new)
            per_call = max(1, Bc // bo)
            for g0 in range(0, len(pend_idx), per_call):
                group = pend_idx[g0 : g0 + per_call]
                rows: list[int] = []
                for s_i in group:
                    rows.extend([s_i] * bo)
                rows.extend([group[0]] * (Bc - len(rows)))  # pad rows (ignored)
                idx = np.asarray(rows)
                key = jax.random.PRNGKey(int(self._rng.integers(0, 2**31)))
                out = retry_fn(self.params, suppress, mels[idx], prompt[idx],
                               prompt_len[idx], sot_index[idx],
                               jnp.asarray(temps[idx]), key)
                tokens = np.asarray(out["tokens"])
                n_sampled = np.asarray(out["n_sampled"])
                avg_lp = np.asarray(out["avg_logprob"])
                ns_prob = np.asarray(out["no_speech_prob"])
                for gi, s_i in enumerate(group):
                    cand_rows = range(gi * bo, (gi + 1) * bo)
                    best_row = max(cand_rows, key=lambda r: avg_lp[r])
                    _settle(s_i, _candidate(tokens, n_sampled, avg_lp, ns_prob,
                                            best_row, temps[s_i]), attempt)
        # anything still pending keeps its last attempt
        for b in range(B):
            if results[b] is None:
                results[b] = last_attempt[b]
        METRICS.observe("asr_decode_window_seconds", time.perf_counter() - t_start)
        return results

    def profile_trace(self, log_dir: str):
        """Context manager: capture a JAX profiler trace of everything inside
        (SURVEY.md §5: 'add per-stage latency metrics + JAX profiler traces').
        View with TensorBoard or xprof."""
        return jax.profiler.trace(log_dir)

    def detect_language(self, audio: np.ndarray) -> str:
        mel = self.compute_mel(audio[: MEL.N_SAMPLES])
        fn = self._detect_fn(1, mel.shape[1])
        lang_ids, _ = fn(self.params, mel)
        return self.tokenizer.lang_code(int(np.asarray(lang_ids)[0]))

    # --------------------------------------------------------- long-form API

    def transcribe_audio(self, audio: np.ndarray, params: AsrParams,
                         decode_window=None) -> TranscribeResult:
        """Long-form transcription: 30 s windows advanced by decoded timestamp
        boundaries (openai-style seek), with silence skipping via
        no_speech_thold (whisper.rs:167).

        decode_window(mel, language, task, suppress_non_speech) -> dict lets
        the continuous batcher route each window through the shared batched
        step instead of a private B=1 program."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        if audio.size == 0:
            return TranscribeResult(segments=[], full_text="")
        language = params.language or (
            self.detect_language(audio) if self.tokenizer.multilingual else "en")
        if decode_window is None:
            decode_window = (lambda mel, lang, task, sns, context=None,
                             speaker_diarization=False, temperature=0.0:
                             self.decode_windows(
                                 mel, lang, task=task, suppress_non_speech=sns,
                                 speaker_diarization=speaker_diarization,
                                 temperatures=([temperature] if temperature
                                               else None),
                                 context_tokens=[context] if context else None)[0])
        # probe the hook's signature ONCE instead of try/except TypeError per
        # window (which masked genuine TypeErrors inside decoding and
        # silently re-ran windows without context — round-2 review)
        import inspect

        hook_params = set(inspect.signature(decode_window).parameters)
        extra_kw = {}
        if "speaker_diarization" in hook_params:
            extra_kw["speaker_diarization"] = params.speaker_diarization
        if "temperature" in hook_params:
            extra_kw["temperature"] = params.temperature
        takes_context = "context" in hook_params

        seek = 0
        raw_segments: list[dict] = []
        context: list[int] = []
        n_tokens = 0
        while seek < audio.size:
            window = audio[seek : seek + MEL.N_SAMPLES]
            mel = self.compute_mel(window)  # pads to 3000 frames
            ctx = context if params.condition_on_previous_text else None
            if takes_context:
                res = decode_window(mel, language, params.task,
                                    params.suppress_non_speech, context=ctx,
                                    **extra_kw)
            else:  # hooks without context support
                res = decode_window(mel, language, params.task,
                                    params.suppress_non_speech, **extra_kw)
            offset = seek / SAMPLE_RATE
            window_dur = min(window.size, MEL.N_SAMPLES) / SAMPLE_RATE
            n_tokens += int(res["n_sampled"])
            if (res["no_speech_prob"] > self.config.no_speech_thold
                    and res["avg_logprob"] < self.config.logprob_thold):
                seek += MEL.N_SAMPLES  # silent window
                continue
            # context for the next window: text tokens of this one; reset
            # after high-temperature fallbacks (openai prompt_reset rule)
            if res.get("temperature", 0.0) > 0.5:
                context = []
            else:
                context = context + [int(t) for t in res["tokens"][: res["n_sampled"]]
                                     if t < self.tokenizer.eot]
                context = context[-(self.dims.n_text_ctx // 2 - 8):]
            segs, advance = D.segments_from_tokens(
                res["tokens"], res["n_sampled"], self.tokenizer, window_offset=offset)
            for s in segs:
                s["end"] = min(s["end"], offset + window_dur)
                s["start"] = min(s["start"], s["end"])
            if params.word_timestamps and segs:
                self._attach_words(segs, res, mel, language, offset, window_dur)
            raw_segments.extend(segs)
            if advance is not None and advance > 0.5:
                seek += int(advance * SAMPLE_RATE)
            else:
                seek += MEL.N_SAMPLES
        return self._postprocess(raw_segments, params, language, n_tokens=n_tokens)

    def transcribe_audio_vad(self, audio: np.ndarray, params: AsrParams,
                             decode_window=None) -> TranscribeResult:
        """VAD-segmented long-form transcription: energy VAD finds speech
        spans (audio/vad.py), only those reach the encoder, and segment
        times are shifted to absolute positions. Silence-heavy inputs decode
        several times faster and hallucinate less (SURVEY.md §7 step 9)."""
        from speaksense_tpu.audio.vad import speech_segments

        audio = np.asarray(audio, np.float32).reshape(-1)
        spans = speech_segments(audio)
        if not spans:
            return TranscribeResult(segments=[], full_text="",
                                    language=params.language)
        all_segments: list[TranscribeSegment] = []
        language = params.language
        full_text = []
        n_tokens = 0
        for start, end in spans:
            if language and params.language is None:
                # propagate the first span's detected language: later spans
                # skip re-detection (one encoder pass each) and the whole
                # file gets consistent language-dependent postprocessing
                import dataclasses

                params = dataclasses.replace(params, language=language)
            res = self.transcribe_audio(audio[start:end], params, decode_window)
            language = language or res.language
            offset = start / SAMPLE_RATE
            for s in res.segments:
                s.start += offset
                s.end += offset
                if s.words:
                    for w in s.words:
                        w["start"] += offset
                        w["end"] += offset
                all_segments.append(s)
            full_text.append(res.full_text)
            n_tokens += res.n_tokens
        return TranscribeResult(segments=all_segments, full_text="".join(full_text),
                                language=language, n_tokens=n_tokens)

    def _attach_words(self, segs: list[dict], res: dict, mel, language: str | None,
                      offset: float, window_dur: float) -> None:
        """Word-level timestamps via cross-attention DTW (models/align.py);
        words are distributed to segments by time overlap."""
        from speaksense_tpu.models.align import word_timestamps

        enc_key = ("enc_align", tuple(mel.shape))
        enc_fn = self._jit_cache.get(enc_key)
        if enc_fn is None:
            enc_fn = jax.jit(lambda p, m: W.encode(p, self.dims, m))
            self._jit_cache[enc_key] = enc_fn
        enc = enc_fn(self.params, jnp.asarray(mel))
        tokens = [int(t) for t in res["tokens"][: res["n_sampled"]]]
        words = word_timestamps(self.params, self.dims, self.tokenizer, tokens, enc,
                                language=language, audio_seconds=window_dur,
                                time_offset=offset)
        for s in segs:
            s["words"] = [w for w in words if s["start"] - 0.02 <= w["start"] < s["end"] + 0.02]

    def _postprocess(self, raw_segments: list[dict], params: AsrParams,
                     language: str | None, n_tokens: int = 0) -> TranscribeResult:
        """Reference segment pipeline (whisper.rs:75-121): promo filter,
        punctuation heuristic, stream-mode last-segment-only collapse."""
        segments: list[TranscribeSegment] = []
        speaker = 0
        prev_turn = False
        for s in raw_segments:
            if prev_turn and params.speaker_diarization:
                speaker += 1  # reference whisper.rs:95-97
            prev_turn = bool(s.get("speaker_turn_next"))
            if not s["text"].strip():
                continue
            if PP.is_promotional_text(s["text"]):
                log.debug("filtered promotional segment: %s", s["text"])
                continue
            text = PP.add_punctuation(s["text"]) if language == "zh" else s["text"]
            segments.append(TranscribeSegment(text=text, speaker_id=speaker,
                                              start=s["start"], end=s["end"],
                                              words=s.get("words")))
        segments = self._merge_short_segments(segments, params.min_segment_length)
        if params.stream_mode and segments:
            # reference keeps only the final segment in stream mode
            # (whisper.rs:107-117)
            last = segments[-1]
            return TranscribeResult(segments=[last], full_text=last.text,
                                    language=language, n_tokens=n_tokens)
        full_text = "".join(s.text for s in segments)
        return TranscribeResult(segments=segments, full_text=full_text,
                                language=language, n_tokens=n_tokens)

    @staticmethod
    def _merge_short_segments(segments: list[TranscribeSegment],
                              min_len: int) -> list[TranscribeSegment]:
        """AsrParams.min_segment_length: segments whose text is shorter than
        min_len characters are merged into the adjacent same-speaker segment
        (no text is ever dropped). The reference DECLARES this knob
        (src/asr/mod.rs:14, default 10; gRPC sets 5 at handlers/asr.rs:157)
        but never consumes it — these are the natural semantics."""
        min_len = max(0, int(min_len))
        if min_len <= 1 or len(segments) <= 1:
            return segments

        def absorb(dst: TranscribeSegment, src: TranscribeSegment) -> None:
            dst.text += src.text
            dst.end = max(dst.end, src.end)
            if dst.words is not None or src.words is not None:
                dst.words = (dst.words or []) + (src.words or [])

        merged: list[TranscribeSegment] = []
        for s in segments:
            if (merged and len(merged[-1].text.strip()) < min_len
                    and merged[-1].speaker_id == s.speaker_id):
                absorb(merged[-1], s)
            else:
                merged.append(s)
        if (len(merged) > 1 and len(merged[-1].text.strip()) < min_len
                and merged[-2].speaker_id == merged[-1].speaker_id):
            last = merged.pop()
            absorb(merged[-1], last)
        return merged

    # ----------------------------------------------------- AsrEngine surface

    def create_state(self) -> EngineState:
        return EngineState()

    def transcribe_with_state(self, state: EngineState, audio, params: AsrParams,
                              decode_window=None) -> TranscribeResult:
        with state.lock:  # reference serializes per-stream (asr/mod.rs:60)
            if log.isEnabledFor(logging.DEBUG):
                import zlib

                a = np.asarray(audio, np.float32)
                log.debug("transcribing %d samples, checksum=%08x", a.size,
                          zlib.crc32(a.tobytes()))  # reference whisper.rs:225-234
            if params.language is None and state.language:
                params = AsrParams(**{**params.__dict__, "language": state.language})
            if params.stream_mode:
                result = self._transcribe_stream_chunk(audio, params, decode_window,
                                                       state=state)
            else:
                result = self.transcribe_audio(np.asarray(audio, np.float32), params,
                                               decode_window)
            state.language = result.language or state.language
            return result

    def enable_slot_serving(self, n_slots: int | None = None,
                            t_mel: int = 512, max_new: int = 96,
                            int8_kv: bool | None = None,
                            self_int8: bool | None = None,
                            max_prompt: int = 16,
                            beam_size: int | None = None) -> None:
        """Route streaming chunks through the token-level slot pool
        (runtime/slots.py): concurrent gRPC streams then join/leave the
        decode batch at token granularity instead of window granularity.
        int8_kv defaults to the engine's cross_kv_int8 config (int8 pools
        halve the KV's device memory).

        max_prompt=16 fits plain SOT prompts; raise to e.g. 64 so pooled
        streams carry previous-text conditioning (the price is a larger
        per-slot KV page, i.e. more self-KV read per step).

        NOTE the pool is COMPILED for one mel bucket (t_mel) but serves
        every chunk size: shorter chunks ride zero-padded (tail flush),
        OVERSIZED chunks (e.g. a 20 s chunk against the default 512-frame
        pool) ride as ceil-split sub-windows admitted concurrently
        (_PendingMultiChunk). The only window-batcher fallback left is a
        SUB-bucket chunk against a pool built above the smallest bucket
        (t_mel > 512) — deliberate: the smaller window program is cheaper.

        On a sharded engine (shard() called first) the pool's pages shard
        with the params: slot rows on dp, heads on tp. The slot count is
        rounded DOWN so the pool's S+1 rows divide dp."""
        from speaksense_tpu.runtime.slots import StreamingDecodeServer

        n_slots = n_slots or self.config.stream_slots
        if self.mesh is not None:
            dp = self.mesh.shape["dp"]
            rounded = max(dp, (n_slots + 1) // dp * dp) - 1
            if rounded != n_slots:
                log.info("slot pool: %d slots -> %d so S+1 rows divide dp=%d",
                         n_slots, rounded, dp)
            n_slots = rounded
        # beam_size=None inherits the engine's --beam-size config, so a beam
        # server pools beam decoding instead of falling back to the window
        # batcher (BASELINE config 4: 64 streams, paged KV, beam=5)
        if beam_size is None:
            beam_size = self.config.beam_size or 1
        # int8 self-KV pages default ON for beam pools: the beam step reads
        # K=5 self pages per slot so page bytes dominate, and they halve
        # the pool's device memory); greedy pools stay bf16. Drift bounds:
        # tests/test_accuracy.py::test_int8_self_kv_ring_drift_quantified.
        if self_int8 is None:
            self_int8 = beam_size > 1
        self._slot_server = StreamingDecodeServer(
            self, n_slots=n_slots,
            t_mel=t_mel, max_new=max_new,
            int8_kv=self.config.cross_kv_int8 if int8_kv is None else int8_kv,
            self_int8=self_int8,
            max_prompt=max_prompt, mesh=self.mesh, beam_size=beam_size)

    @property
    def device_denoise(self) -> bool:
        """True when stream chunks can run the DSP denoise chain on device
        (inside the slot-pool admission program) — StreamSession then skips
        its host-side numpy denoise and sets AsrParams.denoise instead."""
        return getattr(self, "_slot_server", None) is not None

    def disable_slot_serving(self) -> None:
        server = getattr(self, "_slot_server", None)
        if server is not None:
            server.stop()
            self._slot_server = None

    def _pool_candidate(self, raw: dict) -> dict:
        """Host-side quality features for one pooled decode result — the
        same fields decode_windows._candidate computes on the window path
        (compression ratio, 32-token histogram entropy)."""
        n = int(raw["n_sampled"])
        text = self.tokenizer.decode(raw["tokens"][:n])
        return {**raw, "text": text,
                "compression_ratio": PP.compression_ratio(text),
                "token_entropy": PP.token_entropy(raw["tokens"][:n]),
                "temperature": float(raw.get("temperature", 0.0))}

    def _pool_quality_gate(self, raw: dict, retry) -> dict:
        """whisper's temperature-fallback ladder on a POOLED chunk (the
        reference passes entropy/logprob/no-speech thresholds + best_of into
        EVERY decode, whisper.rs:131-173; whisper.cpp applies the ladder
        inside state.full per window — here the window path had it from r2
        but pooled chunks skipped it entirely until r5).

        retry(temperature) resubmits the chunk's audio: for greedy pools it
        returns best_of concurrent pool decodes at that temperature (per-slot
        temp vector — retries stay continuous-batched with live traffic
        instead of the window path's serial ladder); for beam pools it runs
        one window-path decode (whisper.cpp's ladder switches beam -> greedy
        sampling at t>0). Candidates are judged by avg_logprob (openai
        best_of rule); a chunk that still fails at t=1.0 keeps its last
        attempt, exactly as decode_windows does."""
        cand = self._pool_candidate(raw)
        if retry is None:
            return cand
        attempt = 0
        while (needs_fallback_retry(cand, self.config)
               and cand["temperature"] < FALLBACK_TEMPS[-1]
               and attempt + 1 < len(FALLBACK_TEMPS)):
            attempt += 1
            t = FALLBACK_TEMPS[attempt]
            METRICS.inc("asr_fallback_retries_total")
            METRICS.inc("asr_pool_fallback_retries_total")
            try:
                cands = [c if "compression_ratio" in c
                         else self._pool_candidate(c) for c in retry(t)]
            except Exception as e:
                # a failed RESUBMISSION (pool reset failing registered jobs,
                # server stopping mid-retry) must not abort a chunk that
                # already holds a decoded candidate — keep-last-attempt,
                # exactly as the window ladder would
                log.warning("pool fallback retry at t=%.1f failed; keeping "
                            "last attempt: %s", t, e)
                break
            if not cands:
                break
            cand = max(cands, key=lambda c: c["avg_logprob"])
        return cand

    def _pool_retry_factory(self, server, audio, language, task, context,
                            denoise):
        """Build the retry(temperature) closure for one pooled chunk (see
        _pool_quality_gate). audio is the chunk's submit-time array (s16 or
        f32) — kept alive only while the chunk is in flight."""
        best_of = max(1, int(self.config.best_of))
        if getattr(server.pool, "K", 1) > 1:
            # beam pool: t>0 retries switch to greedy sampling on the window
            # path (whisper.cpp SamplingStrategy fallback, whisper.rs:132-141)
            # — decode_windows runs the remaining ladder + best_of itself,
            # so one call settles the chunk
            def retry(temp: float) -> list[dict]:
                a = (audio.astype(np.float32) / 32767.0
                     if audio.dtype == np.int16 else audio)
                if denoise:
                    from speaksense_tpu.audio.dsp import (
                        DenoiseConfig, denoise_audio,
                    )

                    a = denoise_audio(a, DenoiseConfig(post_gain=1.0))
                mel = self.compute_mel(a, pad_to=server.pool.t_mel)
                res = self.decode_windows(
                    mel, language, task=task,
                    max_new_tokens=server.pool.max_new,
                    temperatures=[temp],
                    context_tokens=[context] if context else None,
                    beam_size=1)
                return [res[0]]

            return retry

        def retry(temp: float) -> list[dict]:
            futs = [server.submit_audio(audio, language=language, task=task,
                                        context=context, denoise=denoise,
                                        temperature=temp)
                    for _ in range(best_of)]
            return [f.result() for f in futs]

        return retry

    def _silence_suppressed(self, raw: dict) -> bool:
        """The no-speech gate shared by EVERY stream path (whisper.rs:167;
        openai seek-loop rule): no_speech_prob over threshold AND poor avg
        logprob — whisper's classic silence-hallucination suppression.
        Meters asr_no_speech_suppressed_total when it trips."""
        if (float(raw.get("no_speech_prob", 0.0)) > self.config.no_speech_thold
                and float(raw.get("avg_logprob", 0.0)) < self.config.logprob_thold):
            METRICS.inc("asr_no_speech_suppressed_total")
            return True
        return False

    def _update_stream_context(self, state: EngineState | None,
                               text_toks: list[int], hot: bool) -> None:
        """Conditioning-context bookkeeping for stream chunks. hot=True
        (any window decoded at temperature > 0.5) RESETS the context — the
        openai prompt_reset rule the seek loop applies at engine.py:628:
        hot-retry text is likely degraded and must not condition the next
        chunk (it would feed the hallucination loop conditioning exists to
        dampen)."""
        if state is None:
            return
        if hot:
            state.context_tokens = []
            return
        server = getattr(self, "_slot_server", None)
        cap = server.pool.max_prompt if server is not None else 16
        state.context_tokens = (state.context_tokens + text_toks)[-cap:]

    def _finish_slot_chunk(self, raw: dict, n_samples: int, params: AsrParams,
                           language: str | None,
                           state: EngineState | None) -> TranscribeResult:
        """Host postprocess for one slot-pool stream chunk: token->segment
        conversion, window clamping, conditioning-context bookkeeping, and
        the reference segment pipeline (_postprocess)."""
        if self._silence_suppressed(raw):
            return TranscribeResult(segments=[], full_text="",
                                    language=language,
                                    n_tokens=int(raw["n_sampled"]))
        window_dur = n_samples / SAMPLE_RATE
        segs, _ = D.segments_from_tokens(raw["tokens"], raw["n_sampled"], self.tokenizer)
        for s in segs:
            s["end"] = min(s["end"], window_dur)
            s["start"] = min(s["start"], s["end"])
        text_toks = [int(t) for t in raw["tokens"][: raw["n_sampled"]]
                     if t < self.tokenizer.eot]
        self._update_stream_context(
            state, text_toks, hot=float(raw.get("temperature", 0.0)) > 0.5)
        return self._postprocess(segs, params, language,
                                 n_tokens=int(raw["n_sampled"]))

    def _finish_slot_chunk_multi(self, raws: list[dict], piece_samples: int,
                                 n_samples: int, params: AsrParams,
                                 language: str | None,
                                 state: EngineState | None) -> TranscribeResult:
        """Host postprocess for one OVERSIZED stream chunk decoded as
        several pool-bucket sub-windows (see _PendingMultiChunk): per-piece
        token->segment conversion clamped to the piece's true duration,
        offset onto the chunk's absolute timeline, then ONE reference
        segment pipeline (_postprocess) over the merged list — the result
        is indistinguishable in shape from a single-window decode."""
        segs_all: list[dict] = []
        text_toks: list[int] = []
        n_tokens = 0
        hot = any(float(r.get("temperature", 0.0)) > 0.5 for r in raws)
        for i, raw in enumerate(raws):
            if self._silence_suppressed(raw):
                # silent sub-window: suppress its text (see _finish_slot_chunk)
                n_tokens += int(raw["n_sampled"])
                continue
            off = i * piece_samples / SAMPLE_RATE
            dur = min(piece_samples, n_samples - i * piece_samples) / SAMPLE_RATE
            segs, _ = D.segments_from_tokens(raw["tokens"], raw["n_sampled"],
                                             self.tokenizer)
            for s in segs:
                s["end"] = min(s["end"], dur) + off
                s["start"] = min(s["start"], s["end"] - off) + off
            segs_all.extend(segs)
            n_tokens += int(raw["n_sampled"])
            text_toks.extend(int(t) for t in raw["tokens"][: raw["n_sampled"]]
                             if t < self.tokenizer.eot)
        self._update_stream_context(state, text_toks, hot=hot)
        return self._postprocess(segs_all, params, language, n_tokens=n_tokens)

    def submit_stream_chunk(self, state: EngineState | None, audio,
                            params: AsrParams, pad_to_bucket: bool = False):
        """Nonblocking stream-chunk submission for SESSION-LEVEL PIPELINING.

        When chunks are independent (no previous-text conditioning reaches
        the pool's admission prompt), a backlogged stream may keep several
        chunks decoding concurrently; the transport settles them in order
        (serving/stream.StreamSession.ingest/settle), so slots stay busy
        during the host postprocess + transport turnaround instead of
        idling for it once per chunk. Returns a handle with
        .settle() -> TranscribeResult, or None when the chunk must take the
        sequential transcribe_with_state path (no slot pool, a sub-bucket
        chunk without pad_to_bucket, or the conditioned-pipelining bound
        reached — chunk k+1's prompt then depends on chunk k's output).
        Oversized chunks are served as concurrent pool sub-windows
        (_PendingMultiChunk), never declined."""
        if not params.stream_mode:
            return None
        server = getattr(self, "_slot_server", None)
        if server is None:
            return None
        # s16 PCM passes through UNSCALED (wire-dtype admission: half the
        # host->device bytes; the admit program dequantizes on device);
        # anything else normalizes to f32
        audio = np.asarray(audio).reshape(-1)
        if audio.dtype != np.int16:
            audio = audio.astype(np.float32, copy=False)
        n_frames = max(1, audio.size // MEL.HOP_LENGTH)
        bucket = self._mel_bucket(n_frames)
        # OVERSIZED chunks (bucket > pool bucket, e.g. a 20 s chunk against
        # the default 512-frame pool) ride the pool as ceil-split sub-windows
        # admitted concurrently (_PendingMultiChunk) — no window-batcher
        # fallback, and the token budget scales with chunk length.
        oversized = bucket > server.pool.t_mel
        if bucket != server.pool.t_mel and not oversized:
            # pad_to_bucket: a SHORT chunk (e.g. the end-of-stream tail
            # flush) rides the pool zero-padded to its bucket — during a
            # drain the marginal decode is nearly free, vs a separate
            # window-batcher program dispatch.
            if not pad_to_bucket:
                return None
        context = None
        conditioned = False
        if (state is not None and params.condition_on_previous_text
                and server.pool.max_prompt > 16):
            # BOUNDED conditioned pipelining (VERDICT r2 item 8): the
            # admission prompt carries a SNAPSHOT of the stream's context at
            # submit time, so conditioning no longer disables pipelining.
            # With up to 2 chunks of one stream in flight, chunk k+1's
            # prompt can lag chunk k's text by ONE chunk — a documented,
            # parity-tested divergence from strictly sequential conditioning
            # (identical whenever the stream isn't backlogged: settle k
            # completes before submit k+1, so the snapshot is current).
            # Past the bound the chunk falls back to the sequential path,
            # which settles in order and reads fully-updated context.
            with state.lock:
                if state.inflight_conditioned >= 2:
                    return None
                state.inflight_conditioned += 1
                context = list(state.context_tokens) or None
            conditioned = True
        language = params.language or (state.language if state else None) or "en"

        def mk_retry(a):
            return self._pool_retry_factory(server, a, language, params.task,
                                            context, params.denoise)

        try:
            if oversized:
                piece = server.pool.t_mel * MEL.HOP_LENGTH
                futs = [server.submit_audio(audio[i:i + piece],
                                            language=language, task=params.task,
                                            context=context,
                                            denoise=params.denoise)
                        for i in range(0, audio.size, piece)]
                retries = [mk_retry(audio[i:i + piece])
                           for i in range(0, audio.size, piece)]
            else:
                fut = server.submit_audio(audio, language=language,
                                          task=params.task,
                                          context=context,
                                          denoise=params.denoise)
        except Exception:
            if conditioned:
                with state.lock:
                    state.inflight_conditioned -= 1
            raise
        if oversized:
            return _PendingMultiChunk(self, state, futs, piece, audio.size,
                                      params, language, conditioned=conditioned,
                                      retries=retries)
        return _PendingChunk(self, state, fut, audio.size, params, language,
                             conditioned=conditioned, retry=mk_retry(audio))

    def _transcribe_stream_chunk(self, audio, params: AsrParams,
                                 decode_window=None,
                                 state: EngineState | None = None) -> TranscribeResult:
        """Streaming chunk (~5 s): truncated-encoder bucket, no seek loop."""
        audio = np.asarray(audio, np.float32).reshape(-1)
        n_frames = max(1, audio.size // MEL.HOP_LENGTH)
        bucket = self._mel_bucket(n_frames)
        language = params.language or "en"
        # slot serving takes precedence over the window batcher for stream
        # chunks: token-granularity admission beats window coalescing when
        # many streams are mid-decode
        server = getattr(self, "_slot_server", None)
        if server is not None and bucket > server.pool.t_mel:
            # OVERSIZED chunk: ride the pool as ceil-split pool-bucket
            # sub-windows (same policy as submit_stream_chunk), settled
            # synchronously here — the ordered sequential path reads fully
            # current conditioning context
            context = None
            if (state is not None and params.condition_on_previous_text
                    and server.pool.max_prompt > 16):
                context = list(state.context_tokens) or None
            piece = server.pool.t_mel * MEL.HOP_LENGTH
            futs = [server.submit_audio(audio[i:i + piece], language=language,
                                        task=params.task, context=context,
                                        denoise=params.denoise)
                    for i in range(0, audio.size, piece)]
            raws = [self._pool_quality_gate(
                        f.result(),
                        self._pool_retry_factory(server, audio[i:i + piece],
                                                 language, params.task,
                                                 context, params.denoise))
                    for i, f in zip(range(0, audio.size, piece), futs)]
            return self._finish_slot_chunk_multi(raws, piece, audio.size,
                                                 params, language, state)
        if server is not None and bucket != server.pool.t_mel:
            # documented fallback (see enable_slot_serving): a SUB-bucket
            # chunk on a pool built above the smallest bucket decodes
            # through the (smaller, cheaper) window-batcher program instead
            METRICS.inc("asr_slot_bucket_fallbacks_total")
            log.debug("stream chunk bucket %d != pool bucket %d; window path",
                      bucket, server.pool.t_mel)
        if server is not None and bucket == server.pool.t_mel:
            # previous-text conditioning rides the admission prompt when the
            # pool was built with max_prompt > the SOT length (VERDICT r1
            # item 9); 16-token pools send no context
            context = None
            if (state is not None and params.condition_on_previous_text
                    and server.pool.max_prompt > 16):
                context = list(state.context_tokens) or None
            # raw audio in, mel (and denoise when requested) fused into the
            # admission program — no separate dispatches, no device<->host
            # round trips
            raw = server.submit_audio(audio, language=language,
                                      task=params.task, context=context,
                                      denoise=params.denoise).result()
            raw = self._pool_quality_gate(
                raw, self._pool_retry_factory(server, audio, language,
                                              params.task, context,
                                              params.denoise))
            return self._finish_slot_chunk(raw, audio.size, params, language, state)
        if params.denoise:
            # off-bucket fallback: the pool would have denoised on device;
            # honor the request host-side on the window path
            from speaksense_tpu.audio.dsp import DenoiseConfig, denoise_audio

            audio = denoise_audio(audio, DenoiseConfig(post_gain=1.0))
        mel = self.compute_mel(audio, pad_to=bucket)
        if decode_window is None:
            decode_window = (lambda mel, lang, task, sns,
                             speaker_diarization=False, temperature=0.0:
                             self.decode_windows(
                                 mel, lang, task=task, suppress_non_speech=sns,
                                 speaker_diarization=speaker_diarization,
                                 temperatures=([temperature] if temperature
                                               else None),
                                 max_new_tokens=96)[0])
        import inspect

        hook_params = set(inspect.signature(decode_window).parameters)
        kw = {}
        if "speaker_diarization" in hook_params:
            kw["speaker_diarization"] = params.speaker_diarization
        if "temperature" in hook_params:
            kw["temperature"] = params.temperature
        res = decode_window(mel, language, params.task,
                            params.suppress_non_speech, **kw)
        # streaming no-speech gate on the WINDOW path too (VERDICT r4
        # missing #2: the probability was computed and then ignored here —
        # only the batch seek loop consumed it; reference sets the threshold
        # for stream calls as well, whisper.rs:167)
        if self._silence_suppressed(res):
            return TranscribeResult(segments=[], full_text="",
                                    language=language,
                                    n_tokens=int(res["n_sampled"]))
        window_dur = audio.size / SAMPLE_RATE
        segs, _ = D.segments_from_tokens(res["tokens"], res["n_sampled"], self.tokenizer)
        for s in segs:
            s["end"] = min(s["end"], window_dur)
            s["start"] = min(s["start"], s["end"])
        return self._postprocess(segs, params, language,
                                 n_tokens=int(res["n_sampled"]))
