"""Batched autoregressive decoding with Whisper's timestamp-rule state machine.

Replaces whisper.cpp's sampling loop (the reference configures it via
FullParams — greedy best_of=5, temperature 0, entropy/logprob/no-speech
thresholds, timestamp token probabilities — /root/reference/src/asr/whisper.rs:131-173).

Device-resident formulation: the whole loop is one `lax.while_loop` inside jit —
every step samples for ALL batch slots (finished slots freeze on EOT), all
logit rules are vectorized mask arithmetic, and there is no host round-trip
until the window finishes. The rule set mirrors openai/whisper's logit
filters:

  * SuppressBlank (space + EOT at the first sampled position)
  * SuppressTokens (non-speech set + control specials)
  * timestamp pairing (a lone timestamp must be followed by text or EOT; a
    closed pair must be followed by text), monotonicity, max_initial_ts,
  * and the "timestamp probability sum beats max text prob" forcing rule.

Temperature > 0 uses Gumbel-max sampling; the temperature-fallback retry
policy (whisper.cpp's entropy/logprob tholds) lives host-side in
asr/engine.py because it is per-window control flow.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from speaksense_tpu.models import whisper as W
from speaksense_tpu.models.tokenizer import Tokenizer, TS_RESOLUTION

NEG_INF = -1e30


@dataclass(frozen=True)
class RuleConfig:
    """Static decode configuration (baked into the jitted program)."""

    eot: int
    ts_begin: int
    no_timestamps: int
    no_speech: int
    blank: int
    max_initial_ts_tok: int      # highest allowed first timestamp id (inclusive)
    with_timestamps: bool = True
    max_new_tokens: int = 224

    @classmethod
    def from_tokenizer(cls, tok: Tokenizer, with_timestamps: bool = True,
                       max_initial_ts: float = 1.0, max_new_tokens: int = 224) -> "RuleConfig":
        blank = tok.blank_token()
        return cls(
            eot=tok.eot, ts_begin=tok.ts_begin, no_timestamps=tok.no_timestamps,
            no_speech=tok.no_speech,
            blank=blank if blank is not None else tok.eot,
            max_initial_ts_tok=tok.ts_begin + int(round(max_initial_ts / TS_RESOLUTION)),
            with_timestamps=with_timestamps, max_new_tokens=max_new_tokens,
        )


def apply_logit_rules(logits: jax.Array, cfg: RuleConfig, suppress_mask: jax.Array,
                      n_sampled: jax.Array, last: jax.Array, penult: jax.Array,
                      last_ts: jax.Array) -> jax.Array:
    """Vectorized whisper logit rules. logits (B, V) f32; per-slot state:
    n_sampled (B,), last/penult sampled tokens (B,), last_ts (B,) (0 = none).
    Returns filtered logits."""
    B, V = logits.shape
    vocab_ids = jnp.arange(V)[None, :]
    is_ts_col = vocab_ids >= cfg.ts_begin
    is_text_col = vocab_ids < cfg.eot

    logits = jnp.where(suppress_mask[None, :], NEG_INF, logits)

    first = (n_sampled == 0)[:, None]
    # SuppressBlank at the first sampled position
    blank_cols = (vocab_ids == cfg.blank) | (vocab_ids == cfg.eot)
    logits = jnp.where(first & blank_cols, NEG_INF, logits)

    if not cfg.with_timestamps:
        # timestamps and the notimestamps marker are both off-limits
        logits = jnp.where(is_ts_col | (vocab_ids == cfg.no_timestamps), NEG_INF, logits)
        return logits

    logits = jnp.where(vocab_ids == cfg.no_timestamps, NEG_INF, logits)

    last_was_ts = (n_sampled >= 1) & (last >= cfg.ts_begin)
    penult_was_ts = (n_sampled < 2) | (penult >= cfg.ts_begin)
    # lone timestamp -> must sample timestamp or EOT (no text);
    # closed pair -> must sample text (no timestamp)
    mask_ts = (last_was_ts & penult_was_ts)[:, None] & is_ts_col
    mask_text = (last_was_ts & ~penult_was_ts)[:, None] & is_text_col
    logits = jnp.where(mask_ts | mask_text, NEG_INF, logits)

    # monotonic timestamps: forbid ts below the last sampled one
    have_ts = last_ts > 0
    thresh = jnp.where(last_was_ts & ~penult_was_ts, last_ts, last_ts + 1)
    mono = have_ts[:, None] & is_ts_col & (vocab_ids < thresh[:, None])
    logits = jnp.where(mono, NEG_INF, logits)

    # first sampled token must be a timestamp, capped by max_initial_ts
    logits = jnp.where(first & ~is_ts_col, NEG_INF, logits)
    logits = jnp.where(first & (vocab_ids > cfg.max_initial_ts_tok), NEG_INF, logits)

    # if total timestamp probability beats the best text token, force a timestamp
    logprobs = jax.nn.log_softmax(logits, axis=-1)
    ts_logprob = jax.nn.logsumexp(jnp.where(is_ts_col, logprobs, NEG_INF), axis=-1)
    max_text = jnp.max(jnp.where(is_ts_col, NEG_INF, logprobs), axis=-1)
    force_ts = (ts_logprob > max_text)[:, None] & is_text_col  # EOT stays legal
    logits = jnp.where(force_ts, NEG_INF, logits)
    return logits


def _sample(logits: jax.Array, temperature: jax.Array, key: jax.Array) -> jax.Array:
    """Greedy at t==0, Gumbel-max otherwise — one branchless formulation.
    temperature is per-slot (B,) so a fallback retry re-decodes only the slots
    that tripped the quality thresholds at a higher temperature while the rest
    stay greedy (whisper.cpp retries whole windows serially instead)."""
    gumbel = -jnp.log(-jnp.log(jax.random.uniform(key, logits.shape, minval=1e-20, maxval=1.0)))
    t = jnp.maximum(jnp.broadcast_to(temperature, logits.shape[:1]), 0.0)[:, None]
    noisy = jnp.where(t > 0, logits / jnp.maximum(t, 1e-6) + gumbel, logits)
    return jnp.argmax(noisy, axis=-1).astype(jnp.int32)


def decode_loop(params, dims: W.WhisperDims, cfg: RuleConfig, suppress_mask: jax.Array,
                first_logits: jax.Array, cache: dict, temperature: jax.Array,
                key: jax.Array, uniform_pos: bool = False, kv_write: str = "dus",
                ring_width: int = 16):
    """Run the sampling loop from the post-prompt logits until every slot
    emits EOT (or max_new_tokens). Returns dict of
      tokens (B, max_new) — sampled tokens, EOT-padded,
      n_sampled (B,) — count of real tokens (excluding EOT),
      sum_logprob (B,) — sum of sampled-token logprobs (including EOT).

    kv_write="ring" (requires an arm_uniform_fill'd cache) decodes in chunks
    of ring_width steps: self-KV writes go to a small ring and fold into the
    big cache once per chunk — ANY per-step write to the big cache costs a
    full cache copy (see whisper.init_ring). Early exit then
    happens at chunk granularity (finished slots just idle frozen).
    """
    B = first_logits.shape[0]
    L = cfg.max_new_tokens

    state = dict(
        step=jnp.array(0, jnp.int32),
        logits=first_logits,
        cache=cache,
        tokens=jnp.full((B, L), cfg.eot, jnp.int32),
        n_sampled=jnp.zeros((B,), jnp.int32),
        last=jnp.zeros((B,), jnp.int32),
        penult=jnp.zeros((B,), jnp.int32),
        last_ts=jnp.zeros((B,), jnp.int32),
        finished=jnp.zeros((B,), bool),
        sum_lp=jnp.zeros((B,), jnp.float32),
        key=key,
    )
    use_ring = kv_write == "ring"
    if use_ring:
        assert "fill" in cache, "ring decode needs an arm_uniform_fill'd cache"
        width = ring_width
        while L % width:  # chunks must tile max_new exactly
            width //= 2
        # int8 circular pages keep a FULL-PRECISION ring: rows quantize once
        # per flush (W.flush_ring), not per step
        ring_dtype = (params["decoder"]["tok_emb"].dtype
                      if cache["self_k"].dtype == jnp.int8
                      else cache["self_k"].dtype)
        state["ring"] = W.init_ring(dims, B, width, dtype=ring_dtype)

    def cond(s):
        return (s["step"] < L) & ~jnp.all(s["finished"])

    def body(s):
        filtered = apply_logit_rules(s["logits"], cfg, suppress_mask,
                                     s["n_sampled"], s["last"], s["penult"], s["last_ts"])
        key, sub = jax.random.split(s["key"])
        tok = _sample(filtered, temperature, sub)
        tok = jnp.where(s["finished"], cfg.eot, tok)
        lp = jax.nn.log_softmax(filtered, axis=-1)
        tok_lp = jnp.take_along_axis(lp, tok[:, None], axis=-1)[:, 0]
        newly_done = ~s["finished"] & (tok == cfg.eot)
        active = ~s["finished"]

        tokens = s["tokens"].at[:, s["step"]].set(tok)
        is_ts = tok >= cfg.ts_begin
        upd = active & ~newly_done

        # next-step logits (runs for all slots; finished slots are ignored)
        if use_ring:
            logits, cache, ring = W.decode_step_ring(params, dims, tok,
                                                     s["cache"], s["ring"])
            extra = {"ring": ring}
        else:
            logits, cache = W.decode_step(params, dims, tok, s["cache"],
                                          uniform_pos=uniform_pos, kv_write=kv_write)
            extra = {}

        return dict(
            step=s["step"] + 1,
            logits=logits,
            cache=cache,
            tokens=tokens,
            n_sampled=s["n_sampled"] + upd.astype(jnp.int32),
            last=jnp.where(upd, tok, s["last"]),
            penult=jnp.where(upd, s["last"], s["penult"]),
            last_ts=jnp.where(upd & is_ts, tok, s["last_ts"]),
            finished=s["finished"] | newly_done,
            sum_lp=s["sum_lp"] + jnp.where(active, tok_lp, 0.0),
            key=key,
            **extra,
        )

    if use_ring:
        def chunk_body(s):
            s, _ = jax.lax.scan(lambda c, _: (body(c), ()), s, None, length=width)
            cache2, ring2 = W.flush_ring(s["cache"], s["ring"])
            return {**s, "cache": cache2, "ring": ring2}

        out = jax.lax.while_loop(cond, chunk_body, state)
    else:
        out = jax.lax.while_loop(cond, body, state)
    return dict(tokens=out["tokens"], n_sampled=out["n_sampled"], sum_logprob=out["sum_lp"])


def transcribe_window(params, dims: W.WhisperDims, cfg: RuleConfig, suppress_mask: jax.Array,
                      mel: jax.Array, prompt: jax.Array, temperature: jax.Array,
                      key: jax.Array, sot_index: int | jax.Array = 0,
                      n_audio_ctx: int | None = None,
                      prompt_len: jax.Array | None = None,
                      cross_kv_int8: bool = False,
                      self_kv_int8: bool = False,
                      kv_write: str = "ring"):
    """Encode one batch of 30 s windows and decode them to tokens.

    mel (B, T_mel, n_mels); prompt (B, P) int32. Variable-length prompts
    (context conditioning via <|startofprev|> prefixes) are RIGHT-padded:
    prompt_len (B,) marks each row's true length; padded KV writes beyond
    prompt_len are invisible (the causal mask only admits keys <= pos, and
    generation overwrites them in order). sot_index (B,) locates <|sot|>
    per row for the no-speech probability.

    Returns decode_loop outputs + avg_logprob (B,), no_speech_prob (B,).
    """
    B, P = prompt.shape
    if self_kv_int8 and kv_write == "uniform":
        # plain uniform-DUS writes into int8 pages would need a per-step
        # quantize (the write-time path that measured speed-neutral); only
        # "ring" (flush-time quantization) and "dus" support
        # int8 pages
        kv_write = "dus"
    enc = W.encode(params, dims, mel, n_ctx_out=n_audio_ctx)
    # Cap the self-KV time axis at the window's actual token budget (prompt +
    # max_new, rounded up to 128): every decode step reads the FULL static T
    # axis, so a 448-position cache spends ~43% of its self-KV bandwidth on
    # positions this window can never write (prompt 3 + 224 new -> 256).
    t_cap = min(dims.n_text_ctx, -(-(P + cfg.max_new_tokens) // 128) * 128)
    # fill-layout packs generated KV at [P, P + step): the whole budget must
    # fit the cache axis or the flush DUS would clamp and corrupt earlier
    # columns (ADVICE r1)
    assert P + cfg.max_new_tokens <= t_cap, (P, cfg.max_new_tokens, t_cap)
    cache = W.init_cache(dims, mel.shape[0], enc.shape[1],
                         dtype=params["decoder"]["tok_emb"].dtype,
                         self_kv_int8=self_kv_int8, t_text=t_cap)
    if cross_kv_int8:
        # per-channel int8 cross-KV: halves the dominant decode-time
        # device-memory traffic; scales fold exactly into q / output.
        # Quantized inside the per-layer map — no bf16 round trip through
        # device memory.
        kq, vq, ks, vs = W.compute_cross_kv(params, dims, enc, int8=True)
        cache = {**cache, "cross_k": kq, "cross_v": vq,
                 "cross_k_scale": ks, "cross_v_scale": vs}
    else:
        ck, cv = W.compute_cross_kv(params, dims, enc, dtype=cache["cross_k"].dtype)
        cache = {**cache, "cross_k": ck, "cross_v": cv}

    # NOTE: uniform_pos (batchwide-DUS KV writes) stays OFF here even though
    # window batches qualify: XLA's layout assignment was seen to react to
    # the batchwide time-offset DUS by flipping the self-KV cache to a
    # Dh-minor layout and double-buffering it, which ran the B=32 large-v3
    # window batch out of device memory. Not yet re-measured on the GPU.
    uniform = False
    prefill_logits, cache = W.decode_prefill(params, dims, prompt, cache,
                                             prompt_len=prompt_len,
                                             uniform_pos=uniform)
    rows = jnp.arange(B)
    sot_idx = jnp.broadcast_to(jnp.asarray(sot_index, jnp.int32), (B,))
    sot_logits = prefill_logits[rows, sot_idx].astype(jnp.float32)
    no_speech_prob = jax.nn.softmax(sot_logits, axis=-1)[:, cfg.no_speech]

    last_idx = (jnp.broadcast_to(jnp.asarray(P if prompt_len is None else prompt_len),
                                 (B,)) - 1).astype(jnp.int32)
    first_logits = prefill_logits[rows, last_idx]
    if kv_write in ("uniform", "ring"):
        # fill-layout decode: generated KV packs at [P, P + step) (see
        # W.arm_uniform_fill; "ring" additionally buffers writes in a small
        # chunk-local ring — decode_loop)
        cache = W.arm_uniform_fill(cache, P)
    out = decode_loop(params, dims, cfg, suppress_mask, first_logits, cache,
                      temperature, key, uniform_pos=uniform, kv_write=kv_write)
    denom = (out["n_sampled"] + 1).astype(jnp.float32)
    out["avg_logprob"] = out["sum_logprob"] / denom
    out["no_speech_prob"] = no_speech_prob
    return out


def detect_language(params, dims: W.WhisperDims, enc_out: jax.Array, tok: Tokenizer):
    """Single forward pass from [sot]: probability mass over language tokens
    (openai detect_language; whisper.cpp's auto-language mode)."""
    B = enc_out.shape[0]
    cache = W.init_cache(dims, B, enc_out.shape[1], dtype=params["decoder"]["tok_emb"].dtype)
    ck, cv = W.compute_cross_kv(params, dims, enc_out, dtype=cache["cross_k"].dtype)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    sot = jnp.full((B, 1), tok.sot, jnp.int32)
    logits, _ = W.decode_prefill(params, dims, sot, cache)
    logits = logits[:, 0].astype(jnp.float32)
    mask = np.full((tok.n_vocab,), True)
    mask[tok.lang_base : tok.lang_base + tok.num_languages] = False
    logits = jnp.where(jnp.asarray(mask)[None, :], NEG_INF, logits)
    probs = jax.nn.softmax(logits, axis=-1)
    lang_ids = jnp.argmax(probs, axis=-1)
    return lang_ids, probs


def segments_from_tokens(tokens: np.ndarray, n_sampled: int, tok: Tokenizer,
                         window_offset: float = 0.0):
    """Host-side: split one slot's sampled tokens into timestamped segments.

    Returns (segments, seek_advance_seconds) where each segment is
    {"start","end","text","tokens"}; seconds are relative to the window start
    plus `window_offset`. Mirrors openai's long-form stitching: a trailing
    lone timestamp marks where the next window should seek to; otherwise the
    whole 30 s window is consumed.
    """
    ids = [int(t) for t in tokens[:n_sampled]]
    segments = []
    seek_advance = None

    # indices of the SECOND token of each consecutive-timestamp pair
    consecutive = [i for i in range(1, len(ids)) if tok.is_timestamp(ids[i]) and tok.is_timestamp(ids[i - 1])]
    if consecutive:
        # openai transcribe.py long-form stitching semantics:
        # - window ends with ONE closing timestamp (preceded by text):
        #   the final open slice is a complete segment; the whole window is
        #   consumed (seek_advance None -> caller advances 30 s);
        # - otherwise (truncated mid-segment, or trailing lone/pair
        #   timestamps): emit only the COMPLETE slices, DISCARD any open
        #   tail text, and seek to the pair-closing timestamp
        #   ids[last_slice - 1] so that audio is re-decoded next window
        #   (the old code emitted the open tail with a +30 s end and sought
        #   past it — skipping up to 30 s of audio; round-2 review).
        single_ts_ending = (len(ids) >= 2 and tok.is_timestamp(ids[-1])
                            and not tok.is_timestamp(ids[-2]))
        slices = consecutive + ([len(ids)] if single_ts_ending else [])
        last_slice = 0
        for i in slices:
            segments.append(_make_segment(ids[last_slice:i], tok, window_offset))
            last_slice = i
        if single_ts_ending:
            seek_advance = None             # consumed the whole window
        else:
            seek_advance = tok.timestamp_seconds(ids[last_slice - 1])
    else:
        seg = _make_segment(ids, tok, window_offset)
        if seg["tokens"]:
            segments.append(seg)
        ts = [t for t in ids if tok.is_timestamp(t)]
        if len(ts) >= 2:
            seek_advance = tok.timestamp_seconds(ts[-1])
    segments = [s for s in segments if s["tokens"]]
    return segments, seek_advance


def _make_segment(ids: list[int], tok: Tokenizer, offset: float) -> dict:
    ts = [t for t in ids if tok.is_timestamp(t)]
    text_ids = [t for t in ids if t < tok.eot]
    start = tok.timestamp_seconds(ts[0]) if ts else 0.0
    end = tok.timestamp_seconds(ts[-1]) if len(ts) >= 2 else (start + 30.0 if ts else 30.0)
    turn = tok.speaker_turn_token()
    return {
        "start": offset + start,
        "end": offset + end,
        "text": tok.decode(text_ids),
        "tokens": text_ids,
        # tinydiarize: a segment containing the turn marker flags that the
        # NEXT segment has a new speaker (whisper.cpp's speaker_turn_next,
        # consumed by the reference at whisper.rs:95-97)
        "speaker_turn_next": turn is not None and turn in ids,
    }
