"""Decode-loop tests: logit-rule state machine, termination, segmentation."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from speaksense_tpu.models import whisper as W
from speaksense_tpu.models import decode as D
from speaksense_tpu.models.tokenizer import Tokenizer

TOK = Tokenizer.synthetic(51865)
CFG = D.RuleConfig.from_tokenizer(TOK, max_new_tokens=32)
SUPPRESS = jnp.asarray(TOK.suppress_mask())


def _apply(logits, n_sampled, last, penult, last_ts):
    out = D.apply_logit_rules(
        jnp.asarray(logits, jnp.float32), CFG, SUPPRESS,
        jnp.asarray(n_sampled, jnp.int32), jnp.asarray(last, jnp.int32),
        jnp.asarray(penult, jnp.int32), jnp.asarray(last_ts, jnp.int32))
    return np.asarray(out)


def test_first_token_must_be_initial_timestamp():
    logits = np.zeros((1, TOK.n_vocab), np.float32)
    out = _apply(logits, [0], [0], [0], [0])
    # all text tokens and EOT masked
    assert (out[0, : TOK.ts_begin] <= D.NEG_INF).all()
    # timestamps within max_initial_ts (1.0 s => ts_begin+50) allowed
    assert out[0, TOK.ts_begin] == 0.0
    assert out[0, TOK.ts_begin + 50] == 0.0
    assert out[0, TOK.ts_begin + 51] <= D.NEG_INF


def test_initial_timestamp_then_text_expected():
    logits = np.zeros((1, TOK.n_vocab), np.float32)
    ts = TOK.ts_begin + 10
    # one sampled token (the segment-start timestamp): openai treats len<2 as
    # "penultimate was timestamp" -> timestamps masked, text expected
    out = _apply(logits, [1], [ts], [0], [ts])
    assert (out[0, TOK.ts_begin :] <= D.NEG_INF).all()
    assert out[0, 123] == 0.0


def test_end_timestamp_after_text_forbids_text():
    logits = np.zeros((1, TOK.n_vocab), np.float32)
    ts = TOK.ts_begin + 10
    # [.., text, ts]: segment-end timestamp -> must pair-close with another
    # timestamp (>= same value) or EOT; text masked
    out = _apply(logits, [3], [ts], [123], [ts])
    assert (out[0, : TOK.eot] <= D.NEG_INF).all()
    assert out[0, TOK.eot] == 0.0
    assert out[0, ts] == 0.0            # same ts allowed (pair close)
    assert out[0, ts - 1] <= D.NEG_INF  # monotonicity


def test_closed_pair_forbids_timestamp():
    logits = np.zeros((1, TOK.n_vocab), np.float32)
    ts = TOK.ts_begin + 10
    # last two sampled are both timestamps -> closed pair -> text expected
    out = _apply(logits, [4], [ts], [ts], [ts])
    assert (out[0, TOK.ts_begin :] <= D.NEG_INF).all()
    assert out[0, 123] == 0.0  # text fine


def test_text_then_needs_nothing_special():
    logits = np.zeros((1, TOK.n_vocab), np.float32)
    # peaked text distribution so the ts-sum forcing rule doesn't trigger
    # (on uniform logits, 1500 timestamps' summed mass beats any text token)
    logits[0, 124] = 10.0
    ts = TOK.ts_begin + 10
    # ... ts, text: both text and ts >= last+1 allowed
    out = _apply(logits, [2], [123], [ts], [ts])
    assert out[0, 124] == 10.0
    assert out[0, ts + 1] == 0.0
    assert out[0, ts] <= D.NEG_INF  # strictly increasing after pair+text


def test_timestamp_sum_forcing():
    logits = np.zeros((1, TOK.n_vocab), np.float32)
    # make every timestamp slightly attractive: their mass sum exceeds max text
    logits[0, TOK.ts_begin :] = 2.0
    out = _apply(logits, [2], [123], [TOK.ts_begin + 1], [TOK.ts_begin + 1])
    # text masked; EOT remains legal (openai masks [:eot], exclusive)
    assert (out[0, : TOK.eot] <= D.NEG_INF).all()
    assert out[0, TOK.eot] == 0.0


@pytest.fixture(scope="module")
def tiny_model():
    dims = W.WhisperDims(
        n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
        n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
        n_text_head=4, n_text_layer=2)
    params = W.init_params(dims, jax.random.PRNGKey(1))
    return params, dims


def test_transcribe_window_runs(tiny_model, rng):
    params, dims = tiny_model
    B = 2
    mel = jnp.asarray(rng.standard_normal((B, 3000, dims.n_mels)), jnp.float32)
    prompt = jnp.asarray([TOK.sot_sequence("en")] * B, jnp.int32)
    out = D.transcribe_window(params, dims, CFG, SUPPRESS, mel, prompt,
                              jnp.float32(0.0), jax.random.PRNGKey(0))
    tokens = np.asarray(out["tokens"])
    n = np.asarray(out["n_sampled"])
    assert tokens.shape == (B, CFG.max_new_tokens)
    assert (n >= 0).all() and (n <= CFG.max_new_tokens).all()
    # first sampled token must be a timestamp (rule enforced end-to-end)
    for b in range(B):
        if n[b] > 0:
            assert tokens[b, 0] >= TOK.ts_begin
    assert np.isfinite(np.asarray(out["avg_logprob"])).all()
    ns = np.asarray(out["no_speech_prob"])
    assert ((ns >= 0) & (ns <= 1)).all()


def test_detect_language_runs(tiny_model, rng):
    params, dims = tiny_model
    mel = jnp.asarray(rng.standard_normal((1, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    lang_ids, probs = D.detect_language(params, dims, enc, TOK)
    lid = int(np.asarray(lang_ids)[0])
    assert TOK.lang_base <= lid < TOK.lang_base + TOK.num_languages
    p = np.asarray(probs)[0]
    np.testing.assert_allclose(p.sum(), 1.0, atol=1e-5)
    assert p[: TOK.lang_base].max() == 0.0


def test_segments_from_tokens():
    t = TOK.timestamp_token
    vocab_hi = 100  # arbitrary text ids
    ids = [t(0.0), 10, 11, t(2.0), t(2.0), 12, t(4.5), t(4.5), 13]
    arr = np.asarray(ids + [TOK.eot] * 3)
    segs, advance = D.segments_from_tokens(arr, len(ids), TOK, window_offset=30.0)
    # openai stitching: the open tail ([t4.5, 13] — truncated mid-segment)
    # is NOT emitted; seek returns to the closing timestamp so that audio
    # is re-decoded next window
    assert len(segs) == 2
    assert segs[0]["start"] == 30.0 and segs[0]["end"] == 32.0
    assert segs[0]["tokens"] == [10, 11]
    assert segs[1]["start"] == 32.0 and segs[1]["end"] == 34.5
    assert advance == 4.5


def test_segments_trailing_pair_sets_seek():
    t = TOK.timestamp_token
    ids = [t(0.0), 7, t(3.0), t(3.0), 8, t(6.0)]
    arr = np.asarray(ids)
    segs, advance = D.segments_from_tokens(arr, len(ids), TOK)
    # single-timestamp ending: the final slice IS a complete segment and
    # the whole window is consumed (openai seeks the full 30 s)
    assert segs[-1]["end"] == 6.0
    assert advance is None


def test_segments_gapped_trailing_pair_seeks_closing_timestamp():
    """A non-equal trailing timestamp pair ([<|5.00|>, <|7.00|>]) must seek
    to the CLOSING timestamp of the last complete segment (5.0), not the
    tail's opening one (7.0) — openai's tokens[last_slice-1] (round-2
    review: the off-by-one silently skipped the gap's audio)."""
    t = TOK.timestamp_token
    ids = [t(0.0), 7, t(5.0), t(7.0)]
    segs, advance = D.segments_from_tokens(np.asarray(ids), len(ids), TOK)
    assert len(segs) == 1
    assert segs[0]["end"] == 5.0
    assert advance == 5.0


def test_transcribe_window_int8_cross_kv(tiny_model, rng):
    """int8 cross-KV decoding produces near-identical behavior: same rule
    compliance, and attention numerics within quantization tolerance."""
    params, dims = tiny_model
    mel = jnp.asarray(rng.standard_normal((2, 3000, dims.n_mels)), jnp.float32)
    prompt = jnp.asarray([TOK.sot_sequence("en")] * 2, jnp.int32)
    out = D.transcribe_window(params, dims, CFG, SUPPRESS, mel, prompt,
                              jnp.zeros((2,), jnp.float32), jax.random.PRNGKey(0),
                              cross_kv_int8=True)
    tokens = np.asarray(out["tokens"])
    n = np.asarray(out["n_sampled"])
    for b in range(2):
        if n[b] > 0:
            assert tokens[b, 0] >= TOK.ts_begin
    assert np.isfinite(np.asarray(out["avg_logprob"])).all()


def test_quantize_cross_kv_roundtrip(tiny_model, rng):
    params, dims = tiny_model
    mel = jnp.asarray(rng.standard_normal((1, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    ck, cv = W.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    kq, vq, ks, vs = W.quantize_cross_kv(ck, cv)
    assert kq.dtype == jnp.int8
    deq = np.asarray(kq, np.float32) * np.asarray(ks)
    rel = np.abs(deq - np.asarray(ck)).max() / (np.abs(np.asarray(ck)).max() + 1e-9)
    assert rel < 0.02  # per-channel int8: <2% worst-case error


def test_transcribe_window_int8_self_kv(tiny_model, rng):
    """Write-time int8 self-KV: greedy token stream matches the bf16-cache
    decode closely (tiny random model; per-token scales bound error ~1/127)."""
    params, dims = tiny_model
    mel = jnp.asarray(rng.standard_normal((2, 3000, dims.n_mels)), jnp.float32)
    prompt = jnp.asarray([TOK.sot_sequence("en")] * 2, jnp.int32)
    kw = dict(temperature=jnp.zeros((2,), jnp.float32), key=jax.random.PRNGKey(0))
    ref = D.transcribe_window(params, dims, CFG, SUPPRESS, mel, prompt, **kw)
    out = D.transcribe_window(params, dims, CFG, SUPPRESS, mel, prompt,
                              self_kv_int8=True, **kw)
    tokens = np.asarray(out["tokens"])
    n = np.asarray(out["n_sampled"])
    for b in range(2):
        if n[b] > 0:
            assert tokens[b, 0] >= TOK.ts_begin
    assert np.isfinite(np.asarray(out["avg_logprob"])).all()
    # greedy paths agree on the first sampled token (coarse numerics check;
    # full-sequence agreement is not guaranteed under quantization)
    ref_tok = np.asarray(ref["tokens"])
    assert (tokens[:, 0] == ref_tok[:, 0]).all()


def test_ring_decode_int8_self_kv_matches_write_time(tiny_model, rng):
    """r4 int8 lever: flush-time-quantized int8 circular/fill pages
    (kv_write="ring", the default) agree with the write-time-quantized
    per-slot path (kv_write="dus") on the sampled token stream — the
    quantized VALUES are identical (same rows, same per-token scales); the
    only numeric difference is that in-chunk rows are attended at full
    precision before their flush, which can only REDUCE error vs the
    write-time path."""
    params, dims = tiny_model
    mel = jnp.asarray(rng.standard_normal((2, 3000, dims.n_mels)), jnp.float32)
    prompt = jnp.asarray([TOK.sot_sequence("en")] * 2, jnp.int32)
    kw = dict(temperature=jnp.zeros((2,), jnp.float32), key=jax.random.PRNGKey(0),
              self_kv_int8=True)
    ring = D.transcribe_window(params, dims, CFG, SUPPRESS, mel, prompt,
                               kv_write="ring", **kw)
    dus = D.transcribe_window(params, dims, CFG, SUPPRESS, mel, prompt,
                              kv_write="dus", **kw)
    rt, dt = np.asarray(ring["tokens"]), np.asarray(dus["tokens"])
    rn, dn = np.asarray(ring["n_sampled"]), np.asarray(dus["n_sampled"])
    for b in range(2):
        if rn[b] > 0:
            assert rt[b, 0] >= TOK.ts_begin
        assert rt[b, 0] == dt[b, 0]
    assert np.isfinite(np.asarray(ring["avg_logprob"])).all()


def test_decode_step_int8_self_kv_matches_bf16(tiny_model, rng):
    """Layer-exact check: logits from the int8 self-KV path stay within
    quantization tolerance of the full-precision path across several steps."""
    params, dims = tiny_model
    B = 2
    mel = jnp.asarray(rng.standard_normal((B, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    ck, cv = W.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    prompt = jnp.asarray([TOK.sot_sequence("en")] * B, jnp.int32)

    def run(self_kv_int8):
        cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32,
                             self_kv_int8=self_kv_int8)
        cache = {**cache, "cross_k": ck, "cross_v": cv}
        logits, cache = W.decode_prefill(params, dims, prompt, cache)
        outs = [logits[:, -1]]
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        for _ in range(4):
            logits, cache = W.decode_step(params, dims, tok, cache)
            outs.append(logits)
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return np.stack([np.asarray(o) for o in outs])

    ref = run(False)
    q = run(True)
    rel = np.abs(q - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.05, rel


def test_uniform_pos_matches_general_path(tiny_model, rng):
    """The batchwide-DUS fast path (uniform_pos=True) is bit-identical to the
    per-slot write path when all slots share one position."""
    params, dims = tiny_model
    B = 2
    mel = jnp.asarray(rng.standard_normal((B, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    ck, cv = W.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    prompt = jnp.asarray([TOK.sot_sequence("en")] * B, jnp.int32)

    def run(uniform):
        cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32)
        cache = {**cache, "cross_k": ck, "cross_v": cv}
        logits, cache = W.decode_prefill(params, dims, prompt, cache,
                                         uniform_pos=uniform)
        outs = [np.asarray(logits[:, -1])]
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        for _ in range(3):
            logits, cache = W.decode_step(params, dims, tok, cache,
                                          uniform_pos=uniform)
            outs.append(np.asarray(logits))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        return np.stack(outs)

    np.testing.assert_array_equal(run(True), run(False))


def test_int8_block_weights_roundtrip(tiny_model, rng):
    """Per-out-channel int8 decoder weights keep teacher-forced logits within
    quantization tolerance, and greedy decode stays rule-compliant."""
    params, dims = tiny_model
    qparams = W.quantize_block_weights(params)
    bp = qparams["decoder"]["blocks"]["q"]
    assert bp["wq"].dtype == jnp.int8 and "w" not in bp
    mel = jnp.asarray(rng.standard_normal((1, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    toks = jnp.asarray([TOK.sot_sequence("en") + [100, 200]], jnp.int32)
    ref = np.asarray(W.decode_logits(params, dims, toks, enc))
    q = np.asarray(W.decode_logits(qparams, dims, toks, enc))
    rel = np.abs(q - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < 0.05, rel

    prompt = jnp.asarray([TOK.sot_sequence("en")], jnp.int32)
    out = D.transcribe_window(qparams, dims, CFG, SUPPRESS, mel, prompt,
                              jnp.zeros((1,), jnp.float32), jax.random.PRNGKey(0))
    tokens = np.asarray(out["tokens"])
    if int(np.asarray(out["n_sampled"])[0]) > 0:
        assert tokens[0, 0] >= TOK.ts_begin


def test_deferred_write_step_matches_prefill(tiny_model, rng):
    """decode_step's deferred-write joint attention must agree with the
    write-then-attend prefill path: teacher-forcing token-by-token through
    decode_step reproduces decode_prefill's logits."""
    params, dims = tiny_model
    B = 2
    mel = jnp.asarray(rng.standard_normal((B, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    ck, cv = W.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    toks = np.asarray([TOK.sot_sequence("en") + [100, 200, 300]] * B, np.int32)

    cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    full_logits, _ = W.decode_prefill(params, dims, jnp.asarray(toks), cache)

    cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    step_logits = []
    first, _ = W.decode_prefill(params, dims, jnp.asarray(toks[:, :1]), cache)
    # re-init: drive everything through decode_step from the first token
    cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    for t in range(toks.shape[1]):
        logits, cache = W.decode_step(params, dims, jnp.asarray(toks[:, t]), cache)
        step_logits.append(np.asarray(logits))
    step_logits = np.stack(step_logits, axis=1)  # (B, T, V)
    np.testing.assert_allclose(step_logits, np.asarray(full_logits),
                               rtol=2e-4, atol=2e-4)


def test_fused_qkv_matches_unfused(tiny_model, rng):
    """fuse_qkv_weights (one (d,3d) projection per block) is a pure weight
    re-layout: encoder states and decode_step logits must match the
    three-matmul path exactly (same math, f32)."""
    params, dims = tiny_model
    fused = W.fuse_qkv_weights(params)
    assert "qkv" in fused["decoder"]["blocks"] and "q" not in fused["decoder"]["blocks"]
    B = 2
    mel = jnp.asarray(rng.standard_normal((B, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    enc_f = W.encode(fused, dims, mel)
    np.testing.assert_allclose(np.asarray(enc_f), np.asarray(enc), rtol=1e-5, atol=1e-5)

    toks = np.asarray([TOK.sot_sequence("en") + [100, 200]] * B, np.int32)
    logits = W.decode_logits(params, dims, jnp.asarray(toks), enc)
    logits_f = W.decode_logits(fused, dims, jnp.asarray(toks), enc)
    np.testing.assert_allclose(np.asarray(logits_f), np.asarray(logits),
                               rtol=1e-4, atol=1e-4)

    # step path (deferred writes) with fused weights
    ck, cv = W.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    s1, _ = W.decode_step(params, dims, jnp.asarray(toks[:, 0]), cache)
    cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    s2, _ = W.decode_step(fused, dims, jnp.asarray(toks[:, 0]), cache)
    np.testing.assert_allclose(np.asarray(s2), np.asarray(s1), rtol=1e-4, atol=1e-4)


def test_fused_qkv_then_int8_weights_runs(tiny_model, rng):
    """fuse + per-channel int8 quantization compose (quantize sees the fused
    (L, d, 3d) tensor); decode still runs and logits stay close to f32."""
    params, dims = tiny_model
    fq = W.quantize_block_weights(W.fuse_qkv_weights(params))
    B = 2
    mel = jnp.asarray(rng.standard_normal((B, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    toks = np.asarray([TOK.sot_sequence("en") + [100]] * B, np.int32)
    ref = np.asarray(W.decode_logits(params, dims, jnp.asarray(toks), enc))
    got = np.asarray(W.decode_logits(fq, dims, jnp.asarray(toks), enc))
    # int8 weights: small quantization error, same argmax structure
    assert np.abs(got - ref).max() < 0.15
    assert (np.argmax(got, -1) == np.argmax(ref, -1)).mean() > 0.9


def test_uniform_fill_matches_dus(tiny_model, rng):
    """kv_write="uniform" (fill-layout: generated KV packed at a scalar
    offset, padded prompt gap masked) must produce identical logits to the
    per-slot DUS path, including with variable-length right-padded prompts."""
    params, dims = tiny_model
    B = 3
    mel = jnp.asarray(rng.standard_normal((B, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    ck, cv = W.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    P = 6
    prompts = np.full((B, P), 7, np.int32)
    plen = np.asarray([6, 3, 5], np.int32)
    toks = np.asarray([[11, 12, 13, 14], [21, 22, 23, 24], [31, 32, 33, 34]], np.int32)

    def fresh():
        cache = W.init_cache(dims, B, enc.shape[1], dtype=jnp.float32)
        return {**cache, "cross_k": ck, "cross_v": cv}

    # reference: per-slot DUS writes (generated KV right after each true prompt)
    cache = fresh()
    _, cache = W.decode_prefill(params, dims, jnp.asarray(prompts), cache,
                                prompt_len=jnp.asarray(plen))
    ref = []
    for t in range(toks.shape[1]):
        logits, cache = W.decode_step(params, dims, jnp.asarray(toks[:, t]), cache)
        ref.append(np.asarray(logits))

    # uniform-fill: generated KV packed at [P, P+step)
    cache = fresh()
    _, cache = W.decode_prefill(params, dims, jnp.asarray(prompts), cache,
                                prompt_len=jnp.asarray(plen))
    cache = W.arm_uniform_fill(cache, P)
    got = []
    for t in range(toks.shape[1]):
        logits, cache = W.decode_step(params, dims, jnp.asarray(toks[:, t]), cache,
                                      kv_write="uniform")
        got.append(np.asarray(logits))
    assert int(np.asarray(cache["fill"])) == toks.shape[1]
    for t in range(toks.shape[1]):
        np.testing.assert_allclose(got[t], ref[t], rtol=2e-5, atol=2e-5)


def test_fused_int8_cross_kv_matches_two_pass(tiny_model, rng):
    """compute_cross_kv(int8=True) (quantize inside the per-layer map, no
    bf16 device-memory round trip) must equal quantize_cross_kv over the two-pass
    result exactly (same math, same order)."""
    params, dims = tiny_model
    mel = jnp.asarray(rng.standard_normal((2, 3000, dims.n_mels)), jnp.float32)
    enc = W.encode(params, dims, mel)
    ck, cv = W.compute_cross_kv(params, dims, enc, dtype=jnp.float32)
    kq0, vq0, ks0, vs0 = W.quantize_cross_kv(ck, cv)
    kq1, vq1, ks1, vs1 = W.compute_cross_kv(params, dims, enc, int8=True)
    np.testing.assert_array_equal(np.asarray(kq1), np.asarray(kq0))
    np.testing.assert_array_equal(np.asarray(vq1), np.asarray(vq0))
    np.testing.assert_allclose(np.asarray(ks1), np.asarray(ks0), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(vs1), np.asarray(vs0), rtol=1e-6)
