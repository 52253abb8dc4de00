"""End-to-end engine tests on a tiny random-weight model (hermetic)."""

import numpy as np
import pytest

from speaksense_tpu.asr import AsrParams
from speaksense_tpu.asr.engine import WhisperEngine
from speaksense_tpu.asr.fake import FakeAsrEngine
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models.whisper import WhisperDims, init_params
from speaksense_tpu.models.tokenizer import Tokenizer

TINY_DIMS = WhisperDims(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
    n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
    n_text_head=4, n_text_layer=2)


@pytest.fixture(scope="module")
def engine():
    import jax

    params = init_params(TINY_DIMS, jax.random.PRNGKey(0))
    tok = Tokenizer.synthetic(TINY_DIMS.n_vocab)
    # best_of=1: random weights trip the fallback thresholds on every slot,
    # and best-of-N retries would multiply CPU decode calls in these tests
    cfg = EngineConfig(compute_dtype="float32", best_of=1)
    return WhisperEngine(params, TINY_DIMS, tok, config=cfg, name="test-tiny")


def test_transcribe_audio_structure(engine, rng):
    audio = (rng.standard_normal(16000 * 3) * 0.1).astype(np.float32)
    res = engine.transcribe_audio(audio, AsrParams(language="en"))
    assert isinstance(res.full_text, str)
    for s in res.segments:
        assert s.end >= s.start >= 0.0
        assert s.end <= 3.5  # clamped to window duration
    assert res.language == "en"


def test_transcribe_with_state_stream_mode(engine, rng):
    state = engine.create_state()
    audio = (rng.standard_normal(16000 * 2) * 0.1).astype(np.float32)
    res = engine.transcribe_with_state(state, audio, AsrParams(language="en", stream_mode=True))
    # stream mode returns at most the final segment (reference whisper.rs:107-117)
    assert len(res.segments) <= 1
    if res.segments:
        assert res.full_text == res.segments[0].text


def test_empty_audio(engine):
    res = engine.transcribe_audio(np.zeros((0,), np.float32), AsrParams(language="en"))
    assert res.full_text == "" and res.segments == []


def test_detect_language_returns_code(engine, rng):
    audio = (rng.standard_normal(16000) * 0.1).astype(np.float32)
    code = engine.detect_language(audio)
    assert isinstance(code, str) and len(code) >= 2


def test_decode_windows_batched(engine, rng):
    mels = engine.compute_mel(
        (rng.standard_normal((2, 16000 * 2)) * 0.1).astype(np.float32))
    out = engine.decode_windows(mels, "en")
    assert len(out) == 2
    for r in out:
        assert set(r) >= {"tokens", "n_sampled", "text", "avg_logprob",
                          "no_speech_prob", "compression_ratio", "temperature"}
        assert r["temperature"] in (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)


def test_fake_engine_deterministic(rng):
    fake = FakeAsrEngine()
    audio = (rng.standard_normal(16000 * 7) * 0.2).astype(np.float32)
    r1 = fake.transcribe(audio, AsrParams())
    r2 = fake.transcribe(audio, AsrParams())
    assert r1.full_text == r2.full_text
    assert len(r1.segments) == 2
    assert r1.segments[1].end == pytest.approx(7.0)
    other = fake.transcribe(audio * 0.5, AsrParams())
    assert other.full_text != r1.full_text


def test_word_timestamps_attached(engine, rng):
    audio = (rng.standard_normal(16000 * 2) * 0.1).astype(np.float32)
    res = engine.transcribe_audio(
        audio, AsrParams(language="en", word_timestamps=True))
    for s in res.segments:
        assert s.words is not None
        for w in s.words:
            assert set(w) == {"word", "start", "end"}
            assert w["start"] <= w["end"]


def test_context_conditioning_prompt_shapes(engine, rng):
    """Variable-length conditioned prompts pad to one bucket and decode."""
    mels = engine.compute_mel((rng.standard_normal((2, 16000)) * 0.1).astype(np.float32))
    ctx = [[101, 102, 103], list(range(200, 260))]
    out = engine.decode_windows(mels, "en", context_tokens=ctx, max_new_tokens=8)
    assert len(out) == 2
    for r in out:
        assert isinstance(r["text"], str)


def test_transcribe_audio_vad(engine):
    # 2s silence + 1s tone + 2s silence + 1s tone: VAD finds two spans
    t = np.arange(16000) / 16000
    tone = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    silence = np.zeros(16000 * 2, np.float32)
    audio = np.concatenate([silence, tone, silence, tone])
    res = engine.transcribe_audio_vad(audio, AsrParams(language="en"))
    for s in res.segments:
        # all segments lie inside voiced spans (± VAD padding)
        assert (1.5 <= s.start <= 3.5) or (4.5 <= s.start <= 6.5), s.start


def test_best_of_candidate_sampling(rng):
    """At t>0 the engine must decode best_of candidate rows per pending slot
    and keep the best avg_logprob one (reference greedy best_of=5,
    whisper.rs:132-141). Random weights always trip the fallback, so one
    window forces the retry path; the candidate program batch is
    max(B, best_of) rows."""
    import jax

    params = init_params(TINY_DIMS, jax.random.PRNGKey(0))
    tok = Tokenizer.synthetic(TINY_DIMS.n_vocab)
    cfg = EngineConfig(compute_dtype="float32", best_of=3)
    eng = WhisperEngine(params, TINY_DIMS, tok, config=cfg)
    mel = eng.compute_mel((rng.standard_normal(16000) * 0.1).astype(np.float32))
    res = eng.decode_windows(mel, "en", max_new_tokens=16)[0]
    assert res["temperature"] > 0.0  # fallback fired
    # the candidate bucket (batch=3) was compiled and used
    assert any(k[0] == "win" and k[1] == 3 for k in eng._jit_cache), \
        list(eng._jit_cache)


def test_min_segment_length_merges_short_segments(engine):
    from speaksense_tpu.asr import TranscribeSegment

    segs = [
        TranscribeSegment(text="Hi.", speaker_id=0, start=0.0, end=0.5),
        TranscribeSegment(text=" there, this is long enough.", speaker_id=0,
                          start=0.5, end=2.0),
        TranscribeSegment(text=" Also a long trailing segment here.",
                          speaker_id=0, start=2.0, end=4.0),
    ]
    merged = WhisperEngine._merge_short_segments(segs, 10)
    assert len(merged) == 2
    assert merged[0].text == "Hi. there, this is long enough."
    assert merged[0].start == 0.0 and merged[0].end == 2.0

    # trailing short segment merges backward
    segs2 = [
        TranscribeSegment(text="A full length first segment.", speaker_id=0,
                          start=0.0, end=2.0),
        TranscribeSegment(text=" ok", speaker_id=0, start=2.0, end=2.2),
    ]
    merged2 = WhisperEngine._merge_short_segments(segs2, 10)
    assert len(merged2) == 1
    assert merged2[0].text.endswith(" ok") and merged2[0].end == 2.2

    # never merge across speaker turns
    segs3 = [
        TranscribeSegment(text="Hi", speaker_id=0, start=0.0, end=0.5),
        TranscribeSegment(text="Welcome to the show today", speaker_id=1,
                          start=0.5, end=2.0),
    ]
    assert len(WhisperEngine._merge_short_segments(segs3, 10)) == 2


def test_entropy_fallback_gate():
    """whisper.cpp's entropy_thold gate (whisper.rs:164): a >32-token tail
    cycling through few distinct tokens has histogram entropy < 2.4 and must
    trigger a retry; diverse output must not."""
    from speaksense_tpu.asr import postprocess as PP

    repetitive = [5, 6] * 30                 # 60 tokens, 2 distinct
    assert PP.token_entropy(repetitive) < 1.0
    diverse = list(range(100, 160))          # 60 distinct tokens
    assert PP.token_entropy(diverse) > 3.0
    assert PP.token_entropy([]) == 0.0
    # only the last `window` tokens count: a diverse tail rescues a
    # repetitive prefix (whisper.cpp windows the LAST 32)
    assert PP.token_entropy(repetitive + diverse) > 3.0


def test_entropy_gate_retry_decision():
    """needs_fallback_retry: the entropy gate fires only on a >32-token
    low-entropy candidate, independently of the other two gates."""
    from speaksense_tpu.asr.engine import needs_fallback_retry

    cfg = EngineConfig()
    good = dict(compression_ratio=1.2, avg_logprob=-0.3, n_sampled=60,
                token_entropy=3.5)
    assert not needs_fallback_retry(good, cfg)
    # repetitive tail: 60 sampled tokens, near-zero histogram entropy
    repetitive = dict(good, token_entropy=0.3)
    assert needs_fallback_retry(repetitive, cfg)
    # whisper.cpp's result_len > 32 guard: short outputs never entropy-fail
    short = dict(good, n_sampled=20, token_entropy=0.0)
    assert not needs_fallback_retry(short, cfg)
    # the other gates still fire on their own
    assert needs_fallback_retry(dict(good, compression_ratio=5.0), cfg)
    assert needs_fallback_retry(dict(good, avg_logprob=-3.0), cfg)
    # slot-pool candidates carry no token_entropy key: gate must not crash
    assert not needs_fallback_retry(
        dict(compression_ratio=1.0, avg_logprob=-0.2, n_sampled=60), cfg)


def test_engine_int8_weights_init_idempotent():
    """ADVICE r2: weights_int8 + fuse_qkv engine init must leave int8 'wq'
    with FLOAT32 'ws' scales (bf16 scales would compound quantization
    error), and re-constructing from the already-transformed params must be
    idempotent."""
    import jax
    import jax.numpy as jnp

    params = init_params(TINY_DIMS, jax.random.PRNGKey(0))
    tok = Tokenizer.synthetic(TINY_DIMS.n_vocab)
    cfg = EngineConfig(compute_dtype="bfloat16", weights_int8=True,
                       fuse_qkv=True, best_of=1)
    eng = WhisperEngine(params, TINY_DIMS, tok, config=cfg, name="int8-test")
    qkv = eng.params["decoder"]["blocks"]["qkv"]
    assert qkv["wq"].dtype == jnp.int8
    assert qkv["ws"].dtype == jnp.float32
    fc1 = eng.params["decoder"]["blocks"]["fc1"]
    assert fc1["wq"].dtype == jnp.int8 and fc1["ws"].dtype == jnp.float32

    # idempotent: constructing again from the transformed tree must not
    # re-quantize or cast the scales
    eng2 = WhisperEngine(jax.tree.map(np.asarray, eng.params), TINY_DIMS, tok,
                         config=cfg, name="int8-test-2")
    qkv2 = eng2.params["decoder"]["blocks"]["qkv"]
    assert qkv2["wq"].dtype == jnp.int8
    assert qkv2["ws"].dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(qkv["wq"]), np.asarray(qkv2["wq"]))


def test_self_kv_int8_window_gating(rng, monkeypatch):
    """EngineConfig.self_kv_int8 (--int8-self-kv) plumbs into the window
    program ONLY when the token budget spans more than one 128-column page:
    at t_text=128 the flush-quantize cost offsets the page-read saving."""
    import jax

    import speaksense_tpu.models.decode as D_mod

    captured = []
    orig = D_mod.transcribe_window

    def spy(*a, **kw):
        captured.append(bool(kw.get("self_kv_int8", False)))
        return orig(*a, **kw)

    monkeypatch.setattr(D_mod, "transcribe_window", spy)

    params = init_params(TINY_DIMS, jax.random.PRNGKey(0))
    tok = Tokenizer.synthetic(TINY_DIMS.n_vocab)
    eng = WhisperEngine(params, TINY_DIMS, tok,
                        config=EngineConfig(compute_dtype="float32",
                                            best_of=1, self_kv_int8=True),
                        name="selfint8-test")
    mels = np.asarray(eng.compute_mel(
        (rng.standard_normal(16000) * 0.1).astype(np.float32), pad_to=3000))
    # budget 3 + 8 <= 128: one page — int8 pages must stay OFF
    eng.decode_windows(mels, "en", max_new_tokens=8)
    assert captured == [False]
    # budget 3 + 140 > 128: two pages — int8 pages engage
    captured.clear()
    eng.decode_windows(mels, "en", max_new_tokens=140)
    assert captured == [True]
