"""Hermetic accuracy pinning (VERDICT r1 item 5).

Real audio/checkpoints are unavailable in this image (zero egress), so the
suite pins what CAN be pinned hermetically:

1. golden-transcript regression: a fixed-seed tiny model is round-tripped
   through the ggml container (writer -> loader) and a fixed synthetic
   waveform is transcribed through the FULL pipeline (mel, encoder, rules,
   temperature fallback, seek stitching, postprocess). The result is pinned
   in tests/golden/transcript.json — refactors cannot silently change
   decodes. Regenerate deliberately by deleting the file and rerunning.
2. bf16-vs-f32 logit drift at REALISTIC width (d=1280, 20 heads — the
   large-v3 shape, 2 layers): the production dtype's drift is bounded
   against the f32 reference.
3. int8 decoder-weight drift (a decode-speed lever): quantization error is
   quantified against the same reference so the default-off decision is
   data-backed.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from speaksense_tpu.asr import AsrParams
from speaksense_tpu.asr.engine import WhisperEngine
from speaksense_tpu.config import EngineConfig
from speaksense_tpu.models.whisper import WhisperDims, init_params

GOLDEN_DIR = Path(__file__).parent / "golden"

TINY_DIMS = WhisperDims(
    n_mels=80, n_vocab=51865, n_audio_ctx=1500, n_audio_state=64,
    n_audio_head=4, n_audio_layer=2, n_text_ctx=448, n_text_state=64,
    n_text_head=4, n_text_layer=2)

# large-v3's width/heads with 2 layers: realistic matmul/softmax shapes
# without large-v3's 32-layer runtime
WIDE_DIMS = WhisperDims(
    n_mels=128, n_vocab=51866, n_audio_ctx=1500, n_audio_state=1280,
    n_audio_head=20, n_audio_layer=2, n_text_ctx=448, n_text_state=1280,
    n_text_head=20, n_text_layer=2)


def _fixed_audio(seconds: float = 4.0) -> np.ndarray:
    """Deterministic synthetic speech-band waveform (no RNG)."""
    t = np.arange(int(16000 * seconds)) / 16000.0
    wave = (0.3 * np.sin(2 * np.pi * 220 * t)
            + 0.2 * np.sin(2 * np.pi * 440 * t + 0.5)
            + 0.1 * np.sin(2 * np.pi * 880 * t) * np.sin(2 * np.pi * 3 * t))
    return wave.astype(np.float32)


def test_golden_transcript_full_pipeline(tmp_path):
    import jax

    from speaksense_tpu.ckpt import ggml as G
    from speaksense_tpu.ckpt.ggml import (
        GgmlModel, ggml_tensors_from_params, write_ggml,
    )

    from speaksense_tpu.audio.mel import mel_filter_bank

    params = init_params(TINY_DIMS, jax.random.PRNGKey(7))
    tensors = ggml_tensors_from_params(params, TINY_DIMS)
    vocab = [b"tok%d " % i for i in range(50257)]
    model = GgmlModel(dims=TINY_DIMS, ftype=G.F16,
                      filters=np.asarray(mel_filter_bank(80), np.float32),
                      vocab=vocab, tensors=tensors)
    ckpt = tmp_path / "golden-tiny.bin"
    with open(ckpt, "wb") as f:
        write_ggml(model, f, ftype=G.F16)

    eng = WhisperEngine.from_ggml(
        str(ckpt), config=EngineConfig(compute_dtype="float32", best_of=1),
        use_cache=False)
    res = eng.transcribe_audio(_fixed_audio(), AsrParams(language="en"))
    got = {
        "full_text": res.full_text,
        "segments": [[round(s.start, 2), round(s.end, 2), s.text]
                     for s in res.segments],
    }

    golden_file = GOLDEN_DIR / "transcript.json"
    if not golden_file.exists():  # pin once; commit the file
        GOLDEN_DIR.mkdir(exist_ok=True)
        golden_file.write_text(json.dumps(got, indent=1))
        pytest.skip("golden transcript pinned; rerun to enforce")
    want = json.loads(golden_file.read_text())
    assert got == want, (
        "decode changed vs pinned golden transcript — if intentional, "
        "delete tests/golden/transcript.json and rerun to re-pin")


def _prefill_logits(dims, params, dtype, rng, t_mel=512, n_tok=8):
    """encode + cross-KV + teacher-forced prefill logits, the serving path's
    numerics (models/whisper.py)."""
    import jax
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    cast = jax.tree.map(
        lambda x: jnp.asarray(x, dtype) if x.ndim >= 2 else jnp.asarray(x), params)
    mel = jnp.asarray(rng.standard_normal((1, t_mel, dims.n_mels)), jnp.float32)
    tokens = jnp.asarray(rng.integers(0, 50000, (1, n_tok)), jnp.int32)

    enc = W.encode(cast, dims, mel, n_ctx_out=t_mel // 2)
    cache = W.init_cache(dims, 1, enc.shape[1], dtype=dtype)
    ck, cv = W.compute_cross_kv(cast, dims, enc, dtype=dtype)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    logits, _ = W.decode_prefill(cast, dims, tokens, cache)
    return np.asarray(logits[0, -1], np.float32)


@pytest.mark.slow
def test_bf16_drift_at_large_v3_width(rng):
    import jax.numpy as jnp

    params = init_params(WIDE_DIMS)
    ref = _prefill_logits(WIDE_DIMS, params, jnp.float32, np.random.default_rng(3))
    bf16 = _prefill_logits(WIDE_DIMS, params, jnp.bfloat16, np.random.default_rng(3))
    scale = float(ref.std())
    max_rel = float(np.abs(bf16 - ref).max()) / scale
    # bf16 has ~3 decimal digits; after 2 wide layers the drift stays a
    # small fraction of the logit spread and the greedy choice is stable
    assert max_rel < 0.15, f"bf16 drift {max_rel:.4f} of logit std"
    assert int(ref.argmax()) == int(bf16.argmax())
    # top-5 sets agree (ranking-robustness beyond the single argmax)
    top_ref = set(np.argsort(ref)[-5:].tolist())
    top_b = set(np.argsort(bf16)[-5:].tolist())
    assert len(top_ref & top_b) >= 4, (top_ref, top_b)


@pytest.mark.slow
def test_int8_weight_drift_quantified(rng):
    import jax
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    params = init_params(WIDE_DIMS)
    ref = _prefill_logits(WIDE_DIMS, params, jnp.float32, np.random.default_rng(3))

    q = W.quantize_block_weights(jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16) if x.ndim >= 2 else jnp.asarray(x),
        params))
    int8 = _prefill_logits(WIDE_DIMS, q, jnp.bfloat16, np.random.default_rng(3))
    scale = float(ref.std())
    max_rel = float(np.abs(int8 - ref).max()) / scale
    # int8 per-out-channel is coarser than bf16 but must stay well inside
    # the decision margin at realistic width; this measured bound is the
    # data behind keeping weights_int8 opt-in
    assert max_rel < 0.5, f"int8 weight drift {max_rel:.4f} of logit std"
    top_ref = set(np.argsort(ref)[-5:].tolist())
    top_q = set(np.argsort(int8)[-5:].tolist())
    assert len(top_ref & top_q) >= 3, (top_ref, top_q)


@pytest.mark.slow
def test_int8_self_kv_ring_drift_quantified(rng):
    """r4 lever: int8 self-KV circular/fill pages with flush-time
    quantization (`kv_write="ring"` + self_kv_int8) — the greedy argmax
    agrees with the bf16-page path step for step across a multi-flush
    decode, and the logit drift is bounded.

    Bound calibration (measured, 2026-08-20): the isolated joint-attention
    error of the q8t path is ~2.7% of output std, of which HALF is plain
    bf16 rounding (the fused scale-fold agrees with an exact
    dequantize-then-attend reference to 1.3% — see
    test_int8_self_kv_fold_exactness below, the actual correctness proof).
    These RANDOM init_params layers have no trained-network contraction, so
    2 wide layers + the 51865-way vocab projection amplify that ~2.7% to a
    max-logit drift of ~1.9x logit std at step 1, decaying to ~0.5x by
    step 20 as real generated columns dilute the quantized prompt columns.
    The bound pins that measured ceiling; the decision-margin proof is the
    per-step argmax equality, and the quality gate for real checkpoints is
    tools/wer_check.py (PERF.md int8 policy)."""
    import jax
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    params = jax.tree.map(
        lambda x: jnp.asarray(x, jnp.bfloat16) if x.ndim >= 2 else jnp.asarray(x),
        init_params(WIDE_DIMS))
    m_rng = np.random.default_rng(3)
    mel = jnp.asarray(m_rng.standard_normal((1, 512, WIDE_DIMS.n_mels)),
                      jnp.float32)
    enc = W.encode(params, WIDE_DIMS, mel, n_ctx_out=256)
    prompt = jnp.asarray(m_rng.integers(0, 50000, (1, 4)), jnp.int32)

    def run(self_kv_int8):
        cache = W.init_cache(WIDE_DIMS, 1, enc.shape[1], dtype=jnp.bfloat16,
                             self_kv_int8=self_kv_int8, t_text=128)
        ck, cv = W.compute_cross_kv(params, WIDE_DIMS, enc, dtype=jnp.bfloat16)
        cache = {**cache, "cross_k": ck, "cross_v": cv}
        logits, cache = W.decode_prefill(params, WIDE_DIMS, prompt, cache)
        cache = W.arm_uniform_fill(cache, 4)
        ring = W.init_ring(WIDE_DIMS, 1, 8)
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        outs = []
        for i in range(20):  # crosses two W=8 flush boundaries
            logits, cache, ring = W.decode_step_ring(params, WIDE_DIMS, tok,
                                                     cache, ring)
            outs.append(np.asarray(logits[0], np.float32))
            tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            if (i + 1) % 8 == 0:
                cache, ring = W.flush_ring(cache, ring)
        return np.stack(outs)

    ref = run(False)
    q = run(True)
    scale = float(ref.std())
    max_rel = float(np.abs(q - ref).max()) / scale
    assert max_rel < 3.0, f"int8 self-KV ring drift {max_rel:.4f} of logit std"
    # late steps are dominated by exactly-roundtripped generated columns:
    # drift must DECAY, not compound (a scale-fold bug compounds)
    early = float(np.abs(q - ref)[:4].max()) / scale
    late = float(np.abs(q - ref)[-4:].max()) / scale
    assert late < early, (early, late)
    # the greedy token stream is identical across all steps here
    assert (ref.argmax(axis=-1) == q.argmax(axis=-1)).all()


@pytest.mark.slow
def test_int8_self_kv_fold_exactness(rng):
    """The actual q8t correctness proof: the fused scale-fold attention
    (`_joint_decode_attention_ring_q8t` — key scale multiplies its logit
    column, value scale its softmax weight) agrees with an EXACT
    dequantize-then-attend reference to within bf16 rounding of the same
    computation. Separates 'the fold is algebraically right' from the
    unavoidable int8 quantization noise the drift test above bounds."""
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    B, H, Dh, T, Wd = 2, 20, 64, 128, 8
    def mk(*s):
        return jnp.asarray(rng.standard_normal(s), jnp.bfloat16)
    q = mk(B, H, 1, Dh)
    kn, vn = mk(B, H, 1, Dh), mk(B, H, 1, Dh)
    k_full = rng.standard_normal((B, H, Dh, T)).astype(np.float32)
    v_full = rng.standard_normal((B, H, Dh, T)).astype(np.float32)
    mask_c = jnp.asarray((np.arange(T) < 7)[None, None, None, :]
                         & np.ones((B, 1, 1, T), bool))
    kr, vr = mk(B, H, Wd, Dh), mk(B, H, Wd, Dh)
    mask_r = jnp.asarray((np.arange(Wd) < 3)[None, None, None, :]
                         & np.ones((B, 1, 1, Wd), bool))

    kq, ks = W._quantize_kv_pages(jnp.asarray(k_full))
    vq, vs = W._quantize_kv_pages(jnp.asarray(v_full))
    fused = np.asarray(W._joint_decode_attention_ring_q8t(
        q, kq, vq, ks, vs, mask_c, kr, vr, mask_r, kn, vn), np.float32)
    # exact dequantization, then the plain bf16 joint attention
    kdq = jnp.asarray(np.asarray(kq, np.float32)
                      * np.asarray(ks)[:, :, None, :], jnp.bfloat16)
    vdq = jnp.asarray(np.asarray(vq, np.float32)
                      * np.asarray(vs)[:, :, None, :], jnp.bfloat16)
    ref = np.asarray(W._joint_decode_attention_ring(
        q, kdq, vdq, mask_c, kr, vr, mask_r, kn, vn), np.float32)
    err = np.abs(fused - ref).max() / ref.std()
    assert err < 0.05, f"fold mismatch {err:.4f} of attn-out std"
