"""Whisper encoder/decoder in pure-functional JAX.

Design notes (a JAX design, not a port):
- Parameters are a plain pytree of jnp arrays. Transformer blocks are
  *stacked*: every per-layer tensor carries a leading layer axis and blocks
  run under `jax.lax.scan`, keeping compile time flat in depth and making
  sharding annotations uniform across layers.
- Compute dtype is bf16 (the tensor cores' native input); layer norms,
  softmax and logits accumulate in f32.
- Decoding state is an explicit, statically-shaped KV cache with a *per-slot
  position vector*, so one compiled `decode_step` serves a continuously
  batched pool of streams at different generation offsets (the reference
  serializes one whisper.cpp state per stream instead —
  /root/reference/src/asr/whisper.rs:30-39, src/grpc/handlers/asr.rs:164-169).
- The encoder supports truncated audio contexts (`n_ctx_out`) like
  whisper.cpp's `audio_ctx` parameter (/root/reference/src/asr/whisper.rs:144):
  a 5 s streaming chunk only pays for 250 encoder frames, not 1500.

Weight layouts: linear weights are (in, out) so application is `x @ w`; conv
stem kernels are (k, in, out) (NWC/WIO).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

Params = dict[str, Any]


@dataclass(frozen=True)
class WhisperDims:
    """Model hyperparameters (mirrors the ggml header fields the reference's
    engine reads — see ckpt/ggml.py and SURVEY.md §2 'whisper.cpp engine')."""

    n_mels: int
    n_vocab: int
    n_audio_ctx: int
    n_audio_state: int
    n_audio_head: int
    n_audio_layer: int
    n_text_ctx: int
    n_text_state: int
    n_text_head: int
    n_text_layer: int

    @property
    def head_dim(self) -> int:
        return self.n_audio_state // self.n_audio_head


def _d(n_mels, n_vocab, audio_state, audio_head, audio_layer, text_layer, text_state=None, text_head=None):
    return WhisperDims(
        n_mels=n_mels, n_vocab=n_vocab, n_audio_ctx=1500,
        n_audio_state=audio_state, n_audio_head=audio_head, n_audio_layer=audio_layer,
        n_text_ctx=448, n_text_state=text_state or audio_state,
        n_text_head=text_head or audio_head, n_text_layer=text_layer,
    )


# The whisper model family (same set the reference's download script fetches —
# /root/reference/script/download-ggml-model.sh:28-54).
MODEL_DIMS: dict[str, WhisperDims] = {
    "tiny.en": _d(80, 51864, 384, 6, 4, 4),
    "tiny": _d(80, 51865, 384, 6, 4, 4),
    "base.en": _d(80, 51864, 512, 8, 6, 6),
    "base": _d(80, 51865, 512, 8, 6, 6),
    "small.en": _d(80, 51864, 768, 12, 12, 12),
    "small": _d(80, 51865, 768, 12, 12, 12),
    "medium.en": _d(80, 51864, 1024, 16, 24, 24),
    "medium": _d(80, 51865, 1024, 16, 24, 24),
    "large-v1": _d(80, 51865, 1280, 20, 32, 32),
    "large-v2": _d(80, 51865, 1280, 20, 32, 32),
    "large-v3": _d(128, 51866, 1280, 20, 32, 32),
    "large-v3-turbo": _d(128, 51866, 1280, 20, 32, 4),
    "distil-large-v3": _d(128, 51866, 1280, 20, 32, 2),
}


# ---------------------------------------------------------------------------
# initialization (used for tests/benchmarks; real weights come from ckpt/)
# ---------------------------------------------------------------------------

def _linear_init(key, d_in, d_out, bias=True):
    w = jax.random.normal(key, (d_in, d_out), jnp.float32) * (1.0 / math.sqrt(d_in))
    p = {"w": w}
    if bias:
        p["b"] = jnp.zeros((d_out,), jnp.float32)
    return p


def _attn_init(key, d, cross_prefix=""):
    ks = jax.random.split(key, 4)
    return {
        cross_prefix + "q": _linear_init(ks[0], d, d),
        cross_prefix + "k": _linear_init(ks[1], d, d, bias=False),
        cross_prefix + "v": _linear_init(ks[2], d, d),
        cross_prefix + "o": _linear_init(ks[3], d, d),
    }


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _ln_init(d):
    return {"g": jnp.ones((d,), jnp.float32), "b": jnp.zeros((d,), jnp.float32)}


def init_params(dims: WhisperDims, key: jax.Array | None = None, dtype=jnp.float32) -> Params:
    """Random-init parameter pytree (layout identical to converted ggml/HF
    checkpoints so every test path exercises production code)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    d, dt = dims.n_audio_state, dims.n_text_state
    keys = iter(jax.random.split(key, 16 + 8 * (dims.n_audio_layer + dims.n_text_layer)))

    def enc_block():
        return {
            "attn_ln": _ln_init(d),
            **_attn_init(next(keys), d),
            "mlp_ln": _ln_init(d),
            "fc1": _linear_init(next(keys), d, 4 * d),
            "fc2": _linear_init(next(keys), 4 * d, d),
        }

    def dec_block():
        return {
            "attn_ln": _ln_init(dt),
            **_attn_init(next(keys), dt),
            "cross_ln": _ln_init(dt),
            **{"c" + k: v for k, v in _attn_init(next(keys), dt).items()},
            "mlp_ln": _ln_init(dt),
            "fc1": _linear_init(next(keys), dt, 4 * dt),
            "fc2": _linear_init(next(keys), 4 * dt, dt),
        }

    params = {
        "encoder": {
            "conv1": {
                "w": jax.random.normal(next(keys), (3, dims.n_mels, d), jnp.float32) * 0.05,
                "b": jnp.zeros((d,), jnp.float32),
            },
            "conv2": {
                "w": jax.random.normal(next(keys), (3, d, d), jnp.float32) * 0.05,
                "b": jnp.zeros((d,), jnp.float32),
            },
            "pos": sinusoids(dims.n_audio_ctx, d),
            "blocks": _stack([enc_block() for _ in range(dims.n_audio_layer)]),
            "ln_post": _ln_init(d),
        },
        "decoder": {
            "tok_emb": jax.random.normal(next(keys), (dims.n_vocab, dt), jnp.float32) * 0.02,
            "pos": jax.random.normal(next(keys), (dims.n_text_ctx, dt), jnp.float32) * 0.02,
            "blocks": _stack([dec_block() for _ in range(dims.n_text_layer)]),
            "ln": _ln_init(dt),
        },
    }
    return jax.tree.map(lambda x: x.astype(dtype), params)


def init_params_np(dims: WhisperDims, seed: int = 0, dtype=np.float32) -> Params:
    """Numpy-RNG random parameters (same pytree as init_params).

    init_params draws each tensor via jax.random on the default device —
    hundreds of tiny programs, each compiled on a cold start. This
    host-side initializer generates every
    stacked per-layer tensor in ONE call (no per-layer allocations/stack
    copies) — large-v3 inits in seconds.
    """
    rng = np.random.default_rng(max(seed, 0))
    d, dt = dims.n_audio_state, dims.n_text_state
    La, Lt = dims.n_audio_layer, dims.n_text_layer

    def randn(*shape, scale=1.0):
        if seed < 0:
            # zeros mode: np.zeros is calloc-backed (shared zero pages, no
            # write faults) — the only fast option on hosts with slow
            # fresh-page writes; used by compile checks where weight values
            # are irrelevant
            return np.zeros(shape, dtype)
        out = rng.standard_normal(shape, dtype=np.float32)
        if scale != 1.0:
            out *= np.float32(scale)
        return out.astype(dtype, copy=False)

    def lin_stack(L, d_in, d_out, bias=True):
        p = {"w": randn(L, d_in, d_out, scale=1.0 / math.sqrt(d_in))}
        if bias:
            p["b"] = np.zeros((L, d_out), dtype)
        return p

    def ln_stack(L, dim):
        return {"g": np.ones((L, dim), dtype), "b": np.zeros((L, dim), dtype)}

    def attn_stack(L, dim, prefix=""):
        return {prefix + "q": lin_stack(L, dim, dim),
                prefix + "k": lin_stack(L, dim, dim, bias=False),
                prefix + "v": lin_stack(L, dim, dim),
                prefix + "o": lin_stack(L, dim, dim)}

    enc_blocks = {"attn_ln": ln_stack(La, d), **attn_stack(La, d),
                  "mlp_ln": ln_stack(La, d),
                  "fc1": lin_stack(La, d, 4 * d), "fc2": lin_stack(La, 4 * d, d)}
    dec_blocks = {"attn_ln": ln_stack(Lt, dt), **attn_stack(Lt, dt),
                  "cross_ln": ln_stack(Lt, dt), **attn_stack(Lt, dt, "c"),
                  "mlp_ln": ln_stack(Lt, dt),
                  "fc1": lin_stack(Lt, dt, 4 * dt), "fc2": lin_stack(Lt, 4 * dt, dt)}
    return {
        "encoder": {
            "conv1": {"w": randn(3, dims.n_mels, d, scale=0.05),
                      "b": np.zeros((d,), dtype)},
            "conv2": {"w": randn(3, d, d, scale=0.05),
                      "b": np.zeros((d,), dtype)},
            "pos": np.asarray(sinusoids(dims.n_audio_ctx, d), dtype),
            "blocks": enc_blocks,
            "ln_post": {"g": np.ones((d,), dtype), "b": np.zeros((d,), dtype)},
        },
        "decoder": {
            "tok_emb": randn(dims.n_vocab, dt, scale=0.02),
            "pos": randn(dims.n_text_ctx, dt, scale=0.02),
            "blocks": dec_blocks,
            "ln": {"g": np.ones((dt,), dtype), "b": np.zeros((dt,), dtype)},
        },
    }


def sinusoids(length: int, channels: int, max_timescale: float = 10_000.0) -> np.ndarray:
    """Sinusoidal position embedding (whisper encoder convention).
    Computed host-side (numpy): it is init-time-only data."""
    assert channels % 2 == 0
    log_timescale_increment = math.log(max_timescale) / (channels // 2 - 1)
    inv_timescales = np.exp(-log_timescale_increment * np.arange(channels // 2, dtype=np.float32))
    scaled_time = np.arange(length, dtype=np.float32)[:, None] * inv_timescales[None, :]
    return np.concatenate([np.sin(scaled_time), np.cos(scaled_time)], axis=1).astype(np.float32)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def _ln(x: jax.Array, p: Params, eps: float = 1e-5) -> jax.Array:
    """LayerNorm with f32 statistics regardless of activation dtype."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.var(xf, axis=-1, keepdims=True)
    y = (xf - mean) * jax.lax.rsqrt(var + eps)
    return (y * p["g"].astype(jnp.float32) + p["b"].astype(jnp.float32)).astype(x.dtype)


def _linear(x: jax.Array, p: Params) -> jax.Array:
    if "wq" in p:
        # int8 weight with per-output-channel scale: y = (x @ w_q) * s + b.
        # The dequant folds into the f32 output exactly; the int8 tensor is
        # the only weight HBM read (see quantize_block_weights).
        y = jnp.dot(x, p["wq"].astype(x.dtype), preferred_element_type=jnp.float32)
        y = y * p["ws"].astype(jnp.float32)
    else:
        y = jnp.dot(x, p["w"].astype(x.dtype), preferred_element_type=jnp.float32)
    if "b" in p:
        y = y + p["b"].astype(jnp.float32)
    return y.astype(x.dtype)


def _split_heads(x: jax.Array, n_head: int) -> jax.Array:
    # (..., T, d) -> (..., n_head, T, head_dim)
    *lead, t, d = x.shape
    x = x.reshape(*lead, t, n_head, d // n_head)
    return jnp.moveaxis(x, -2, -3)


def _heads_minor(x: jax.Array, n_head: int) -> jax.Array:
    # (..., T, d) -> (..., T, n_head, head_dim): a reshape, no transpose
    *lead, t, d = x.shape
    return x.reshape(*lead, t, n_head, d // n_head)


def _merge_heads(x: jax.Array) -> jax.Array:
    # (..., n_head, T, head_dim) -> (..., T, d)
    x = jnp.moveaxis(x, -3, -2)
    *lead, t, h, hd = x.shape
    return x.reshape(*lead, t, h * hd)


def _attention(q: jax.Array, k: jax.Array, v: jax.Array, mask: jax.Array | None) -> jax.Array:
    """softmax(q k^T / sqrt(dh)) v with f32 softmax. q,k,v: (..., H, T, Dh)."""
    scale = q.shape[-1] ** -0.5
    logits = jnp.einsum("...htd,...hsd->...hts", q, k, preferred_element_type=jnp.float32) * scale
    if mask is not None:
        logits = jnp.where(mask, logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("...hts,...hsd->...htd", weights, v, preferred_element_type=jnp.float32).astype(q.dtype)


def attention_impl(backend: str, dtype) -> str:
    """The `jax.nn.dot_product_attention` implementation for the encoder.

    A GPU with 16-bit operands gets cuDNN's fused flash attention, which
    never writes the (B, H, T, T) logits to device memory (f32 logits of a
    B=64 large-v3 window encode are ~11.5 GB per layer). Everything else
    (CPU, the float32 engine) gets XLA's plain composition."""
    if backend == "gpu" and jnp.dtype(dtype) in (jnp.dtype(jnp.bfloat16),
                                                 jnp.dtype(jnp.float16)):
        return "cudnn"
    return "xla"


def encoder_attention(q: jax.Array, k: jax.Array, v: jax.Array) -> jax.Array:
    """Unmasked self-attention of the encoder: softmax(q k^T / sqrt(dh)) v
    with an f32 softmax, as `_attention`. q, k, v: (B, T, H, Dh), the layout
    `_qkv_proj` gives the encoder, so no transpose is added. A shape cuDNN
    refuses raises; it never falls back quietly."""
    impl = attention_impl(jax.default_backend(), q.dtype)
    return jax.nn.dot_product_attention(q, k, v, implementation=impl)


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _conv1d(x: jax.Array, p: Params, stride: int) -> jax.Array:
    """NWC conv with 'same-ish' padding 1 (kernel 3), matching whisper's stem."""
    y = jax.lax.conv_general_dilated(
        x, p["w"].astype(x.dtype),
        window_strides=(stride,), padding=[(1, 1)],
        dimension_numbers=("NWC", "WIO", "NWC"),
        preferred_element_type=jnp.float32,
    )
    return (y + p["b"].astype(jnp.float32)).astype(x.dtype)


def encode(params: Params, dims: WhisperDims, mel: jax.Array,
           n_ctx_out: int | None = None) -> jax.Array:
    """mel (B, T_mel, n_mels) -> encoder states (B, n_ctx_out, d).

    n_ctx_out defaults to T_mel // 2. Passing fewer mel frames than 3000
    implements whisper.cpp's `audio_ctx` compute-saving mode
    (/root/reference/src/asr/whisper.rs:144,68).

    The (f32) log-mel is cast to the weights' compute dtype first, so a bf16
    engine encodes in bf16 end to end: f32 activations would run every
    matmul in TF32 on a GPU and keep attention off cuDNN.
    """
    p = params["encoder"]
    x = mel.astype(p["conv1"]["w"].dtype)
    x = jax.nn.gelu(_conv1d(x, p["conv1"], 1), approximate=False)
    x = jax.nn.gelu(_conv1d(x, p["conv2"], 2), approximate=False)
    t = x.shape[1] if n_ctx_out is None else n_ctx_out
    x = x[:, :t] + p["pos"][:t].astype(x.dtype)

    n_head = dims.n_audio_head

    def block(x, bp):
        h = _ln(x, bp["attn_ln"])
        q, k, v = _qkv_proj(h, bp, n_head, split=_heads_minor)
        attn = encoder_attention(q, k, v)
        x = x + _linear(attn.reshape(attn.shape[:-2] + (-1,)), bp["o"])
        h = _ln(x, bp["mlp_ln"])
        x = x + _linear(jax.nn.gelu(_linear(h, bp["fc1"]), approximate=False), bp["fc2"])
        return x, None

    x, _ = jax.lax.scan(block, x, p["blocks"])
    return _ln(x, p["ln_post"])


# ---------------------------------------------------------------------------
# decoder — KV cache for continuous batching
# ---------------------------------------------------------------------------

def init_cache(dims: WhisperDims, batch: int, n_audio_ctx: int | None = None, dtype=jnp.bfloat16,
               self_kv_int8: bool = False, t_text: int | None = None) -> Params:
    """Statically-shaped decode state for `batch` slots.

    KV is stored TIME-MINOR — self (L, B, H, Dh, n_text_ctx), cross
    (L, B, H, Dh, n_audio_ctx) — so the decode attention contracts q @ K
    and V @ w without any transpose, and a backend that tiles the minor
    axis to 128 pads 1500->1536 (2.4%) rather than head_dim=64 -> 128 (2x
    memory and KV bandwidth). Whether this layout suits the GPU is not yet
    measured.

    self_kv_int8: store the self-attention KV int8, quantized at write time
    with one f32 scale per written token (per (layer, slot, head, t));
    scales live in (L, B, H, T) tensors (~1.5% the KV bytes) and fold
    exactly into the attention math (see _cached_attention_q8t). Halves the
    self-KV footprint and per-step read traffic vs bf16.

    pos: (B,) int32 — per-slot write offset: slots decode at different
      offsets inside one compiled step.

    t_text caps the decode-position axis below dims.n_text_ctx (448) for
    short-generation serving — a 96-token streaming chunk fits in 128
    positions, cutting the self-KV pool (and its per-step read traffic)
    3.5x. Attention masks derive from the cache shape, not dims.
    """
    L, H, Dh = dims.n_text_layer, dims.n_text_head, dims.n_text_state // dims.n_text_head
    A = n_audio_ctx if n_audio_ctx is not None else dims.n_audio_ctx
    T = t_text if t_text is not None else dims.n_text_ctx
    cache = {
        "self_k": jnp.zeros((L, batch, H, Dh, T), jnp.int8 if self_kv_int8 else dtype),
        "self_v": jnp.zeros((L, batch, H, Dh, T), jnp.int8 if self_kv_int8 else dtype),
        "cross_k": jnp.zeros((L, batch, H, Dh, A), dtype),
        "cross_v": jnp.zeros((L, batch, H, Dh, A), dtype),
        "pos": jnp.zeros((batch,), jnp.int32),
    }
    if self_kv_int8:
        cache["self_k_scale"] = jnp.zeros((L, batch, H, T), jnp.float32)
        cache["self_v_scale"] = jnp.zeros((L, batch, H, T), jnp.float32)
    return cache


def _write_kv(cache_k: jax.Array, new_k: jax.Array, pos: jax.Array,
              uniform_pos: bool = False) -> jax.Array:
    """Scatter new keys at per-slot offsets along the minor (time) axis.
    cache_k: (B, H, Dh, T_max); new_k: (B, H, T_new, Dh); pos: (B,) int32.

    uniform_pos=True asserts every slot writes at the SAME offset (window-
    batched decode: all rows start and step together), turning the write
    into ONE batchwide dynamic_update_slice. The general per-slot form is a
    vmap'd DUS that XLA lowers to a serial B-iteration "sunk" while loop
    per layer per tensor — measured as the dominant decode overhead at
    B=32. Only the token-level slot pool needs the general form."""
    new_t = jnp.swapaxes(new_k, -1, -2)
    if uniform_pos:
        z = jnp.zeros((), jnp.int32)
        return jax.lax.dynamic_update_slice(cache_k, new_t, (z, z, z, pos[0]))

    def upd(c, n, p):
        return jax.lax.dynamic_update_slice(c, n, (0, 0, p))

    return jax.vmap(upd)(cache_k, new_t, pos)


def _write_scale(cache_s: jax.Array, new_s: jax.Array, pos: jax.Array,
                 uniform_pos: bool = False) -> jax.Array:
    """Scatter per-token KV scales at per-slot offsets.
    cache_s: (B, H, T_max) f32; new_s: (B, H, P) f32; pos: (B,) int32.

    The hot path (P == 1, every decode step) is a full-tensor select: XLA
    lowers the per-slot-offset vmap-DUS into a serial B-iteration "sunk"
    while loop (seen in the decode-step HLO), which costs more in launch
    overhead than rewriting this whole ~37 MB tensor does in bandwidth.
    (A take_along_axis gather formulation measured WORSE than the DUS
    loop — gathers over a (B,H,T) index tensor were slow; the KV tensors
    themselves stay on the DUS path, where a full rewrite would be ~0.6 GB
    per tensor per step.) Prefill (P > 1) keeps vmap-DUS: it runs once per
    window, so the serial loop amortizes."""
    B, H, P = new_s.shape
    if uniform_pos:
        z = jnp.zeros((), jnp.int32)
        return jax.lax.dynamic_update_slice(cache_s, new_s, (z, z, pos[0]))
    if P == 1:
        sel = jnp.arange(cache_s.shape[-1])[None, None, :] == pos[:, None, None]
        return jnp.where(sel, new_s, cache_s)

    def upd(c, n, p):
        return jax.lax.dynamic_update_slice(c, n, (0, p))

    return jax.vmap(upd)(cache_s, new_s, pos)


def _quantize_kv_rows(x: jax.Array):
    """Symmetric per-token int8 quantization of new KV rows.
    x: (B, H, P, Dh) -> (int8 (B, H, P, Dh), f32 scales (B, H, P))."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return q, scale[..., 0]


def flush_ring_rows(ring_k: jax.Array, ring_v: jax.Array, page_dtype,
                    at: jax.Array, k_scale: jax.Array | None = None,
                    v_scale: jax.Array | None = None):
    """The ONE flush-time quantize-or-cast of bf16 ring rows, shared by
    flush_ring (full windows), SlotPool and BeamSlotPool (tune-or-delete
    review: the pattern was copy-pasted three times and a future change to
    the quantization would silently diverge the three numerics).

    ring_k/ring_v (..., W, Dh) row-major -> returns (rk, rv, extra):
    rk/rv (..., Dh, W) page-layout blocks for the caller's uniform page
    DUS at column `at`; extra = {"self_k_scale": ..., "self_v_scale": ...}
    scale tensors already DUS'd at (0,0,0,at) when page_dtype is int8
    (flush-time per-token quantization via _quantize_kv_rows — the
    write-time path paid quantize+scale-write EVERY step and measured
    speed-neutral; amortized W-fold at the flush it wins), else
    {} and a plain cast."""
    z = jnp.zeros((), jnp.int32)
    if page_dtype == jnp.int8:
        rkq, rks = _quantize_kv_rows(ring_k)   # (..., W, Dh), (..., W)
        rvq, rvs = _quantize_kv_rows(ring_v)
        rk = jnp.swapaxes(rkq, -1, -2)
        rv = jnp.swapaxes(rvq, -1, -2)
        extra = {
            "self_k_scale": jax.lax.dynamic_update_slice(
                k_scale, rks, (z, z, z, at)),
            "self_v_scale": jax.lax.dynamic_update_slice(
                v_scale, rvs, (z, z, z, at))}
    else:
        rk = jnp.swapaxes(ring_k, -1, -2).astype(page_dtype)
        rv = jnp.swapaxes(ring_v, -1, -2).astype(page_dtype)
        extra = {}
    return rk, rv, extra


def _quantize_kv_pages(x: jax.Array):
    """Per-token int8 quantization of TIME-MINOR KV pages (the Dh axis is
    second-minor): x (..., Dh, T) -> (int8 (..., Dh, T), f32 (..., T))."""
    xf = x.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-2, keepdims=True)
    scale = jnp.maximum(amax, 1e-8) / 127.0
    q = jnp.clip(jnp.round(xf / scale), -127, 127).astype(jnp.int8)
    return q, scale[..., 0, :]


def _cached_attention(q: jax.Array, k: jax.Array, v: jax.Array,
                      mask: jax.Array | None) -> jax.Array:
    """Attention over time-minor cached KV. q: (B, H, P, Dh);
    k, v: (B, H, Dh, T); mask: broadcastable to (B, H, P, T)."""
    scale = q.shape[-1] ** -0.5
    logits = jnp.einsum("bhpd,bhdt->bhpt", q, k, preferred_element_type=jnp.float32) * scale
    if mask is not None:
        logits = jnp.where(mask, logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("bhpt,bhdt->bhpd", weights, v, preferred_element_type=jnp.float32).astype(q.dtype)


def _cached_attention_q8(q: jax.Array, kq: jax.Array, vq: jax.Array,
                         ks: jax.Array, vs: jax.Array,
                         mask: jax.Array | None) -> jax.Array:
    """Attention over int8 time-minor KV with per-channel scales.
    q (B,H,P,Dh); kq/vq int8 (B,H,Dh,T); ks/vs f32 (B,H,Dh,1).
    Exact folding: scales move into q (keys) and the output (values)."""
    scale = q.shape[-1] ** -0.5
    q_scaled = (q.astype(jnp.float32) * jnp.swapaxes(ks, -1, -2)).astype(q.dtype)
    logits = jnp.einsum("bhpd,bhdt->bhpt", q_scaled, kq.astype(q.dtype),
                        preferred_element_type=jnp.float32) * scale
    if mask is not None:
        logits = jnp.where(mask, logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    out = jnp.einsum("bhpt,bhdt->bhpd", weights, vq.astype(q.dtype),
                     preferred_element_type=jnp.float32)
    return (out * jnp.swapaxes(vs, -1, -2)).astype(q.dtype)


def _joint_decode_attention(q: jax.Array, k_cache: jax.Array, v_cache: jax.Array,
                            k_new: jax.Array, v_new: jax.Array,
                            mask: jax.Array) -> jax.Array:
    """Single-query self-attention over cached KV (where `mask` is True) PLUS
    the current token's k/v as one extra softmax column — mathematically
    identical to writing k/v first and attending to keys <= current, but
    WITHOUT the per-layer cache write. The write is deferred and batched
    across all layers after the scan (see decode_step): the per-layer vmap'd
    per-slot dynamic_update_slice lowers to a serial B-iteration loop, which
    measured as most of the decode step at B=32 on large-v3.

    q, k_new, v_new: (B, H, 1, Dh); k_cache/v_cache: (B, H, Dh, T);
    mask: True where a cached key is valid, broadcastable to (B, H, 1, T).
    """
    T = k_cache.shape[-1]
    scale = q.shape[-1] ** -0.5
    logits = jnp.einsum("bhpd,bhdt->bhpt", q, k_cache.astype(q.dtype),
                        preferred_element_type=jnp.float32) * scale
    logits = jnp.where(mask, logits, -1e30)
    logit_self = jnp.sum(q.astype(jnp.float32) * k_new.astype(jnp.float32),
                         axis=-1, keepdims=True) * scale       # (B, H, 1, 1)
    joint = jax.nn.softmax(jnp.concatenate([logits, logit_self], axis=-1), axis=-1)
    wc, ws = joint[..., :T].astype(q.dtype), joint[..., T:]
    out = jnp.einsum("bhpt,bhdt->bhpd", wc, v_cache.astype(q.dtype),
                     preferred_element_type=jnp.float32)
    out = out + ws * v_new.astype(jnp.float32)
    return out.astype(q.dtype)


def _joint_decode_attention_q8t(q: jax.Array, kq: jax.Array, vq: jax.Array,
                                ks: jax.Array, vs: jax.Array,
                                k_new: jax.Array, v_new: jax.Array,
                                mask: jax.Array) -> jax.Array:
    """Deferred-write joint attention over the int8 per-token-scaled self-KV
    cache plus the current token's (full-precision) k/v column.
    q, k_new, v_new (B,H,1,Dh); kq/vq int8 (B,H,Dh,T); ks/vs f32 (B,H,T);
    mask: True where a cached key is valid, broadcastable to (B, H, 1, T)."""
    T = kq.shape[-1]
    scale = q.shape[-1] ** -0.5
    logits = jnp.einsum("bhpd,bhdt->bhpt", q, kq.astype(q.dtype),
                        preferred_element_type=jnp.float32)
    logits = logits * (ks[:, :, None, :] * scale)
    logits = jnp.where(mask, logits, -1e30)
    logit_self = jnp.sum(q.astype(jnp.float32) * k_new.astype(jnp.float32),
                         axis=-1, keepdims=True) * scale
    joint = jax.nn.softmax(jnp.concatenate([logits, logit_self], axis=-1), axis=-1)
    wc = (joint[..., :T] * vs[:, :, None, :]).astype(q.dtype)
    ws = joint[..., T:]
    out = jnp.einsum("bhpt,bhdt->bhpd", wc, vq.astype(q.dtype),
                     preferred_element_type=jnp.float32)
    out = out + ws * v_new.astype(jnp.float32)
    return out.astype(q.dtype)


def _cached_attention_q8t(q: jax.Array, kq: jax.Array, vq: jax.Array,
                          ks: jax.Array, vs: jax.Array,
                          mask: jax.Array | None) -> jax.Array:
    """Attention over int8 time-minor KV with PER-TOKEN scales (the
    write-time-quantized self-KV). q (B,H,P,Dh); kq/vq int8 (B,H,Dh,T);
    ks/vs f32 (B,H,T). Exact folding: a key scale multiplies its logit
    column; a value scale multiplies its softmax weight before the V matmul:
      logits[:, t] = (q @ kq[:, t]) * ks[t]
      out = (w * vs) @ vq
    """
    scale = q.shape[-1] ** -0.5
    logits = jnp.einsum("bhpd,bhdt->bhpt", q, kq.astype(q.dtype),
                        preferred_element_type=jnp.float32)
    logits = logits * (ks[:, :, None, :] * scale)
    if mask is not None:
        logits = jnp.where(mask, logits, -1e30)
    weights = jax.nn.softmax(logits, axis=-1)
    weights = (weights * vs[:, :, None, :]).astype(q.dtype)
    return jnp.einsum("bhpt,bhdt->bhpd", weights, vq.astype(q.dtype),
                      preferred_element_type=jnp.float32).astype(q.dtype)


def _dec_block_factory(dims: WhisperDims, cross_quant: bool = False,
                       self_quant: bool = False, uniform_pos: bool = False,
                       defer_write: bool = False):
    n_head = dims.n_text_head

    def block(carry, xs):
        x, pos, mask = carry
        bp = xs["bp"]
        # self-attention with cache (time-minor KV)
        h = _ln(x, bp["attn_ln"])
        q, k_new, v_new = _qkv_proj(h, bp, n_head)
        out = {}
        if defer_write and self_quant:
            # mask carries CACHED-key validity (strict — the current token is
            # the joint column, not yet written)
            attn = _joint_decode_attention_q8t(q, xs["sk"], xs["sv"],
                                               xs["sks"], xs["svs"],
                                               k_new, v_new, mask)
            kq, ksc = _quantize_kv_rows(k_new)
            vq, vsc = _quantize_kv_rows(v_new)
            out.update(k_new=jnp.swapaxes(kq, -1, -2),
                       v_new=jnp.swapaxes(vq, -1, -2),
                       ks_new=ksc, vs_new=vsc)
        elif defer_write:
            # no cache write in-layer: joint attention over stale cache + the
            # new token; k/v emitted as scan outputs, written batched across
            # layers afterwards (decode_step)
            attn = _joint_decode_attention(q, xs["sk"], xs["sv"], k_new, v_new, mask)
            out.update(k_new=jnp.swapaxes(k_new, -1, -2).astype(xs["sk"].dtype),
                       v_new=jnp.swapaxes(v_new, -1, -2).astype(xs["sv"].dtype))
        elif self_quant:
            kq, ksc = _quantize_kv_rows(k_new)
            vq, vsc = _quantize_kv_rows(v_new)
            sk = _write_kv(xs["sk"], kq, pos, uniform_pos)
            sv = _write_kv(xs["sv"], vq, pos, uniform_pos)
            sks = _write_scale(xs["sks"], ksc, pos, uniform_pos)
            svs = _write_scale(xs["svs"], vsc, pos, uniform_pos)
            attn = _cached_attention_q8t(q, sk, sv, sks, svs, mask)
            out.update(sks=sks, svs=svs)
        else:
            sk = _write_kv(xs["sk"], k_new.astype(xs["sk"].dtype), pos, uniform_pos)
            sv = _write_kv(xs["sv"], v_new.astype(xs["sv"].dtype), pos, uniform_pos)
            attn = _cached_attention(q, sk.astype(q.dtype), sv.astype(q.dtype), mask)
        if not defer_write:
            out.update(sk=sk, sv=sv)
        x = x + _linear(_merge_heads(attn), bp["o"])
        # cross-attention over precomputed encoder KV
        h = _ln(x, bp["cross_ln"])
        cq = _split_heads(_linear(h, bp["cq"]), n_head)
        if cross_quant:
            cattn = _cached_attention_q8(cq, xs["ck"], xs["cv"], xs["cks"], xs["cvs"], None)
        else:
            cattn = _cached_attention(cq, xs["ck"].astype(cq.dtype), xs["cv"].astype(cq.dtype), None)
        x = x + _linear(_merge_heads(cattn), bp["co"])
        # mlp
        h = _ln(x, bp["mlp_ln"])
        x = x + _linear(jax.nn.gelu(_linear(h, bp["fc1"]), approximate=False), bp["fc2"])
        return (x, pos, mask), out

    return block


def _dec_scan_xs(params: Params, cache: Params):
    """Assemble the per-layer scan inputs from a cache dict; returns
    (xs, cross_quant, self_quant)."""
    cross_quant = "cross_k_scale" in cache
    self_quant = "self_k_scale" in cache
    xs = {"bp": params["decoder"]["blocks"],
          "sk": cache["self_k"], "sv": cache["self_v"],
          "ck": cache["cross_k"], "cv": cache["cross_v"]}
    if cross_quant:
        xs.update(cks=cache["cross_k_scale"], cvs=cache["cross_v_scale"])
    if self_quant:
        xs.update(sks=cache["self_k_scale"], svs=cache["self_v_scale"])
    return xs, cross_quant, self_quant


def _dec_scan_out_to_cache(cache: Params, out: dict, new_pos: jax.Array) -> Params:
    cache = {**cache, "self_k": out["sk"], "self_v": out["sv"], "pos": new_pos}
    if "sks" in out:
        cache["self_k_scale"] = out["sks"]
        cache["self_v_scale"] = out["svs"]
    return cache


def compute_cross_kv(params: Params, dims: WhisperDims, enc_out: jax.Array, dtype=jnp.bfloat16,
                     int8: bool = False):
    """Encoder states -> stacked cross-attention K/V, time-minor:
    (L, B, H, Dh, A) each. Computed once per 30 s window; reused across every
    decode step of that window (and across beam hypotheses).

    int8=True quantizes per (layer, slot, head, channel) INSIDE the per-layer
    map (returns (kq, vq, k_scale, v_scale) — same contract as
    quantize_cross_kv): the bf16 tensors never round-trip through HBM
    (~12 GB of traffic per B=32 large-v3 window batch otherwise)."""
    n_head = dims.n_text_head

    def per_layer(bp):
        k = _split_heads(_linear(enc_out, bp["ck"]), n_head)
        v = _split_heads(_linear(enc_out, bp["cv"]), n_head)
        k = jnp.swapaxes(k, -1, -2)
        v = jnp.swapaxes(v, -1, -2)
        if int8:
            def q8(x):
                amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
                scale = jnp.maximum(amax, 1e-8) / 127.0
                q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale),
                             -127, 127).astype(jnp.int8)
                return q, scale

            kq, ks = q8(k)
            vq, vs = q8(v)
            return kq, vq, ks, vs
        return k.astype(dtype), v.astype(dtype)

    return jax.lax.map(per_layer, params["decoder"]["blocks"])


def fuse_qkv_weights(params: Params, encoder: bool = True) -> Params:
    """Concatenate each block's q/k/v projections into ONE (d, 3d) linear
    ("qkv"): a single matmul per layer instead of three, which matters in
    the decode step where the (B, d) activation is tiny and the weight read
    dominates — fewer ops in the scan body, one weight-load pipeline instead
    of three. k has no bias in whisper; the fused bias zero-fills that third.
    The block factories detect "qkv" and split the output. Apply BEFORE
    quantize_block_weights (the fused "w" is (L, d, 3d) and quantizes
    per-output-channel exactly like the separate tensors would).

    Returns HOST (numpy) tensors for the fused entries: callers place them
    on device afterwards (jit argument upload or an explicit tree_map).
    Running this on device-resident arrays works but fetches the q/k/v
    weights back to host first — ~600 MB for large-v3 — so engines apply
    it before device placement. Idempotent
    (already-fused blocks pass through)."""
    import numpy as onp

    def fuse(blocks):
        if "qkv" in blocks:
            return blocks
        d = blocks["q"]["w"].shape[-1]
        out = {k: v for k, v in blocks.items() if k not in ("q", "k", "v")}
        wq, wk, wv = blocks["q"]["w"], blocks["k"]["w"], blocks["v"]["w"]
        w = onp.concatenate([onp.asarray(wq), onp.asarray(wk), onp.asarray(wv)], axis=-1)
        L = w.shape[0]
        b = onp.concatenate([
            onp.asarray(blocks["q"]["b"]),
            onp.zeros((L, d), onp.asarray(blocks["q"]["b"]).dtype),
            onp.asarray(blocks["v"]["b"]),
        ], axis=-1)
        out["qkv"] = {"w": w, "b": b}
        return out

    new = dict(params)
    new["decoder"] = {**params["decoder"],
                      "blocks": fuse(params["decoder"]["blocks"])}
    if encoder:
        new["encoder"] = {**params["encoder"],
                          "blocks": fuse(params["encoder"]["blocks"])}
    return new


def _qkv_proj(h: jax.Array, bp: Params, n_head: int, split=None):
    """q/k/v projections, fused when the params carry a "qkv" entry. split
    lays out the heads: _split_heads (..., H, T, Dh) by default, or
    _heads_minor (..., T, H, Dh) for the encoder."""
    split = split or _split_heads
    if "qkv" in bp:
        d = h.shape[-1]
        qkv = _linear(h, bp["qkv"])
        q, k, v = qkv[..., :d], qkv[..., d:2 * d], qkv[..., 2 * d:]
    else:
        q, k, v = _linear(h, bp["q"]), _linear(h, bp["k"]), _linear(h, bp["v"])
    return split(q, n_head), split(k, n_head), split(v, n_head)


def quantize_block_weights(params: Params, encoder: bool = False) -> Params:
    """Symmetric per-output-channel int8 quantization of the transformer
    block linear weights (the stacked (L, d_in, d_out) tensors): each "w"
    becomes int8 "wq" + f32 "ws" (L, 1, d_out). Decoder blocks are read
    every decode step (~1.5 GB/step bf16 for large-v3) — int8 halves that;
    the encoder runs once per window (compute-bound), so it is quantized
    only on request. Embeddings/layer norms stay full precision.

    Same recipe as whisper.cpp's q8_0 weights (the reference's download
    script fetches -q5/-q8 variants, download-ggml-model.sh:28-54) but with
    per-channel instead of per-32-block scales.
    """
    import numpy as onp

    def quant_tree(blocks):
        out = {}
        for name, sub in blocks.items():
            if isinstance(sub, dict) and "w" in sub and getattr(sub["w"], "ndim", 0) == 3:
                w = onp.asarray(sub["w"], onp.float32)
                amax = onp.abs(w).max(axis=1, keepdims=True)  # (L, 1, d_out)
                ws = onp.maximum(amax, 1e-8) / 127.0
                wq = onp.clip(onp.rint(w / ws), -127, 127).astype(onp.int8)
                # host tensors out (see fuse_qkv_weights): the caller device-
                # places them; "ws" must STAY f32 through that placement —
                # bf16 scales would add ~0.4% relative error on top of the
                # int8 rounding
                q = {"wq": wq, "ws": ws.astype(onp.float32)}
                if "b" in sub:
                    q["b"] = sub["b"]
                out[name] = q
            else:
                out[name] = sub
        return out

    new = dict(params)
    new["decoder"] = {**params["decoder"],
                      "blocks": quant_tree(params["decoder"]["blocks"])}
    if encoder:
        new["encoder"] = {**params["encoder"],
                          "blocks": quant_tree(params["encoder"]["blocks"])}
    return new


def quantize_cross_kv(ck: jax.Array, cv: jax.Array):
    """Symmetric per-(layer, slot, head, channel) int8 quantization of the
    cross-attention KV — the dominant decode-time device-memory traffic.
    Scales fold into the attention math exactly:
      logits = (q * k_scale) @ k_q        (scale per Dh channel)
      out    = v_scale * (w @ v_q)
    so the int8 tensors are the only per-step KV reads (2x fewer bytes than
    bf16, and half the KV memory).
    Input/output time-minor (L, B, H, Dh, A); scales (L, B, H, Dh, 1) f32.
    """
    def q8(x):
        amax = jnp.max(jnp.abs(x.astype(jnp.float32)), axis=-1, keepdims=True)
        scale = jnp.maximum(amax, 1e-8) / 127.0
        q = jnp.clip(jnp.round(x.astype(jnp.float32) / scale), -127, 127).astype(jnp.int8)
        return q, scale

    kq, ks = q8(ck)
    vq, vs = q8(cv)
    return kq, vq, ks, vs


def _decoder_tail(params: Params, x: jax.Array) -> jax.Array:
    p = params["decoder"]
    x = _ln(x, p["ln"])
    logits = jnp.dot(x, p["tok_emb"].astype(x.dtype).T, preferred_element_type=jnp.float32)
    return logits  # f32 (..., T, n_vocab)


def decode_prefill(params: Params, dims: WhisperDims, tokens: jax.Array, cache: Params,
                   prompt_len: jax.Array | None = None, uniform_pos: bool = False):
    """Run a prompt of P tokens through the decoder, writing self-KV at
    positions [pos, pos+P). tokens: (B, P) int32. Returns (logits (B,P,V),
    cache'). Padded prompt positions (>= prompt_len) still write KV but are
    masked from attention by later steps via cache['pos'].

    uniform_pos: static promise that all slots are at the same position
    (see _write_kv) — enables the batchwide-DUS fast path.
    """
    p = params["decoder"]
    B, P = tokens.shape
    pos = cache["pos"]
    dtype = p["tok_emb"].dtype
    x = p["tok_emb"][tokens] + jax.lax.dynamic_slice_in_dim(p["pos"], 0, P, 0)[None].astype(dtype)
    # causal mask offset by per-slot pos: query i attends keys <= pos + i
    q_idx = pos[:, None, None, None] + jnp.arange(P)[None, None, :, None]
    k_idx = jnp.arange(cache["self_k"].shape[-1])[None, None, None, :]
    mask = k_idx <= q_idx  # (B, 1, P, T_max)

    xs, cross_quant, self_quant = _dec_scan_xs(params, cache)
    block = _dec_block_factory(dims, cross_quant=cross_quant, self_quant=self_quant,
                               uniform_pos=uniform_pos)
    (x, _, _), out = jax.lax.scan(block, (x, pos, mask), xs)
    new_len = P if prompt_len is None else prompt_len
    cache = _dec_scan_out_to_cache(cache, out, pos + new_len)
    return _decoder_tail(params, x), cache


def init_ring(dims: WhisperDims, batch: int, width: int = 16, dtype=jnp.bfloat16) -> Params:
    """Chunk-local KV ring for ring-buffered decoding (decode_step_ring).

    Why it exists: ANY per-step write into the big
    self-KV cache — per-slot DUS loop, full-tensor select, even a single
    batchwide DUS at a scalar offset — makes XLA materialize a fresh copy of
    the whole cache every step (the cache is both a layer-scan operand and
    the write target, so it cannot update in place).
    The ring bounds the per-step copy to W columns: steps write here, and
    flush_ring folds W columns into the big cache ONCE per chunk, amortizing
    the unavoidable big copy W-fold.

    Layout is ROW-major (L, B, H, W, Dh) — not time-minor like the big
    cache: new k/v rows are (B, H, 1, Dh), so the per-step ring write needs
    no transpose, and a W-minor ring would pad W up to 128 on a backend that
    tiles the minor axis to 128 (4x waste at W=32). The flush transposes
    once per chunk."""
    L, H, Dh = dims.n_text_layer, dims.n_text_head, dims.n_text_state // dims.n_text_head
    return {
        "k": jnp.zeros((L, batch, H, width, Dh), dtype),
        "v": jnp.zeros((L, batch, H, width, Dh), dtype),
        "n": jnp.zeros((), jnp.int32),
    }


def flush_ring(cache: Params, ring: Params) -> tuple[Params, Params]:
    """Fold the ring's n valid columns into the fill-layout cache at
    [gen_base + fill, ...) and reset the ring. Writes the full W-column
    window (garbage beyond n stays masked by `fill` accounting and is
    overwritten by the next flush); requires the cache time axis to hold
    gen_base + round_up(max_new, W) columns so the window never clamps.

    INT8 pages (self_k_scale present): the bf16 ring rows quantize HERE —
    once per W steps, batched over (L,B,H,W) — and the per-token scales
    land in the (L,B,H,T) scale tensors with a second DUS at the same
    column. Flush-time quantization is what makes int8 self-KV a WIN:
    the write-time path paid quantize+scale-write every step and measured
    speed-neutral."""
    z = jnp.zeros((), jnp.int32)
    at = cache["gen_base"] + cache["fill"]
    rk, rv, extra = flush_ring_rows(
        ring["k"], ring["v"], cache["self_k"].dtype, at,
        cache.get("self_k_scale"), cache.get("self_v_scale"))
    cache = {**cache, **extra,
             "self_k": jax.lax.dynamic_update_slice(
                 cache["self_k"], rk, (z, z, z, z, at)),
             "self_v": jax.lax.dynamic_update_slice(
                 cache["self_v"], rv, (z, z, z, z, at)),
             "fill": cache["fill"] + ring["n"]}
    return cache, {**ring, "n": jnp.zeros((), jnp.int32)}


def _joint_decode_attention_ring(q, k_cache, v_cache, mask_cache,
                                 k_ring, v_ring, mask_ring, k_new, v_new):
    """Single-query attention over THREE key groups in one softmax: the big
    cache (prompt + archived generations), the chunk-local ring, and the
    current token's k/v column. Exact same math as a fully-written cache.
    q, k_new, v_new (B,H,1,Dh); k_cache/v_cache (B,H,Dh,T);
    k_ring/v_ring (B,H,W,Dh) ROW-major; masks broadcastable to (B,H,1,T|W)."""
    T = k_cache.shape[-1]
    W = k_ring.shape[-2]
    scale = q.shape[-1] ** -0.5
    lc = jnp.einsum("bhpd,bhdt->bhpt", q, k_cache.astype(q.dtype),
                    preferred_element_type=jnp.float32) * scale
    lc = jnp.where(mask_cache, lc, -1e30)
    lr = jnp.einsum("bhpd,bhwd->bhpw", q, k_ring.astype(q.dtype),
                    preferred_element_type=jnp.float32) * scale
    lr = jnp.where(mask_ring, lr, -1e30)
    ls = jnp.sum(q.astype(jnp.float32) * k_new.astype(jnp.float32),
                 axis=-1, keepdims=True) * scale
    joint = jax.nn.softmax(jnp.concatenate([lc, lr, ls], axis=-1), axis=-1)
    wc = joint[..., :T].astype(q.dtype)
    wr = joint[..., T:T + W].astype(q.dtype)
    ws = joint[..., T + W:]
    out = jnp.einsum("bhpt,bhdt->bhpd", wc, v_cache.astype(q.dtype),
                     preferred_element_type=jnp.float32)
    out = out + jnp.einsum("bhpw,bhwd->bhpd", wr, v_ring.astype(q.dtype),
                           preferred_element_type=jnp.float32)
    out = out + ws * v_new.astype(jnp.float32)
    return out.astype(q.dtype)


def _joint_decode_attention_ring_q8t(q, kq, vq, ks, vs, mask_cache,
                                     k_ring, v_ring, mask_ring, k_new, v_new):
    """_joint_decode_attention_ring over an INT8 per-token-scaled big cache:
    the archived columns are int8 with (B,H,T) f32 scales (folded exactly —
    a key scale multiplies its logit column, a value scale its softmax
    weight); the chunk-local ring and the current column stay bf16, so the
    quantization boundary is the flush. q, k_new, v_new (B,H,1,Dh);
    kq/vq int8 (B,H,Dh,T); ks/vs f32 (B,H,T); k_ring/v_ring (B,H,W,Dh)
    ROW-major; masks broadcastable to (B,H,1,T|W)."""
    T = kq.shape[-1]
    W = k_ring.shape[-2]
    scale = q.shape[-1] ** -0.5
    lc = jnp.einsum("bhpd,bhdt->bhpt", q, kq.astype(q.dtype),
                    preferred_element_type=jnp.float32)
    lc = lc * (ks[:, :, None, :] * scale)
    lc = jnp.where(mask_cache, lc, -1e30)
    lr = jnp.einsum("bhpd,bhwd->bhpw", q, k_ring.astype(q.dtype),
                    preferred_element_type=jnp.float32) * scale
    lr = jnp.where(mask_ring, lr, -1e30)
    ls = jnp.sum(q.astype(jnp.float32) * k_new.astype(jnp.float32),
                 axis=-1, keepdims=True) * scale
    joint = jax.nn.softmax(jnp.concatenate([lc, lr, ls], axis=-1), axis=-1)
    wc = (joint[..., :T] * vs[:, :, None, :]).astype(q.dtype)
    wr = joint[..., T:T + W].astype(q.dtype)
    ws = joint[..., T + W:]
    out = jnp.einsum("bhpt,bhdt->bhpd", wc, vq.astype(q.dtype),
                     preferred_element_type=jnp.float32)
    out = out + jnp.einsum("bhpw,bhwd->bhpd", wr, v_ring.astype(q.dtype),
                           preferred_element_type=jnp.float32)
    out = out + ws * v_new.astype(jnp.float32)
    return out.astype(q.dtype)


def decode_step_ring(params: Params, dims: WhisperDims, token: jax.Array,
                     cache: Params, ring: Params,
                     mask_cache: jax.Array | None = None,
                     mask_ring: jax.Array | None = None):
    """One autoregressive step with ring-buffered self-KV writes.

    cache is READ-ONLY here. By default it must be fill-layout
    (arm_uniform_fill): `fill` counts ARCHIVED (flushed) columns and the
    cache-validity mask is derived from fill/gen_base/pos. A caller with a
    different column layout (the slot pool's CIRCULAR pages) passes its own
    mask_cache (broadcastable to (B, H, 1, T); True = cached key valid) and
    then fill/gen_base need not be present.

    The current chunk's generations live in `ring` (written at the scalar
    row ring["n"]). Flush every W steps (flush_ring, or the pool's circular
    flush). The big self-KV pages may be INT8 with per-token scales
    (self_k_scale/self_v_scale, (L,B,H,T)): the ring stays bf16 and the
    flush quantizes (flush-time quantization amortizes the
    quantize cost W-fold vs the write-time path that measured
    speed-neutral, and the archived-page reads are the largest byte
    stream of the step)."""
    p = params["decoder"]
    pos = cache["pos"]
    dtype = p["tok_emb"].dtype
    x = p["tok_emb"][token][:, None, :] + p["pos"][pos][:, None, :].astype(dtype)
    T = cache["self_k"].shape[-1]
    W = ring["k"].shape[-2]
    k_idx = jnp.arange(T)[None, None, None, :]
    w_idx = jnp.arange(W)[None, None, None, :]
    n = ring["n"]
    if mask_cache is None:
        fill, base = cache["fill"], cache["gen_base"]
        prompt_len = pos - (fill + n)
        mask_cache = ((k_idx < prompt_len[:, None, None, None])
                      | ((k_idx >= base) & (k_idx < base + fill)))
    if mask_ring is None:
        mask_ring = w_idx < n
    # else: caller-supplied (broadcastable to (B, H, 1, W)) — the slot
    # pool's MID-RING admissions mask a new occupant's pre-admission ring
    # rows (they hold the previous occupant's writes from this chunk)
    n_head = dims.n_text_head
    cross_quant = "cross_k_scale" in cache
    self_quant = "self_k_scale" in cache

    def block(carry, xs):
        x, = carry
        bp = xs["bp"]
        h = _ln(x, bp["attn_ln"])
        q, k_new, v_new = _qkv_proj(h, bp, n_head)
        if self_quant:
            attn = _joint_decode_attention_ring_q8t(
                q, xs["sk"], xs["sv"], xs["sks"], xs["svs"], mask_cache,
                xs["rk"], xs["rv"], mask_ring, k_new, v_new)
        else:
            attn = _joint_decode_attention_ring(
                q, xs["sk"], xs["sv"], mask_cache,
                xs["rk"], xs["rv"], mask_ring, k_new, v_new)
        x = x + _linear(_merge_heads(attn), bp["o"])
        h = _ln(x, bp["cross_ln"])
        cq = _split_heads(_linear(h, bp["cq"]), n_head)
        if cross_quant:
            cattn = _cached_attention_q8(cq, xs["ck"], xs["cv"], xs["cks"], xs["cvs"], None)
        else:
            cattn = _cached_attention(cq, xs["ck"].astype(cq.dtype), xs["cv"].astype(cq.dtype), None)
        x = x + _linear(_merge_heads(cattn), bp["co"])
        h = _ln(x, bp["mlp_ln"])
        x = x + _linear(jax.nn.gelu(_linear(h, bp["fc1"]), approximate=False), bp["fc2"])
        # ring rows are (B, H, 1, Dh) — written row-major, no transpose
        return (x,), (k_new.astype(xs["rk"].dtype), v_new.astype(xs["rv"].dtype))

    xs = {"bp": p["blocks"], "sk": cache["self_k"], "sv": cache["self_v"],
          "ck": cache["cross_k"], "cv": cache["cross_v"],
          "rk": ring["k"], "rv": ring["v"]}
    if cross_quant:
        xs.update(cks=cache["cross_k_scale"], cvs=cache["cross_v_scale"])
    if self_quant:
        xs.update(sks=cache["self_k_scale"], svs=cache["self_v_scale"])
    (x,), (k_new, v_new) = jax.lax.scan(block, (x,), xs)
    # k_new/v_new: (L, B, H, 1, Dh) — one row-major DUS at scalar row n
    z = jnp.zeros((), jnp.int32)
    ring = {"k": jax.lax.dynamic_update_slice(ring["k"], k_new, (z, z, z, n, z)),
            "v": jax.lax.dynamic_update_slice(ring["v"], v_new, (z, z, z, n, z)),
            "n": n + 1}
    cache = {**cache, "pos": pos + 1}
    return _decoder_tail(params, x)[:, 0, :], cache, ring


def arm_uniform_fill(cache: Params, gen_base: int) -> Params:
    """Arm a freshly prefilled cache for UNIFORM-FILL decoding: generated
    tokens' KV is packed at [gen_base, gen_base + fill) where `fill` is a
    scalar step counter shared by every slot — so the deferred self-KV write
    in decode_step(kv_write="uniform") is one plain batchwide
    dynamic_update_slice at a scalar offset instead of a serial per-slot
    loop (measured as about half the decode step at B=32 large-v3). Works
    with variable-length right-padded prompts: the padding gap
    [prompt_len_b, gen_base) is masked out of attention forever.

    gen_base must be the prefill's padded prompt length P."""
    return {**cache, "fill": jnp.zeros((), jnp.int32),
            "gen_base": jnp.asarray(gen_base, jnp.int32)}


def decode_step(params: Params, dims: WhisperDims, token: jax.Array, cache: Params,
                uniform_pos: bool = False, kv_write: str = "dus"):
    """One autoregressive step for all slots. token: (B,) int32.
    Returns (logits (B, V), cache').

    The self-KV write is DEFERRED out of the layer scan: each layer attends
    jointly over its (stale) cache plus the new token's k/v
    (_joint_decode_attention) and emits k/v as scan outputs; ONE vmap'd
    dynamic_update_slice then writes all L layers' columns. This replaces
    2L per-layer serialized B-iteration write loops with a single one,
    which measured as most of the decode step at B=32 large-v3."""
    p = params["decoder"]
    B = token.shape[0]
    pos = cache["pos"]
    dtype = p["tok_emb"].dtype
    x = p["tok_emb"][token][:, None, :] + p["pos"][pos][:, None, :].astype(dtype)  # (B,1,d)
    k_idx = jnp.arange(cache["self_k"].shape[-1])[None, None, None, :]

    uniform_fill = kv_write == "uniform" and "fill" in cache
    defer = True  # deferred self-KV writes (the only production path; the
    #               eager in-layer write existed for the deleted Pallas
    #               decode kernel and as the self_quant legacy path below)
    if defer and uniform_fill:
        # fill-layout cache (see arm_uniform_fill): prompt KV at
        # [0, prompt_len_b) (right-padded region masked), generated KV packed
        # at [gen_base, gen_base + fill) — the write offset gen_base + fill
        # is a SCALAR shared by every slot, so the deferred write below is
        # one plain batchwide DUS instead of a serial per-slot loop
        fill, base = cache["fill"], cache["gen_base"]
        prompt_len = pos - fill
        mask = ((k_idx < prompt_len[:, None, None, None])
                | ((k_idx >= base) & (k_idx < base + fill)))
    elif defer:
        # cached-key validity is STRICT (< pos): the current token enters as
        # the joint column, its KV is written after the scan
        mask = k_idx < pos[:, None, None, None]
    else:
        mask = k_idx <= pos[:, None, None, None]  # (B,1,1,T_max)

    xs, cross_quant, self_quant = _dec_scan_xs(params, cache)
    block = _dec_block_factory(dims, cross_quant=cross_quant, self_quant=self_quant,
                               uniform_pos=uniform_pos, defer_write=defer)
    (x, _, _), out = jax.lax.scan(block, (x, pos, mask), xs)
    if defer and uniform_fill:
        z = jnp.zeros((), jnp.int32)
        at = base + fill
        cache = {**cache,
                 "self_k": jax.lax.dynamic_update_slice(
                     cache["self_k"], out["k_new"], (z, z, z, z, at)),
                 "self_v": jax.lax.dynamic_update_slice(
                     cache["self_v"], out["v_new"], (z, z, z, z, at)),
                 "pos": pos + 1, "fill": fill + 1}
        if self_quant:
            cache["self_k_scale"] = jax.lax.dynamic_update_slice(
                cache["self_k_scale"], out["ks_new"], (z, z, z, at))
            cache["self_v_scale"] = jax.lax.dynamic_update_slice(
                cache["self_v_scale"], out["vs_new"], (z, z, z, at))
    elif defer:
        # batched cross-layer write, selectable formulation (kv_write):
        #  "dus"    — vmap'd dynamic_update_slice over slots: lowers to a
        #             serial B-iteration sunk loop (per-slot offsets);
        #  "select" — full-tensor where(t == pos[b]): rewrites the whole
        #             cache (bandwidth) but is one fused batched op;
        #  "uniform"— all slots at the SAME position (window-batched decode):
        #             one plain batchwide DUS at a scalar offset;
        #  "none"   — skip the write (microbench bound; WRONG numerics).
        if kv_write == "uniform":
            z = jnp.zeros((), jnp.int32)
            cache = {**cache,
                     "self_k": jax.lax.dynamic_update_slice(
                         cache["self_k"], out["k_new"], (z, z, z, z, pos[0])),
                     "self_v": jax.lax.dynamic_update_slice(
                         cache["self_v"], out["v_new"], (z, z, z, z, pos[0])),
                     "pos": pos + 1}
        elif kv_write == "select":
            t_idx = jnp.arange(cache["self_k"].shape[-1])
            sel = (t_idx[None, :] == pos[:, None])[None, :, None, None, :]
            cache = {**cache,
                     "self_k": jnp.where(sel, out["k_new"], cache["self_k"]),
                     "self_v": jnp.where(sel, out["v_new"], cache["self_v"]),
                     "pos": pos + 1}
        elif kv_write == "none":
            cache = {**cache, "pos": pos + 1}
        else:
            def upd(c, n, pb):
                return jax.lax.dynamic_update_slice(c, n, (0, 0, 0, pb))

            wr = jax.vmap(upd, in_axes=(1, 1, 0), out_axes=1)
            cache = {**cache,
                     "self_k": wr(cache["self_k"], out["k_new"], pos),
                     "self_v": wr(cache["self_v"], out["v_new"], pos),
                     "pos": pos + 1}
        if self_quant:
            def upd_s(c, n, pb):  # c (L, H, T) <- n (L, H, 1)
                return jax.lax.dynamic_update_slice(c, n, (0, 0, pb))

            wr_s = jax.vmap(upd_s, in_axes=(1, 1, 0), out_axes=1)
            cache["self_k_scale"] = wr_s(cache["self_k_scale"], out["ks_new"], pos)
            cache["self_v_scale"] = wr_s(cache["self_v_scale"], out["vs_new"], pos)
    else:
        cache = _dec_scan_out_to_cache(cache, out, pos + 1)
    return _decoder_tail(params, x)[:, 0, :], cache


def decode_logits(params: Params, dims: WhisperDims, tokens: jax.Array, enc_out: jax.Array) -> jax.Array:
    """Teacher-forced full-sequence logits (no cache) — used by parity tests
    and scoring. tokens (B, T), enc_out (B, A, d) -> logits (B, T, V)."""
    dtype = params["decoder"]["tok_emb"].dtype
    cache = init_cache(dims, tokens.shape[0], enc_out.shape[1], dtype=dtype)
    ck, cv = compute_cross_kv(params, dims, enc_out, dtype=dtype)
    cache = {**cache, "cross_k": ck, "cross_v": cv}
    logits, _ = decode_prefill(params, dims, tokens, cache)
    return logits
