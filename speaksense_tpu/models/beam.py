"""Batched beam-search decoding (beam_size=5 per the reference's
SamplingStrategy and the BASELINE config 4 target; whisper.cpp's beam decoder
is configured at /root/reference/src/asr/whisper.rs:132 via best_of/beam).

Design (no physical KV movement at all):
- one jitted chunked `lax.while_loop` decodes ALL batch rows x beams together;
- cross-attention K/V is stored once per batch row and beams index it via
  einsum — NOT replicated per beam (for large-v3 at B=8, K=5 a replicated
  cross-KV would be ~10 GB);
- self-attention KV is NEVER reordered: each beam row always writes its own
  column (uniform fill layout), and an ANCESTOR TABLE anc (B, K, T) records
  which row produced the KV each hypothesis needs at each column. Attention
  computes logits against ALL K rows of the batch entry (the extra K'
  factor is ~1 GFLOP — cheap on the matrix units) and contracts with
  one-hot(anc), replacing a per-step physical gather of the whole
  (L, B*K, H, Dh, T) cache (~3.4 GB/step of device-memory traffic at B=8,
  K=5).
  The prompt region needs no ancestry: prefill replicates rows K-fold, so
  every row holds identical prompt KV and any ancestor is correct.
- writes are RING-buffered like greedy decode (whisper.init_ring): ANY
  direct per-step write to the big cache costs a whole-cache copy
  (see whisper.init_ring); the ring bounds it to W columns and the flush amortizes the
  big copy W-fold. The ancestor table has a matching ring (anc_ring).
- finished hypotheses are frozen: their only continuation is EOT at zero
  added logprob, so the joint top-k stays well-defined under jit.

Final selection follows whisper's default (length_penalty None/-1):
total logprob / (length + 1).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from speaksense_tpu.models import whisper as W
from speaksense_tpu.models.decode import NEG_INF, RuleConfig, apply_logit_rules

Params = dict


def _beam_block_factory(dims: W.WhisperDims, B: int, K: int):
    """Decoder block for (B*K, 1, d) steps with beam-shared cross KV and
    ancestor-indirected self attention.

    Carried masks/selectors (computed once per step, shared by all layers):
      oh_cache (B, K, K', T) f32 — one-hot(anc) x cache-validity
      oh_ring  (B, K, K', Wr) f32 — one-hot(anc_ring) x ring-validity
    Self-KV xs: sk/sv (B, K', H, Dh, T) views; rk/rv (B, K', H, Wr, Dh)."""
    n_head = dims.n_text_head

    def block(carry, xs):
        x, pos, oh_cache, oh_ring = carry  # x (BK, 1, d); pos (BK,)
        bp, sk, sv, rk, rv, ck, cv, cks, cvs = xs  # cks/cvs None unless int8 cross
        h = W._ln(x, bp["attn_ln"])
        q, k_new, v_new = W._qkv_proj(h, bp, n_head)  # (BK, H, 1, Dh)
        qb = q[:, :, 0, :].reshape(B, K, n_head, -1)   # (B, K, H, Dh)
        scale = q.shape[-1] ** -0.5

        # self-attention: logits vs ALL K' rows, then one-hot ancestor select
        lc_all = jnp.einsum("bkhd,bKhdt->bkKht", qb, sk.astype(qb.dtype),
                            preferred_element_type=jnp.float32) * scale
        lc = jnp.einsum("bkKht,bkKt->bkht", lc_all, oh_cache)
        lc = jnp.where(jnp.sum(oh_cache, axis=2)[:, :, None, :] > 0, lc, NEG_INF)
        lr_all = jnp.einsum("bkhd,bKhwd->bkKhw", qb, rk.astype(qb.dtype),
                            preferred_element_type=jnp.float32) * scale
        lr = jnp.einsum("bkKhw,bkKw->bkhw", lr_all, oh_ring)
        lr = jnp.where(jnp.sum(oh_ring, axis=2)[:, :, None, :] > 0, lr, NEG_INF)
        knb = k_new[:, :, 0, :].reshape(B, K, n_head, -1)
        ls = jnp.sum(qb.astype(jnp.float32) * knb.astype(jnp.float32),
                     axis=-1, keepdims=True) * scale  # (B, K, H, 1)
        T = sk.shape[-1]
        Wr = rk.shape[-2]
        joint = jax.nn.softmax(jnp.concatenate([lc, lr, ls], axis=-1), axis=-1)
        wc, wr_, ws = joint[..., :T], joint[..., T:T + Wr], joint[..., T + Wr:]
        # value contraction with the same one-hot selectors
        wc_sel = (wc[:, :, None, :, :] * oh_cache[:, :, :, None, :]).astype(qb.dtype)
        out = jnp.einsum("bkKht,bKhdt->bkhd", wc_sel, sv.astype(qb.dtype),
                         preferred_element_type=jnp.float32)
        wr_sel = (wr_[:, :, None, :, :] * oh_ring[:, :, :, None, :]).astype(qb.dtype)
        out = out + jnp.einsum("bkKhw,bKhwd->bkhd", wr_sel, rv.astype(qb.dtype),
                               preferred_element_type=jnp.float32)
        vnb = v_new[:, :, 0, :].reshape(B, K, n_head, -1)
        out = out + ws * vnb.astype(jnp.float32)
        attn = out.astype(qb.dtype).reshape(B * K, n_head, 1, -1)
        x = x + W._linear(W._merge_heads(attn), bp["o"])

        # cross-attention: beams share their batch row's encoder KV.
        # int8 cross (cks/cvs present): per-channel scales fold exactly into
        # the query (keys) and the output (values), as in _cached_attention_q8
        h = W._ln(x, bp["cross_ln"])
        cq = W._split_heads(W._linear(h, bp["cq"]), n_head)  # (BK, H, 1, Dh)
        cqb = cq.reshape(B, K, n_head, cq.shape[-1])          # (B, K, H, Dh)
        if cks is not None:
            cq_in = (cqb.astype(jnp.float32)
                     * cks[:, None, :, :, 0]).astype(cqb.dtype)  # (B,K,H,Dh)
        else:
            cq_in = cqb
        logits = jnp.einsum("bkhd,bhda->bkha", cq_in, ck.astype(cqb.dtype),
                            preferred_element_type=jnp.float32) * scale
        weights = jax.nn.softmax(logits, axis=-1).astype(cqb.dtype)
        ctx = jnp.einsum("bkha,bhda->bkhd", weights, cv.astype(cqb.dtype),
                         preferred_element_type=jnp.float32)
        if cvs is not None:
            ctx = ctx * cvs[:, None, :, :, 0]
        ctx = ctx.astype(cqb.dtype)
        ctx = ctx.reshape(B * K, n_head, 1, ctx.shape[-1])
        x = x + W._linear(W._merge_heads(ctx), bp["co"])
        h = W._ln(x, bp["mlp_ln"])
        x = x + W._linear(jax.nn.gelu(W._linear(h, bp["fc1"]), approximate=False), bp["fc2"])
        # ring rows (BK, H, 1, Dh) — row-major, no transpose
        return (x, pos, oh_cache, oh_ring), (k_new.astype(rk.dtype),
                                             v_new.astype(rv.dtype))

    return block


def beam_decode(params: Params, dims: W.WhisperDims, cfg: RuleConfig,
                suppress_mask: jax.Array, enc_out: jax.Array, prompt: jax.Array,
                beam_size: int = 5, prompt_len: jax.Array | None = None,
                sot_index: int | jax.Array = 0, ring_width: int = 16,
                cross_kv_int8: bool = False):
    """Beam-search one batch of windows.

    enc_out: (B, A, d) encoder states; prompt: (B, P) int32. Variable-length
    prompts (previous-text conditioning) are RIGHT-padded with prompt_len (B,)
    marking true lengths, same contract as decode.transcribe_window;
    sot_index (B,) locates <|sot|> per row for the no-speech probability.
    Returns dict(tokens (B, max_new), n_sampled (B,), sum_logprob (B,),
    avg_logprob (B,), no_speech_prob (B,)) for the best hypothesis per row.
    """
    B, A, _ = enc_out.shape
    K = beam_size
    P = prompt.shape[1]
    L = cfg.max_new_tokens
    Wr = ring_width
    while L % Wr:
        Wr //= 2
    dtype = params["decoder"]["tok_emb"].dtype
    n_head = dims.n_text_head

    # prompt prefill at beam granularity: replicate rows K-fold. Self-KV time
    # axis capped at the actual token budget (gather-free now, but the
    # attention still reads the full static axis every step).
    t_cap = min(dims.n_text_ctx, -(-(P + L) // 128) * 128)
    # the chunk flush DUS at offset P + fill would clamp and overwrite
    # earlier KV columns if the budget exceeded the cache axis (ADVICE r1)
    assert P + L <= t_cap, (P, L, t_cap)
    cache = W.init_cache(dims, B * K, A, dtype=dtype, t_text=t_cap)
    rep = lambda x: jnp.repeat(x, K, axis=1)
    if cross_kv_int8:
        # per-channel int8 cross-KV (halves the dominant cross read, ~2 GB/
        # step bf16 at B=8); scales fold into q/output in the beam block
        ck, cv, cks, cvs = W.compute_cross_kv(params, dims, enc_out, int8=True)
        cache_rep = {**cache, "cross_k": rep(ck), "cross_v": rep(cv),
                     "cross_k_scale": rep(cks), "cross_v_scale": rep(cvs)}
    else:
        ck, cv = W.compute_cross_kv(params, dims, enc_out, dtype=dtype)  # (L,B,H,Dh,A)
        cks = cvs = None
        cache_rep = {**cache, "cross_k": rep(ck), "cross_v": rep(cv)}
    prompt_rep = jnp.repeat(prompt, K, axis=0)
    pl_rep = None if prompt_len is None else jnp.repeat(prompt_len, K, axis=0)
    prefill_logits, cache_rep = W.decode_prefill(params, dims, prompt_rep, cache_rep,
                                                 prompt_len=pl_rep)
    sot_idx = jnp.broadcast_to(jnp.asarray(sot_index, jnp.int32), (B,))
    sot_logits = prefill_logits[::K][jnp.arange(B), sot_idx].astype(jnp.float32)
    no_speech_prob = jax.nn.softmax(sot_logits, axis=-1)[:, cfg.no_speech]
    last_idx = (jnp.broadcast_to(jnp.asarray(P if prompt_len is None else pl_rep),
                                 (B * K,)) - 1).astype(jnp.int32)
    first_logits = prefill_logits[jnp.arange(B * K), last_idx]

    block = _beam_block_factory(dims, B, K)
    T = t_cap

    def run_blocks(tok, cache, ring, anc_cache, anc_ring, fill):
        """One decode step for all B*K rows, ancestor-indirected, ring-
        buffered. fill = archived generated columns; ring["n"] = in-ring."""
        pos = cache["pos"]
        n = ring["n"]
        x = (params["decoder"]["tok_emb"][tok][:, None, :]
             + params["decoder"]["pos"][pos][:, None, :].astype(dtype))
        # per-step selectors, shared across layers. Cache validity:
        # own prompt [0, prompt_len_b) + archived generations [P, P+fill).
        prompt_len_vec = (pos - fill - n).reshape(B, K)
        t_idx = jnp.arange(T)
        valid_c = ((t_idx[None, None, :] < prompt_len_vec[:, :, None])
                   | ((t_idx[None, None, :] >= P)
                      & (t_idx[None, None, :] < P + fill)))   # (B, K, T)
        oh_c = (anc_cache[:, :, None, :] == jnp.arange(K)[None, None, :, None])
        oh_cache = (oh_c & valid_c[:, :, None, :]).astype(jnp.float32)
        valid_r = jnp.arange(Wr)[None, None, :] < n              # (1, 1, Wr)
        oh_r = (anc_ring[:, :, None, :] == jnp.arange(K)[None, None, :, None])
        oh_ring = (oh_r & valid_r[:, :, None, :]).astype(jnp.float32)

        skv = cache["self_k"].reshape(cache["self_k"].shape[0], B, K,
                                      n_head, -1, T)
        svv = cache["self_v"].reshape(*skv.shape)
        rkv = ring["k"].reshape(ring["k"].shape[0], B, K, n_head, Wr, -1)
        rvv = ring["v"].reshape(*rkv.shape)
        (x, _, _, _), (k_new, v_new) = jax.lax.scan(
            block, (x, pos, oh_cache, oh_ring),
            (params["decoder"]["blocks"], skv, svv, rkv, rvv, ck, cv, cks, cvs))
        # ring write at the uniform row n (k_new: (L, BK, H, 1, Dh))
        z = jnp.zeros((), jnp.int32)
        ring = {"k": jax.lax.dynamic_update_slice(ring["k"], k_new, (z, z, z, n, z)),
                "v": jax.lax.dynamic_update_slice(ring["v"], v_new, (z, z, z, n, z)),
                "n": n + 1}
        cache = {**cache, "pos": pos + 1}
        return W._decoder_tail(params, x)[:, 0, :], cache, ring

    def flush(cache, ring, anc_cache, anc_ring, fill):
        """Fold the ring into the big cache at the uniform offset P + fill
        (every row writes its own column — ancestry lives in anc_cache)."""
        z = jnp.zeros((), jnp.int32)
        at = P + fill
        rk = jnp.swapaxes(ring["k"], -1, -2).astype(cache["self_k"].dtype)
        rv = jnp.swapaxes(ring["v"], -1, -2).astype(cache["self_v"].dtype)
        cache = {**cache,
                 "self_k": jax.lax.dynamic_update_slice(
                     cache["self_k"], rk, (z, z, z, z, at)),
                 "self_v": jax.lax.dynamic_update_slice(
                     cache["self_v"], rv, (z, z, z, z, at))}
        anc_cache = jax.lax.dynamic_update_slice(
            anc_cache, anc_ring, (z, z, at))
        ring = {**ring, "n": jnp.zeros((), jnp.int32)}
        return cache, ring, anc_cache, fill + Wr

    # drop replicated cross KV from the live cache (beam blocks use ck/cv)
    live_cache = {k: v for k, v in cache_rep.items() if not k.startswith("cross_")}

    init_scores = jnp.tile(jnp.where(jnp.arange(K) == 0, 0.0, NEG_INF)[None, :], (B, 1))
    own = jnp.broadcast_to(jnp.arange(K, dtype=jnp.int32)[None, :, None], (B, K, T))
    Ldec = dims.n_text_layer
    H, Dh = n_head, dims.n_text_state // n_head
    state = dict(
        step=jnp.array(0, jnp.int32),
        fill=jnp.array(0, jnp.int32),
        logits=first_logits,                     # (BK, V)
        cache=live_cache,
        ring={"k": jnp.zeros((Ldec, B * K, H, Wr, Dh), dtype),
              "v": jnp.zeros((Ldec, B * K, H, Wr, Dh), dtype),
              "n": jnp.zeros((), jnp.int32)},
        anc_cache=own,                           # (B, K, T) int32
        anc_ring=own[:, :, :Wr],                 # (B, K, Wr)
        tokens=jnp.full((B, K, L), cfg.eot, jnp.int32),
        scores=init_scores,                      # (B, K) cumulative logprob
        n_sampled=jnp.zeros((B, K), jnp.int32),
        last=jnp.zeros((B, K), jnp.int32),
        penult=jnp.zeros((B, K), jnp.int32),
        last_ts=jnp.zeros((B, K), jnp.int32),
        finished=jnp.zeros((B, K), bool),
    )

    V = dims.n_vocab

    def cond(s):
        return (s["step"] < L) & ~jnp.all(s["finished"])

    def body(s):
        flat = lambda x: x.reshape(B * K, *x.shape[2:])
        filtered = apply_logit_rules(s["logits"], cfg, suppress_mask,
                                     flat(s["n_sampled"]), flat(s["last"]),
                                     flat(s["penult"]), flat(s["last_ts"]))
        logprobs = jax.nn.log_softmax(filtered, axis=-1).reshape(B, K, V)
        # frozen beams: only EOT continuation at 0 added logprob
        eot_only = jnp.full((V,), NEG_INF).at[cfg.eot].set(0.0)
        logprobs = jnp.where(s["finished"][:, :, None], eot_only[None, None, :], logprobs)
        joint = s["scores"][:, :, None] + logprobs          # (B, K, V)
        top_scores, top_idx = jax.lax.top_k(joint.reshape(B, K * V), K)
        parent = top_idx // V                                # (B, K)
        tok = (top_idx % V).astype(jnp.int32)                # (B, K)

        gather_bk = lambda x: jnp.take_along_axis(x, parent, axis=1)
        tokens = jnp.take_along_axis(s["tokens"], parent[:, :, None], axis=1)
        step = s["step"]
        sel = jnp.arange(L)[None, None, :] == step
        tokens = jnp.where(sel, tok[:, :, None], tokens)

        was_finished = gather_bk(s["finished"])
        newly = ~was_finished & (tok == cfg.eot)
        upd = ~was_finished & ~newly

        n_sampled = gather_bk(s["n_sampled"]) + upd.astype(jnp.int32)
        last_prev = gather_bk(s["last"])
        last = jnp.where(upd, tok, last_prev)
        penult = jnp.where(upd, last_prev, gather_bk(s["penult"]))
        is_ts = tok >= cfg.ts_begin
        last_ts = jnp.where(upd & is_ts, tok, gather_bk(s["last_ts"]))
        finished = was_finished | newly

        # ancestor bookkeeping REPLACES the physical KV reorder: the history
        # a child hypothesis needs is its parent's ancestry (tiny gathers)
        anc_cache = jnp.take_along_axis(s["anc_cache"], parent[:, :, None], axis=1)
        anc_ring = jnp.take_along_axis(s["anc_ring"], parent[:, :, None], axis=1)
        n = s["ring"]["n"]
        wsel = jnp.arange(Wr)[None, None, :] == n
        anc_ring = jnp.where(wsel, jnp.arange(K, dtype=jnp.int32)[None, :, None],
                             anc_ring)
        # positions follow the parent chain (variable prompt lengths)
        pos = jnp.take_along_axis(
            s["cache"]["pos"].reshape(B, K), parent, axis=1).reshape(-1)
        cache = {**s["cache"], "pos": pos}

        logits, cache, ring = run_blocks(tok.reshape(-1), cache, s["ring"],
                                         anc_cache, anc_ring, s["fill"])

        return dict(step=step + 1, fill=s["fill"], logits=logits, cache=cache,
                    ring=ring, anc_cache=anc_cache, anc_ring=anc_ring,
                    tokens=tokens, scores=top_scores, n_sampled=n_sampled,
                    last=last, penult=penult, last_ts=last_ts, finished=finished)

    def chunk_body(s):
        s, _ = jax.lax.scan(lambda c, _: (body(c), ()), s, None, length=Wr)
        cache, ring, anc_cache, fill = flush(s["cache"], s["ring"],
                                             s["anc_cache"], s["anc_ring"],
                                             s["fill"])
        return {**s, "cache": cache, "ring": ring, "anc_cache": anc_cache,
                "fill": fill}

    out = jax.lax.while_loop(cond, chunk_body, state)

    # pick best hypothesis: avg logprob over (length + 1)
    denom = (out["n_sampled"] + 1).astype(jnp.float32)
    avg = out["scores"] / denom
    best = jnp.argmax(avg, axis=1)                           # (B,)
    take = lambda x: jnp.take_along_axis(x, best[:, None], axis=1)[:, 0]
    tokens = jnp.take_along_axis(out["tokens"], best[:, None, None], axis=1)[:, 0]
    return dict(
        tokens=tokens,
        n_sampled=take(out["n_sampled"]),
        sum_logprob=take(out["scores"]),
        avg_logprob=take(avg),
        no_speech_prob=no_speech_prob,
    )


def transcribe_window_beam(params, dims: W.WhisperDims, cfg: RuleConfig,
                           suppress_mask: jax.Array, mel: jax.Array, prompt: jax.Array,
                           beam_size: int = 5, n_audio_ctx: int | None = None,
                           prompt_len: jax.Array | None = None,
                           sot_index: int | jax.Array = 0,
                           cross_kv_int8: bool = False):
    """Beam-search counterpart of decode.transcribe_window."""
    enc = W.encode(params, dims, mel, n_ctx_out=n_audio_ctx)
    return beam_decode(params, dims, cfg, suppress_mask, enc, prompt, beam_size,
                       prompt_len=prompt_len, sot_index=sot_index,
                       cross_kv_int8=cross_kv_int8)
