"""Beam-search slot pool: token-level continuous batching at beam width K.

BASELINE config 4 reads "64 concurrent streams, paged KV cache, beam=5";
the window batcher's beam cannot admit or retire streams at token
granularity. This pool extends the
circular-page design (runtime/slots.py) with a beam axis, reusing the
ancestor-indirection idea from models/beam.py so beam reordering NEVER moves
KV bytes:

- self-KV pages: (L, (S+1)*K, H, Dh, T) circular pages — each beam row
  always writes its own row; an ancestor table anc (S+1, K, T) records which
  row produced the KV each hypothesis needs at each (circular) column, and
  attention contracts logits against all K rows with one-hot(anc).
- cross-KV: stored ONCE per slot (L, S+1, H, Dh, A) and shared by the K
  beams via einsum — a replicated cross-KV would multiply the dominant
  per-step read K-fold (and the admission encode cost).
- ring-buffered writes + one uniform flush per chunk, exactly as the greedy
  pool (ring ancestors flush into anc alongside the KV).
- per-slot joint top-k over (K x V) each step; finished hypotheses freeze
  (EOT continuation at zero added logprob); a slot retires when all K beams
  finish or the token budget is hit. Retirement packs the BEST hypothesis
  per slot (whisper's length penalty: total logprob / (length + 1)) into
  the same flat meta layout as the greedy pool, so the host-side lagged
  retirement is inherited unchanged.

Reference beam config: /root/reference/src/asr/whisper.rs:132-141.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from speaksense_tpu.models import decode as D
from speaksense_tpu.models import whisper as W
from speaksense_tpu.models.decode import NEG_INF
from speaksense_tpu.runtime.slots import SlotPool, _StreamJob


class BeamSlotPool(SlotPool):
    """SlotPool with K beam hypotheses per slot (host API unchanged)."""

    def __init__(self, engine, n_slots: int, t_mel: int, max_new: int,
                 beam_size: int = 5, **kw):
        # self_int8: int8 SELF-KV beam pages. The beam step's page
        # reads DOMINATE its bytes (every hypothesis contracts against all
        # K rows' pages: ~4.3 GB/step at S=32 K=5 large-v3 vs ~1.7 GB of
        # weights), so int8 pages are both a speed lever and a capacity
        # lever (they halve the pages' device memory).
        # Ring rows stay bf16; the flush quantizes (same design as the
        # greedy pool).
        self.K = int(beam_size)
        assert self.K >= 2, "use SlotPool for greedy serving"
        super().__init__(engine, n_slots, t_mel, max_new, **kw)

    # ------------------------------------------------------------------ state

    def _init_state(self) -> None:
        S, dims, dtype, T = self.S, self.dims, self._dtype, self._t_text
        K, Wd = self.K, self.ring_width
        L, H = dims.n_text_layer, dims.n_text_head
        Dh = dims.n_text_state // H
        R = (S + 1) * K
        cache_self = W.init_cache(dims, R, self.n_audio_ctx, dtype=dtype,
                                  self_kv_int8=self.self_int8, t_text=T)
        # cross shapes from a throwaway (S+1)-row cache (t_text minimal)
        cache_cross = W.init_cache(dims, S + 1, self.n_audio_ctx, dtype=dtype,
                                   t_text=self.ring_width)
        state = dict(
            self_k=cache_self["self_k"], self_v=cache_self["self_v"],
            cross_k=cache_cross["cross_k"], cross_v=cache_cross["cross_v"],
            pos=jnp.zeros((R,), jnp.int32),
        )
        if self.self_int8:
            state["self_k_scale"] = cache_self["self_k_scale"]
            state["self_v_scale"] = cache_self["self_v_scale"]
        if self.int8_kv:
            state["cross_k"] = jnp.zeros(state["cross_k"].shape, jnp.int8)
            state["cross_v"] = jnp.zeros(state["cross_v"].shape, jnp.int8)
            state["cross_k_scale"] = jnp.zeros((L, S + 1, H, Dh, 1), jnp.float32)
            state["cross_v_scale"] = jnp.zeros((L, S + 1, H, Dh, 1), jnp.float32)
        own = jnp.broadcast_to(
            jnp.arange(K, dtype=jnp.int32)[None, :, None], (S + 1, K, T))
        state.update(
            ring_k=jnp.zeros((L, R, H, Wd, Dh), dtype),
            ring_v=jnp.zeros((L, R, H, Wd, Dh), dtype),
            ring_n=jnp.zeros((), jnp.int32),
            gstep=jnp.zeros((), jnp.int32),
            cnt=jnp.zeros((S + 1,), jnp.int32),
            plen=jnp.ones((S + 1,), jnp.int32),
            ppad=jnp.ones((S + 1,), jnp.int32),
            anc=own,
            anc_ring=own[:, :, :Wd],
            born=jnp.zeros((S + 1,), jnp.int32),
            tokens=jnp.full((S + 1, K, self.max_new), self.cfg.eot, jnp.int32),
            last_logits=jnp.zeros((R, dims.n_vocab), jnp.float32),
            scores=jnp.zeros((S + 1, K), jnp.float32),
            n_sampled=jnp.zeros((S + 1, K), jnp.int32),
            last=jnp.zeros((S + 1, K), jnp.int32),
            penult=jnp.zeros((S + 1, K), jnp.int32),
            last_ts=jnp.zeros((S + 1, K), jnp.int32),
            finished=jnp.zeros((S + 1, K), bool),
            active=jnp.zeros((S + 1,), bool),
            # per-slot no-speech probability (prefill logits at the SOT
            # position, shared by all K beams) — consumed host-side at
            # settle against no_speech_thold (whisper.rs:167). Beam pools
            # have no per-slot temperature: fallback retries at t>0 switch
            # to greedy sampling on the window path, matching whisper.cpp's
            # beam -> greedy-sampling ladder.
            ns_prob=jnp.zeros((S + 1,), jnp.float32),
        )
        self.state = state
        if self.mesh is not None:
            from speaksense_tpu.parallel import shard_pool_state

            self.state = shard_pool_state(self.state, self.mesh)
        self.free = list(range(S))
        self.jobs = {}
        self.ring_fill = 0
        self.gstep_host = 0
        self._last_meta = None

    # ----------------------------------------------------------------- jitted

    def _build_admit(self, n: int, prompt_len: int, from_audio: bool = False,
                     denoise: str | None = None):
        dims, cfg = self.dims, self.cfg
        S, K = self.S, self.K

        def admit(params, state, mel, slots, prompts, plen, sot_idx, temps,
                  valid, ring_fill):
            # temps is accepted for host-protocol parity with the greedy
            # pool but unused: beam decode is t=0 only (fallback retries
            # route through the window path at t>0)
            del temps
            if from_audio:
                from speaksense_tpu.audio import mel as MEL

                if mel.dtype == jnp.int16:
                    mel = mel.astype(jnp.float32) / 32767.0
                if denoise:
                    from speaksense_tpu.audio.dsp import (
                        DenoiseConfig, denoise_audio_jax,
                    )

                    mel = denoise_audio_jax(mel, DenoiseConfig(post_gain=1.0),
                                            branch=denoise)
                mel = MEL.log_mel_spectrogram(
                    mel, n_mels=dims.n_mels, filters=self.engine.mel_filters,
                    pad_to_chunk=False)
            enc = W.encode(params, dims, mel, n_ctx_out=self.n_audio_ctx)
            # cross-KV computed ONCE per window; replicated K-fold only for
            # the transient prefill cache, stored per-slot in the pool
            if self.int8_kv:
                kq, vq, ks, vs = W.compute_cross_kv(params, dims, enc, int8=True)
                cross = {"cross_k": kq, "cross_v": vq,
                         "cross_k_scale": ks, "cross_v_scale": vs}
            else:
                ck, cv = W.compute_cross_kv(params, dims, enc,
                                            dtype=self.engine.dtype)
                cross = {"cross_k": ck, "cross_v": cv}
            T = state["self_k"].shape[-1]
            # int8 pools prefill STRAIGHT into int8 pages + per-token
            # scales (same as the greedy pool, slots.py _build_admit) —
            # the old path prefilled bf16 and quantized the placed
            # full-T page, paying T/P-fold wasted quantize work on the
            # zero columns (r4 review)
            cache1 = W.init_cache(dims, n * K, enc.shape[1],
                                  dtype=self.engine.dtype,
                                  self_kv_int8=self.self_int8, t_text=T)
            rep = lambda x: jnp.repeat(x, K, axis=1)
            cache1 = {**cache1, **{k: rep(v) for k, v in cross.items()}}
            prompts_rep = jnp.repeat(prompts, K, axis=0)
            plen_rep = jnp.repeat(plen, K, axis=0)
            logits, cache1 = W.decode_prefill(params, dims, prompts_rep, cache1,
                                              prompt_len=plen_rep)

            # circular placement: prompt block ends at the cursor (same
            # two-variant place as the greedy pool, incl. wrap for P > W)
            P_len = prompts.shape[1]
            shift = jnp.mod(state["gstep"] - P_len, T)
            if P_len <= self.ring_width:
                def place(page):
                    # page: any rank with the circular T axis MINOR
                    # (5D KV pages, 4D per-token scale tensors)
                    z = (jnp.zeros((), jnp.int32),) * (page.ndim - 1)
                    return jax.lax.dynamic_update_slice(
                        jnp.zeros_like(page), page[..., :P_len], z + (shift,))
            else:
                def place(page):
                    z = (jnp.zeros((), jnp.int32),) * (page.ndim - 1)
                    buf = jnp.zeros(page.shape[:-1] + (T + P_len,), page.dtype)
                    buf = jax.lax.dynamic_update_slice(
                        buf, page[..., :P_len], z + (shift,))
                    return buf[..., :T].at[..., :P_len].add(buf[..., T:])

            rows = (slots[:, None] * K
                    + jnp.arange(K, dtype=slots.dtype)[None, :]).reshape(-1)
            new = dict(state)
            new["self_k"] = state["self_k"].at[:, rows].set(place(cache1["self_k"]))
            new["self_v"] = state["self_v"].at[:, rows].set(place(cache1["self_v"]))
            if self.self_int8:
                # per-token scales ride the same circular placement as
                # their columns (prefill wrote them alongside the pages)
                new["self_k_scale"] = state["self_k_scale"].at[:, rows].set(
                    place(cache1["self_k_scale"]))
                new["self_v_scale"] = state["self_v_scale"].at[:, rows].set(
                    place(cache1["self_v_scale"]))
            for key, v in cross.items():
                new[key] = state[key].at[:, slots].set(v)
            new["pos"] = state["pos"].at[rows].set(cache1["pos"])
            last = logits[jnp.arange(n * K), plen_rep - 1].astype(jnp.float32)
            new["last_logits"] = state["last_logits"].at[rows].set(last)
            # no-speech probability from beam 0's prefill row (all K beams
            # share the prompt, so any row works)
            r0 = jnp.arange(n) * K
            sot_logits = logits[r0, sot_idx].astype(jnp.float32)
            ns = jax.nn.softmax(sot_logits, axis=-1)[:, cfg.no_speech]
            new["ns_prob"] = state["ns_prob"].at[slots].set(ns)
            own = jnp.broadcast_to(
                jnp.arange(K, dtype=jnp.int32)[None, :, None], (n, K, T))
            new["anc"] = state["anc"].at[slots].set(own)
            new["anc_ring"] = state["anc_ring"].at[slots].set(
                own[:, :, : self.ring_width])
            new["tokens"] = state["tokens"].at[slots].set(
                jnp.full((n, K, self.max_new), cfg.eot, jnp.int32))
            zeros2 = jnp.zeros((n, K), jnp.int32)
            for key in ("n_sampled", "last", "penult", "last_ts"):
                new[key] = state[key].at[slots].set(zeros2)
            new["finished"] = state["finished"].at[slots].set(
                jnp.zeros((n, K), bool))
            init_scores = jnp.where(jnp.arange(K) == 0, 0.0, NEG_INF)
            new["scores"] = state["scores"].at[slots].set(
                jnp.broadcast_to(init_scores, (n, K)).astype(jnp.float32))
            P_pad = jnp.int32(prompts.shape[1])
            filln = lambda v: jnp.full((n,), v, jnp.int32)
            new["cnt"] = state["cnt"].at[slots].set(filln(P_pad))
            # mid-ring admission (see SlotPool._build_admit): the previous
            # occupant's pending ring rows flush over [gstep, gstep+ring_
            # fill) — absorbed into the padding hole and masked in-ring
            new["ppad"] = state["ppad"].at[slots].set(filln(P_pad) + ring_fill)
            new["plen"] = state["plen"].at[slots].set(plen)
            new["born"] = state["born"].at[slots].set(filln(1) * ring_fill)
            active = state["active"].at[slots].set(valid)
            new["active"] = active.at[S].set(False)
            return new

        return jax.jit(admit, donate_argnums=(1,))

    def _build_step(self, k: int = 1, do_flush: bool = False):
        dims, cfg = self.dims, self.cfg
        S, K, Wd = self.S, self.K, self.ring_width
        V = dims.n_vocab
        n_head = dims.n_text_head
        Sp1 = S + 1
        assert k <= Wd

        self_q8 = self.self_int8

        def block(carry, xs):
            # models/beam._beam_block_factory adapted to Sp1 batch rows with
            # per-SLOT cross-KV (shared by the K beams via einsum)
            x, oh_cache, oh_ring = carry
            if self_q8:
                bp, sk, sv, rk, rv, ck, cv, cks, cvs, sks, svs = xs
            else:
                bp, sk, sv, rk, rv, ck, cv, cks, cvs = xs
                sks = svs = None
            h = W._ln(x, bp["attn_ln"])
            q, k_new, v_new = W._qkv_proj(h, bp, n_head)
            qb = q[:, :, 0, :].reshape(Sp1, K, n_head, -1)
            scale = q.shape[-1] ** -0.5
            lc_all = jnp.einsum("bkhd,bKhdt->bkKht", qb, sk.astype(qb.dtype),
                                preferred_element_type=jnp.float32) * scale
            if sks is not None:
                # int8 pages: per-token key scale multiplies its logit
                # column (exact fold — whisper._cached_attention_q8t)
                lc_all = lc_all * sks[:, None]
            lc = jnp.einsum("bkKht,bkKt->bkht", lc_all, oh_cache)
            lc = jnp.where(jnp.sum(oh_cache, axis=2)[:, :, None, :] > 0, lc, NEG_INF)
            lr_all = jnp.einsum("bkhd,bKhwd->bkKhw", qb, rk.astype(qb.dtype),
                                preferred_element_type=jnp.float32) * scale
            lr = jnp.einsum("bkKhw,bkKw->bkhw", lr_all, oh_ring)
            lr = jnp.where(jnp.sum(oh_ring, axis=2)[:, :, None, :] > 0, lr, NEG_INF)
            knb = k_new[:, :, 0, :].reshape(Sp1, K, n_head, -1)
            ls = jnp.sum(qb.astype(jnp.float32) * knb.astype(jnp.float32),
                         axis=-1, keepdims=True) * scale
            T = sk.shape[-1]
            joint = jax.nn.softmax(
                jnp.concatenate([lc, lr, ls], axis=-1), axis=-1)
            wc, wr_, ws = joint[..., :T], joint[..., T:T + Wd], joint[..., T + Wd:]
            wc_sel = wc[:, :, None, :, :] * oh_cache[:, :, :, None, :]
            if svs is not None:
                # value scale multiplies its softmax weight before the
                # V contraction (exact fold)
                wc_sel = wc_sel * svs[:, None]
            wc_sel = wc_sel.astype(qb.dtype)
            out = jnp.einsum("bkKht,bKhdt->bkhd", wc_sel, sv.astype(qb.dtype),
                             preferred_element_type=jnp.float32)
            wr_sel = (wr_[:, :, None, :, :] * oh_ring[:, :, :, None, :]).astype(qb.dtype)
            out = out + jnp.einsum("bkKhw,bKhwd->bkhd", wr_sel, rv.astype(qb.dtype),
                                   preferred_element_type=jnp.float32)
            vnb = v_new[:, :, 0, :].reshape(Sp1, K, n_head, -1)
            out = out + ws * vnb.astype(jnp.float32)
            attn = out.astype(qb.dtype).reshape(Sp1 * K, n_head, 1, -1)
            x = x + W._linear(W._merge_heads(attn), bp["o"])

            h = W._ln(x, bp["cross_ln"])
            cq = W._split_heads(W._linear(h, bp["cq"]), n_head)
            cqb = cq.reshape(Sp1, K, n_head, cq.shape[-1])
            if cks is not None:
                cq_in = (cqb.astype(jnp.float32)
                         * cks[:, None, :, :, 0]).astype(cqb.dtype)
            else:
                cq_in = cqb
            scale_c = cq.shape[-1] ** -0.5
            logits_c = jnp.einsum("bkhd,bhda->bkha", cq_in, ck.astype(cqb.dtype),
                                  preferred_element_type=jnp.float32) * scale_c
            weights = jax.nn.softmax(logits_c, axis=-1).astype(cqb.dtype)
            ctx = jnp.einsum("bkha,bhda->bkhd", weights, cv.astype(cqb.dtype),
                             preferred_element_type=jnp.float32)
            if cvs is not None:
                ctx = ctx * cvs[:, None, :, :, 0]
            ctx = ctx.astype(cqb.dtype).reshape(Sp1 * K, n_head, 1, ctx.shape[-1])
            x = x + W._linear(W._merge_heads(ctx), bp["co"])
            h = W._ln(x, bp["mlp_ln"])
            x = x + W._linear(jax.nn.gelu(W._linear(h, bp["fc1"]),
                                          approximate=False), bp["fc2"])
            return (x, oh_cache, oh_ring), (k_new.astype(rk.dtype),
                                            v_new.astype(rv.dtype))

        def step(params, suppress, state):
            flat = lambda a: a.reshape(Sp1 * K, *a.shape[2:])
            filtered = D.apply_logit_rules(
                state["last_logits"], cfg, suppress,
                flat(state["n_sampled"]), flat(state["last"]),
                flat(state["penult"]), flat(state["last_ts"]))
            logprobs = jax.nn.log_softmax(filtered, axis=-1).reshape(Sp1, K, V)
            eot_only = jnp.full((V,), NEG_INF).at[cfg.eot].set(0.0)
            logprobs = jnp.where(state["finished"][:, :, None],
                                 eot_only[None, None, :], logprobs)
            joint = state["scores"][:, :, None] + logprobs
            top_scores, top_idx = jax.lax.top_k(joint.reshape(Sp1, K * V), K)
            parent = (top_idx // V).astype(jnp.int32)
            tok = (top_idx % V).astype(jnp.int32)
            act = state["active"]
            own_k = jnp.arange(K, dtype=jnp.int32)
            # inactive slots freeze completely (retirement reads a snapshot)
            parent = jnp.where(act[:, None], parent, own_k[None, :])
            tok = jnp.where(act[:, None], tok, cfg.eot)
            scores = jnp.where(act[:, None], top_scores, state["scores"])

            g = lambda a: jnp.take_along_axis(a, parent, axis=1)
            was_fin = g(state["finished"])
            newly = act[:, None] & ~was_fin & (tok == cfg.eot)
            upd = act[:, None] & ~was_fin & ~newly
            n_s = g(state["n_sampled"]) + upd.astype(jnp.int32)
            last_prev = g(state["last"])
            last = jnp.where(upd, tok, last_prev)
            penult = jnp.where(upd, last_prev, g(state["penult"]))
            is_ts = tok >= cfg.ts_begin
            last_ts = jnp.where(upd & is_ts, tok, g(state["last_ts"]))
            finished = jnp.where(act[:, None], was_fin | newly,
                                 state["finished"])

            n = state["ring_n"]
            tokens = jnp.take_along_axis(state["tokens"], parent[:, :, None],
                                         axis=1)
            # per-slot local step since admission (cnt advances W per flush)
            local_step = jnp.clip(state["cnt"] + n - state["ppad"], 0,
                                  self.max_new - 1)
            sel = (jnp.arange(self.max_new)[None, None, :]
                   == local_step[:, None, None])
            tokens = jnp.where(sel & act[:, None, None], tok[:, :, None], tokens)

            anc = jnp.take_along_axis(state["anc"], parent[:, :, None], axis=1)
            anc_ring = jnp.take_along_axis(state["anc_ring"],
                                           parent[:, :, None], axis=1)
            anc_ring = jnp.where(jnp.arange(Wd)[None, None, :] == n,
                                 own_k[None, :, None], anc_ring)
            pos = jnp.take_along_axis(state["pos"].reshape(Sp1, K), parent,
                                      axis=1).reshape(-1)

            # circular-page validity (age intervals — see SlotPool._build_step)
            # expanded with the one-hot ancestor selector
            T = state["self_k"].shape[-1]
            gg = state["gstep"] + n
            age = jnp.mod(gg - 1 - jnp.arange(T), T) + 1
            ext = state["cnt"] + n
            pad_hi = ext - state["plen"]
            pad_lo = ext - state["ppad"]
            valid = ((age[None, :] > n) & (age[None, :] <= ext[:, None])
                     & ~((age[None, :] > pad_lo[:, None])
                         & (age[None, :] <= pad_hi[:, None])))   # (Sp1, T)
            oh_cache = ((anc[:, :, None, :] == own_k[None, None, :, None])
                        & valid[:, None, None, :]).astype(jnp.float32)
            w_idx = jnp.arange(Wd)
            rvalid = ((w_idx[None, None, None, :] < n)
                      & (w_idx[None, None, None, :]
                         >= state["born"][:, None, None, None]))  # (Sp1,1,1,Wd)
            oh_ring = ((anc_ring[:, :, None, :] == own_k[None, None, :, None])
                       & rvalid).astype(jnp.float32)

            p = params["decoder"]
            dtype = p["tok_emb"].dtype
            x = (p["tok_emb"][tok.reshape(-1)][:, None, :]
                 + p["pos"][pos][:, None, :].astype(dtype))
            L = dims.n_text_layer
            H, Dh = n_head, dims.n_text_state // n_head
            skv = state["self_k"].reshape(L, Sp1, K, H, Dh, T)
            svv = state["self_v"].reshape(L, Sp1, K, H, Dh, T)
            rkv = state["ring_k"].reshape(L, Sp1, K, H, Wd, Dh)
            rvv = state["ring_v"].reshape(L, Sp1, K, H, Wd, Dh)
            cks = state.get("cross_k_scale")
            cvs = state.get("cross_v_scale")
            xs_scan = (p["blocks"], skv, svv, rkv, rvv,
                       state["cross_k"], state["cross_v"], cks, cvs)
            if self_q8:
                xs_scan = xs_scan + (
                    state["self_k_scale"].reshape(L, Sp1, K, H, T),
                    state["self_v_scale"].reshape(L, Sp1, K, H, T))
            (x, _, _), (k_new, v_new) = jax.lax.scan(
                block, (x, oh_cache, oh_ring), xs_scan)
            logits = W._decoder_tail(params, x)[:, 0, :]

            z = jnp.zeros((), jnp.int32)
            new = dict(state)
            new["ring_k"] = jax.lax.dynamic_update_slice(
                state["ring_k"], k_new, (z, z, z, n, z))
            new["ring_v"] = jax.lax.dynamic_update_slice(
                state["ring_v"], v_new, (z, z, z, n, z))
            new["ring_n"] = n + 1
            new["pos"] = pos + 1  # uniform advance (circular validity is
            #                       age-derived; pos only feeds embeddings)
            new["last_logits"] = logits
            new["tokens"] = tokens
            new["scores"] = scores
            new["n_sampled"] = n_s
            new["last"] = last
            new["penult"] = penult
            new["last_ts"] = last_ts
            new["finished"] = finished
            new["anc"] = anc
            new["anc_ring"] = anc_ring
            all_done = jnp.all(finished, axis=1)
            hit_cap = local_step + 1 >= self.max_new
            new["active"] = act & ~all_done & ~hit_cap
            return new

        def pack_meta(state):
            """Best hypothesis per slot, packed into the SAME flat layout as
            the greedy pool's meta (active | n_sampled | score | tokens) —
            SlotPool.retire_from is inherited unchanged."""
            denom = (state["n_sampled"] + 1).astype(jnp.float32)
            avg = state["scores"] / denom
            best = jnp.argmax(avg, axis=1)
            take = lambda a: jnp.take_along_axis(a, best[:, None], axis=1)[:, 0]
            btok = jnp.take_along_axis(state["tokens"], best[:, None, None],
                                       axis=1)[:, 0]
            return jnp.concatenate([
                state["active"].astype(jnp.int32),
                take(state["n_sampled"]).astype(jnp.int32),
                jax.lax.bitcast_convert_type(
                    take(state["scores"]).astype(jnp.float32), jnp.int32),
                jax.lax.bitcast_convert_type(
                    state["ns_prob"].astype(jnp.float32), jnp.int32),
                btok.reshape(-1),
            ])

        def flush(state):
            z = jnp.zeros((), jnp.int32)
            at = jnp.mod(state["gstep"], state["self_k"].shape[-1])
            # flush-time quantization or plain cast via the shared helper
            # (numerically identical to the greedy pool and full windows)
            rk, rv, extra = W.flush_ring_rows(
                state["ring_k"], state["ring_v"], state["self_k"].dtype,
                at, state.get("self_k_scale"), state.get("self_v_scale"))
            return {**state, **extra,
                    "self_k": jax.lax.dynamic_update_slice(
                        state["self_k"], rk, (z, z, z, z, at)),
                    "self_v": jax.lax.dynamic_update_slice(
                        state["self_v"], rv, (z, z, z, z, at)),
                    "anc": jax.lax.dynamic_update_slice(
                        state["anc"], state["anc_ring"], (z, z, at)),
                    "gstep": state["gstep"] + Wd,
                    "cnt": state["cnt"] + Wd,
                    "born": jnp.zeros_like(state["born"]),
                    "ring_n": jnp.zeros((), jnp.int32)}

        def step_k(params, suppress, state):
            if k == 1:
                state = step(params, suppress, state)
            else:
                state, _ = jax.lax.scan(
                    lambda s, _: (step(params, suppress, s), ()), state, None,
                    length=k)
            if do_flush:
                state = flush(state)
            return state, pack_meta(state)

        return jax.jit(step_k, donate_argnums=(2,))

    # ------------------------------------------------------------------ host

    def retire_finished(self) -> list[_StreamJob]:
        if not self.jobs:
            return []
        active = np.asarray(self.state["active"])
        done_slots = [s for s in list(self.jobs) if not active[s]]
        if not done_slots:
            return []
        scores = np.asarray(self.state["scores"])
        n_sampled = np.asarray(self.state["n_sampled"])
        tokens = np.asarray(self.state["tokens"])
        ns_prob = np.asarray(self.state["ns_prob"])
        done: list[_StreamJob] = []
        for slot in done_slots:
            job = self.jobs.pop(slot)
            best = int(np.argmax(scores[slot] / (n_sampled[slot] + 1)))
            self._complete(job, slot, tokens[slot, best],
                           int(n_sampled[slot, best]),
                           float(scores[slot, best]), float(ns_prob[slot]))
            done.append(job)
        return done
