"""Token-level continuous batching: a slot-pool decode server.

BASELINE config 4 targets "large-v3 continuous-batched serving: 64 concurrent
streams, paged KV-cache". This engine admits and retires streams at *token*
granularity: a pool of S decode slots shares one compiled step function; new
windows join free slots while others are mid-decode, and slots free the
moment their stream hits EOT — no head-of-line blocking across streams
(the reference's design blocks per stream on a whisper.cpp mutex,
/root/reference/src/asr/whisper.rs:30-39).

KV memory design (static "paged" layout): XLA wants static shapes, so the
pool IS the page table — self-KV (L, S, H, n_text_ctx, Dh) and cross-KV
(L, S, H, A, Dh) are preallocated; a slot is a page, admission scatters a
window's prefilled KV into its page via indexed writes inside jit, retirement
just marks the slot free (no copies). This is the static-shape equivalent of
vLLM-style paging at one-window-per-page granularity, which matches whisper:
every window needs its whole cross-KV for every step, so finer pages would
only add gather overhead.

Two jitted programs, both S-static:
  admit(params, state, mel, slot_idx, prompt...)  — encode + cross-KV +
      prompt prefill for ONE new window, scattered into slot `slot_idx`;
  pool_step(params, state)                        — one token for ALL active
      slots (inactive slots masked; logits/rules identical to models/decode).

The host loop interleaves admissions with steps, so a long-running stream
never blocks admission for more than one decode step (~ms).
"""

from __future__ import annotations

import logging
import os
import queue
import threading
from concurrent.futures import Future
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from speaksense_tpu.models import whisper as W
from speaksense_tpu.models import decode as D

log = logging.getLogger(__name__)

# device-resident KV pool tensors scattered per-slot at admit time (the
# scale entries exist only when the pool runs int8)
_KV_KEYS = ("self_k", "self_v", "cross_k", "cross_v",
            "self_k_scale", "self_v_scale", "cross_k_scale", "cross_v_scale")


@dataclass
class _StreamJob:
    mel: np.ndarray                  # (T_mel, n_mels) mel — or raw audio
    prompt: list[int]                # (t_mel*HOP,) f32 when is_audio
    future: Future = field(default_factory=Future)
    slot: int = -1
    is_audio: bool = False
    denoise: str | None = None       # device denoise branch name, or None
    sot_index: int = 0               # position of <|sot|> in prompt — the
    #                                  no-speech probability reads the
    #                                  prefill logits at this row (openai
    #                                  whisper's sot_index; whisper.cpp
    #                                  no_speech_thold, whisper.rs:167)
    temperature: float = 0.0         # per-slot sampling temperature: >0 on
    #                                  quality-fallback retries (the ladder
    #                                  stays continuous-batched — resubmitted
    #                                  chunks sample at their own temp while
    #                                  other slots stay greedy)
    admit_step: int = 0              # pool.step_calls when admitted (see
    #                                  retire_from: a meta snapshot older
    #                                  than the admission must not retire
    #                                  this slot's NEW occupant)
    admit_tstep: int = 0             # pool.total_steps when admitted: after
    #                                  max_new further pool steps this job is
    #                                  PROVABLY finished (hit_cap fires on
    #                                  step max_new post-admit), which lets
    #                                  the server retire a fully-capped pool
    #                                  without dispatching frozen rows


class SlotPool:
    """Device-resident decode state for S slots + host-side occupancy."""

    def __init__(self, engine, n_slots: int, t_mel: int, max_new: int,
                 with_timestamps: bool = True, int8_kv: bool = False,
                 self_int8: bool = False, ring_width: int = 16,
                 max_prompt: int = 16, mesh=None):
        """int8_kv: int8 CROSS-attention KV pages (read-only after admission
        — pure byte saving). self_int8: int8 SELF-KV pages too — these
        RIDE THE RING: the chunk-local ring stays bf16 and the flush
        quantizes its W rows in one batched op (per-token scales land in
        (L,S,H,T) tensors with a second uniform DUS), so the quantize cost
        the old write-time path paid every step (which measured it
        speed-neutral) is amortized W-fold while the archived-page reads —
        the largest byte stream of the step — halve.

        All pools use RING-buffered writes over CIRCULAR pages: per-step KV
        lands in a small ring at a row index shared by every slot (the
        in-chunk step counter — slots decode in lockstep even though their
        fills differ), and ONE uniform flush per chunk folds it in at
        column gstep % T. The per-step per-slot DUS loop this replaces
        measured as most of the step at S=64 large-v3."""
        self.engine = engine
        self.dims = engine.dims
        self.S = n_slots
        self.t_mel = t_mel
        self.n_audio_ctx = min(t_mel // 2, self.dims.n_audio_ctx)
        self.max_new = max_new
        self.int8_kv = int8_kv
        self.self_int8 = self_int8
        self.ring_width = ring_width
        self.cfg = D.RuleConfig.from_tokenizer(
            engine.tokenizer, with_timestamps=with_timestamps,
            max_initial_ts=engine.config.max_initial_ts, max_new_tokens=max_new)
        self.suppress = engine._suppress[(False, False)]
        dtype = engine.dtype
        S, dims = self.S, self.dims
        # t_text: decode positions sized to the generation budget (prompt +
        # max_new), rounded up to 128 — a 96-token streaming pool reads 3.5x less
        # self-KV per step than the full 448-position cache. The default
        # prompt allowance (16) fits plain SOT sequences; raise max_prompt
        # (e.g. 64) so pooled streams can carry previous-text conditioning —
        # the price is a larger t_text, i.e. more self-KV per step. Ring
        # mode uses CIRCULAR pages — column = global step cursor mod T —
        # which needs T >= max_prompt + max_new (a slot's live span) and
        # T % ring_width == 0 (chunk flushes stay aligned).
        self.max_prompt = max_prompt
        t_text = min(dims.n_text_ctx,
                     ((self.max_prompt + max_new + 127) // 128) * 128)
        assert t_text % ring_width == 0
        # a slot's live span (prompt + generation) must fit the circular
        # page, else ages wrap and the oldest prompt KV silently drops out
        # of attention (ADVICE r1)
        assert t_text >= self.max_prompt + max_new + ring_width - 1, \
            (t_text, self.max_prompt, max_new, ring_width)
        # S+1 rows: row S is a SCRATCH slot — batched admissions pad their
        # slot-index vector with S, so dummy rows scatter harmlessly into it
        # (its active flag is always forced False)
        self._dtype = dtype
        self._t_text = t_text
        # (dp, tp) serving mesh: pool pages shard slot-rows on dp, heads on
        # tp (parallel/mesh.pool_state_shardings); admit/step programs then
        # compile SPMD with XLA-inserted collectives
        self.mesh = mesh
        if mesh is not None:
            dp = mesh.shape["dp"]
            assert (S + 1) % dp == 0, (
                f"pool rows S+1={S + 1} must divide the mesh's dp={dp} "
                f"(engine.enable_slot_serving rounds the slot count)")
        self._init_state()
        # telemetry: admission batching + occupancy (serving-tuning data)
        self.admit_calls = 0
        self.admit_rows = 0
        self.step_calls = 0
        self.occupancy_sum = 0
        # cumulative decode STEPS (not dispatches; k varies with ring
        # clipping) — with _StreamJob.admit_tstep this makes budget
        # exhaustion host-provable (all_jobs_at_budget)
        self.total_steps = 0
        self._admit_fns: dict[tuple, object] = {}
        self._step_fns: dict[tuple[int, bool], object] = {}

    def _init_state(self) -> None:
        """(Re)build the device-resident pool state and its host mirrors.
        Called from __init__ and from reset() after a failed donated
        dispatch poisons the state (the donated buffer is deleted even when
        the program errors, so recovery must start from fresh pages)."""
        S, dims, dtype, t_text = self.S, self.dims, self._dtype, self._t_text
        self_int8, int8_kv, ring_width = self.self_int8, self.int8_kv, self.ring_width
        max_new = self.max_new
        cache = W.init_cache(dims, S + 1, self.n_audio_ctx, dtype=dtype,
                             self_kv_int8=self_int8, t_text=t_text)
        if int8_kv:
            L, H = dims.n_text_layer, dims.n_text_head
            Dh = dims.n_text_state // dims.n_text_head
            cache["cross_k"] = jnp.zeros(cache["cross_k"].shape, jnp.int8)
            cache["cross_v"] = jnp.zeros(cache["cross_v"].shape, jnp.int8)
            cache["cross_k_scale"] = jnp.zeros((L, S + 1, H, Dh, 1), jnp.float32)
            cache["cross_v_scale"] = jnp.zeros((L, S + 1, H, Dh, 1), jnp.float32)
        self.state = dict(
            **cache,
            tokens=jnp.full((S + 1, max_new), self.cfg.eot, jnp.int32),
            last_logits=jnp.zeros((S + 1, dims.n_vocab), jnp.float32),
            n_sampled=jnp.zeros((S + 1,), jnp.int32),
            last=jnp.zeros((S + 1,), jnp.int32),
            penult=jnp.zeros((S + 1,), jnp.int32),
            last_ts=jnp.zeros((S + 1,), jnp.int32),
            active=jnp.zeros((S + 1,), bool),
            sum_lp=jnp.zeros((S + 1,), jnp.float32),
            # whisper quality-gate plumbing on the POOLED path (VERDICT r4
            # item 1): per-slot no-speech probability captured at admission
            # (prefill logits at the SOT position) and a per-slot sampling
            # temperature so fallback retries ride the pool continuously
            # batched instead of the window path's serial ladder
            ns_prob=jnp.zeros((S + 1,), jnp.float32),
            temp=jnp.zeros((S + 1,), jnp.float32),
            key=jax.random.PRNGKey(0),
        )
        # Ring mode with CIRCULAR self-KV pages (all pools; int8 pages keep
        # the ring bf16 — the flush quantizes). Per-step writes land in
        # a chunk-local ring at a slot-UNIFORM row (the in-chunk step
        # index); the flush is ONE uniform DUS at column gstep % T —
        # every slot's s-th global step lives at the same column, and
        # each slot's validity window is an AGE interval (see
        # _build_step). This removes both per-step AND per-flush
        # per-slot DUS loops.
        #   gstep — global step cursor at chunk start (W-aligned)
        #   cnt   — per-slot written-column extent (ppad + steps since
        #           admission; advances by W at every flush, all slots)
        #   plen/ppad — true and padded prompt lengths at admission
        #           (the padding gap is masked out by age forever)
        L, H = dims.n_text_layer, dims.n_text_head
        Dh = dims.n_text_state // dims.n_text_head
        self.state.update(
            ring_k=jnp.zeros((L, S + 1, H, ring_width, Dh), dtype),
            ring_v=jnp.zeros((L, S + 1, H, ring_width, Dh), dtype),
            ring_n=jnp.zeros((), jnp.int32),
            gstep=jnp.zeros((), jnp.int32),
            cnt=jnp.zeros((S + 1,), jnp.int32),
            plen=jnp.ones((S + 1,), jnp.int32),
            ppad=jnp.ones((S + 1,), jnp.int32),
            # MID-RING admission support: ring row index at admission —
            # the new occupant masks ring rows [0, born) (they hold the
            # previous occupant's writes from this chunk); reset to 0 at
            # every flush
            born=jnp.zeros((S + 1,), jnp.int32))
        if self.mesh is not None:
            # sharded serving: pool pages live distributed from the start so
            # EVERY admit/step dispatch (and every reset-recovery rebuild)
            # is SPMD — same placement path as the driver's multichip dryrun
            from speaksense_tpu.parallel import shard_pool_state

            self.state = shard_pool_state(self.state, self.mesh)
        self.free: list[int] = list(range(S))
        self.jobs: dict[int, _StreamJob] = {}
        self.ring_fill = 0   # host mirror of ring_n (deterministic)
        self.gstep_host = 0  # host mirror of state["gstep"]
        # (packed-meta device handle, dispatch number) of the newest step
        # dispatch — fetched by retire_from, possibly one dispatch later
        self._last_meta: tuple[object, int] | None = None

    def reset(self, error: Exception | None = None) -> None:
        """Fail every registered job and rebuild the pool from fresh state.
        The recovery path after a dispatch failure: step/admit programs
        donate the state, so a runtime failure deletes the old buffers —
        continuing from them raises 'Array has been deleted' forever."""
        err = error or RuntimeError("slot pool reset")
        for job in self.jobs.values():
            if not job.future.done():
                job.future.set_exception(err)
        self.jobs.clear()
        self._init_state()

    def state_healthy(self) -> bool:
        """False when the device state was poisoned by a failed donated
        dispatch (its buffers are deleted)."""
        try:
            jax.block_until_ready(self.state["active"])
            return True
        except Exception:
            return False

    # ---------------------------------------------------------------- jitted

    def _build_admit(self, n: int, prompt_len: int, from_audio: bool = False,
                     denoise: str | None = None):
        """Batched admission: encode + cross-KV + prefill for n windows in
        ONE program, scattered into n pool slots. Dummy rows (padding a
        partial bucket) carry slot index S — the scratch row — and
        valid=False; their writes land harmlessly and scratch never
        activates. One dispatch instead of n means at most one whole-pool
        state copy (where buffer donation does not alias) and a batched
        encode/prefill.

        from_audio fuses the log-mel transform INTO the admission program:
        the host uploads raw PCM once and the mel never goes device->host
        (a separate compute_mel dispatch would fetch and re-upload ~330 KB
        per chunk)."""
        dims, cfg = self.dims, self.cfg
        S = self.S

        def admit(params, state, mel, slots, prompts, plen, sot_idx, temps,
                  valid, ring_fill):
            # mel (n, t_mel, n_mels) — or raw audio (n, t_mel*HOP) when
            # from_audio; slots/plen/valid (n,); prompts (n, P); sot_idx (n,)
            # locates <|sot|> per row (no-speech probability); temps (n,)
            # per-slot sampling temperature (0 = greedy); ring_fill:
            # the ring row cursor at admission (SUB-FLUSH admission, VERDICT
            # r2 item 3 — a freed slot no longer waits for the chunk
            # boundary). The prompt still lands just behind the flush cursor
            # gstep; the ring rows [0, ring_fill) that will flush over
            # columns [gstep, gstep+ring_fill) belong to the PREVIOUS
            # occupant, so they are absorbed into the slot's padding hole
            # (ppad += ring_fill) and masked from in-chunk ring attention
            # via the born register.
            if from_audio:
                from speaksense_tpu.audio import mel as MEL

                if mel.dtype == jnp.int16:
                    # wire-dtype admission: the host uploads s16 PCM (half
                    # the host->device bytes of f32); dequantize with the
                    # reference's 1/32767 scaling (handlers/asr.rs:188-194)
                    mel = mel.astype(jnp.float32) / 32767.0
                if denoise:
                    # DSP on-device too (host denoise cost serving
                    # throughput at 64 streams); numpy parity ~1e-6
                    # (audio/dsp.denoise_audio_jax). The branch is pinned
                    # per-program from the HOST classifier so only one DSP
                    # path is computed.
                    from speaksense_tpu.audio.dsp import (
                        DenoiseConfig, denoise_audio_jax,
                    )

                    mel = denoise_audio_jax(mel, DenoiseConfig(post_gain=1.0),
                                            branch=denoise)
                mel = MEL.log_mel_spectrogram(
                    mel, n_mels=dims.n_mels, filters=self.engine.mel_filters,
                    pad_to_chunk=False)
            enc = W.encode(params, dims, mel, n_ctx_out=self.n_audio_ctx)
            cache1 = W.init_cache(dims, n, enc.shape[1], dtype=self.engine.dtype,
                                  self_kv_int8=self.self_int8,
                                  t_text=self.state["self_k"].shape[-1])
            if self.int8_kv:
                kq, vq, ks, vs = W.compute_cross_kv(params, dims, enc, int8=True)
                cache1 = {**cache1, "cross_k": kq, "cross_v": vq,
                          "cross_k_scale": ks, "cross_v_scale": vs}
            else:
                ck, cv = W.compute_cross_kv(params, dims, enc,
                                            dtype=self.engine.dtype)
                cache1 = {**cache1, "cross_k": ck, "cross_v": cv}
            logits, cache1 = W.decode_prefill(params, dims, prompts, cache1,
                                              prompt_len=plen)

            rows = jnp.arange(n)
            new = dict(state)
            # circular pages: the prompt block [0, P) must land at global
            # columns [(gstep - P) % T, gstep) — virtually written at the
            # P steps before the cursor. For P <= ring_width the window
            # never wraps (gstep is W-aligned, admissions only at ring-
            # empty), so ONE plain DUS places it (jnp.roll with a traced
            # shift lowers to a slow gather). Conditioning prompts
            # (P > W) CAN wrap; place into a T+P-wide scratch and fold
            # the overflow back to column 0 — still static shapes, two
            # slices + one add, and the two regions never overlap
            # (shift + P - T <= shift since P <= T).
            T = cache1["self_k"].shape[-1]
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

            placed = {"self_k": place(cache1["self_k"]),
                      "self_v": place(cache1["self_v"])}
            if self.self_int8:
                # int8 pages carry (L, n, H, T) per-token scales; they
                # rotate with their columns
                placed["self_k_scale"] = place(cache1["self_k_scale"])
                placed["self_v_scale"] = place(cache1["self_v_scale"])
            cache1 = {**cache1, **placed}
            P_pad = jnp.int32(prompts.shape[1])
            new["cnt"] = state["cnt"].at[slots].set(
                jnp.full((n,), P_pad, jnp.int32))
            new["ppad"] = state["ppad"].at[slots].set(
                jnp.full((n,), P_pad, jnp.int32) + ring_fill)
            new["plen"] = state["plen"].at[slots].set(plen)
            new["born"] = state["born"].at[slots].set(
                jnp.full((n,), 1, jnp.int32) * ring_fill)
            for k in _KV_KEYS:
                if k in cache1:
                    new[k] = state[k].at[:, slots].set(cache1[k])
            new["pos"] = state["pos"].at[slots].set(cache1["pos"])
            last = logits[rows, plen - 1].astype(jnp.float32)
            new["last_logits"] = state["last_logits"].at[slots].set(last)
            # no-speech probability at the SOT position (openai whisper's
            # probs_at_sot; consumed host-side at settle against
            # no_speech_thold — whisper.rs:167)
            sot_logits = logits[rows, sot_idx].astype(jnp.float32)
            ns = jax.nn.softmax(sot_logits, axis=-1)[:, cfg.no_speech]
            new["ns_prob"] = state["ns_prob"].at[slots].set(ns)
            new["temp"] = state["temp"].at[slots].set(temps)
            new["tokens"] = state["tokens"].at[slots].set(
                jnp.full((n, self.max_new), cfg.eot, jnp.int32))
            zeros = jnp.zeros((n,), jnp.int32)
            for k in ("n_sampled", "last", "penult", "last_ts"):
                new[k] = state[k].at[slots].set(zeros)
            new["sum_lp"] = state["sum_lp"].at[slots].set(jnp.zeros((n,), jnp.float32))
            active = state["active"].at[slots].set(valid)
            new["active"] = active.at[S].set(False)  # scratch never activates
            return new

        return jax.jit(admit, donate_argnums=(1,))

    def _build_step(self, k: int = 1, do_flush: bool = False):
        dims, cfg = self.dims, self.cfg
        W_ring = self.ring_width
        assert k <= W_ring, (
            f"steps_per_dispatch {k} overflows the {W_ring}-row KV ring")

        def step(params, suppress, state):
            filtered = D.apply_logit_rules(
                state["last_logits"], cfg, suppress,
                state["n_sampled"], state["last"], state["penult"], state["last_ts"])
            # per-slot temperature: greedy slots argmax; fallback-retry slots
            # (temp > 0, set at admission) Gumbel-max sample. The cond keeps
            # the all-greedy hot path free of the (S+1, V) uniform draw.
            key, sub = jax.random.split(state["key"])
            tok = jax.lax.cond(
                jnp.any(state["temp"] > 0.0),
                lambda f: D._sample(f, state["temp"], sub),
                lambda f: jnp.argmax(f, axis=-1).astype(jnp.int32),
                filtered)
            tok = jnp.where(state["active"], tok, cfg.eot)
            lp = jax.nn.log_softmax(filtered, axis=-1)
            tok_lp = jnp.take_along_axis(lp, tok[:, None], axis=-1)[:, 0]
            newly_done = state["active"] & (tok == cfg.eot)
            still = state["active"] & ~newly_done

            write_col = jnp.minimum(state["n_sampled"], self.max_new - 1)
            # select-form write: a per-slot vmap-DUS lowers to a serial
            # S-iteration loop; rewriting this tiny (S, max_new) tensor is free
            sel = (jnp.arange(self.max_new)[None, :] == write_col[:, None])
            tokens = jnp.where(sel & state["active"][:, None],
                               tok[:, None], state["tokens"])

            cache = {k: state[k] for k in _KV_KEYS + ("pos",) if k in state}
            # circular-page step: every slot writes ring row ring_n (the
            # in-chunk step index — uniform even though slot fills
            # differ). Cache validity is an AGE interval per slot:
            # column t holds global step g' = g-1-((g-1-t) mod T), i.e.
            # age a = g-g' in [1, T]; ages <= n live in the ring (the
            # cache column there is T-steps stale), ages up to the
            # slot's extent cnt+n are real, and the prompt-padding gap
            # (the ppad-plen columns just below the true prompt) is
            # excluded forever.
            T = state["self_k"].shape[-1]
            n = state["ring_n"]
            g = state["gstep"] + n
            age = jnp.mod(g - 1 - jnp.arange(T), T) + 1       # (T,)
            ext = state["cnt"] + n                             # (S+1,)
            pad_hi = ext - state["plen"]
            pad_lo = ext - state["ppad"]
            valid = ((age[None, :] > n) & (age[None, :] <= ext[:, None])
                     & ~((age[None, :] > pad_lo[:, None])
                         & (age[None, :] <= pad_hi[:, None])))
            ring = {"k": state["ring_k"], "v": state["ring_v"],
                    "n": n}
            w_idx = jnp.arange(self.ring_width)[None, None, None, :]
            mask_ring = ((w_idx < n)
                         & (w_idx >= state["born"][:, None, None, None]))
            logits, cache, ring = W.decode_step_ring(
                params, dims, tok, cache, ring,
                mask_cache=valid[:, None, None, :], mask_ring=mask_ring)
            cache.update(ring_k=ring["k"], ring_v=ring["v"], ring_n=ring["n"])

            is_ts = tok >= cfg.ts_begin
            hit_cap = still & (state["n_sampled"] + 1 >= self.max_new)
            new = dict(state)
            new.update(cache)
            new["last_logits"] = logits
            new["tokens"] = tokens
            new["n_sampled"] = state["n_sampled"] + still.astype(jnp.int32)
            new["last"] = jnp.where(still, tok, state["last"])
            new["penult"] = jnp.where(still, state["last"], state["penult"])
            new["last_ts"] = jnp.where(still & is_ts, tok, state["last_ts"])
            new["sum_lp"] = state["sum_lp"] + jnp.where(state["active"], tok_lp, 0.0)
            new["active"] = state["active"] & ~newly_done & ~hit_cap
            # clear retired rows' temps: otherwise one t>0 retry would leave
            # jnp.any(temp > 0) true forever and EVERY later step would pay
            # the (S+1, V) sampling branch the lax.cond exists to skip
            new["temp"] = jnp.where(new["active"], state["temp"], 0.0)
            new["key"] = key
            finished_now = newly_done | hit_cap
            return new, finished_now

        def pack_meta(state):
            """Everything retirement reads, packed into ONE flat int32 array.

            The pool state is DONATED to the next dispatch, so a held state
            handle cannot be fetched after another step is enqueued. This
            concatenated copy is a fresh output buffer (a concat cannot
            alias its inputs), so the host may enqueue dispatch N+1 and
            only then fetch dispatch N's meta — the ~one-RTT retirement
            fetch overlaps N+1's execution instead of idling the device
            (see StreamingDecodeServer._loop lagged retirement)."""
            return jnp.concatenate([
                state["active"].astype(jnp.int32),
                state["n_sampled"].astype(jnp.int32),
                jax.lax.bitcast_convert_type(
                    state["sum_lp"].astype(jnp.float32), jnp.int32),
                jax.lax.bitcast_convert_type(
                    state["ns_prob"].astype(jnp.float32), jnp.int32),
                state["tokens"].astype(jnp.int32).reshape(-1),
            ])

        def flush(state):
            """Fold the full W-row ring into the circular pages with ONE
            batchwide DUS at column gstep % T — the cursor column is shared
            by every slot (that is the point of the circular layout; the
            per-slot-offset flush loop this replaces was a serial loop).
            Called only when the ring is full (host-enforced:
            dispatch widths divide W), so the window is W-aligned and never
            wraps (T % W == 0). cnt advances by W for ALL slots — it is a
            cursor extent, and inactive slots' pages just age out."""
            z = jnp.zeros((), jnp.int32)
            at = jnp.mod(state["gstep"], state["self_k"].shape[-1])
            # flush-time quantization (r4) or plain cast — the ONE shared
            # helper (W.flush_ring_rows) keeps this numerically identical
            # to the full-window and beam-pool flushes
            rk, rv, extra = W.flush_ring_rows(
                state["ring_k"], state["ring_v"], state["self_k"].dtype,
                at, state.get("self_k_scale"), state.get("self_v_scale"))
            return {**state, **extra,
                    "self_k": jax.lax.dynamic_update_slice(
                        state["self_k"], rk, (z, z, z, z, at)),
                    "self_v": jax.lax.dynamic_update_slice(
                        state["self_v"], rv, (z, z, z, z, at)),
                    "gstep": state["gstep"] + W_ring,
                    "cnt": state["cnt"] + W_ring,
                    "born": jnp.zeros_like(state["born"]),
                    "ring_n": jnp.zeros((), jnp.int32)}

        if k == 1:
            def step1(params, suppress, state):
                state, _fin = step(params, suppress, state)
                if do_flush:
                    state = flush(state)
                return state, pack_meta(state)

            return jax.jit(step1, donate_argnums=(2,))

        # k decode steps in ONE dispatch: where buffer donation does not
        # alias, every jit call copies the whole pool state (~GBs), and each
        # dispatch costs host time — scanning k steps inside the program
        # amortizes both k-fold. Slots that finish mid-scan freeze (active=False
        # masks all their updates), so retirement semantics are unchanged.
        def step_k(params, suppress, state):
            def body(s, _):
                s2, _fin = step(params, suppress, s)
                return s2, ()

            state, _ = jax.lax.scan(body, state, None, length=k)
            if do_flush:
                state = flush(state)
            return state, pack_meta(state)

        return jax.jit(step_k, donate_argnums=(2,))

    # ------------------------------------------------------------------ host

    # admission bucket sizes: 1 for trickle, 8 for bursts (each (bucket,
    # prompt_len) pair is one compiled program). SPEAKSENSE_ADMIT_BUCKETS
    # overrides (e.g. "1,8,16" — larger buckets amortize per-admit fixed
    # cost when completions cluster at flush boundaries).
    ADMIT_BUCKETS = tuple(
        int(b) for b in os.environ.get("SPEAKSENSE_ADMIT_BUCKETS", "1,8").split(","))

    def _prompt_buckets(self) -> tuple[int, ...]:
        """Padded-prompt width buckets: 4 covers plain SOT sequences, 16 the
        timestamped/taskful ones, max_prompt the conditioned rows."""
        return tuple(sorted({b for b in (4, 16, self.max_prompt)
                             if b <= self.max_prompt}))

    def admit_many(self, jobs: list[_StreamJob]) -> int:
        """Admit up to one bucket's worth of jobs in a single dispatch.
        Returns how many were admitted (0 if the pool is full)."""
        take = min(len(jobs), len(self.free), max(self.ADMIT_BUCKETS))
        if take == 0:
            return 0
        # one admission program per input kind: don't mix audio- and
        # mel-carrying jobs in a batch (the caller removes the admitted
        # PREFIX, so only the leading same-kind run is taken)
        batch = []
        for j in jobs[:take]:
            if ((j.is_audio, j.denoise, j.mel.dtype)
                    != (jobs[0].is_audio, jobs[0].denoise, jobs[0].mel.dtype)):
                break
            batch.append(j)
        take = len(batch)
        bucket = next(b for b in self.ADMIT_BUCKETS if b >= take)
        P = max(len(j.prompt) for j in batch)
        assert P <= self.max_prompt, (
            f"pool prompt of {P} tokens exceeds max_prompt={self.max_prompt}; "
            f"construct the pool with a larger max_prompt for conditioning")
        # bucket the padded prompt width so one compiled admit program
        # serves a range of prompt lengths (plain SOT rows -> the small
        # bucket; conditioned rows -> the max_prompt bucket)
        P = next(b for b in self._prompt_buckets() if b >= P)

        slots = np.full((bucket,), self.S, np.int32)       # padding -> scratch
        valid = np.zeros((bucket,), bool)
        plen = np.ones((bucket,), np.int32)
        sot_idx = np.zeros((bucket,), np.int32)
        temps = np.zeros((bucket,), np.float32)
        prompts = np.full((bucket, P), self.cfg.eot, np.int32)
        mel = np.zeros((bucket,) + batch[0].mel.shape, batch[0].mel.dtype)
        try:
            for i, job in enumerate(batch):
                slot = self.free.pop()
                job.slot = slot
                job.admit_step = self.step_calls
                job.admit_tstep = self.total_steps
                slots[i], valid[i], plen[i] = slot, True, len(job.prompt)
                sot_idx[i], temps[i] = job.sot_index, job.temperature
                prompts[i, : len(job.prompt)] = job.prompt
                mel[i] = job.mel
                self.jobs[slot] = job

            key = (bucket, P, batch[0].is_audio, batch[0].denoise,
                   batch[0].mel.dtype.str)
            fn = self._admit_fns.get(key)
            if fn is None:
                fn = self._admit_fns[key] = self._build_admit(
                    bucket, P, from_audio=batch[0].is_audio,
                    denoise=batch[0].denoise)
            self.state = fn(self.engine.params, self.state, jnp.asarray(mel),
                            jnp.asarray(slots), jnp.asarray(prompts),
                            jnp.asarray(plen), jnp.asarray(sot_idx),
                            jnp.asarray(temps), jnp.asarray(valid),
                            jnp.asarray(self.ring_fill, jnp.int32))
        except Exception as e:
            # roll the batch back (an admission failure — bad mel shape,
            # compile error — must not kill the server thread or strand
            # these futures; the OTHER slots are untouched unless the
            # donated dispatch actually ran, which the server loop checks
            # via state_healthy)
            for job in batch:
                if job.slot >= 0 and self.jobs.get(job.slot) is job:
                    del self.jobs[job.slot]
                    self.free.append(job.slot)
                    job.slot = -1
                if not job.future.done():
                    job.future.set_exception(e)
            del jobs[:take]          # caller must not resubmit the batch
            raise
        self.admit_calls += 1
        self.admit_rows += take
        return take

    def admit(self, job: _StreamJob) -> bool:
        return self.admit_many([job]) == 1

    def step(self, retire: bool = True, k: int = 1) -> list[_StreamJob]:
        """k pool-wide decode steps in one dispatch; returns jobs that
        finished.

        k > 1 scans k steps inside one jitted program, amortizing the
        per-dispatch host cost (and the whole-pool state copy where buffer
        donation does not alias) k-fold; finished slots freeze mid-scan and
        retirement is unchanged.

        retire=False additionally skips the device->host fetch, which waits
        for the dispatch to finish. The host loop retires every
        `poll_interval` dispatches instead (a finished slot just idles
        frozen briefly)."""
        k = min(k, self.ring_width - self.ring_fill)
        do_flush = self.ring_fill + k == self.ring_width
        fn = self._step_fns.get((k, do_flush))
        if fn is None:
            fn = self._step_fns[(k, do_flush)] = self._build_step(k, do_flush)
        self.state, meta = fn(self.engine.params, self.suppress, self.state)
        self.step_calls += 1
        self.total_steps += k
        self._last_meta = (meta, self.step_calls)
        self.occupancy_sum += len(self.jobs)
        if do_flush:
            self.ring_fill = 0
            self.gstep_host += self.ring_width  # mirrors state["gstep"]
        else:
            self.ring_fill += k
        if not retire:
            return []
        return self.retire_from(*self._last_meta)

    def retire_from(self, meta, dispatch_no: int) -> list[_StreamJob]:
        """Retire from a PACKED META snapshot (the step program's second
        output; see pack_meta in _build_step).

        `dispatch_no` is the pool.step_calls value at which `meta` was
        produced: only jobs admitted BEFORE that dispatch (admit_step <
        dispatch_no) are eligible — a newer occupant of a recycled slot
        would otherwise be retired instantly with the previous job's
        frozen snapshot values. Finished slots freeze mid-scan, so a
        one-dispatch-old snapshot holds the finisher's final tokens."""
        if not self.jobs:
            return []
        m = np.asarray(meta)          # the only device->host fetch
        s1 = self.S + 1
        active = m[:s1] != 0
        n_sampled = m[s1 : 2 * s1]
        sum_lp = m[2 * s1 : 3 * s1].view(np.float32)
        ns_prob = m[3 * s1 : 4 * s1].view(np.float32)
        tokens = m[4 * s1 :].reshape(s1, self.max_new)
        done: list[_StreamJob] = []
        for slot, job in list(self.jobs.items()):
            if job.admit_step >= dispatch_no or active[slot]:
                continue
            self.jobs.pop(slot)
            self._complete(job, slot, tokens[slot], int(n_sampled[slot]),
                           float(sum_lp[slot]), float(ns_prob[slot]))
            done.append(job)
        return done

    def _complete(self, job: _StreamJob, slot: int, tokens, n: int,
                  sum_lp: float, ns_prob: float = 0.0) -> None:
        job.future.set_result(dict(
            tokens=tokens, n_sampled=n, sum_logprob=sum_lp,
            avg_logprob=sum_lp / (n + 1),
            no_speech_prob=ns_prob, temperature=job.temperature,
        ))
        self.free.append(slot)

    def retire_finished(self) -> list[_StreamJob]:
        """Complete futures for every occupied slot whose decode finished
        (device-side `active` flag dropped) and recycle the slots."""
        if not self.jobs:
            return []
        active = np.asarray(self.state["active"])
        done_slots = [s for s in list(self.jobs) if not active[s]]
        if not done_slots:
            return []
        tokens = np.asarray(self.state["tokens"])
        n_sampled = np.asarray(self.state["n_sampled"])
        sum_lp = np.asarray(self.state["sum_lp"])
        ns_prob = np.asarray(self.state["ns_prob"])
        done: list[_StreamJob] = []
        for slot in done_slots:
            job = self.jobs.pop(slot)
            self._complete(job, slot, tokens[slot], int(n_sampled[slot]),
                           float(sum_lp[slot]), float(ns_prob[slot]))
            done.append(job)
        return done

    @property
    def n_active(self) -> int:
        return len(self.jobs)

    def all_jobs_at_budget(self) -> bool:
        """True iff EVERY current occupant has provably exhausted its token
        budget: hit_cap fires on post-admit step max_new (n_sampled+1 >=
        max_new with n_sampled = steps survived), so after total_steps has
        advanced max_new past a job's admit_tstep its device `active` flag
        is certainly False and the newest packed meta retires it. The server
        loop uses this to retire a fully-capped pool IMMEDIATELY instead of
        paying another dispatch that decodes only frozen rows (at 96-token
        chunks and k=16 that wasted dispatch was ~1/7 of pool throughput).
        Jobs that EOT before the cap just miss the fast path (conservative:
        the normal lagged retirement handles them)."""
        if not self.jobs:
            return False
        t = self.total_steps
        return all(t - j.admit_tstep >= self.max_new
                   for j in self.jobs.values())


class StreamingDecodeServer:
    """Background thread driving a SlotPool: submit windows, get futures."""

    def __init__(self, engine, n_slots: int = 16, t_mel: int = 3000,
                 max_new: int = 128, int8_kv: bool = False,
                 poll_interval: int = 1, steps_per_dispatch: int = 16,
                 self_int8: bool = False, max_prompt: int = 16, mesh=None,
                 beam_size: int = 1):
        self.engine = engine
        if beam_size and beam_size > 1:
            # beam=K continuous batching (BASELINE config 4's beam=5):
            # ancestor-indirected beam pages, same host protocol
            from speaksense_tpu.runtime.beam_slots import BeamSlotPool

            self.pool = BeamSlotPool(engine, n_slots, t_mel, max_new,
                                     beam_size=beam_size, int8_kv=int8_kv,
                                     self_int8=self_int8,
                                     max_prompt=max_prompt, mesh=mesh)
        else:
            self.pool = SlotPool(engine, n_slots, t_mel, max_new,
                                 int8_kv=int8_kv, self_int8=self_int8,
                                 max_prompt=max_prompt, mesh=mesh)
        # retire finished slots every N dispatches: each retirement check is
        # a device->host fetch that waits for the dispatch to finish
        self.poll_interval = max(1, poll_interval)
        # decode steps scanned per dispatch (amortizes the per-dispatch host
        # cost and any cross-call state copy); admissions
        # happen between dispatches, i.e. at steps_per_dispatch-token
        # granularity
        self.steps_per_dispatch = max(1, steps_per_dispatch)
        self._queue: "queue.Queue[_StreamJob]" = queue.Queue()
        self._stop = threading.Event()
        # set to the fatal exception when the pool could not be rebuilt
        # after a failed step (e.g. allocation failure) — submissions are
        # then rejected instead of queueing forever on a dead loop
        self._dead: Exception | None = None
        self._thread = threading.Thread(target=self._loop, name="slot-server", daemon=True)
        self._thread.start()
        self.steps_run = 0
        # telemetry: budget-exhaustion fast-path retirements (dispatches of
        # frozen rows avoided — see all_jobs_at_budget)
        self.fast_retires = 0
        # lagged-retirement snapshot: (packed meta handle, dispatch no) of a
        # dispatch whose retirement fetch is deferred so it overlaps the
        # NEXT dispatch's device execution (a fetch of the newest dispatch
        # would leave the device idle while the host retires and admits)
        self._lag_meta: tuple[object, int] | None = None

    def _build_prompt(self, language: str | None, task: str,
                      context: list[int] | None) -> tuple[list[int], int]:
        """[<|startofprev|>] + context[-cap:] + SOT sequence, truncated from
        the left to the pool's max_prompt budget (16-token pools carry no
        context; construct with max_prompt=64 for conditioned streaming).
        Returns (prompt, sot_index) — sot_index locates <|sot|> for the
        no-speech probability read at admission."""
        tok = self.engine.tokenizer
        sot = list(tok.sot_sequence(language or "en", task=task))
        cap = self.pool.max_prompt - len(sot) - 1
        if context and cap > 0:
            prompt = [tok.sot_prev] + list(context)[-cap:] + sot
            return prompt, len(prompt) - len(sot)
        return sot, 0

    def submit(self, mel: np.ndarray, language: str | None = "en",
               task: str = "transcribe",
               context: list[int] | None = None,
               temperature: float = 0.0) -> Future:
        """context: previous-text conditioning tokens (see _build_prompt).
        temperature > 0: quality-fallback retry submission (per-slot Gumbel
        sampling in the pool step)."""
        self._check_temperature(temperature)
        prompt, sot_index = self._build_prompt(language, task, context)
        job = _StreamJob(np.asarray(mel), prompt, sot_index=sot_index,
                         temperature=float(temperature))
        return self._put(job)

    def _check_temperature(self, temperature: float) -> None:
        """Beam pools decode at t=0 only (their admit drops the temps
        vector): reject t>0 submissions loudly instead of returning a
        greedy decode falsely labeled hot — which would skip ladder rungs
        and wrongly trip the prompt_reset rule downstream. Beam fallback
        retries route through the window path (engine._pool_retry_factory),
        matching whisper.cpp's beam -> greedy-sampling ladder."""
        if temperature > 0.0 and getattr(self.pool, "K", 1) > 1:
            raise ValueError(
                "beam pools are t=0 only; route t>0 retries through the "
                "window path (see engine._pool_retry_factory)")

    def submit_audio(self, audio: np.ndarray, language: str | None = "en",
                     task: str = "transcribe",
                     context: list[int] | None = None,
                     denoise: bool = False,
                     temperature: float = 0.0) -> Future:
        """Submit RAW 16 kHz PCM (preferred over submit()): the log-mel
        transform — and, with denoise=True, the DSP
        denoise chain — runs inside the admission program, so the audio
        uploads once and nothing round-trips device<->host.
        Audio is padded/truncated to the pool's t_mel bucket."""
        self._check_temperature(temperature)
        from speaksense_tpu.audio import mel as MEL

        n = self.pool.t_mel * MEL.HOP_LENGTH
        # s16 PCM is uploaded AS-IS (wire dtype: half the host->device bytes
        # of f32) and dequantized inside the admission program; other dtypes
        # normalize to f32 here
        a = np.asarray(audio).reshape(-1)[:n]
        if a.dtype != np.int16:
            a = a.astype(np.float32, copy=False)
        if a.size < n:
            a = np.pad(a, (0, n - a.size))
        prompt, sot_index = self._build_prompt(language, task, context)
        branch = None
        if denoise:
            from speaksense_tpu.audio.dsp import classify_noise

            # classifier thresholds are amplitude-absolute: feed it the
            # reference-scaled f32 view even when the upload stays s16
            c = a.astype(np.float32) / 32767.0 if a.dtype == np.int16 else a
            branch = classify_noise(c)  # host pick -> single-branch program
        job = _StreamJob(a, prompt, is_audio=True, denoise=branch,
                         sot_index=sot_index, temperature=float(temperature))
        return self._put(job)

    def _fatal(self, e2: Exception) -> None:
        """Declare the server dead after an unrecoverable pool failure:
        fail every registered + queued future and reject new submissions
        (submit/submit_audio check _dead, and re-check after their put —
        see the post-put guard — so no job can be stranded on the queue)."""
        self._dead = e2
        for job in list(self.pool.jobs.values()):
            if not job.future.done():
                job.future.set_exception(e2)
        self.pool.jobs.clear()
        while True:
            try:
                j = self._queue.get_nowait()
            except queue.Empty:
                break
            if not j.future.done():
                j.future.set_exception(e2)

    def _put(self, job: "_StreamJob") -> Future:
        """Enqueue a job, closing the submit/dead-transition race: if the
        loop thread declared the server dead between our _dead check and
        the put, nothing will ever drain the queue again — fail the job
        here instead of stranding its settler on future.result()."""
        if self._dead is not None:
            raise RuntimeError("slot server dead") from self._dead
        self._queue.put(job)
        if self._dead is not None and not job.future.done():
            try:
                job.future.set_exception(
                    RuntimeError("slot server dead"))
            except Exception:  # already resolved by the drain — fine
                pass
        return job.future

    def _loop(self) -> None:
        pending: list[_StreamJob] = []
        while not self._stop.is_set():
            # drain the submit queue (block briefly only when idle), then
            # admit in bucket-sized batched dispatches — BETWEEN step
            # dispatches, i.e. token-granularity continuous batching
            while True:
                try:
                    timeout = (0.0 if pending or self.pool.n_active else 0.05)
                    pending.append(self._queue.get(timeout=timeout)
                                   if timeout else self._queue.get_nowait())
                except queue.Empty:
                    break
            while pending and self.pool.free:
                try:
                    n = self.pool.admit_many(pending)
                except Exception as e:
                    # admit_many already failed the batch's futures and
                    # rolled its slots back; if the dispatch ran far enough
                    # to consume the donated state, rebuild the pool (every
                    # then-active job is failed by reset) — otherwise the
                    # other slots are untouched and serving continues
                    log.error("admission failed: %s", e, exc_info=True)
                    if not self.pool.state_healthy():
                        try:
                            self.pool.reset(e)
                        except Exception as e2:
                            # reset itself failed (e.g. OOM rebuilding the
                            # pages) — same dead-server path as the step
                            # branch below; without this guard the thread
                            # would die with futures unresolved
                            log.error("pool reset failed; slot server dead:"
                                      " %s", e2, exc_info=True)
                            for job in pending:
                                if not job.future.done():
                                    job.future.set_exception(e2)
                            self._fatal(e2)
                            return
                        self._lag_meta = None
                    break
                if n == 0:
                    break
                del pending[:n]
            if self.pool.n_active:
                try:
                    if self.pool.all_jobs_at_budget():
                        # BUDGET-EXHAUSTION FAST PATH: every occupant is
                        # provably capped, so its state in the newest meta
                        # is final — retire from it NOW and loop back to
                        # admit, instead of dispatching k steps of frozen
                        # rows just to carry the lag pipeline forward
                        if self._lag_meta is not None:
                            self.pool.retire_from(*self._lag_meta)
                            self._lag_meta = None
                        if self.pool.n_active:
                            self.pool.retire_from(*self.pool._last_meta)
                        if not self.pool.n_active:
                            self.fast_retires += 1
                            continue
                    # retire on the poll cadence, when the pool is saturated
                    # and work is waiting, or when every slot may be done
                    retire = ((self.steps_run % self.poll_interval == 0)
                              or (pending and not self.pool.free))
                    lagged = self._lag_meta
                    self.pool.step(retire=False, k=self.steps_per_dispatch)
                    self.steps_run += 1
                    if self.pool.all_jobs_at_budget():
                        # the dispatch just enqueued capped every occupant:
                        # retire synchronously (one fetch RTT) so the refill
                        # admits before the next dispatch — lagging here
                        # would decode a whole dispatch of frozen rows
                        if lagged is not None:
                            self.pool.retire_from(*lagged)
                        self.pool.retire_from(*self.pool._last_meta)
                        self._lag_meta = None
                        self.fast_retires += 1
                    elif retire:
                        if lagged is not None:
                            # LAGGED retirement: fetch the previous
                            # dispatch's packed meta while the dispatch just
                            # enqueued executes — the retirement wait
                            # overlaps device compute instead of idling it
                            self.pool.retire_from(*lagged)
                            self._lag_meta = self.pool._last_meta
                        elif pending or not self.pool.free:
                            # saturated and no older snapshot yet: defer
                            # this dispatch's retirement one iteration so
                            # the overlap pipeline starts
                            self._lag_meta = self.pool._last_meta
                        else:
                            # unsaturated (free slots, nothing queued):
                            # synchronous retire keeps a trickle stream's
                            # chunk-completion latency at one dispatch
                            self.pool.retire_from(*self.pool._last_meta)
                            self._lag_meta = None
                except Exception as e:  # pragma: no cover
                    log.error("pool step failed: %s", e, exc_info=True)
                    # the step donated the state: rebuild from fresh pages
                    # (continuing from a deleted buffer raises forever) and
                    # fail queued-but-unadmitted jobs too — their streams
                    # would otherwise block on future.result() for good
                    for job in pending:
                        if not job.future.done():
                            job.future.set_exception(e)
                    pending.clear()
                    self._lag_meta = None
                    try:
                        self.pool.reset(e)
                    except Exception as e2:
                        # reset itself failed (e.g. OOM: fresh pages cannot
                        # allocate either). Letting it propagate would kill
                        # this thread with jobs still unresolved — every
                        # stream would then hang on future.result() forever
                        # (observed: beam pool OOM deadlocked the server).
                        log.error("pool reset failed; slot server dead: %s",
                                  e2, exc_info=True)
                        self._fatal(e2)
                        return

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5.0)
        # resolve every stranded future: settlers block on future.result()
        # with no timeout, so an unresolved job would hang its gRPC
        # executor thread forever (round-2 review)
        err = RuntimeError("slot server stopped")
        # mark dead BEFORE the one-shot drain so a submit racing stop()
        # (e.g. a quality-gate retry fired from a settler thread) fails
        # fast via _put's dead checks instead of landing on the queue
        # after the drain with no loop thread left to serve it
        if self._dead is None:
            self._dead = err
        leftovers = list(self.pool.jobs.values())
        self.pool.jobs.clear()
        while True:
            try:
                leftovers.append(self._queue.get_nowait())
            except queue.Empty:
                break
        for job in leftovers:
            if not job.future.done():
                job.future.set_exception(err)
