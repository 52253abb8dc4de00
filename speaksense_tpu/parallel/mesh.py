"""Mesh construction and Whisper sharding rules.

Layout (Megatron-style tensor parallel over the `tp` axis, data parallel over
`dp`):
- attention q/k/v and mlp fc1 weights: column-parallel — out-feature dim on tp
  (heads split across chips; contraction stays local);
- attention out-proj and mlp fc2: row-parallel — in-feature dim on tp (XLA
  inserts the psum on the block output);
- embeddings / norms / conv stem / positional tables: replicated;
- activations and KV caches: batch on dp, heads on tp.

With params and inputs annotated, `jit` propagates shardings through the
stacked-layer scan and inserts every collective (NCCL on GPUs) — no
hand-written communication code (contrast: the reference has none of this
at all; whisper.cpp is single-device).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(n_devices: int | None = None, tp: int = 1,
              devices: list | None = None) -> Mesh:
    """(dp, tp) mesh over the first n_devices. tp must divide n_devices."""
    devs = devices if devices is not None else jax.devices()
    n = n_devices or len(devs)
    devs = devs[:n]
    assert n % tp == 0, f"tp={tp} must divide n_devices={n}"
    arr = np.asarray(devs).reshape(n // tp, tp)
    return Mesh(arr, ("dp", "tp"))


# column-parallel projections (out-feature dim on tp; contraction local) and
# row-parallel ones (in-feature dim on tp; XLA psums the block output).
# Fused "qkv" (models/whisper.fuse_qkv_weights, the engine default) is
# column-parallel over the concatenated 3d axis.
_COL_PROJ = {"q", "k", "v", "qkv", "cq", "ck", "cv", "fc1"}
_ROW_PROJ = {"o", "co", "fc2"}


def param_shardings(params) -> dict:
    """PartitionSpec pytree for ANY models/whisper.py parameter layout
    (unfused q/k/v, fused qkv, int8-quantized blocks with scale leaves):
    specs are derived from the tree structure, so layout transforms can't
    drift out of sync with a hand-written spec table."""

    def spec_for(path, leaf) -> P:
        names = [p.key for p in path if hasattr(p, "key")]
        if "blocks" in names:
            i = names.index("blocks")
            proj = names[i + 1] if len(names) > i + 1 else ""
            leafname = names[i + 2] if len(names) > i + 2 else ""
            if proj in _COL_PROJ:
                # "w" bf16 / "wq" int8 / "ws" (L, 1, d_out) scales: all carry
                # the out-feature minor axis -> tp
                if leafname in ("w", "wq", "ws") and leaf.ndim == 3:
                    return P(None, None, "tp")
                if leafname == "b" and leaf.ndim == 2:
                    return P(None, "tp")
            if proj in _ROW_PROJ and leaf.ndim == 3:
                if leafname in ("w", "wq"):
                    return P(None, "tp", None)
                # "ws" scales are per-out-channel: out dim unsharded here
        return P()  # norms, embeddings, conv stem, row biases: replicated

    return jax.tree_util.tree_map_with_path(spec_for, params)


def cache_shardings(self_kv_int8: bool = False) -> dict:
    """Decode-cache specs for models/whisper.init_cache — KV is TIME-MINOR
    (L, B, H, Dh, T): slots/batch on dp, heads on tp."""
    kv = P(None, "dp", "tp", None, None)
    out = {"self_k": kv, "self_v": kv, "cross_k": kv, "cross_v": kv,
           "pos": P("dp")}
    if self_kv_int8:
        out["self_k_scale"] = P(None, "dp", "tp", None)  # (L, B, H, T)
        out["self_v_scale"] = P(None, "dp", "tp", None)
    return out


def pool_state_shardings(state: dict) -> dict:
    """PartitionSpec pytree for a runtime/slots.SlotPool state dict: the
    slot axis on dp, heads on tp, scalars replicated. The pool's S+1 rows
    (S slots + 1 scratch) must divide dp."""
    kv5 = P(None, "dp", "tp", None, None)  # (L, S+1, H, Dh|W, T|Dh)
    per_slot = P("dp")
    specs: dict = {}
    for k, v in state.items():
        if k in ("self_k", "self_v", "cross_k", "cross_v",
                 "cross_k_scale", "cross_v_scale", "ring_k", "ring_v"):
            specs[k] = kv5
        elif k in ("self_k_scale", "self_v_scale"):
            specs[k] = P(None, "dp", "tp", None)
        elif k in ("tokens", "last_logits"):
            specs[k] = P("dp", None)
        elif k == "key":  # pool PRNG key (2,) — replicated, NOT a slot axis
            specs[k] = P()
        elif getattr(v, "ndim", 0) == 1:  # per-slot registers
            specs[k] = per_slot
        else:  # scalars (ring_n, gstep)
            specs[k] = P()
    return specs


def shard_pool_state(state: dict, mesh: Mesh) -> dict:
    """Place a SlotPool state dict on the mesh (dp over slots, tp over
    heads) so the admit/step programs compile SPMD."""
    specs = pool_state_shardings(state)
    return {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
            for k, v in state.items()}


def shard_params(params, mesh: Mesh):
    """Place a parameter pytree on the mesh per param_shardings."""
    specs = param_shardings(params)
    # tree.map flattens by the FIRST tree's structure, so PartitionSpec leaves
    # in `specs` (tuple subclasses) are not themselves flattened.
    return jax.tree.map(
        lambda x, s: jax.device_put(x, NamedSharding(mesh, s)), params, specs)
