"""Encoder self-attention on the GPU: three candidates, and the encode they make.

  xla    plain `_attention` as XLA compiles it: it writes the (B, H, T, T)
         f32 logits to device memory and reads them back
  cudnn  jax.nn.dot_product_attention(implementation="cudnn"), cuDNN's
         fused flash attention (the implementation `encoder_attention`
         selects for bf16 on a GPU)
  mha    jax.experimental.pallas.ops.gpu.attention.mha, JAX's library
         flash-attention kernel through Pallas and Triton (not a kernel this
         repository wrote). T is padded to a multiple of the block and the
         padded keys are masked with segment ids. Its block sizes and
         num_warps / num_stages are swept first; the best setting is timed.

Each candidate is timed with block_until_ready at (B, H, T, Dh) =
(64, 20, 1500, 64), the window encode, and (8, 20, 256, 64), the 5.12 s
streaming admission bucket. Then the full large-v3 encode is timed with
each, per window, at the same two shapes (64 windows of 30 s; 8 chunks of
5.12 s), beside `f32 mel`: the encode with f32 activations (TF32 matmuls,
XLA attention), which is what the engine ran before the log-mel was cast
to the compute dtype.

Run on the card (needs a GPU; refuses the CPU):
    python tools/microbench_encattn.py [--out chiprun_out/encattn.json]
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SHAPES = ((64, 20, 1500, 64), (8, 20, 256, 64))
# (windows, mel frames) of each encode, keyed to its attention shape
ENCODES = {(64, 3000): "64x20x1500x64", (8, 512): "8x20x256x64"}
SWEEP = dict(block_q=(64, 128), block_k=(64, 128), num_warps=(4, 8),
             num_stages=(2, 3))


def time_ms(fn, *args, iters: int = 10, reps: int = 1) -> float:
    """Median over iters samples of the wall ms per call of fn(*args), each
    sample `reps` back-to-back calls ended by block_until_ready (so a
    sub-millisecond kernel is not timed as one dispatch's host latency),
    after two warm-up calls (compilation included there)."""
    import jax

    for _ in range(2):
        jax.block_until_ready(fn(*args))
    samples = []
    for _ in range(iters):
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn(*args)
        jax.block_until_ready(out)
        samples.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(samples)


def xla_attention(q, k, v):
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    def t(x):
        return jnp.swapaxes(x, 1, 2)

    return t(W._attention(t(q), t(k), t(v), None))


def cudnn_attention(q, k, v):
    import jax

    return jax.nn.dot_product_attention(q, k, v, implementation="cudnn")


def mha_attention(q, k, v, block_q=64, block_k=64, num_warps=4, num_stages=2):
    """The Pallas-Triton library kernel on (B, T, H, Dh), T padded to the
    block and the padded keys masked by segment id."""
    import jax.numpy as jnp
    from jax.experimental.pallas.ops.gpu import attention as A

    B, T, H, Dh = q.shape
    blk = max(block_q, block_k)
    Tp = -(-T // blk) * blk

    def pad(x):
        return jnp.pad(x, ((0, 0), (0, Tp - T), (0, 0), (0, 0)))

    seg = jnp.broadcast_to((jnp.arange(Tp) < T).astype(jnp.int32)[None], (B, Tp))
    out = A.mha(pad(q), pad(k), pad(v), seg, sm_scale=Dh ** -0.5,
                block_sizes=A.BlockSizes(block_q=block_q, block_k=block_k),
                num_warps=num_warps, num_stages=num_stages)
    return out[:, :T]


def sweep_mha(q, k, v, log) -> tuple[dict, float]:
    import functools

    import jax

    best, best_ms = None, float("inf")
    for vals in itertools.product(*SWEEP.values()):
        cfg = dict(zip(SWEEP, vals))
        try:
            ms = time_ms(jax.jit(functools.partial(mha_attention, **cfg)),
                         q, k, v, iters=5, reps=10)
        except Exception as e:  # a block the card refuses is a sweep result
            log(f"  mha {cfg}: refused ({type(e).__name__}: {str(e)[:120]})")
            continue
        log(f"  mha {cfg}: {ms:.3f} ms")
        if ms < best_ms:
            best, best_ms = cfg, ms
    if best is None:
        raise RuntimeError("no mha setting compiled")
    return best, best_ms


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/encattn.json")
    ap.add_argument("--model", default="large-v3")
    args = ap.parse_args(argv)

    from speaksense_tpu.utils.jaxsetup import init_compilation_cache

    init_compilation_cache()
    import functools

    import jax
    import jax.numpy as jnp

    from speaksense_tpu.models import whisper as W

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"needs a GPU; JAX found {dev.platform!r}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()

    def log(msg):
        print(msg, flush=True)

    log(f"card: {card}; jax {jax.__version__}; {dev.device_kind}")
    result = {"card": card, "device_kind": dev.device_kind, "kernels": {},
              "encode_ms_per_window": {}}
    rng = np.random.default_rng(0)
    for B, H, T, Dh in SHAPES:
        q, k, v = (jnp.asarray(rng.standard_normal((B, T, H, Dh), np.float32),
                               jnp.bfloat16) for _ in range(3))
        ref = jax.jit(xla_attention)(q, k, v).astype(jnp.float32)
        log(f"shape B={B} H={H} T={T} Dh={Dh}: sweeping mha")
        best, _ = sweep_mha(q, k, v, log)
        cands = {"xla": jax.jit(xla_attention),
                 "cudnn": jax.jit(cudnn_attention),
                 "mha": jax.jit(functools.partial(mha_attention, **best))}
        row = {"mha_setting": best}
        for name, fn in cands.items():
            err = float(jnp.max(jnp.abs(fn(q, k, v).astype(jnp.float32) - ref)))
            row[name] = {"ms": time_ms(fn, q, k, v, reps=20), "max_abs_vs_xla": err}
            log(f"  {name}: {row[name]['ms']:.3f} ms (max |diff| vs xla {err:.2e})")
        result["kernels"][f"{B}x{H}x{T}x{Dh}"] = row
        del q, k, v, ref

    dims = W.MODEL_DIMS[args.model]
    import ml_dtypes

    host = jax.tree.map(lambda x: x.astype(ml_dtypes.bfloat16) if x.ndim >= 2 else x,
                        W.init_params_np(dims, seed=0))
    # the engine's own layout: q/k/v fused per block, on the host
    params = jax.tree.map(jnp.asarray, W.fuse_qkv_weights(host))
    f32_stem = {**params, "encoder": {**params["encoder"], "conv1": {
        "w": params["encoder"]["conv1"]["w"].astype(jnp.float32),
        "b": params["encoder"]["conv1"]["b"]}}}
    del host
    kept = W.encoder_attention
    for (B, t_mel), shape in ENCODES.items():
        mel = jnp.asarray(rng.standard_normal((B, t_mel, dims.n_mels)), jnp.float32)
        best = result["kernels"][shape]["mha_setting"]
        runs = {"f32 mel": (kept, f32_stem), "xla": (xla_attention, params),
                "cudnn": (cudnn_attention, params),
                "mha": (functools.partial(mha_attention, **best), params)}
        row = result["encode_ms_per_window"][f"{B}x{t_mel}"] = {}
        for name, (attn, p) in runs.items():
            W.encoder_attention = attn     # encode looks it up while tracing
            try:
                fn = jax.jit(lambda p, m: W.encode(p, dims, m))
                ms = time_ms(fn, p, mel, iters=5, reps=1 if B > 8 else 5)
            finally:
                W.encoder_attention = kept
            row[name] = ms / B
            log(f"{args.model} encode, {B} x {t_mel} mel frames: {name}: "
                f"{ms:.2f} ms per batch, {ms / B:.3f} ms per window")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    log(json.dumps(result["encode_ms_per_window"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
