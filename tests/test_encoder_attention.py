"""Encoder self-attention: the kept implementation against the plain
reference, the implementation choice, the compile-cache placement, and a
source scan for machine-specific kernels and branches."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as S
from speaksense_tpu.models import whisper as W

REPO = Path(__file__).resolve().parents[1]


def _qkv(rng, B, T, H, Dh, dtype):
    return tuple(jnp.asarray(rng.standard_normal((B, T, H, Dh), np.float32), dtype)
                 for _ in range(3))


def _plain(q, k, v):
    """`_attention` in f32 on (B, T, H, Dh) inputs."""
    def t(x):
        return jnp.swapaxes(x.astype(jnp.float32), 1, 2)

    return jnp.swapaxes(W._attention(t(q), t(k), t(v), None), 1, 2)


def _rel_l2(got, want) -> float:
    d = got.astype(jnp.float32) - want
    return float(jnp.linalg.norm(d) / jnp.linalg.norm(want))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 1e-5),
                                       (jnp.bfloat16, S.ATTN_REL_L2)])
@pytest.mark.parametrize("T", [200, 256, 1500])
def test_encoder_attention_matches_plain_attention(rng, T, dtype, tol):
    # T=1500 is the full 30 s window, 256 the streaming bucket, 200 an odd
    # truncated context; the bf16 limit is the smoke's (chip_smoke.ATTN_REL_L2)
    q, k, v = _qkv(rng, 1, T, 2, 64, dtype)
    got = jax.jit(W.encoder_attention)(q, k, v)
    assert got.shape == q.shape and got.dtype == dtype
    with jax.default_matmul_precision("highest"):
        want = _plain(q, k, v)
    err = _rel_l2(got, want)
    assert err <= tol, err


@pytest.mark.parametrize("fault", list(S.planted_faults("xla")))
@pytest.mark.parametrize("T", [256, 1500])
def test_attention_limit_catches_planted_faults(rng, T, fault):
    """Each planted fault of the attention lies outside the limit that the
    bf16 attention meets."""
    q, k, v = _qkv(rng, 1, T, 2, 64, jnp.bfloat16)
    got = jax.jit(S.planted_faults("xla")[fault])(q, k, v)
    with jax.default_matmul_precision("highest"):
        want = _plain(q, k, v)
    assert _rel_l2(got, want) > S.ATTN_REL_L2


@pytest.mark.parametrize("backend,dtype,impl", [
    ("gpu", jnp.bfloat16, "cudnn"),
    ("gpu", jnp.float16, "cudnn"),
    ("gpu", jnp.float32, "xla"),
    ("cpu", jnp.bfloat16, "xla"),
    ("cpu", jnp.float32, "xla"),
])
def test_attention_impl_choice(backend, dtype, impl):
    assert W.attention_impl(backend, dtype) == impl


def test_encoder_runs_in_weight_dtype(rng):
    """The f32 log-mel is cast to the weights' compute dtype, so a bf16
    engine's encoder attention sees bf16 (the cuDNN path on a GPU)."""
    dims = W.WhisperDims(n_mels=80, n_vocab=1024, n_audio_ctx=1500,
                         n_audio_state=64, n_audio_head=4, n_audio_layer=1,
                         n_text_ctx=448, n_text_state=64, n_text_head=4,
                         n_text_layer=1)
    seen = []
    kept = W.encoder_attention

    def spy(q, k, v):
        seen.append((q.dtype, q.shape))
        return kept(q, k, v)

    mel = jnp.asarray(rng.standard_normal((1, 400, 80)), jnp.float32)
    for dtype in (jnp.bfloat16, jnp.float32):
        params = jax.tree.map(lambda x: x.astype(dtype) if x.ndim >= 2 else x,
                              W.init_params(dims))
        W.encoder_attention = spy
        try:
            out = W.encode(params, dims, mel)
        finally:
            W.encoder_attention = kept
        assert out.dtype == dtype
        assert seen[-1] == (dtype, (1, 200, 4, 16))  # (B, T, H, Dh)


_CACHE_CHILD = """
import jax
from speaksense_tpu.utils.jaxsetup import init_compilation_cache
init_compilation_cache()
print(jax.config.jax_compilation_cache_dir)
"""


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_placement(tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR is honoured and nothing else is set; the
    unset default is a fixed path under the checkout."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO)
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    out = subprocess.run([sys.executable, "-c", _CACHE_CHILD], env=env,
                         cwd=tmp_path, capture_output=True, text=True,
                         timeout=120, check=True).stdout.split()
    want = str(tmp_path / env_dir) if env_dir else str(REPO / ".jax_cache")
    assert out == [want]
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


_MACHINE_SPECIFIC = re.compile(
    r"pallas\.tpu|pallas\.ops\.tpu|pallas import tpu|platform\s*==\s*['\"]tpu"
    r"|SPEAKSENSE_FLASH")


def test_no_tpu_kernels_or_platform_branches():
    files = [p for p in REPO.rglob("*.py")
             if not {".git", ".jax_cache", "asr_data"} & set(p.parts)]
    assert len(files) > 50
    hits = [f"{p.relative_to(REPO)}:{i}"
            for p in files if p.name != Path(__file__).name
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if _MACHINE_SPECIFIC.search(line)]
    assert hits == []


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(64, 20, 1500, 64), (8, 20, 256, 64)])
def test_cudnn_encoder_attention_on_card(gpu, shape):
    """On the card: bf16 selects cuDNN, and it matches f32 `_attention`."""
    B, H, T, Dh = shape
    rng = np.random.default_rng(0)
    q, k, v = _qkv(rng, B, T, H, Dh, jnp.bfloat16)
    compiled = jax.jit(W.encoder_attention).lower(q, k, v).compile()
    assert "cudnn" in compiled.as_text().lower()
    got = compiled(q, k, v).astype(jnp.float32)
    with jax.default_matmul_precision("highest"):
        for b in range(0, B, 8):
            want = _plain(q[b:b + 8], k[b:b + 8], v[b:b + 8])
            assert _rel_l2(got[b:b + 8], want) <= S.ATTN_REL_L2
