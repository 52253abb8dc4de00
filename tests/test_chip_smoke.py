"""chip_smoke.py rehearsed on the CPU: its device check refuses CPU devices,
and its phase functions run end to end at tiny widths (the one-card
serving phases over the wire and under it, the four-device mesh path on
virtual devices)."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

import chip_smoke as S
from speaksense_tpu.models.whisper import WhisperDims

REPO = Path(__file__).resolve().parents[1]
# full vocabulary and 128 mels (large-v3's), tiny width and depth
TINY = WhisperDims(n_mels=128, n_vocab=51866, n_audio_ctx=1500,
                   n_audio_state=64, n_audio_head=4, n_audio_layer=2,
                   n_text_ctx=448, n_text_state=64, n_text_head=4,
                   n_text_layer=2)


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(S.SmokeFailure, match="no GPU"):
        S.check_device(jax.devices())
    with pytest.raises(S.SmokeFailure):
        S.check_device([])


def _run_script(path: Path, cwd: Path):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, str(path)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("alone", [False, True])
def test_script_fails_without_gpu_or_repo(tmp_path, alone):
    """On the CPU the script stops at its device check; copied alone into an
    empty directory it cannot import the program. Neither prints a result."""
    script = REPO / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    proc = _run_script(script, tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    if not alone:
        assert "FAILED: JAX found no GPU" in proc.stdout


def test_attention_check_tiny():
    S.attention_check(((2, 2, 200, 64), (1, 2, 256, 64)), seed=0)


def test_model_check_tiny():
    from speaksense_tpu.models.whisper import init_params_np

    S.model_check(TINY, init_params_np(TINY, seed=0), seed=0, n_tok=8)


@pytest.mark.parametrize("wire", [True, False])
def test_run_single_tiny(tmp_path, monkeypatch, wire, capsys):
    """The whole one-card flow: checkpoint file, main.start with
    --slot-serving, streams, a batch task, the beam-5 pool, memory analysis.
    wire=False drives StreamSession and TaskManager directly, as the script
    does where a front-door package is missing."""
    if not wire:
        monkeypatch.setattr(S, "front_door_packages",
                            lambda: dict.fromkeys(S.FRONT_DOOR, False))
    lines = S.run_single(TINY, seed=0, work=tmp_path,
                         attn_shapes=((1, 2, 200, 64),), ports=(0, 0),
                         compute_dtype="float32")
    out = capsys.readouterr().out
    assert ("gRPC" if wire else "StreamSession") in out
    assert ("batch task (REST)" if wire else "batch task (TaskManager)") in out
    assert any(l.startswith("memory_analysis admit") for l in lines)
    assert any(l.startswith("memory_analysis step") for l in lines)
    assert any(l.startswith("memory_analysis beam step") for l in lines)
    assert any(l.startswith("peak_bytes_in_use") for l in lines)
    assert (tmp_path / "ggml-random.bin").stat().st_size > 0
    if wire:
        from speaksense_tpu.serving import grpc_server as G

        assert G.local_ip.__name__ == "local_ip"  # restored after serving


def test_run_multichip_tiny(capsys):
    """The --chips 4 path on four of the eight virtual CPU devices."""
    lines = S.run_multichip(TINY, seed=0, n_devices=4)
    out = capsys.readouterr().out
    assert "phase mesh tp=2 x dp=2: ok" in out
    assert "tp=2 x dp=2: all-reduces in the forward program by element type: f32" in out
    assert [l.split(":")[0] for l in lines[:5]] == [
        "dp=4", "tp=2 x dp=2", "one card", "dp=4", "tp=2 x dp=2"]
    assert all("against f32" in l for l in lines[:3])
    assert all("against one card" in l for l in lines[3:5])


def test_all_reduce_types():
    hlo = """
  %all-reduce.1 = f32[4,1500,64]{2,1,0} all-reduce(%b), channel_id=3
  %ars = (bf16[8,64]{1,0}, f32[8]{0}) all-reduce-start(%x, %y), channel_id=4
  %ard = (bf16[8,64]{1,0}, f32[8]{0}) all-reduce-done(%ars)
  %add = f32[4]{0} add(%p, %q)
"""
    assert S.all_reduce_types(hlo) == {"f32": 2, "bf16": 1}


def test_last_line_is_the_result(monkeypatch, capsys, tmp_path):
    """main() prints the device as JAX reports it, as the final line."""
    class FakeGpu:
        platform = "gpu"
        device_kind = "NVIDIA H100 80GB HBM3"

    monkeypatch.setattr(jax, "devices", lambda *a: [FakeGpu()])
    monkeypatch.setattr(S, "card_line", lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(S, "run_single", lambda *a, **k: ["summary"])
    assert S.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
