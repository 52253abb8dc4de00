"""speaksense_tpu — a JAX ASR (Whisper) serving framework for accelerators.

A from-scratch rebuild of the capabilities of bean-du/SpeakSense (a Rust
whisper.cpp gRPC/REST server) designed around a device-resident engine:

- the neural inference engine (reference: whisper.cpp behind `whisper-rs`,
  /root/reference/src/asr/whisper.rs) is a JAX/XLA/Pallas Whisper
  implementation with batched encode + continuous-batched decode;
- the audio DSP pipeline (reference: /root/reference/src/audio/mod.rs) is a
  numpy/jnp pipeline with the log-mel transform fused into the on-device
  admission program (XLA framed-matmul STFT);
- the serving stack (gRPC bidi streaming on :7300, REST on :7200, SQLite task
  queue, API-key auth, etcd registry) preserves the reference's external
  contracts bit-for-bit so existing clients keep working.
"""

__version__ = "0.1.0"
