# SpeakSense serving image for an NVIDIA GPU host (CUDA 12).
#
# The reference ships CPU/CUDA/scratch dockerfiles (dockerfile.cpu,
# dockerfile.cuda, docker-compose.yml); this is the CUDA one. JAX's cuda12
# wheels bring their own CUDA and cuDNN libraries, so the base only needs
# the driver's user-space hooks. Build args let CI pin versions.

FROM nvidia/cuda:12.8.1-base-ubuntu24.04

ARG JAX_VERSION=0.9.0

RUN apt-get update && apt-get install -y --no-install-recommends \
    python3 python3-venv ffmpeg g++ && rm -rf /var/lib/apt/lists/* \
    && python3 -m venv /opt/venv
ENV PATH=/opt/venv/bin:$PATH

RUN pip install --no-cache-dir \
    "jax[cuda12]==${JAX_VERSION}" \
    grpcio protobuf aiohttp requests scipy numpy

WORKDIR /app
COPY speaksense_tpu ./speaksense_tpu
COPY examples ./examples
COPY script ./script
COPY chip_smoke.py ./

# model fetched at boot when ASR_MODEL_PATH is absent (mirrors the
# reference's dockerfile.cuda on-boot download); the compile cache lives on
# the data volume so a restarted container reuses its compiled programs
ENV ASR_MODEL_PATH=/models/ggml-large-v3.bin \
    ASR_SQLITE_PATH=sqlite:///data/storage.db?mode=rwc \
    ASR_AUDIO_PATH=/data/audio/ \
    JAX_COMPILATION_CACHE_DIR=/data/jax_cache

EXPOSE 7200 7300

CMD ["sh", "-c", "\
  [ -f \"$ASR_MODEL_PATH\" ] || python script/download-ggml-model.py large-v3 /models; \
  python -m speaksense_tpu.main"]
