# Developer entry points + image build/push (the reference Makefile covers
# OS/arch detection, docker build/push and run variants —
# /root/reference/Makefile:1-100; cargo cross-compilation maps to our
# per-backend docker images, since the deployable artifact here is an image,
# not a musl binary).

PY ?= python
IMAGE_NAME ?= speaksense-tpu
VERSION := $(shell git describe --tags --always --dirty 2>/dev/null || echo dev)
DOCKER_REGISTRY ?= speaksense
DOCKER_IMAGE = $(DOCKER_REGISTRY)/$(IMAGE_NAME)
OS := $(shell uname -s)
ARCH := $(shell uname -m)

.PHONY: test test-fast test-gpu smoke bench serve serve-fake native sanitize \
        proto clean docker-build docker-build-cpu docker-push docker-push-cpu \
        up up-cpu info

test:  # 8 virtual CPU devices (tests/conftest.py); gpu-marked tests skip
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -m "not slow"

test-gpu:  # on a machine with an NVIDIA GPU
	JAX_PLATFORMS=cuda $(PY) -m pytest tests/ -q -m gpu

smoke:  # the serving path at full large-v3 width on one GPU (needs a GPU)
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

serve:
	$(PY) -m speaksense_tpu.main

serve-fake:
	$(PY) -m speaksense_tpu.main --fake-engine

native:
	$(PY) -c "from speaksense_tpu.native.build import build; print(build(force=True))"

sanitize:  # ASAN+UBSAN and TSAN runs of the native kernels (SURVEY §5)
	$(PY) -c "from speaksense_tpu.native.build import build_sanitizer as b; b('address'); b('thread'); print('sanitizers clean')"

proto:
	sh speaksense_tpu/serving/pb/regenerate.sh

clean:
	rm -rf speaksense_tpu/native/*.so .pytest_cache
	find . -name __pycache__ -type d -exec rm -rf {} +

# --- images (reference Makefile build/push equivalents) ---

docker-build:  # CUDA serving image (reference: dockerfile.cuda)
	docker build -f Dockerfile -t $(DOCKER_IMAGE):$(VERSION) -t $(DOCKER_IMAGE):latest .

docker-build-cpu:  # CPU/off-accelerator image (reference: dockerfile.cpu)
	docker build -f Dockerfile.cpu -t $(DOCKER_IMAGE)-cpu:$(VERSION) -t $(DOCKER_IMAGE)-cpu:latest .

docker-push: docker-build
	docker push $(DOCKER_IMAGE):$(VERSION)
	docker push $(DOCKER_IMAGE):latest

docker-push-cpu: docker-build-cpu
	docker push $(DOCKER_IMAGE)-cpu:$(VERSION)
	docker push $(DOCKER_IMAGE)-cpu:latest

up:  # GPU compose stack (asr + etcd)
	docker compose up --build

up-cpu:  # CPU smoke stack: fake engine, answers /health with no model
	docker compose -f docker-compose.cpu.yml up --build

info:
	@echo "Operating System: $(OS)"
	@echo "Architecture: $(ARCH)"
	@echo "Version: $(VERSION)"
	@echo "Image: $(DOCKER_IMAGE)"
