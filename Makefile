# Development / CI entry points.  The suite runs on the virtual 8-device
# CPU mesh (tests/conftest.py forces JAX_PLATFORMS=cpu, kernels in
# interpret mode); the smoke and bench targets need an NVIDIA GPU.

PY ?= python

.PHONY: test test-fast native smoke smoke-multi bench bench-all ci

test:
	$(PY) -m pytest tests/ -q

test-fast:
	$(PY) -m pytest tests/ -q -x -m "not slow"

native:
	$(MAKE) -C native

# one GPU: every phase of the main path, compiled, bit-checked
smoke:
	$(PY) chip_smoke.py

# four GPUs: the sharded four-step, channelizer and convolution
smoke-multi:
	$(PY) chip_smoke.py --multi

bench:
	$(PY) bench.py

bench-all:
	$(PY) bench.py --all

# the CI gate: native oracle builds, full suite green
ci: native test
