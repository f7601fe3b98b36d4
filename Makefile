# Gate: the suite, the driver entry points, and (on a GPU) the smoke run and
# the bench all run green.
#   make check        — pytest + single-device entry + 8-device virtual dryrun
#   make check-bench  — the above + chip_smoke.py + bench.py (needs a GPU)

PY ?= python

.PHONY: check check-bench test entry dryrun smoke bench lint

lint:
	$(PY) tools/lint.py

test:
	JAX_PLATFORMS=cpu $(PY) -m pytest tests/ -x -q

entry:
	$(PY) __graft_entry__.py

dryrun:
	XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
	DRYRUN_DEVICES=8 $(PY) __graft_entry__.py

smoke:
	$(PY) chip_smoke.py

bench:
	$(PY) bench.py

check: lint test dryrun

check-bench: check smoke bench
