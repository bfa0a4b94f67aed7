# Top-level build: native components + tests
.PHONY: all native test bench clean

all: native

native:
	$(MAKE) -C moptimizer_jax/native

test: native
	python -m pytest tests/ -q

bench: native
	python bench.py

clean:
	$(MAKE) -C moptimizer_jax/native clean
