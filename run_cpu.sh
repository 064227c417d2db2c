#!/bin/bash
# Run a command on JAX's CPU backend with 8 virtual devices (the setting
# the tests use; multi-device paths get a CPU mesh).
# Usage: ./run_cpu.sh python -m pytest tests/ -x -q
exec env JAX_PLATFORMS=cpu \
    XLA_FLAGS="--xla_force_host_platform_device_count=8 ${XLA_FLAGS:-}" \
    "$@"
