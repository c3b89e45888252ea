#!/bin/bash
# Run the test suite on XLA:CPU with 8 virtual devices.
# Usage: ./run_tests.sh [pytest args]   |   ./run_tests.sh e2e [pytest args]
export JAX_PLATFORMS=cpu
export XLA_FLAGS="--xla_force_host_platform_device_count=8 ${XLA_FLAGS:-}"
if [ "$1" = "e2e" ]; then
    shift
    exec python -m pytest tests/ -m e2e "$@"
fi
exec python -m pytest tests/ "$@"
