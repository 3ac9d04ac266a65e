#!/bin/bash
# The port's worker entrypoint (counterpart of deploy/entrypoint.sh): chown
# the outputs and drop privileges. BOA_WARMUP_ON_BOOT=1 first builds the
# CUDA kernels and runs one study per bucketed shape on the card before the
# worker takes tasks (stamped: the bake runs once per cache volume; see
# boa_tpu_torch/serve/warmup.py).
set -e
if [ "${BOA_WARMUP_ON_BOOT:-0}" = "1" ]; then
  # BOA_WARMUP_FULL=1 also bakes the non-fast programs (the five-model
  # total and the 5-fold BCA), for deployments that serve non-fast studies
  WARMUP_FLAGS=""
  [ "${BOA_WARMUP_FULL:-0}" = "1" ] && WARMUP_FLAGS="--full"
  python -m boa_tpu_torch.serve.warmup --bake $WARMUP_FLAGS \
    --stamp "${BOA_WARMUP_STAMP:-$HOME/.boa_tpu/warmup.stamp}" || true
fi
if [ -d /storage_directory ] && [ -n "$DOCKER_USER" ]; then
  chown -R "$DOCKER_USER" /storage_directory || true
  exec gosu "$DOCKER_USER" "$@"
fi
exec "$@"
