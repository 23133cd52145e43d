#!/usr/bin/env bash
# Job dispatcher for training over several nodes. Inside a SLURM
# allocation of more than one node it starts one torchrun per node through
# srun (every GPU of the node a rank, the first node the rendezvous host)
# with GEOTRAX_MULTIHOST=1, so that each rank of the command joins one
# process group; anywhere else it runs the command as given.
#
# Usage: launch.sh geotrax_tpu_torch/train/train.sh -d DATASET ...
#        launch.sh python -m geotrax_tpu_torch.train --data DATASET ...
# GEOTRAX_RDZV_PORT sets the rendezvous port (default 29500).
set -euo pipefail

if [[ -n "${SLURM_JOB_ID:-}" && "${SLURM_JOB_NUM_NODES:-1}" -gt 1 ]]; then
  head=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
  gpus=${SLURM_GPUS_ON_NODE:-$(nvidia-smi -L | wc -l)}
  export GEOTRAX_MULTIHOST=1
  exec srun --nodes "$SLURM_JOB_NUM_NODES" --ntasks-per-node 1 \
    "${PYTHON:-python}" -m torch.distributed.run --nnodes "$SLURM_JOB_NUM_NODES" \
    --nproc-per-node "$gpus" --rdzv-backend c10d \
    --rdzv-endpoint "$head:${GEOTRAX_RDZV_PORT:-29500}" --rdzv-id "$SLURM_JOB_ID" \
    --no-python "$@"
fi

exec "$@"
