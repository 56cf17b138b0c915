#!/bin/bash
# SLURM launcher for data-parallel (DD-PPO) training of the PyTorch port.
#
# Counterpart of scripts/slurm_train.sh and the reference's
# ss_baselines/savi/slurm.sh: one torchrun a node, GPUS_PER_NODE ranks each,
# every rank running `python -m avlen_tpu_torch.run` on the card LOCAL_RANK
# names and training its share of NUM_PROCESSES env slots; the gradients
# are averaged over all ranks once a minibatch (avlen_tpu_torch/parallel/).
# NCCL carries them when each rank has a card of its own, gloo when ranks
# share a card. SIGUSR1 120 s before the time limit reaches torchrun, which
# forwards it to its ranks (--signals-to-handle) and gives them
# --shutdown-timeout seconds: every rank stops at the same update, rank 0
# saves the interrupted state and runs `scontrol requeue`
# (avlen_tpu_torch/utils/preemption.py), and the requeued job resumes from
# it (RESUME_CHECKPOINT True).
#
#   sbatch avlen_tpu_torch/scripts/slurm_train.sh [EXP_CONFIG] [MODEL_DIR]
#
#SBATCH --job-name=avlen_torch
#SBATCH --output=logs/avlen_%j.out
#SBATCH --nodes=1
#SBATCH --ntasks-per-node=1
#SBATCH --gpus-per-node=8
#SBATCH --signal=USR1@120
#SBATCH --requeue

set -euo pipefail

EXP_CONFIG=${1:-configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml}
MODEL_DIR=${2:-runs/$SLURM_JOB_ID}
GPUS_PER_NODE=${GPUS_PER_NODE:-${SLURM_GPUS_ON_NODE:-8}}
MASTER_ADDR=$(scontrol show hostnames "$SLURM_JOB_NODELIST" | head -n 1)
MASTER_PORT=${MASTER_PORT:-29500}

srun python -m torch.distributed.run \
    --nnodes "$SLURM_JOB_NUM_NODES" \
    --nproc_per_node "$GPUS_PER_NODE" \
    --node_rank "$SLURM_NODEID" \
    --rdzv_backend c10d \
    --rdzv_endpoint "$MASTER_ADDR:$MASTER_PORT" \
    --signals-to-handle SIGTERM,SIGINT,SIGHUP,SIGQUIT,SIGUSR1,SIGUSR2 \
    --shutdown-timeout 110 \
    -m avlen_tpu_torch.run \
    --run-type train \
    --exp-config "$EXP_CONFIG" \
    --model-dir "$MODEL_DIR" \
    RESUME_CHECKPOINT True
