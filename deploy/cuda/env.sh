# Per-shell environment of the PyTorch port on a CUDA machine (the
# reference's domainID.sh counterpart).  `source deploy/cuda/env.sh`.

# Bus namespace: isolates this deployment's topics from other processes
# sharing a bus bridge (the reference's ROS_DOMAIN_ID=22).
export OFC_BUS_NAMESPACE="${OFC_BUS_NAMESPACE:-of22}"

# The CUDA toolkit whose nvcc builds the kernels (ops/_build.py looks in
# $CUDA_HOME/bin first).
export CUDA_HOME="${CUDA_HOME:-/usr/local/cuda}"

# The port on the card: the smoke run, its GPU tests, the multi-rank dry
# run (NCCL, one rank a card).
alias ofc-smoke='python3 chip_smoke.py'
alias ofc-gpu-test='python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gpu.py'
alias ofc-dryrun='python -m opticalflowcontainer_tpu_torch.parallel.dryrun --ranks "$(nvidia-smi -L | wc -l)"'

echo "OFC_BUS_NAMESPACE=$OFC_BUS_NAMESPACE  CUDA_HOME=$CUDA_HOME"
