"""Tensor-parallel serving on ``torch.distributed`` (port of
``sleekit_tpu/parallel/``): one process a rank, each running the
single-device code on its shard of heads and ff; NCCL on the card, gloo
on the CPU."""
